"""base_dft_roofline: the base-DFT kernels' share of their roofline, in percent.

The least time of every launch in the window (the program's launch census
gives each launch's shape; `proofbench.peaks.base_dft_bound`), summed, over
the device time the profiler gives the kernels of those names. The bound
reads only shapes, so it counts the same work whatever implements the DFT.
Nothing to read (no launch, or no device time for the kernels): None."""

import re

from proofbench import peaks

# a kernel's symbol as the profiler names it: "base_dft_kernel(...)",
# "(anonymous namespace)::base_dft_kernel(...)", with template arguments or none
_KERNEL = re.compile(r"(?:^|[\s:])(" + "|".join(peaks.BASE_DFT_KERNELS) + r")(?:[(<]|$)")


def read(run):
    if run.trace is None:
        return None
    bound_s = 0.0
    for (name, rows, n, _inverse), count in run.census.items():
        kernel = peaks.CENSUS_NAMES.get(name)
        if kernel is not None:
            bound_s += count * peaks.base_dft_bound(rows, n, kernel)[0]
    kernel_s = sum(s for name, s in run.trace.time_by_name().items() if _KERNEL.search(name))
    if bound_s <= 0 or kernel_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s

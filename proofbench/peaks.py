"""Peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit) and
the base-DFT kernels' least times.

A kernel's roofline share is its least time, the larger of the bytes it
must move over the HBM rate and the operations it must do over the tensor
cores' peak for its type, divided by its measured device time.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12

# kernel (device symbol) -> (peak operations per second, weight-table bytes per n^2)
# The i8 kernel reads 8 int8 digit planes of the n x n DFT matrix, the bf16
# kernel 8 bf16 chunk planes.
BASE_DFT_KERNELS = {
    "base_dft_kernel": (INT8_OPS_PER_S, 8),
    "base_dft_bf16_kernel": (BF16_OPS_PER_S, 16),
}
# the program's launch counter names its kernels by their C entry point
CENSUS_NAMES = {"base_dft": "base_dft_kernel", "base_dft_bf16": "base_dft_bf16_kernel"}


def base_dft_bound(rows: int, n: int, kernel: str) -> Tuple[float, str]:
    """(least seconds, what binds) of one launch over `rows` rows of n points:
    16 B per element (8 in, 8 out) plus the weight table over the HBM rate,
    against 2 * 64 * n operations per element (8 x 8 digit products per
    term) over the kernel's tensor-core peak."""
    ops_per_s, weight_per_n2 = BASE_DFT_KERNELS[kernel]
    elements = rows * n
    bytes_s = (16 * elements + weight_per_n2 * n * n) / HBM_BYTES_PER_S
    ops_s = 2 * 64 * n * elements / ops_per_s
    return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")

"""Reading a `torch.profiler` trace of the window, and what the host did.

The profiler records device activity (kernels, copies, memsets) with start
and duration on the host's clock. `DeviceTrace` keeps the device intervals
of the traced window as arrays:
- busy seconds: the union of device intervals inside the window;
- device time and count by name;
- idle gaps: the window less the busy union, each named by what the host
  was doing in it, from `HostSampler`: the program function (file and
  name) sampled most often inside the gap.

`HostSampler` is a thread that reads the main thread's Python stack every
few milliseconds during the traced window; it costs the traced run a
little time, the untraced run none.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

NAME_CHARS = 160
PROGRAM = "ethproof_tpu_torch"
_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


class HostSampler(threading.Thread):
    """Samples the main thread's innermost program frame every `interval` s."""

    def __init__(self, interval: float = 0.005):
        super().__init__(daemon=True)
        self.interval = interval
        self.target = threading.main_thread().ident
        self.times: List[int] = []
        self.labels: List[str] = []
        self._halt = threading.Event()

    @staticmethod
    def label(frame, depth: int = 3) -> str:
        """The innermost `depth` program frames, "file:function <- caller ..."."""
        inner, names = frame, []
        while frame is not None and len(names) < depth:
            path = frame.f_code.co_filename
            if PROGRAM in path:
                names.append(f"{path[path.rindex(PROGRAM) + len(PROGRAM) + 1:]}:"
                             f"{frame.f_code.co_name}")
            frame = frame.f_back
        return " <- ".join(names) if names else f"{inner.f_code.co_name} (outside the program)"

    def run(self) -> None:
        while not self._halt.wait(self.interval):
            frame = sys._current_frames().get(self.target)
            if frame is not None:
                self.times.append(time.time_ns())
                self.labels.append(self.label(frame))

    def stop(self) -> None:
        self._halt.set()
        self.join()


@dataclass
class DeviceTrace:
    window: Tuple[int, int]  # ns, the host clock the profiler uses
    dev_start: np.ndarray  # ns, clipped to the window
    dev_end: np.ndarray
    dev_name: List[str]
    host_times: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    host_labels: List[str] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        order = np.argsort(self.dev_start, kind="stable")
        merged: List[Tuple[int, int]] = []
        for s, e in zip(self.dev_start[order].tolist(), self.dev_end[order].tolist()):
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_count(self) -> int:
        return sum(1 for n in self.dev_name if not n.startswith(_COPY_PREFIXES))

    def time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, s, e in zip(self.dev_name, self.dev_start.tolist(), self.dev_end.tolist()):
            out[n] += (e - s) / 1e9
        return out

    def idle_gaps(self) -> List[Tuple[int, int]]:
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def host_during(self, s: int, e: int) -> str:
        """The host label sampled most inside [s, e], else the sample nearest it."""
        if not len(self.host_times):
            return "not sampled"
        lo, hi = np.searchsorted(self.host_times, [s, e])
        if hi > lo:
            return Counter(self.host_labels[lo:hi]).most_common(1)[0][0]
        near = min(max(lo, 0), len(self.host_times) - 1)
        return self.host_labels[near] + " (nearest sample)"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[self.host_during(s, e)[:NAME_CHARS], (e - s) / 1e9] for s, e in gaps],
        }


def read(prof, window: Tuple[int, int], sampler: HostSampler = None) -> DeviceTrace:
    """The device events of a stopped `torch.profiler.profile` inside `window`
    (ns, `time.time_ns()` at its start and end), with the host samples."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    lo, hi = window
    d_s, d_e, d_n = [], [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if e > lo and s < hi:
            d_s.append(max(s, lo))
            d_e.append(min(e, hi))
            d_n.append(ev.name())
    tr = DeviceTrace(window, np.asarray(d_s, dtype=np.int64), np.asarray(d_e, dtype=np.int64), d_n)
    if sampler is not None:
        tr.host_times = np.asarray(sampler.times, dtype=np.int64)
        tr.host_labels = list(sampler.labels)
    return tr

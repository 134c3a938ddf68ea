"""Per-phase wall-clock seconds.

Counterpart: ethproof_tpu/runtime/tracing.py:51 (`phase`). The counterpart
accumulates into a module-level dict; here the caller owns the dict. On a
CUDA device the phase ends with a synchronise, so its seconds cover the
device work it enqueued and not only the host's enqueueing.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def phase(name: str, times: Optional[Dict[str, float]], device: torch.device):
    """Add the seconds of the `with` body to times[name] (no-op for None)."""
    if times is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0

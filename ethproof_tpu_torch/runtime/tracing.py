"""Logging spans and per-phase wall-clock seconds.

Counterpart: ethproof_tpu/runtime/tracing.py:17-50 (`logger`,
`init_tracing`, `span`, copied: one span per proof operation, its duration
logged when it closes; `ETHPROOF_LOG` sets the level) and :51 (`phase`).
The counterpart's `phase` accumulates into a module-level dict; here the
caller owns the dict. On a CUDA device the phase ends with a synchronise,
so its seconds cover the device work it enqueued and not only the host's
enqueueing.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger("ethproof_tpu_torch")


def init_tracing(level: Optional[str] = None, pretty: bool = False) -> None:
    lvl = (level or os.environ.get("ETHPROOF_LOG", "info")).upper()
    fmt = (
        "%(asctime)s %(levelname)s %(name)s: %(message)s"
        if pretty
        else "%(levelname)s %(name)s: %(message)s"
    )
    logging.basicConfig(level=getattr(logging, lvl, logging.INFO), format=fmt)


@contextlib.contextmanager
def span(name: str, **fields):
    """One span per proof op, its duration logged on close."""
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    logger.info("%s begin %s", name, extra)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.info("%s close time.busy=%.3fs %s", name, time.perf_counter() - t0, extra)


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

"""The comparison that decides `correct`: a proof against the reference's.

Both proofs are walked field by field (dataclasses by field name, lists by
index, arrays element by element). Every field falls into one group, the
layer that produced it; a group's number is how many of its u64 elements
differ, and a field whose type, shape or presence differs counts every
element of the larger side, and at least one. Field arithmetic, Poseidon
and the transcript are exact, so every limit is 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

# first path component -> group
GROUPS = {
    "trace_cap": "caps", "aux_cap": "caps", "quotient_cap": "caps",
    "ctl_totals": "ctl_totals",
    "openings": "openings",
    "fri_proof": "fri",
    "trace_query_openings": "tree_openings", "aux_query_openings": "tree_openings",
    "quotient_query_openings": "tree_openings", "fixed_query_openings": "tree_openings",
    "degree_bits": "shape", "public_inputs": "shape",
}
LIMITS = {"caps": 0, "ctl_totals": 0, "openings": 0, "fri": 0, "tree_openings": 0, "shape": 0}


def _size(x) -> int:
    if x is None:
        return 1
    if dataclasses.is_dataclass(x):
        return sum(_size(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return max(1, sum(_size(v) for v in x))
    if isinstance(x, np.ndarray):
        return max(1, x.size)
    return 1


def _diff(got, want) -> int:
    """Differing elements between two proof values."""
    if want is None or got is None:
        return 0 if got is None and want is None else max(_size(got), _size(want))
    if dataclasses.is_dataclass(want):
        names = [f.name for f in dataclasses.fields(want)]
        if not dataclasses.is_dataclass(got):
            return _size(want)
        return sum(_diff(getattr(got, n, None), getattr(want, n)) for n in names)
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return max(_size(got), _size(want))
        return sum(_diff(g, w) for g, w in zip(got, want))
    if isinstance(want, np.ndarray):
        g = np.asarray(got)
        if g.shape != want.shape:
            return max(_size(g), _size(want))
        return int(np.count_nonzero(g.astype(np.uint64) != want.astype(np.uint64)))
    return 0 if int(got) == int(want) else 1


def compare(got, want) -> Dict[str, int]:
    """{group: differing elements} of proof `got` against reference `want`."""
    out = {g: 0 for g in LIMITS}
    for f in dataclasses.fields(want):
        group = GROUPS.get(f.name, "shape")
        out[group] += _diff(getattr(got, f.name, None), getattr(want, f.name))
    return out


def judged(numbers: Dict[str, int]) -> Dict[str, dict]:
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}


def passes(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())

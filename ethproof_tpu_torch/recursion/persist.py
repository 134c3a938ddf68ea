"""Disk persistence for compiled recursion circuits.

Counterpart: ethproof_tpu/recursion/persist.py:1 (a copy). The salt
digests THIS package's circuit sources, so the port never loads a circuit
that the JAX package wrote (and the reverse).

Reference equivalent: `AllRecursiveCircuits` serialized whole to
`./prover_state_<digest>` (common/src/prover_state/
persistence.rs:40-88). Here circuit PROGRAMS (gate arrays with
declarative hints — recursion/circuit.py circuit_to_arrays) persist to
the prover-state artifact dir next to the vkey caps, keyed by build
parameters + a digest of the circuit-generating SOURCES: a code change
invalidates every cached circuit, and a stale/corrupt file can only
fail vkey verification, never verify unsoundly (same trust domain as
the reference's deserialized circuits). Loaded circuits carry no
witness accessors (vc=None); proving lazily re-runs the builder, so the
fast path covers verifiers and warm-vkey consumers and the prover still
skips nothing it needs.

This module is import-cycle-free: the source-digest walks sibling
modules lazily inside the function body.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np

_SALT: Optional[str] = None


def circuit_salt() -> str:
    global _SALT
    if _SALT is None:
        from . import aggregate as _a
        from . import block as _b
        from . import circuit as _c
        from . import machine as _m
        from . import root as _r
        from . import verifier_circuit as _v

        h = hashlib.sha256()
        for mod in (_c, _m, _v, _r, _a, _b):
            with open(mod.__file__, "rb") as f:
                h.update(f.read())
        _SALT = h.hexdigest()[:16]
    return _SALT


def circ_path(kind: str, key_parts) -> Optional[str]:
    from ..runtime.prover_state import artifact_dir

    d = artifact_dir()
    if d is None:
        return None
    k = hashlib.sha256(
        (repr(key_parts) + circuit_salt()).encode()
    ).hexdigest()[:24]
    return os.path.join(d, f"{kind}_{k}.npz")


def save_circuit(path: Optional[str], circuit, extra: Dict) -> None:
    if path is None:
        return
    from .circuit import circuit_to_arrays

    arrays = circuit_to_arrays(circuit)
    arrays.update({f"x_{k}": np.asarray(v) for k, v in extra.items()})
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_circuit(path: Optional[str]):
    """-> (Circuit, extras dict) or None."""
    if path is None or not os.path.exists(path):
        return None
    from .circuit import circuit_from_arrays

    try:
        with np.load(path) as z:
            d = {k: z[k] for k in z.files}
        extras = {k[2:]: d.pop(k) for k in list(d) if k.startswith("x_")}
        return circuit_from_arrays(d), extras
    except Exception:
        return None  # corrupt cache degrades to rebuild

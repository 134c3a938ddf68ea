"""Per-table circuit size ranges and the prover state.

Counterpart: ethproof_tpu/runtime/prover_state.py:26-134 (`DEFAULT_RANGES`,
`ENV_KEYS`, `CircuitConfig` with `from_env` and `digest`, `ProverState`,
`p_state`, `set_prover_state_from_config`, `reset_prover_state`,
`artifact_dir`). The seven-table degree ranges with their
`*_CIRCUIT_SIZE` environment keys; `tables.all.TableSizes.fit` sizes a
proof within them. With `persistence="disk"` the state's `cache_dir` is
`<base>/prover_state_<digest>` and holds the port's own artifacts: the
vkey caps of `stark.prove.fixed_cap` and the circuits of
`recursion/persist.py`. The counterpart also points JAX's compilation
cache there; the port compiles no XLA program, so it has no such branch.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

from .parsing import parse_range

# the reference's code-default ranges (log2 rows; stop excluded)
DEFAULT_RANGES: Dict[str, range] = {
    "arithmetic": range(16, 23),
    "byte_packing": range(9, 21),
    "cpu": range(12, 25),
    "keccak": range(14, 20),
    "keccak_sponge": range(9, 15),
    "logic": range(12, 18),
    "memory": range(17, 28),
}

ENV_KEYS = {
    "arithmetic": "ARITHMETIC_CIRCUIT_SIZE",
    "byte_packing": "BYTE_PACKING_CIRCUIT_SIZE",
    "cpu": "CPU_CIRCUIT_SIZE",
    "keccak": "KECCAK_CIRCUIT_SIZE",
    "keccak_sponge": "KECCAK_SPONGE_CIRCUIT_SIZE",
    "logic": "LOGIC_CIRCUIT_SIZE",
    "memory": "MEMORY_CIRCUIT_SIZE",
}


@dataclass(frozen=True)
class CircuitConfig:
    ranges: Dict[str, range] = field(default_factory=lambda: dict(DEFAULT_RANGES))

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "CircuitConfig":
        env = dict(os.environ) if env is None else env
        ranges = dict(DEFAULT_RANGES)
        for name, key in ENV_KEYS.items():
            if key in env:
                ranges[name] = parse_range(env[key])
        return cls(ranges)

    def digest(self) -> str:
        """Stable digest over the ranges: the cache key."""
        text = "_".join(
            f"{name}_{r.start}..{r.stop}" for name, r in sorted(self.ranges.items())
        )
        return hashlib.sha256(text.encode()).hexdigest()[:16]


@dataclass
class ProverState:
    config: CircuitConfig
    cache_dir: Optional[str]


_P_STATE: Optional[ProverState] = None


def p_state() -> ProverState:
    """The process's prover state (set once by `set_prover_state_from_config`)."""
    if _P_STATE is None:
        raise RuntimeError("prover state accessed before initialization")
    return _P_STATE


def set_prover_state_from_config(
    config: CircuitConfig, persistence: str = "disk", base_dir: str = "."
) -> ProverState:
    """Initialize once; a later call returns the first state.

    persistence="disk" keeps the artifacts under
    `<base_dir>/prover_state_<digest>`; "none" keeps them in memory."""
    global _P_STATE
    if _P_STATE is not None:
        return _P_STATE
    if persistence not in ("disk", "none"):
        raise ValueError(f"persistence must be 'disk' or 'none', not {persistence!r}")
    cache_dir = None
    if persistence == "disk":
        cache_dir = os.path.join(base_dir, f"prover_state_{config.digest()}")
        os.makedirs(cache_dir, exist_ok=True)
    _P_STATE = ProverState(config=config, cache_dir=cache_dir)
    return _P_STATE


def reset_prover_state() -> None:
    """Testing hook: forget the state, so the next set initializes anew."""
    global _P_STATE
    _P_STATE = None


def artifact_dir() -> Optional[str]:
    """Directory for deterministic prover artifacts (vkey caps, circuit
    programs), the analogue of the reference's serialized circuits in
    `./prover_state_<digest>`. Resolution: the initialized prover state's
    cache dir, else ETHPROOF_ARTIFACT_DIR (created on first use), else
    None (in memory only)."""
    if _P_STATE is not None and _P_STATE.cache_dir:
        return _P_STATE.cache_dir
    d = os.environ.get("ETHPROOF_ARTIFACT_DIR")
    if d:
        os.makedirs(d, exist_ok=True)
        return d
    return None

"""Per-table circuit size ranges: `CircuitConfig`.

Counterpart: ethproof_tpu/runtime/prover_state.py:26-60 (`DEFAULT_RANGES`,
`ENV_KEYS`, `CircuitConfig` with `from_env`), copied. The seven-table
degree ranges with their `*_CIRCUIT_SIZE` environment keys;
`tables.all.TableSizes.fit` sizes a proof within them. The counterpart's
persistence half (the XLA compilation cache under
`./prover_state_<digest>`) has no counterpart here.
"""

from __future__ import annotations

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


def artifact_dir() -> Optional[str]:
    """Directory for deterministic prover artifacts (vkey caps, circuit
    programs), the analogue of the reference's serialized circuits in
    `./prover_state_<digest>`: ETHPROOF_ARTIFACT_DIR (created on first
    use), else None (in-memory only)."""
    d = os.environ.get("ETHPROOF_ARTIFACT_DIR")
    if d:
        os.makedirs(d, exist_ok=True)
        return d
    return None

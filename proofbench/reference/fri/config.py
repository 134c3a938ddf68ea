"""[The benchmark's frozen copy of ethproof_tpu_torch/fri/config.py.]

FRI / STARK configuration.

Counterpart: ethproof_tpu/fri/config.py:1 (a copy; the port imports
nothing of the JAX package).

Mirrors the knobs of plonky2's `FriConfig` + starky's `StarkConfig`. The
upstream prover always selects `standard_fast_config` (rate_bits 2,
cap_height 4, pow_bits 16, 84 query rounds, constant arity 2^4 reductions
with a final polynomial of degree < 2^5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 2
    cap_height: int = 4
    proof_of_work_bits: int = 16
    num_query_rounds: int = 84
    # fold by 2^arity_bits between commitments until the codeword is no
    # larger than 2^(final_poly_bits + rate_bits)
    arity_bits: int = 4
    final_poly_bits: int = 5

    def reduction_arity_bits(self, degree_bits: int) -> List[int]:
        """Per-round arities (ConstantArityBits strategy semantics)."""
        out = []
        rem = degree_bits
        while rem > self.final_poly_bits:
            step = min(self.arity_bits, rem - self.final_poly_bits)
            out.append(step)
            rem -= step
        return out

    @property
    def coset_shift(self) -> int:
        from ..gf import field_host as fh

        return fh.MULT_GROUP_GEN  # g = 7, plonky2's coset shift


@dataclass(frozen=True)
class StarkConfig:
    security_bits: int = 100
    num_challenges: int = 2  # soundness amplification for alpha/CTL
    fri_config: FriConfig = field(default_factory=FriConfig)


def standard_fast_config() -> StarkConfig:
    return StarkConfig()

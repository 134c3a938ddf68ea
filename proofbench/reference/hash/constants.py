"""[The benchmark's frozen copy of ethproof_tpu_torch/hash/constants.py.]

Poseidon parameters for Goldilocks, width 12.

Counterpart: ethproof_tpu/hash/constants.py:1 (a copy; the port imports
nothing of the JAX package).

Dimensions match plonky2's `Poseidon` for `GoldilocksField`: state width t = 12, S-box x^7,
circulant-plus-diagonal MDS matrix, 30 rounds, 30 * 12 = 360 round
constants.

Round constants are generated with the Grain-LFSR procedure from the Poseidon
paper's reference implementation (`generate_parameters_grain.sage`), seeded
with (field=GF(p), sbox=x^alpha, n=64, t=12, R_F=8, R_P=22). The generator is
below (`grain_round_constants`) and runs at import time; the procedure is
deterministic so the constants are stable across runs/hosts.

PLONKY2 PARITY (decided, see BASELINE.md "Proof-validity scope"): this
framework's transcript hash is deliberately NOT bit-exact with plonky2's.
Two divergences, both load-bearing:
  1. These Grain constants differ from plonky2's literal
     `ALL_ROUND_CONSTANTS` table (which cannot be re-derived offline —
     it is a hardcoded artifact of plonky2's repo, not of the Grain
     procedure with documented parameters).
  2. hash/poseidon.py applies the full-width S-box in ALL 30 rounds,
     where plonky2 S-boxes only lane 0 during its 22 partial rounds.
     The all-full-rounds schedule is a TPU/XLA choice (no lane mask in
     the fused scan body of the JAX package) and is strictly
     stronger cryptographically; restoring parity would require BOTH
     the literal constant table AND the 4+22+4 partial schedule.
Proof validity is therefore defined against this framework's own
host-side verifier (stark/verify.py), which shares no device code with
the prover. Every consumer reads only this module, so a future parity
swap remains a one-module change plus the poseidon.py schedule.
"""

from __future__ import annotations

import numpy as np

P = 0xFFFFFFFF00000001  # Goldilocks

WIDTH = 12
HALF_N_FULL_ROUNDS = 4
N_FULL_ROUNDS_TOTAL = 2 * HALF_N_FULL_ROUNDS
N_PARTIAL_ROUNDS = 22
N_ROUNDS = N_FULL_ROUNDS_TOTAL + N_PARTIAL_ROUNDS  # 30
SBOX_EXP = 7

# plonky2's width-12 Goldilocks MDS: first row of the circulant part plus a
# diagonal correction on entry (0,0). MDS[i][j] = CIRC[(j - i) % 12] + (i==j)*DIAG[i].
MDS_MATRIX_CIRC = [17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20]
MDS_MATRIX_DIAG = [8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]


def mds_matrix() -> np.ndarray:
    """Full 12x12 MDS matrix as uint64 (entries are tiny: < 2^6)."""
    m = np.zeros((WIDTH, WIDTH), dtype=np.uint64)
    for i in range(WIDTH):
        for j in range(WIDTH):
            m[i, j] = MDS_MATRIX_CIRC[(j - i) % WIDTH]
        m[i, i] += np.uint64(MDS_MATRIX_DIAG[i])
    return m


def _grain_bits(n_bits: int, t: int, r_f: int, r_p: int):
    """Grain LFSR bit stream from the Poseidon paper's parameter generator."""
    state = []
    for bits, width in (
        (0b01, 2),      # field = GF(p)
        (0b0000, 4),    # sbox = x^alpha
        (n_bits, 12),   # field size
        (t, 12),        # state width
        (r_f, 10),      # full rounds
        (r_p, 10),      # partial rounds
    ):
        state += [(bits >> (width - 1 - i)) & 1 for i in range(width)]
    state += [1] * 30
    assert len(state) == 80

    def step():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):  # discard warm-up
        step()

    def next_bit():
        # self-shrinking: emit the 2nd bit of a pair only when the 1st is 1
        while True:
            if step() == 1:
                return step()

    return next_bit


def grain_round_constants(n_constants: int = N_ROUNDS * WIDTH) -> np.ndarray:
    """n_constants field elements via rejection sampling of 64-bit draws."""
    next_bit = _grain_bits(64, WIDTH, N_FULL_ROUNDS_TOTAL, N_PARTIAL_ROUNDS)
    out = []
    while len(out) < n_constants:
        v = 0
        for _ in range(64):
            v = (v << 1) | next_bit()
        if v < P:
            out.append(v)
    return np.array(out, dtype=np.uint64)


ALL_ROUND_CONSTANTS = grain_round_constants()

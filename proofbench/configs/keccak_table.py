"""[The benchmark's frozen copy of ethproof_tpu_torch/tables/keccak.py: this configuration's plain reference table.]

Keccak table: keccak-f[1600], one round per row.

Counterpart: ethproof_tpu/tables/keccak.py:1 (columns :48-59, `KeccakStark`
:73-222, `generate_trace` :225-290). The columns, fixed columns, CTL specs
and `eval` are copies; `_slice_vec` slices a stacked tensor (or the host
verifier's list) where the counterpart rebuilds a `GF(lo, hi)`.
`generate_trace` is vectorised with numpy and fills the same bits as the
counterpart's per-row loop; the zero-state padding block is computed once
and tiled.

Arithmetization (degree <= 4 — still exact on the rate-4 LDE):

- A bits (1600): round input state. B bits (1600): state after
  theta+rho+pi, committed with linkage B[pi(x,y),rot(z)] = A ^ D (deg 3),
  where D[x][z] = P[x-1][z] ^ P[x+1][z-1] and P/Q (320 each) decompose
  the theta column sums S = P + 2Q (P boolean, Q in {0,1,2}).
- chi is a degree-3 expression over B; the round linkage
  (A_next ^ RC) = chi(B), gated by the FIXED not-last-round flag, is
  degree 4. Round constants are fixed columns (row % 24 patterns).
- OUT bits (1600) materialize the permutation output on last-round rows.
- IN_LIMBS / OUT_LIMBS (100 each: 25 lanes x 4 x 16-bit) are the packed
  CTL surface for the sponge table (degree-1 packing constraints).

Padding soundness: inactive blocks carry REAL zero-state permutation
traces, so every algebraic constraint holds ungated; only the CTL filter
columns (ACTIVE x first/last-round) exclude padding from lookups.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..reference.hash.keccak import ROTATIONS, ROUND_CONSTANTS, keccak_f_trace
from ..reference.stark.stark import CtlSpec, Stark
from ..reference.common import Cols

NUM_ROUNDS = 24


def _bit_index(x: int, y: int, z: int) -> int:
    return (x * 5 + y) * 64 + z


def _pq_index(x: int, z: int) -> int:
    return x * 64 + z


_c = Cols()
ACTIVE = _c.one()
FIRST_FILTER = _c.one()  # ACTIVE * (row%24 == 0)
LAST_FILTER = _c.one()  # ACTIVE * (row%24 == 23)
PERM_ID = _c.one()  # block counter — joins input/output CTLs per permutation
A_BITS = _c.many(1600)
B_BITS = _c.many(1600)
P_COLS = _c.many(320)
Q_COLS = _c.many(320)
OUT_BITS = _c.many(1600)
IN_LIMBS = _c.many(100)
OUT_LIMBS = _c.many(100)
NUM_COLUMNS = _c.count

_ALL_XYZ = [(x, y, z) for x in range(5) for y in range(5) for z in range(64)]


def _slice_vec(vec, start: int, stop: int):
    """Rows start..stop of a stacked vector (a (k, m) tensor on the prover,
    a list of ext pairs on the host verifier)."""
    return vec[start:stop]


class KeccakStark(Stark):
    num_columns = NUM_COLUMNS
    num_public_inputs = 0
    constraint_degree = 4
    lookups = []

    # fixed columns
    F_IS_FIRST = 0
    F_IS_LAST = 1
    F_NOT_LAST = 2
    F_RC = list(range(3, 3 + 64))
    num_fixed_columns = 3 + 64

    def fixed_columns(self, n: int) -> np.ndarray:
        rnd = np.arange(n) % NUM_ROUNDS
        fx = np.zeros((self.num_fixed_columns, n), dtype=np.uint64)
        fx[self.F_IS_FIRST] = rnd == 0
        fx[self.F_IS_LAST] = rnd == NUM_ROUNDS - 1
        fx[self.F_NOT_LAST] = rnd != NUM_ROUNDS - 1
        rc = ROUND_CONSTANTS[rnd]
        z = np.arange(64, dtype=np.uint64)[:, None]
        fx[self.F_RC] = (rc[None, :] >> z) & np.uint64(1)
        return fx

    def input_ctl_spec(self) -> CtlSpec:
        return CtlSpec(columns=tuple([PERM_ID] + IN_LIMBS), filter_col=FIRST_FILTER)

    def output_ctl_spec(self) -> CtlSpec:
        return CtlSpec(columns=tuple([PERM_ID] + OUT_LIMBS), filter_col=LAST_FILTER)

    def eval(self, ctx):
        c, o = ctx.consumer, ctx.ops
        one = o.one()
        two = o.constant(2)

        def xor(u, v):
            return o.sub(o.add(u, v), o.mul(two, o.mul(u, v)))

        act = ctx.local(ACTIVE)
        c.constraint(o.mul(act, o.sub(act, one)))
        # ACTIVE constant within a block; may only fall at block boundaries
        c.constraint_transition(
            o.mul(ctx.fixed(self.F_NOT_LAST), o.sub(ctx.next(ACTIVE), act))
        )
        c.constraint_transition(
            o.mul(
                ctx.fixed(self.F_IS_LAST),
                o.mul(ctx.next(ACTIVE), o.sub(one, act)),
            )
        )
        # filter linkage
        c.constraint(
            o.sub(ctx.local(FIRST_FILTER), o.mul(act, ctx.fixed(self.F_IS_FIRST)))
        )
        c.constraint(
            o.sub(ctx.local(LAST_FILTER), o.mul(act, ctx.fixed(self.F_IS_LAST)))
        )
        # PERM_ID: 0 on the first row, constant within a block, +1 across
        # block boundaries — a stable join key for the sponge's in/out CTLs
        c.constraint_first_row(ctx.local(PERM_ID))
        d_id = o.sub(ctx.next(PERM_ID), ctx.local(PERM_ID))
        c.constraint_transition(o.mul(ctx.fixed(self.F_NOT_LAST), d_id))
        c.constraint_transition(
            o.mul(ctx.fixed(self.F_IS_LAST), o.sub(d_id, one))
        )

        a = ctx.local_stack(A_BITS)
        b = ctx.local_stack(B_BITS)
        p = ctx.local_stack(P_COLS)
        q = ctx.local_stack(Q_COLS)
        out_bits = ctx.local_stack(OUT_BITS)

        for bits in (a, b, out_bits, p):
            c.constraint_vec(o.mul(bits, o.sub(bits, one)))
        c.constraint_vec(o.mul(q, o.mul(o.sub(q, one), o.sub(q, two))))

        # theta sums: sum_y A[x][y][z] = P + 2Q
        sums = None
        for y in range(5):
            part = ctx.local_stack(
                [A_BITS[_bit_index(x, y, z)] for x in range(5) for z in range(64)]
            )
            sums = part if sums is None else o.add(sums, part)
        c.constraint_vec(o.sub(sums, o.add(p, o.mul(two, q))))

        # B linkage (rho+pi applied to A ^ D)
        p1 = ctx.local_stack(
            [P_COLS[_pq_index((x - 1) % 5, z)] for (x, y, z) in _ALL_XYZ]
        )
        p2 = ctx.local_stack(
            [P_COLS[_pq_index((x + 1) % 5, (z - 1) % 64)] for (x, y, z) in _ALL_XYZ]
        )
        after_theta = xor(a, xor(p1, p2))  # degree 3
        b_perm = ctx.local_stack(
            [
                B_BITS[
                    _bit_index(y, (2 * x + 3 * y) % 5, (z + ROTATIONS[x][y]) % 64)
                ]
                for (x, y, z) in _ALL_XYZ
            ]
        )
        c.constraint_vec(o.sub(b_perm, after_theta))

        # chi (degree 3 over committed B)
        b1 = ctx.local_stack(
            [B_BITS[_bit_index((x + 1) % 5, y, z)] for (x, y, z) in _ALL_XYZ]
        )
        b2 = ctx.local_stack(
            [B_BITS[_bit_index((x + 2) % 5, y, z)] for (x, y, z) in _ALL_XYZ]
        )
        chi = xor(b, o.mul(o.sub(one, b1), b2))

        # lane (0, 0) is bits 0..63; the rest 64..1599
        chi00 = _slice_vec(chi, 0, 64)
        chi_rest = _slice_vec(chi, 64, 1600)
        rc_bits = ctx.fixed_stack(self.F_RC)

        # round linkage (iota folded into the A_next side, degree <= 4)
        gate = ctx.fixed(self.F_NOT_LAST)
        a_next00 = ctx.next_stack(A_BITS[:64])
        a_next_rest = ctx.next_stack(A_BITS[64:])
        c.constraint_vec_transition(o.mul(gate, o.sub(xor(a_next00, rc_bits), chi00)))
        c.constraint_vec_transition(o.mul(gate, o.sub(a_next_rest, chi_rest)))

        # output materialization on last-round rows
        last = ctx.fixed(self.F_IS_LAST)
        out00 = _slice_vec(out_bits, 0, 64)
        out_rest = _slice_vec(out_bits, 64, 1600)
        c.constraint_vec(o.mul(last, o.sub(xor(out00, rc_bits), chi00)))
        c.constraint_vec(o.mul(last, o.sub(out_rest, chi_rest)))

        # packed limb interfaces — lane order x + 5y (keccak absorption
        # order, shared with the sponge table's CTL tuples)
        w16 = [1 << i for i in range(16)]
        lane_order_bits = [
            _bit_index(idx % 5, idx // 5, z) for idx in range(25) for z in range(64)
        ]
        a_lane = ctx.local_stack([A_BITS[i] for i in lane_order_bits])
        out_lane = ctx.local_stack([OUT_BITS[i] for i in lane_order_bits])
        c.constraint_vec(
            o.sub(ctx.local_stack(IN_LIMBS), o.pack_weighted(a_lane, w16, 16))
        )
        c.constraint_vec(
            o.sub(ctx.local_stack(OUT_LIMBS), o.pack_weighted(out_lane, w16, 16))
        )


# -- trace generation ------------------------------------------------------------

_XYZ = np.asarray(_ALL_XYZ)
_X, _Y, _Z = _XYZ[:, 0], _XYZ[:, 1], _XYZ[:, 2]
# B[pi(x, y), rot(z)] = A[x, y, z] ^ P[x-1, z] ^ P[x+1, z-1], in _ALL_XYZ order
_B_TARGET = (_Y * 5 + (2 * _X + 3 * _Y) % 5) * 64 + (_Z + np.asarray(ROTATIONS)[_X, _Y]) % 64
_D_P1 = ((_X - 1) % 5) * 64 + _Z
_D_P2 = ((_X + 1) % 5) * 64 + (_Z - 1) % 64
_Z64 = np.arange(64, dtype=np.uint64)
_L16 = np.arange(0, 64, 16, dtype=np.uint64)


def _bits(states: np.ndarray) -> np.ndarray:
    """(r, 5, 5) lanes -> (r, 1600) bits in A_BITS order (x, y, z)."""
    return ((states[..., None] >> _Z64) & np.uint64(1)).reshape(len(states), 1600)


def _limbs(states: np.ndarray) -> np.ndarray:
    """(r, 5, 5) lanes -> (r, 100) 16-bit limbs, lane order x + 5y."""
    lanes = states.transpose(0, 2, 1).reshape(len(states), 25)
    return ((lanes[..., None] >> _L16) & np.uint64(0xFFFF)).reshape(len(states), 100)


def _block(state: np.ndarray, active: bool) -> np.ndarray:
    """(NUM_COLUMNS, 24) rows of one permutation block; PERM_ID left 0."""
    states = np.stack(keccak_f_trace(state))  # (25, 5, 5)
    cur = states[:NUM_ROUNDS]
    blk = np.zeros((NUM_ROUNDS, NUM_COLUMNS), dtype=np.uint64)
    a = _bits(cur)
    sums = a.reshape(NUM_ROUNDS, 5, 5, 64).sum(axis=2, dtype=np.uint64).reshape(NUM_ROUNDS, 320)
    p = sums & np.uint64(1)
    blk[:, A_BITS] = a
    blk[:, P_COLS] = p
    blk[:, Q_COLS] = sums >> np.uint64(1)
    b = np.empty_like(a)
    b[:, _B_TARGET] = a ^ p[:, _D_P1] ^ p[:, _D_P2]
    blk[:, B_BITS] = b
    blk[:, IN_LIMBS] = _limbs(cur)
    blk[-1, OUT_BITS] = _bits(states[-1:])[0]
    blk[-1, OUT_LIMBS] = _limbs(states[-1:])[0]
    if active:
        blk[:, ACTIVE] = 1
        blk[0, FIRST_FILTER] = 1
        blk[-1, LAST_FILTER] = 1
    return blk.T


def generate_trace(perm_inputs: List[np.ndarray], n_rows: int) -> np.ndarray:
    """perm_inputs: list of (5,5) uint64 input states; 24 rows each.

    Padding blocks are real zero-state permutations (ACTIVE=0), so every
    constraint holds on them without gating; the last block may be cut."""
    assert NUM_ROUNDS * len(perm_inputs) <= n_rows
    tr = np.zeros((NUM_COLUMNS, n_rows), dtype=np.uint64)
    base = 0
    for state in perm_inputs:
        tr[:, base : base + NUM_ROUNDS] = _block(np.asarray(state, dtype=np.uint64), True)
        base += NUM_ROUNDS
    if base < n_rows:
        pad = _block(np.zeros((5, 5), dtype=np.uint64), False)
        reps = -(-(n_rows - base) // NUM_ROUNDS)
        tr[:, base:] = np.tile(pad, reps)[:, : n_rows - base]
    tr[PERM_ID] = np.arange(n_rows, dtype=np.uint64) // np.uint64(NUM_ROUNDS)
    return tr

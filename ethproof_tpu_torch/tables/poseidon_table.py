"""Poseidon table: the framework's own hash, arithmetized.

Counterpart: ethproof_tpu/tables/poseidon_table.py:1 (a copy: columns,
`PoseidonStark` with its fixed columns, CTL specs and `eval`, and
`generate_trace`); `_slice1` indexes a stacked tensor (or the host
verifier's list) where the counterpart rebuilds a `GF(lo, hi)`. The
verifier machine (recursion/machine.py) reuses this arithmetization for
its Poseidon blocks.

Reference equivalent: plonky2's Poseidon GATE — the reference proves its
transcript hash inside recursion circuits (AllRecursiveCircuits' shrink/
root/agg ladder [dep: from knowledge; pin Cargo.lock:3441]).
This table is the STARK-flavored version of that primitive and the first
brick of succinct recursive aggregation (SURVEY.md §7 hard part #1): an
in-proof Merkle-path / challenger check is a chain of these permutations.

One row per round (30 rows per permutation; ALL rounds full — see
hash/poseidon.py):

  s' = STATE + RC(row%30)                (RC are fixed columns)
  X3 = s'^3                              (committed; degree-3 constraint)
  sbox(s') = X3^2 * s'                   (degree 3 in committed values)
  STATE_next = MDS @ sbox(s')            (gated NOT_LAST, degree 4)
  OUT = MDS @ sbox(s')                   (gated IS_LAST, degree 4)

CTL surface: (PERM_ID, STATE) on first-round rows and (PERM_ID, OUT) on
last-round rows — the join pattern shared with the Keccak table.
Padding blocks carry real zero-state permutations, so constraints hold
ungated; ACTIVE only drives the CTL filters.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..hash import constants as C
from ..hash import poseidon as ps
from ..stark.stark import CtlSpec, Stark
from .common import Cols

WIDTH = C.WIDTH
N_ROUNDS = C.N_ROUNDS
_MDS = C.mds_matrix()

_c = Cols()
ACTIVE = _c.one()
FIRST_FILTER = _c.one()
LAST_FILTER = _c.one()
PERM_ID = _c.one()
STATE = _c.many(WIDTH)
X3 = _c.many(WIDTH)
OUT = _c.many(WIDTH)
NUM_COLUMNS = _c.count


class PoseidonStark(Stark):
    num_columns = NUM_COLUMNS
    num_public_inputs = 0
    constraint_degree = 4
    lookups = []

    # fixed columns
    F_IS_FIRST = 0
    F_IS_LAST = 1
    F_NOT_LAST = 2
    F_RC = list(range(3, 3 + WIDTH))
    num_fixed_columns = 3 + WIDTH

    def fixed_columns(self, n: int) -> np.ndarray:
        fx = np.zeros((self.num_fixed_columns, n), dtype=np.uint64)
        rc = C.ALL_ROUND_CONSTANTS.reshape(N_ROUNDS, WIDTH)
        for r in range(n):
            rnd = r % N_ROUNDS
            fx[self.F_IS_FIRST, r] = 1 if rnd == 0 else 0
            fx[self.F_IS_LAST, r] = 1 if rnd == N_ROUNDS - 1 else 0
            fx[self.F_NOT_LAST, r] = 0 if rnd == N_ROUNDS - 1 else 1
            for i in range(WIDTH):
                fx[self.F_RC[i], r] = rc[rnd, i]
        return fx

    def input_ctl_spec(self) -> CtlSpec:
        return CtlSpec(columns=tuple([PERM_ID] + STATE), filter_col=FIRST_FILTER)

    def output_ctl_spec(self) -> CtlSpec:
        return CtlSpec(columns=tuple([PERM_ID] + OUT), filter_col=LAST_FILTER)

    def eval(self, ctx):
        c, o = ctx.consumer, ctx.ops
        one = o.one()
        act = ctx.local(ACTIVE)
        c.constraint(o.mul(act, o.sub(act, one)))
        c.constraint_transition(
            o.mul(ctx.fixed(self.F_NOT_LAST), o.sub(ctx.next(ACTIVE), act))
        )
        c.constraint_transition(
            o.mul(
                ctx.fixed(self.F_IS_LAST),
                o.mul(ctx.next(ACTIVE), o.sub(one, act)),
            )
        )
        c.constraint(
            o.sub(ctx.local(FIRST_FILTER), o.mul(act, ctx.fixed(self.F_IS_FIRST)))
        )
        c.constraint(
            o.sub(ctx.local(LAST_FILTER), o.mul(act, ctx.fixed(self.F_IS_LAST)))
        )
        # PERM_ID: 0 first, constant within a block, +1 across boundaries
        c.constraint_first_row(ctx.local(PERM_ID))
        d_id = o.sub(ctx.next(PERM_ID), ctx.local(PERM_ID))
        c.constraint_transition(o.mul(ctx.fixed(self.F_NOT_LAST), d_id))
        c.constraint_transition(o.mul(ctx.fixed(self.F_IS_LAST), o.sub(d_id, one)))

        state = ctx.local_stack(STATE)
        rc = ctx.fixed_stack(self.F_RC)
        sp = o.add(state, rc)
        x3 = ctx.local_stack(X3)
        c.constraint_vec(o.sub(x3, o.mul(sp, o.mul(sp, sp))))
        sbox = o.mul(o.mul(x3, x3), sp)  # degree 3 in committed values

        # MDS rows as weighted folds over the stacked sbox values
        def mds_apply(vec):
            rows = []
            for i in range(WIDTH):
                acc = None
                for j in range(WIDTH):
                    term = o.mul(o.constant(int(_MDS[i, j])), _slice1(o, vec, j))
                    acc = term if acc is None else o.add(acc, term)
                rows.append(acc)
            return o.stack(rows)

        mds_out = mds_apply(sbox)
        gate = ctx.fixed(self.F_NOT_LAST)
        c.constraint_vec_transition(
            o.mul(gate, o.sub(ctx.next_stack(STATE), mds_out))
        )
        last = ctx.fixed(self.F_IS_LAST)
        c.constraint_vec(o.mul(last, o.sub(ctx.local_stack(OUT), mds_out)))


def _slice1(ops, vec, i):
    """Row i of a stacked vector (a (k, m) tensor on the prover, a list of
    ext pairs or registers elsewhere)."""
    return vec[i]


def generate_trace(perm_inputs: List[List[int]], n_rows: int) -> np.ndarray:
    """perm_inputs: list of 12-int input states; 30 rows per permutation.

    Padding blocks are real zero-state permutations (ACTIVE=0).
    """
    assert N_ROUNDS * len(perm_inputs) <= n_rows
    tr = np.zeros((NUM_COLUMNS, n_rows), dtype=np.uint64)
    P = C.P
    rc = C.ALL_ROUND_CONSTANTS.reshape(N_ROUNDS, WIDTH)

    def fill_block(base: int, state: List[int], active: bool) -> None:
        perm_id = base // N_ROUNDS
        s = [x % P for x in state]
        out = ps.permute_host(s)
        for rnd in range(min(N_ROUNDS, n_rows - base)):
            r = base + rnd
            tr[PERM_ID, r] = perm_id
            if active:
                tr[ACTIVE, r] = 1
                if rnd == 0:
                    tr[FIRST_FILTER, r] = 1
                if rnd == N_ROUNDS - 1:
                    tr[LAST_FILTER, r] = 1
            sp = [(x + int(rc[rnd, i])) % P for i, x in enumerate(s)]
            x3 = [pow(x, 3, P) for x in sp]
            for i in range(WIDTH):
                tr[STATE[i], r] = s[i]
                tr[X3[i], r] = x3[i]
            sboxed = [x3[i] * x3[i] % P * sp[i] % P for i in range(WIDTH)]
            s = [
                sum(int(_MDS[i, j]) * sboxed[j] for j in range(WIDTH)) % P
                for i in range(WIDTH)
            ]
            if rnd == N_ROUNDS - 1:
                for i in range(WIDTH):
                    tr[OUT[i], r] = out[i]

    base = 0
    for state in perm_inputs:
        fill_block(base, state, True)
        base += N_ROUNDS
    while base < n_rows:
        fill_block(base, [0] * WIDTH, False)
        base += N_ROUNDS
    return tr

"""Logic table: 256-bit AND / OR / XOR via bit decomposition.

Counterpart: ethproof_tpu/tables/logic.py:1 (a copy).

Reference equivalent: evm_arithmetization's Logic STARK (bitwise ops on
bit-decomposed operands, packed results) [dep: from knowledge; pin
Cargo.lock:1675; table named at
common/src/prover_state/circuit.rs:64].

Design: operands live as 256 boolean columns each; outputs as 16-bit
limbs. No lookups needed — booleanity + the algebraic identities
  AND = a*b,   OR = a + b - a*b,   XOR = a + b - 2ab
keep every constraint within degree 3 (selector * degree-2 combine).
Limb columns (IN0/IN1/OUT) are linear sums of bits, so they are
implicitly < 2^16 — the CTL to the CPU table exchanges limbs, keeping
the CPU's word representation uniform with the arithmetic table.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..stark.stark import CtlSpec, Stark
from .common import Cols, N_LIMBS, int_to_limbs

OP_AND, OP_OR, OP_XOR = 5, 6, 7

_c = Cols()
IS_AND = _c.one()
IS_OR = _c.one()
IS_XOR = _c.one()
OP_ID = _c.one()
FILTER = _c.one()
IN0_BITS = _c.many(256)
IN1_BITS = _c.many(256)
IN0 = _c.many(N_LIMBS)
IN1 = _c.many(N_LIMBS)
OUT = _c.many(N_LIMBS)
NUM_COLUMNS = _c.count


class LogicStark(Stark):
    num_columns = NUM_COLUMNS
    num_public_inputs = 0
    constraint_degree = 3
    lookups = []

    ctl_spec = CtlSpec(columns=tuple([OP_ID] + IN0 + IN1 + OUT), filter_col=FILTER)

    def eval(self, ctx):
        c, o = ctx.consumer, ctx.ops
        one = o.one()
        sels = [ctx.local(i) for i in (IS_AND, IS_OR, IS_XOR)]
        sel_vec = ctx.local_stack([IS_AND, IS_OR, IS_XOR, FILTER])
        c.constraint_vec(o.mul(sel_vec, o.sub(sel_vec, one)))
        filt = ctx.local(FILTER)
        c.constraint(o.sub(filt, o.add(o.add(sels[0], sels[1]), sels[2])))
        op = o.mul(o.constant(OP_AND), sels[0])
        for w, s in zip((OP_OR, OP_XOR), sels[1:]):
            op = o.add(op, o.mul(o.constant(w), s))
        c.constraint(o.sub(ctx.local(OP_ID), op))

        is_and, is_or, is_xor = sels
        a_bits = ctx.local_stack(IN0_BITS)  # (256, m)
        b_bits = ctx.local_stack(IN1_BITS)
        for bits in (a_bits, b_bits):
            c.constraint_vec(o.mul(bits, o.sub(bits, one)))

        # limb linkage: limbs are the packed bits
        w16 = [1 << b for b in range(16)]
        c.constraint_vec(
            o.sub(ctx.local_stack(IN0), o.pack_weighted(a_bits, w16, 16))
        )
        c.constraint_vec(
            o.sub(ctx.local_stack(IN1), o.pack_weighted(b_bits, w16, 16))
        )

        # out limbs: packed selector-weighted combine of all 256 bit pairs
        ab = o.mul(a_bits, b_bits)
        a_plus_b = o.add(a_bits, b_bits)
        or_bits = o.sub(a_plus_b, ab)
        xor_bits = o.sub(a_plus_b, o.add(ab, ab))
        comb = o.add(
            o.mul(is_and, ab),
            o.add(o.mul(is_or, or_bits), o.mul(is_xor, xor_bits)),
        )
        c.constraint_vec(
            o.sub(ctx.local_stack(OUT), o.pack_weighted(comb, w16, 16))
        )


def generate_trace(
    requests: List[Tuple[int, int, int]], n_rows: int
) -> Tuple[np.ndarray, List[int]]:
    """requests: [(op, a, b)] -> (trace, results)."""
    assert len(requests) <= n_rows
    tr = np.zeros((NUM_COLUMNS, n_rows), dtype=np.uint64)
    results: List[int] = []
    for r, (op, a, b) in enumerate(requests):
        tr[OP_ID, r] = op
        tr[FILTER, r] = 1
        if op == OP_AND:
            tr[IS_AND, r] = 1
            res = a & b
        elif op == OP_OR:
            tr[IS_OR, r] = 1
            res = a | b
        elif op == OP_XOR:
            tr[IS_XOR, r] = 1
            res = a ^ b
        else:
            raise ValueError(f"unknown logic op {op}")
        for i in range(256):
            tr[IN0_BITS[i], r] = (a >> i) & 1
            tr[IN1_BITS[i], r] = (b >> i) & 1
        for j, l in enumerate(int_to_limbs(a)):
            tr[IN0[j], r] = l
        for j, l in enumerate(int_to_limbs(b)):
            tr[IN1[j], r] = l
        for j, l in enumerate(int_to_limbs(res)):
            tr[OUT[j], r] = l
        results.append(res)
    return tr, results

"""Memory table: ordered access log with read-consistency.

Counterpart: ethproof_tpu/tables/memory.py:1 (a copy: `MemoryStark`,
`MemoryOp`, `generate_trace`).

Reference equivalent: evm_arithmetization's Memory STARK (rows sorted by
(context, segment, virtual, timestamp) with range-checked diffs, linked
to the CPU's accesses by CTL).

Sorted-order argument: per transition, exactly one of four one-hot
selectors (ctx/seg/virt changed, or same address) fires; the appropriate
difference (minus one for address components, exact for timestamps) is
exposed in RC and range-checked against the counter column — monotone
keys. Consistency:
  same addr & next is read  -> value unchanged
  new  addr & first is read -> value is zero
The CPU table emits accesses in execution order; CTL multiset equality
against this sorted table is the memory argument.

Capacity contract: all addresses/timestamps and their diffs must be < n
(single-limb range checks) — production memory degree 2^17..2^30 per the
upstream prover's MEMORY_CIRCUIT_SIZE envelope.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..stark.stark import CtlSpec, LookupSpec, Stark
from .common import Cols, N_LIMBS, int_to_limbs

_c = Cols()
FILTER = _c.one()
CTX = _c.one()
SEG = _c.one()
VIRT = _c.one()
TS = _c.one()
IS_READ = _c.one()
VALUE = _c.many(N_LIMBS)
S_CTX = _c.one()  # transition selectors (about local -> next)
S_SEG = _c.one()
S_VIRT = _c.one()
S_TS = _c.one()
RC = _c.one()  # range-checked transition diff
RC_MULT = _c.one()
NUM_COLUMNS = _c.count

F_COUNTER = NUM_COLUMNS  # fixed range column 0..n-1 (diff bound is n)


class MemoryStark(Stark):
    num_columns = NUM_COLUMNS
    num_public_inputs = 0
    constraint_degree = 3
    num_fixed_columns = 1
    lookups = [
        LookupSpec(looking_cols=(RC,), table_col=F_COUNTER, multiplicity_col=RC_MULT)
    ]

    def fixed_columns(self, n: int) -> np.ndarray:
        return np.arange(n, dtype=np.uint64)[None, :]

    ctl_spec = CtlSpec(
        columns=tuple([CTX, SEG, VIRT, TS, IS_READ] + VALUE), filter_col=FILTER
    )

    def eval(self, ctx):
        c, o = ctx.consumer, ctx.ops
        one = o.one()
        for i in (FILTER, IS_READ, S_CTX, S_SEG, S_VIRT, S_TS):
            b = ctx.local(i)
            c.constraint(o.mul(b, o.sub(b, one)))
        sels = [ctx.local(i) for i in (S_CTX, S_SEG, S_VIRT, S_TS)]
        ssum = sels[0]
        for s in sels[1:]:
            ssum = o.add(ssum, s)
        # exactly one selector per transition (last row exempt)
        c.constraint_transition(o.sub(ssum, one))

        d_ctx = o.sub(ctx.next(CTX), ctx.local(CTX))
        d_seg = o.sub(ctx.next(SEG), ctx.local(SEG))
        d_virt = o.sub(ctx.next(VIRT), ctx.local(VIRT))
        d_ts = o.sub(ctx.next(TS), ctx.local(TS))
        s_ctx, s_seg, s_virt, s_ts = sels
        # lower-priority components must be equal when a higher one claims
        c.constraint_transition(o.mul(s_seg, d_ctx))
        c.constraint_transition(o.mul(s_virt, d_ctx))
        c.constraint_transition(o.mul(s_virt, d_seg))
        c.constraint_transition(o.mul(s_ts, d_ctx))
        c.constraint_transition(o.mul(s_ts, d_seg))
        c.constraint_transition(o.mul(s_ts, d_virt))
        # RC holds the strictly-positive (minus one) / non-negative diff
        rc_expect = o.add(
            o.add(
                o.mul(s_ctx, o.sub(d_ctx, one)),
                o.mul(s_seg, o.sub(d_seg, one)),
            ),
            o.add(o.mul(s_virt, o.sub(d_virt, one)), o.mul(s_ts, d_ts)),
        )
        c.constraint_transition(o.sub(ctx.local(RC), rc_expect))

        # consistency
        nxt_read = ctx.next(IS_READ)
        for i in range(N_LIMBS):
            dv = o.sub(ctx.next(VALUE[i]), ctx.local(VALUE[i]))
            c.constraint_transition(o.mul(s_ts, o.mul(nxt_read, dv)))
            new_addr = o.sub(one, s_ts)
            c.constraint_transition(
                o.mul(new_addr, o.mul(nxt_read, ctx.next(VALUE[i])))
            )
            c.constraint_first_row(o.mul(ctx.local(IS_READ), ctx.local(VALUE[i])))



class MemoryOp:
    __slots__ = ("ctx", "seg", "virt", "ts", "is_read", "value")

    def __init__(self, ctx, seg, virt, ts, is_read, value):
        self.ctx, self.seg, self.virt = ctx, seg, virt
        self.ts, self.is_read, self.value = ts, is_read, value

    @property
    def key(self):
        return (self.ctx, self.seg, self.virt, self.ts)


def generate_trace(ops: List[MemoryOp], n_rows: int) -> np.ndarray:
    """Sorted memory trace. Padding extends the last row's address with
    incrementing timestamps and repeated reads (vacuously consistent)."""
    assert ops, "memory trace needs at least one op"
    ops = sorted(ops, key=lambda op: op.key)
    rows = list(ops)
    last = rows[-1]
    for k in range(n_rows - len(ops)):
        rows.append(
            MemoryOp(last.ctx, last.seg, last.virt, last.ts + k + 1, 1, last.value)
        )
    assert len(rows) == n_rows
    tr = np.zeros((NUM_COLUMNS, n_rows), dtype=np.uint64)
    mult = np.zeros(n_rows, dtype=np.uint64)
    for r, op in enumerate(rows):
        tr[CTX, r], tr[SEG, r], tr[VIRT, r], tr[TS, r] = op.ctx, op.seg, op.virt, op.ts
        tr[IS_READ, r] = op.is_read
        for i, l in enumerate(int_to_limbs(op.value)):
            tr[VALUE[i], r] = l
        if r + 1 < n_rows:
            nxt = rows[r + 1]
            if nxt.ctx != op.ctx:
                tr[S_CTX, r], rc = 1, nxt.ctx - op.ctx - 1
            elif nxt.seg != op.seg:
                tr[S_SEG, r], rc = 1, nxt.seg - op.seg - 1
            elif nxt.virt != op.virt:
                tr[S_VIRT, r], rc = 1, nxt.virt - op.virt - 1
            else:
                tr[S_TS, r], rc = 1, nxt.ts - op.ts
                assert rc >= 0, "duplicate key ordering"
            assert 0 <= rc < n_rows, f"diff {rc} exceeds range table"
            tr[RC, r] = rc
            mult[rc] += 1
        # mark real rows
        tr[FILTER, r] = 1 if r < len(ops) else 0
    # last row's RC is unconstrained but still looked up; count it
    mult[0] += 1
    tr[RC_MULT] = mult
    return tr

"""BytePacking table: memory bytes <-> 256-bit words.

Counterpart: ethproof_tpu/tables/bytepacking.py:1 (a copy).

Reference equivalent: evm_arithmetization's BytePacking STARK ((un)packing
up to 32 memory bytes into a word for the CPU, one CTL per byte position
into the Memory table) [dep: from knowledge; pin
Cargo.lock:1675; table named at
common/src/prover_state/circuit.rs:62].

A row (un)packs `len` (1..=32) bytes at base address (ctx, seg, virt)
and timestamp ts. One-hot length flags L_k (len == k+1) define prefix
indicators ACTIVE_i = sum_{k >= i} L_k; inactive bytes are pinned to 0.
Bytes are range-checked via logUp against a FIXED counter column
min(row, 255) — part of the circuit definition, clamped so the check is
a sound 8-bit bound at any n >= 256 (production degree >= 9 matches the
reference's BYTE_PACKING minimum, circuit.rs:77-87). Byte i's memory
access is a CTL into Memory at virtual address `virt + i` (an LC
virtual column).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..stark.stark import CtlSpec, LC, LookupSpec, Stark
from .common import Cols, N_LIMBS
from .memory import MemoryOp

OP_BYTEPACK = 8

_c = Cols()
FILTER = _c.one()
IS_READ = _c.one()
CTX = _c.one()
SEG = _c.one()
VIRT = _c.one()
TS = _c.one()
LEN_FLAGS = _c.many(32)  # one-hot: len == k+1
ACTIVE = _c.many(32)  # prefix: i < len
BYTES = _c.many(32)
LIMBS = _c.many(N_LIMBS)
RC_MULT = _c.one()
NUM_COLUMNS = _c.count

F_COUNTER = NUM_COLUMNS  # fixed byte-range column min(row, 255)

# virtual column: len = sum (k+1) * L_k
LEN_LC = LC(terms=tuple((LEN_FLAGS[k], k + 1) for k in range(32)), const=0)


def memory_ctl_specs() -> List[CtlSpec]:
    """32 looking specs into the Memory table, one per byte offset."""
    out = []
    for i in range(32):
        cols: List = [
            CTX,
            SEG,
            LC(terms=((VIRT, 1),), const=i),
            TS,
            IS_READ,
            BYTES[i],
        ]
        cols += [LC(terms=(), const=0)] * (N_LIMBS - 1)
        out.append(CtlSpec(columns=tuple(cols), filter_col=ACTIVE[i]))
    return out


class BytePackingStark(Stark):
    num_columns = NUM_COLUMNS
    num_public_inputs = 0
    constraint_degree = 3
    num_fixed_columns = 1
    lookups = [
        LookupSpec(
            looking_cols=tuple(BYTES), table_col=F_COUNTER, multiplicity_col=RC_MULT
        )
    ]

    def fixed_columns(self, n: int) -> np.ndarray:
        counter = np.minimum(np.arange(n, dtype=np.uint64), np.uint64(255))
        return counter[None, :]

    # CPU-facing tuple: (op, ctx, seg, virt, ts, len, limbs...)
    ctl_spec = CtlSpec(
        columns=tuple(
            [LC(terms=(), const=OP_BYTEPACK), CTX, SEG, VIRT, TS, LEN_LC] + LIMBS
        ),
        filter_col=FILTER,
    )

    def eval(self, ctx):
        c, o = ctx.consumer, ctx.ops
        one = o.one()
        for i in (FILTER, IS_READ):
            b = ctx.local(i)
            c.constraint(o.mul(b, o.sub(b, one)))
        flags = [ctx.local(i) for i in LEN_FLAGS]
        for f in flags:
            c.constraint(o.mul(f, o.sub(f, one)))
        total = flags[0]
        for f in flags[1:]:
            total = o.add(total, f)
        c.constraint(o.sub(total, ctx.local(FILTER)))  # one-hot iff active row
        # prefix indicators
        suffix = o.zero()
        for i in reversed(range(32)):
            suffix = o.add(suffix, flags[i])
            c.constraint(o.sub(ctx.local(ACTIVE[i]), suffix))
        # inactive bytes are zero
        for i in range(32):
            c.constraint(
                o.mul(ctx.local(BYTES[i]), o.sub(one, ctx.local(ACTIVE[i])))
            )
        # limb packing
        for j in range(N_LIMBS):
            expect = o.add(
                ctx.local(BYTES[2 * j]),
                o.mul(o.constant(256), ctx.local(BYTES[2 * j + 1])),
            )
            c.constraint(o.sub(ctx.local(LIMBS[j]), expect))


class PackRequest:
    __slots__ = ("is_read", "ctx", "seg", "virt", "ts", "data")

    def __init__(self, is_read, ctx, seg, virt, ts, data: bytes):
        assert 1 <= len(data) <= 32
        self.is_read, self.ctx, self.seg, self.virt, self.ts = (
            is_read,
            ctx,
            seg,
            virt,
            ts,
        )
        self.data = data

    @property
    def value(self) -> int:
        return int.from_bytes(self.data, "little")


def generate_trace(
    requests: List[PackRequest], n_rows: int
) -> Tuple[np.ndarray, List[MemoryOp]]:
    """-> (trace, implied memory ops for the Memory table)."""
    assert len(requests) <= n_rows
    assert n_rows >= 256, "byte range check needs >= 256 rows"
    tr = np.zeros((NUM_COLUMNS, n_rows), dtype=np.uint64)
    mult = np.zeros(n_rows, dtype=np.uint64)
    mem_ops: List[MemoryOp] = []
    for r, req in enumerate(requests):
        tr[FILTER, r] = 1
        tr[IS_READ, r] = req.is_read
        tr[CTX, r], tr[SEG, r], tr[VIRT, r], tr[TS, r] = (
            req.ctx,
            req.seg,
            req.virt,
            req.ts,
        )
        ln = len(req.data)
        tr[LEN_FLAGS[ln - 1], r] = 1
        for i in range(32):
            tr[ACTIVE[i], r] = 1 if i < ln else 0
        for i, byte in enumerate(req.data):
            tr[BYTES[i], r] = byte
            mult[byte] += 1
            mem_ops.append(
                MemoryOp(req.ctx, req.seg, req.virt + i, req.ts, req.is_read, byte)
            )
        mult[0] += 32 - ln  # inactive byte columns hold 0 and are looked up
        for j in range(N_LIMBS):
            tr[LIMBS[j], r] = int(tr[BYTES[2 * j], r]) + 256 * int(
                tr[BYTES[2 * j + 1], r]
            )
    # padding rows: inactive bytes are zero and still looked up
    for r in range(len(requests), n_rows):
        mult[0] += 32
    tr[RC_MULT] = mult
    return tr, mem_ops

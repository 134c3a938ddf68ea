"""KeccakSponge table: absorption linking memory bytes to keccak-f.

Counterpart: ethproof_tpu/tables/keccak_sponge.py:1 (a copy:
`KeccakSpongeStark` :136-240 with its fixed byte-range column :64, the CTL
specs :71-134, `HashRequest`, `SpongeResult` and `generate_trace`
:242-374, `_state_limbs`, `_limbs_to_int`).

One row = one absorbed 136-byte block of one keccak256 operation:

- message bytes for the block live in BYTES (raw, zero beyond the final
  block's length) and are byte range-checked (logUp); the same data is
  read from a word-staged memory segment as five 256-bit words (five
  Memory CTLs) with packing constraints BYTES <-> word limbs.
- Ethereum padding (0x01 ... 0x80) is applied algebraically: the xor
  input XIN = packed bytes + one-hot length deltas (+0x8000 on limb 67
  for final blocks) — valid as xor because padded positions hold zero.
- XORED = STATE_IN_rate ^ XIN via five XOR CTLs into the Logic table.
- permutation: (PERM_ID, XORED ++ capacity) and (PERM_ID, STATE_OUT)
  CTLs join this row to one 24-row block of the Keccak table.
- chaining: first block's STATE_IN = 0; later blocks continue the
  previous row's STATE_OUT. Final rows expose the digest (first 16
  limbs of STATE_OUT) for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..hash.keccak import keccak_f
from ..stark.stark import LC, CtlSpec, LookupSpec, Stark
from .common import Cols
from .logic import OP_XOR
from .memory import MemoryOp

RATE_BYTES = 136
RATE_LIMBS = 68  # 136 bytes = 68 x 16-bit limbs
STATE_LIMBS = 100  # 25 lanes x 4 limbs

OP_KECCAK_DIGEST = 13
OP_SPONGE_INIT = 14

_c = Cols()
FILTER = _c.one()
IS_FIRST = _c.one()
IS_FINAL = _c.one()
PERM_ID = _c.one()
CTX = _c.one()
SEG = _c.one()
VIRT = _c.one()  # word index of this block's first staged word
TS = _c.one()
LEN_FLAGS = _c.many(RATE_BYTES)  # one-hot len-in-final-block (0..135)
ACTIVE_PFX = _c.many(RATE_BYTES)  # byte i carries message data
BYTES = _c.many(RATE_BYTES)
WORDS = _c.many(80)  # 5 words x 16 limbs (staged memory reads)
XIN = _c.many(RATE_LIMBS)  # padded block limbs (xor input)
STATE_IN = _c.many(STATE_LIMBS)
XORED = _c.many(RATE_LIMBS)
STATE_OUT = _c.many(STATE_LIMBS)
RC_MULT = _c.one()
NUM_COLUMNS = _c.count

F_COUNTER = NUM_COLUMNS  # fixed byte-range column min(row, 255)


def _zero() -> LC:
    return LC(terms=(), const=0)


def memory_ctl_specs() -> List[CtlSpec]:
    out = []
    for w in range(5):
        cols: List = [
            CTX,
            SEG,
            LC(terms=((VIRT, 1),), const=w),
            TS,
            LC(terms=(), const=1),  # is_read
        ] + list(WORDS[w * 16 : (w + 1) * 16])
        out.append(CtlSpec(columns=tuple(cols), filter_col=FILTER))
    return out


def logic_ctl_specs() -> List[CtlSpec]:
    """Five XOR lookups: state-rate slice ^ XIN slice = XORED slice."""
    out = []
    for w in range(5):
        if w < 4:
            in0 = list(STATE_IN[w * 16 : (w + 1) * 16])
            in1 = list(XIN[w * 16 : (w + 1) * 16])
            res = list(XORED[w * 16 : (w + 1) * 16])
        else:
            in0 = list(STATE_IN[64:68]) + [_zero()] * 12
            in1 = list(XIN[64:68]) + [_zero()] * 12
            res = list(XORED[64:68]) + [_zero()] * 12
        cols = [LC(terms=(), const=OP_XOR)] + in0 + in1 + res
        out.append(CtlSpec(columns=tuple(cols), filter_col=FILTER))
    return out


def keccak_input_ctl_spec() -> CtlSpec:
    cols = [PERM_ID] + list(XORED) + list(STATE_IN[RATE_LIMBS:])
    return CtlSpec(columns=tuple(cols), filter_col=FILTER)


def keccak_output_ctl_spec() -> CtlSpec:
    return CtlSpec(columns=tuple([PERM_ID] + list(STATE_OUT)), filter_col=FILTER)


def digest_ctl_spec() -> CtlSpec:
    """CPU-facing, on FINAL rows: (op, ctx, seg, virt_final, ts, len_final,
    digest limbs). Together with `first_ctl_spec` and the intra-request
    chaining constraints (VIRT+5 / PERM_ID+1 / same ctx,seg,ts per block),
    one (first, final) consumption pair pins the hashed message to an
    exact word region and byte length of kernel memory — the binding the
    trie kernel relies on (evm/binding.py)."""
    len_lc = LC(terms=tuple((LEN_FLAGS[i], i) for i in range(1, RATE_BYTES)), const=0)
    cols = [LC(terms=(), const=OP_KECCAK_DIGEST), CTX, SEG, VIRT, TS, len_lc] + list(
        STATE_OUT[:16]
    )
    return CtlSpec(columns=tuple(cols), filter_col=IS_FINAL)


def first_ctl_spec() -> CtlSpec:
    """CPU-facing, on FIRST rows: (op, ctx, seg, virt, ts). Consuming this
    pins a request's STARTING word address (a final-row consumption alone
    would let a malicious prover shift where absorption began)."""
    cols = [LC(terms=(), const=OP_SPONGE_INIT), CTX, SEG, VIRT, TS]
    return CtlSpec(columns=tuple(cols), filter_col=IS_FIRST)


class KeccakSpongeStark(Stark):
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

    def eval(self, ctx):
        c, o = ctx.consumer, ctx.ops
        one = o.one()
        filt = ctx.local(FILTER)
        first = ctx.local(IS_FIRST)
        final = ctx.local(IS_FINAL)
        for col in (FILTER, IS_FIRST, IS_FINAL):
            b = ctx.local(col)
            c.constraint(o.mul(b, o.sub(b, one)))
        # first/final only on active rows
        c.constraint(o.mul(first, o.sub(filt, one)))
        c.constraint(o.mul(final, o.sub(filt, one)))

        flags = ctx.local_stack(LEN_FLAGS)
        c.constraint_vec(o.mul(flags, o.sub(flags, one)))
        total = o.fold_vec(flags, 1)
        c.constraint(o.sub(total, final))  # one-hot iff final block

        # active prefix: full non-final blocks have every byte active;
        # final blocks activate bytes below the length
        full = o.mul(filt, o.sub(one, final))
        suffix = o.zero()
        lflags = [ctx.local(i) for i in LEN_FLAGS]
        for i in reversed(range(RATE_BYTES)):
            if i < RATE_BYTES - 1:
                suffix = o.add(suffix, lflags[i + 1])
            c.constraint(
                o.sub(ctx.local(ACTIVE_PFX[i]), o.add(full, suffix))
            )
        bytes_v = ctx.local_stack(BYTES)
        act = ctx.local_stack(ACTIVE_PFX)
        c.constraint_vec(o.mul(bytes_v, o.sub(one, act)))

        # packing: word limbs equal packed raw bytes; high word-4 limbs 0
        packed = o.pack_weighted(bytes_v, [1, 256], 2)  # (68, m)
        c.constraint_vec(
            o.sub(ctx.local_stack(WORDS[:RATE_LIMBS]), packed)
        )
        c.constraint_vec(ctx.local_stack(WORDS[RATE_LIMBS:]))

        # XIN = packed + padding deltas (valid as xor on zero bytes)
        # delta for L_p: 0x01 at byte p -> 1 or 256 into limb p//2;
        # final block always adds 0x80 at byte 135 -> 0x8000 into limb 67
        xin = ctx.local_stack(XIN)
        deltas = []
        for j in range(RATE_LIMBS):
            d = o.mul(ctx.local(LEN_FLAGS[2 * j]), one)
            d = o.add(
                d, o.mul(ctx.local(LEN_FLAGS[2 * j + 1]), o.constant(256))
            )
            if j == RATE_LIMBS - 1:
                d = o.add(d, o.mul(final, o.constant(0x8000)))
            deltas.append(d)
        c.constraint_vec(
            o.sub(xin, o.add(ctx.local_stack(WORDS[:RATE_LIMBS]), o.stack(deltas)))
        )

        # chaining
        state_in = ctx.local_stack(STATE_IN)
        c.constraint_vec(o.mul(first, state_in))
        nxt_first = ctx.next(IS_FIRST)
        nxt_filter = ctx.next(FILTER)
        carry_gate = o.mul(nxt_filter, o.sub(one, nxt_first))
        # request shape: an active non-final row is ALWAYS continued by an
        # active non-first row (and only then), a final row never is, and a
        # request cannot dangle past the last row. Together with the
        # per-block +5/+1 address/perm chaining below this makes the
        # (first_ctl, digest_ctl) pair pin each request's exact word region
        # — load-bearing for the trie-binding kernel (evm/binding.py),
        # where the WITNESS behind hash requests is adversarial.
        c.constraint_transition(
            o.sub(o.mul(filt, o.sub(one, final)), carry_gate)
        )
        c.constraint_last_row(o.mul(filt, o.sub(one, final)))
        for col, step in ((CTX, 0), (SEG, 0), (TS, 0), (PERM_ID, 1), (VIRT, 5)):
            want = ctx.local(col) if step == 0 else o.add(
                ctx.local(col), o.constant(step)
            )
            c.constraint_transition(
                o.mul(carry_gate, o.sub(ctx.next(col), want))
            )
        c.constraint_vec_transition(
            o.mul(
                carry_gate,
                o.sub(ctx.next_stack(STATE_IN), ctx.local_stack(STATE_OUT)),
            )
        )


@dataclass
class SpongeResult:
    trace: np.ndarray
    mem_ops: List[MemoryOp]  # word reads (and staging writes)
    logic_requests: List[Tuple[int, int, int]]
    perm_inputs: List[np.ndarray]  # (5,5) states for the keccak table
    digests: List[bytes]


@dataclass
class HashRequest:
    ctx: int
    seg: int
    virt: int  # word index where the message's staged words begin
    ts: int
    message: bytes
    # True: this table emits the companion staging writes (self-contained
    # request). False: the words were already written by the CPU kernel
    # (OP_WIT / computed splices) — only reads are emitted, and memory
    # consistency binds the absorbed words to the kernel's cells.
    staged: bool = True


def generate_trace(
    requests: List[HashRequest], n_rows: int, first_perm_id: int = 0
) -> SpongeResult:
    tr = np.zeros((NUM_COLUMNS, n_rows), dtype=np.uint64)
    mult = np.zeros(n_rows, dtype=np.uint64)
    assert n_rows >= 256, "byte range check needs >= 256 rows"
    mem_ops: List[MemoryOp] = []
    logic_reqs: List[Tuple[int, int, int]] = []
    perm_inputs: List[np.ndarray] = []
    digests: List[bytes] = []
    row = 0
    perm_id = first_perm_id
    for req in requests:
        msg = req.message
        n_blocks = len(msg) // RATE_BYTES + 1  # final block always exists
        state = np.zeros((5, 5), dtype=np.uint64)
        word_virt = req.virt
        for blk in range(n_blocks):
            r = row
            row += 1
            raw = msg[blk * RATE_BYTES : (blk + 1) * RATE_BYTES]
            is_final = blk == n_blocks - 1
            tr[FILTER, r] = 1
            tr[IS_FIRST, r] = 1 if blk == 0 else 0
            tr[IS_FINAL, r] = 1 if is_final else 0
            tr[PERM_ID, r] = perm_id
            tr[CTX, r], tr[SEG, r], tr[VIRT, r], tr[TS, r] = (
                req.ctx,
                req.seg,
                word_virt,
                req.ts,
            )
            padded = bytearray(raw + b"\x00" * (RATE_BYTES - len(raw)))
            if is_final:
                tr[LEN_FLAGS[len(raw)], r] = 1
                padded[len(raw)] ^= 0x01
                padded[RATE_BYTES - 1] ^= 0x80
            for i in range(RATE_BYTES):
                active = 1 if (not is_final) or i < len(raw) else 0
                tr[ACTIVE_PFX[i], r] = active
                b = raw[i] if i < len(raw) else 0
                tr[BYTES[i], r] = b
                mult[b] += 1
            # staged words (raw bytes packed little-endian)
            raw_pad = raw + b"\x00" * (RATE_BYTES - len(raw))
            for w in range(5):
                word_bytes = (raw_pad + b"\x00" * 24)[w * 32 : (w + 1) * 32]
                val = int.from_bytes(word_bytes, "little")
                for l, limb in enumerate(
                    [(val >> (16 * i)) & 0xFFFF for i in range(16)]
                ):
                    tr[WORDS[w * 16 + l], r] = limb
                mem_ops.append(
                    MemoryOp(req.ctx, req.seg, word_virt + w, req.ts, 1, val)
                )
                if req.staged:
                    # companion staging write at an earlier timestamp
                    mem_ops.append(
                        MemoryOp(
                            req.ctx, req.seg, word_virt + w, max(req.ts - 1, 0), 0, val
                        )
                    )
            # xin limbs = padded block
            xin_limbs = [
                padded[2 * j] + 256 * padded[2 * j + 1] for j in range(RATE_LIMBS)
            ]
            for j, v in enumerate(xin_limbs):
                tr[XIN[j], r] = v
            # state in limbs
            in_limbs = _state_limbs(state)
            for j, v in enumerate(in_limbs):
                tr[STATE_IN[j], r] = v
            # xor rate
            xored = [in_limbs[j] ^ xin_limbs[j] for j in range(RATE_LIMBS)]
            for j, v in enumerate(xored):
                tr[XORED[j], r] = v
            for w in range(5):
                if w < 4:
                    a = _limbs_to_int(in_limbs[w * 16 : (w + 1) * 16])
                    b = _limbs_to_int(xin_limbs[w * 16 : (w + 1) * 16])
                else:
                    a = _limbs_to_int(in_limbs[64:68])
                    b = _limbs_to_int(xin_limbs[64:68])
                logic_reqs.append((OP_XOR, a, b))
            # absorb into the state and permute
            new_state = state.copy()
            for j in range(RATE_LIMBS):
                lane_idx, l = divmod(j, 4)
                x, y = lane_idx % 5, lane_idx // 5
                lane = int(new_state[x, y])
                lane ^= xin_limbs[j] << (16 * l)
                new_state[x, y] = lane
            perm_inputs.append(new_state.copy())
            state = keccak_f(new_state)
            out_limbs = _state_limbs(state)
            for j, v in enumerate(out_limbs):
                tr[STATE_OUT[j], r] = v
            perm_id += 1
            word_virt += 5
        digest = b"".join(
            int(state[i % 5, i // 5]).to_bytes(8, "little") for i in range(4)
        )
        digests.append(digest)
    # padding rows look up byte 0
    mult[0] += (n_rows - row) * RATE_BYTES
    tr[RC_MULT] = mult
    return SpongeResult(tr, mem_ops, logic_reqs, perm_inputs, digests)


def _state_limbs(state: np.ndarray) -> List[int]:
    """lane order (x + 5y), 4 little-endian 16-bit limbs per lane."""
    out = []
    for idx in range(25):
        x, y = idx % 5, idx // 5
        lane = int(state[x, y])
        out.extend((lane >> (16 * l)) & 0xFFFF for l in range(4))
    return out


def _limbs_to_int(limbs: List[int]) -> int:
    v = 0
    for i, l in enumerate(limbs):
        v |= int(l) << (16 * i)
    return v

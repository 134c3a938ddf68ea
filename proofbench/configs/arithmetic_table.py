"""[The benchmark's frozen copy of ethproof_tpu_torch/tables/arithmetic.py: this configuration's plain reference table.]

Arithmetic table: 256-bit ADD/SUB/LT/MUL/DIV/MOD/SHR/SHL over 16-bit limbs.

Counterpart: ethproof_tpu/tables/arithmetic.py:1 (a copy).

Reference equivalent: evm_arithmetization's Arithmetic STARK (add/mul/
sub/cmp/div/mod/shifts over 256-bit operands in 16-bit limbs,
range-checked) [dep: from knowledge; pin Cargo.lock:1675;
table named at common/src/prover_state/circuit.rs:61].

Limb equations hold over the integers (all terms < 2^40 << p), so the
field constraints pin the exact 2^256-modular results:

- ADD: in0_i + in1_i + c_{i-1} = out_i + 2^16 c_i, carries boolean.
- SUB: in0_i - in1_i - b_{i-1} + 2^16 b_i = out_i, borrows boolean.
- LT : the SUB borrow chain run on scratch limbs; out = final borrow.
- MUL: sum_{i+j=k} in0_i in1_j + carry_{k-1} = out_k + 2^16 carry_k,
  carry_k = mclo_k + 2^16 mchi_k, both 16-bit (bounds the carry < 2^32,
  which keeps every equation exact over Z — soundness needs no tighter
  bound). Overflow past limb 15 is discarded: mod-2^256 semantics.
- DIV/MOD (EVM: x/0 = x%0 = 0): witnessed quotient QUO and remainder REM
  with, when in1 != 0 (boolean B_NZ, forced by an inverse witness BINV):
  the 31-limb identity QUO*in1 + REM == in0 held exactly over Z (upper
  convolution limbs forced to zero through carries DCLO2/DCHI2, final
  carry zero), and REM < in1 via a borrow chain whose final borrow is
  pinned to 1. in1 == 0 forces QUO = REM = 0. out = QUO (DIV) / REM (MOD).
- SHR/SHL (EVM: in0 is the value, in1 the shift count; count >= 256 -> 0):
  the count's low limb decomposes as 256*B0_HI + 16*K + T with K, T given
  by one-hot selector banks KSEL/TSEL whose sums equal the validity bit
  B_VALID; B_VALID == 1 forces B0_HI and the count's high limbs to zero
  (count < 256), B_VALID == 0 forces their sum nonzero via inverse
  witness BIGINV (count >= 256) — so the bit exactly encodes validity
  and, through the all-zero selector banks, zeroes the output.
  Per-limb bit shift by t uses pow2t = sum_t 2^t TSEL_t:
    SHL: in0_i * pow2t = 2^16 SH_HI_i + SH_LO_i  (both 16-bit checked)
    SHR: in0_i = pow2t * SH_HI_i + SH_LO_i, with SH_LO_i < 2^t enforced
         by SHR_SCALED_i = SH_LO_i * 2^(16-t) being 16-bit checked
  and the K-limb rotation is a one-hot-selected sum (degree 3).
- BYTE (EVM: in1 is the byte index i counting from the MOST significant
  byte, in0 the value; i >= 32 -> 0): the shift one-hot banks double as
  a 32-slot selector over the little-endian byte position j = 31 - i
  (KSEL covers j < 16, TSEL covers j >= 16). in1_0 = 32*B0_HI + IDX5
  (exact over Z, both 16-bit checked) pins the low index bits; validity
  reuses the shift machinery (v=1 forces B0_HI and high index limbs to
  zero, v=0 forces their sum invertible and empties the selector banks,
  zeroing the output). The selected 16-bit limb splits as
  256*BYTE_HI + BYTE_LO (BYTE_LO < 256 by scaled check; BYTE_HI < 256
  then follows over Z) and out_0 one-hot-selects the half.

All value/scratch limbs are range-checked to 16 bits by one logUp
against a FIXED (preprocessed) counter column min(row, 2^16-1) — part of
the circuit definition, so the prover has zero freedom over the range
table. At production sizes (n >= 2^16, the reference's ARITHMETIC
minimum, circuit.rs:77-87) the check is a sound 16-bit bound; below
2^16 the bound degrades to n (documented test-tier relaxation).

CTL surface: (op_id, in0, in1, out) filtered by `filter`, looked up by
the CPU table.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..reference.gf import field_host as fh
from ..reference.stark.stark import CtlSpec, LookupSpec, Stark
from ..reference.common import Cols, LIMB_BASE, N_LIMBS, int_to_limbs, limbs_to_int

OP_ADD, OP_SUB, OP_LT, OP_MUL = 1, 2, 3, 4
OP_SLT = 5  # signed less-than (borrow chain with flipped sign bits)
OP_DIV, OP_MOD, OP_SHR, OP_SHL = 13, 14, 15, 16
OP_BYTE = 17
OP_SAR = 18  # arithmetic shift right (SHR + sign-extension mask)
OP_SEXT = 19  # SIGNEXTEND (byte-boundary sign fill)
OP_ADDMOD, OP_MULMOD = 21, 22  # ternary: (a, b, N) -> (a op b) mod N

ALL_OPS = (OP_ADD, OP_SUB, OP_LT, OP_MUL, OP_DIV, OP_MOD, OP_SHR, OP_SHL,
           OP_BYTE, OP_ADDMOD, OP_MULMOD, OP_SLT, OP_SAR, OP_SEXT)

_c = Cols()
IS_ADD = _c.one()
IS_SUB = _c.one()
IS_LT = _c.one()
IS_MUL = _c.one()
IS_DIV = _c.one()
IS_MOD = _c.one()
IS_SHR = _c.one()
IS_SHL = _c.one()
IS_BYTE = _c.one()
IS_ADDMOD = _c.one()
IS_MULMOD = _c.one()
IS_SLT = _c.one()
IS_SAR = _c.one()
IS_SEXT = _c.one()
OP_ID = _c.one()
FILTER = _c.one()
IN0 = _c.many(N_LIMBS)
IN1 = _c.many(N_LIMBS)
IN2 = _c.many(N_LIMBS)  # modop modulus N (zero on binary-op rows)
OUT = _c.many(N_LIMBS)
CARRY = _c.many(N_LIMBS)  # boolean carry/borrow chain (add/sub/lt/divmod)
SCRATCH = _c.many(N_LIMBS)  # LT / REM<IN1 difference limbs (16-bit)
MCLO = _c.many(N_LIMBS)  # mul/div carry low 16 bits (conv limbs 0..15)
MCHI = _c.many(N_LIMBS)  # mul/div carry high bits (16-bit checked)
QUO = _c.many(N_LIMBS)  # div/mod quotient
REM = _c.many(N_LIMBS)  # div/mod remainder
DCLO2 = _c.many(N_LIMBS - 2)  # div carry lows, conv limbs 16..29
DCHI2 = _c.many(N_LIMBS - 2)  # div carry highs
B_NZ = _c.one()  # divmod: boolean "in1 != 0"
BINV = _c.one()  # divmod: inverse witness for sum(in1 limbs)
G_DIV = _c.one()  # divmod: B_NZ * (is_div + is_mod)  (degree control)
KSEL = _c.many(16)  # shifts: one-hot limb offset k (count = 16k + t)
TSEL = _c.many(16)  # shifts: one-hot bit offset t
B_VALID = _c.one()  # shifts: boolean "count < 256"
B0_HI = _c.one()  # shifts: count_limb0 >> 8 (16-bit checked)
BIGINV = _c.one()  # shifts: inverse witness for the invalidity sum
G_SHIFT = _c.one()  # shifts: (is_shr + is_shl) * (1 - B_VALID)
SH_LO = _c.many(N_LIMBS)  # shifts: per-limb low part (16-bit checked)
SH_HI = _c.many(N_LIMBS)  # shifts: per-limb high part (16-bit checked)
SHR_SCALED = _c.many(N_LIMBS)  # shr: SH_LO * 2^(16-t) (16-bit checked)
IDX5 = _c.one()  # byte: low index bits; b0=32*B0_HI+IDX5 over Z + the
# one-hot binding j_lin == v*IDX5 pin it exactly (no scaled check needed)
BYTE_LO = _c.one()  # byte: selected limb low byte (scaled-checked < 256)
BYTE_HI = _c.one()  # byte: selected limb high byte
BYTE_LO_SC = _c.one()  # byte: BYTE_LO * 2^8 (16-bit checked)
# ADDMOD/MULMOD: full-precision intermediate ACC = (a op b) over Z
# (32 limbs), identity-A carries (31 pairs), plus 16 extra carry pairs
# for identity B's high convolution limbs (low 30 pairs reuse MCLO/MCHI
# + DCLO2/DCHI2 — row kinds are disjoint); Q reuses QUO||REM (32 limbs)
ACC = _c.many(2 * N_LIMBS)
ACLO = _c.many(2 * N_LIMBS - 1)
ACHI = _c.many(2 * N_LIMBS - 1)
QC2LO = _c.many(16)  # identity-B carries, conv limbs 30..45
QC2HI = _c.many(16)
M_NZ = _c.one()  # modop: boolean "N != 0"
MINV = _c.one()  # modop: inverse witness for sum(IN2 limbs)
G_MOD = _c.one()  # modop: M_NZ * (is_addmod + is_mulmod)
SGN0 = _c.one()  # slt/sar: sign bit of in0 (top limb = low15 + 0x8000*
SGN1 = _c.one()  # sign; low-15 parts + doublings reuse MCLO[0..3])
SX_S = _c.one()  # signextend: sign bit of the selected byte
SX_LOW7 = _c.one()  # signextend: its low 7 bits (512x reuses MCLO[4])
G_SAR = _c.one()  # sar: is_sar * sign (degree control for the mask)
RC_MULT = _c.one()
NUM_COLUMNS = _c.count

RANGE_CHECKED = (
    IN0 + IN1 + OUT + SCRATCH + MCLO + MCHI
    + QUO + REM + DCLO2 + DCHI2 + [B0_HI]
    + SH_LO + SH_HI + SHR_SCALED
    + [IDX5, BYTE_LO, BYTE_HI, BYTE_LO_SC]
    + IN2 + ACC + ACLO + ACHI + QC2LO + QC2HI
)

RANGE_BOUND = 1 << 16  # limb width; table column clamps here
F_COUNTER = NUM_COLUMNS  # fixed column, addressed past the trace columns

_SEL_OF_OP = {
    OP_ADD: IS_ADD, OP_SUB: IS_SUB, OP_LT: IS_LT, OP_MUL: IS_MUL,
    OP_DIV: IS_DIV, OP_MOD: IS_MOD, OP_SHR: IS_SHR, OP_SHL: IS_SHL,
    OP_BYTE: IS_BYTE, OP_ADDMOD: IS_ADDMOD, OP_MULMOD: IS_MULMOD,
    OP_SLT: IS_SLT, OP_SAR: IS_SAR, OP_SEXT: IS_SEXT,
}


class ArithmeticStark(Stark):
    num_columns = NUM_COLUMNS
    num_public_inputs = 0
    constraint_degree = 3
    num_fixed_columns = 1
    lookups = [
        LookupSpec(
            looking_cols=tuple(RANGE_CHECKED),
            table_col=F_COUNTER,
            multiplicity_col=RC_MULT,
        )
    ]

    def fixed_columns(self, n: int) -> np.ndarray:
        counter = np.minimum(
            np.arange(n, dtype=np.uint64), np.uint64(RANGE_BOUND - 1)
        )
        return counter[None, :]

    # CPU-facing lookup tuple (ternary: binary ops carry IN2 = 0)
    ctl_spec = CtlSpec(
        columns=tuple([OP_ID] + IN0 + IN1 + IN2 + OUT), filter_col=FILTER
    )

    def eval(self, ctx):
        c, o = ctx.consumer, ctx.ops
        one = o.one()
        sels = [ctx.local(_SEL_OF_OP[op]) for op in ALL_OPS]
        for s in sels:
            c.constraint(o.mul(s, o.sub(s, one)))
        filt = ctx.local(FILTER)
        acc = sels[0]
        for s in sels[1:]:
            acc = o.add(acc, s)
        c.constraint(o.sub(filt, acc))
        c.constraint(o.mul(filt, o.sub(filt, one)))  # at most one op per row
        # op id linkage
        op = o.mul(o.constant(ALL_OPS[0]), sels[0])
        for w, s in zip(ALL_OPS[1:], sels[1:]):
            op = o.add(op, o.mul(o.constant(w), s))
        c.constraint(o.sub(ctx.local(OP_ID), op))

        base = o.constant(LIMB_BASE)
        (is_add, is_sub, is_lt, is_mul, is_div, is_mod, is_shr, is_shl,
         is_byte, is_addmod, is_mulmod, is_slt, is_sar, is_sext) = sels
        carries = [ctx.local(i) for i in CARRY]
        for cy in carries:
            c.constraint(o.mul(cy, o.sub(cy, one)))

        a = [ctx.local(i) for i in IN0]
        b = [ctx.local(i) for i in IN1]
        out = [ctx.local(i) for i in OUT]

        # ADD / SUB / LT limb chains
        for i in range(N_LIMBS):
            cin = carries[i - 1] if i > 0 else o.zero()
            # add: a + b + cin - out - base*cout = 0
            c.constraint(
                o.mul(
                    is_add,
                    o.sub(
                        o.add(o.add(a[i], b[i]), cin),
                        o.add(out[i], o.mul(base, carries[i])),
                    ),
                )
            )
            # sub: a - b - bin + base*bout - out = 0
            sub_expr = o.sub(
                o.add(o.sub(o.sub(a[i], b[i]), cin), o.mul(base, carries[i])),
                out[i],
            )
            c.constraint(o.mul(is_sub, sub_expr))
            # lt: same chain with scratch difference limbs
            d = ctx.local(SCRATCH[i])
            lt_expr = o.sub(
                o.add(o.sub(o.sub(a[i], b[i]), cin), o.mul(base, carries[i])),
                d,
            )
            c.constraint(o.mul(is_lt, lt_expr))
        # lt output: out_0 = final borrow, out_i>0 = 0
        c.constraint(o.mul(is_lt, o.sub(out[0], carries[N_LIMBS - 1])))
        for i in range(1, N_LIMBS):
            c.constraint(o.mul(is_lt, out[i]))

        # SLT: the LT borrow chain with both top-limb sign bits flipped
        # (signed a < b  <=>  unsigned a^2^255 < b^2^255). Sign split:
        # top limb = low15 + 0x8000*sign with low15 < 2^15 proven by the
        # range check on its doubling. low15/doublings reuse MCLO[0..3].
        sgn0, sgn1 = ctx.local(SGN0), ctx.local(SGN1)
        for sg in (sgn0, sgn1):
            c.constraint(o.mul(sg, o.sub(sg, one)))
        l0, l1 = ctx.local(MCLO[0]), ctx.local(MCLO[1])
        half = o.constant(1 << 15)
        c.constraint(
            o.mul(is_slt, o.sub(a[15], o.add(l0, o.mul(half, sgn0))))
        )
        c.constraint(
            o.mul(is_slt, o.sub(b[15], o.add(l1, o.mul(half, sgn1))))
        )
        c.constraint(
            o.mul(is_slt, o.sub(ctx.local(MCLO[2]), o.mul(o.constant(2), l0)))
        )
        c.constraint(
            o.mul(is_slt, o.sub(ctx.local(MCLO[3]), o.mul(o.constant(2), l1)))
        )
        eff_a15 = o.add(l0, o.mul(half, o.sub(one, sgn0)))
        eff_b15 = o.add(l1, o.mul(half, o.sub(one, sgn1)))
        for i in range(N_LIMBS):
            cin = carries[i - 1] if i > 0 else o.zero()
            ea = a[i] if i < N_LIMBS - 1 else eff_a15
            eb = b[i] if i < N_LIMBS - 1 else eff_b15
            d = ctx.local(SCRATCH[i])
            slt_expr = o.sub(
                o.add(o.sub(o.sub(ea, eb), cin), o.mul(base, carries[i])),
                d,
            )
            c.constraint(o.mul(is_slt, slt_expr))
        c.constraint(o.mul(is_slt, o.sub(out[0], carries[N_LIMBS - 1])))
        for i in range(1, N_LIMBS):
            c.constraint(o.mul(is_slt, out[i]))

        # MUL: schoolbook low half with 32-bit carries
        prev_carry = o.zero()
        for k in range(N_LIMBS):
            acc = None
            for i in range(k + 1):
                j = k - i
                term = o.mul(a[i], b[j])
                acc = term if acc is None else o.add(acc, term)
            carry_k = o.add(
                ctx.local(MCLO[k]), o.mul(base, ctx.local(MCHI[k]))
            )
            expr = o.sub(
                o.add(acc, prev_carry),
                o.add(out[k], o.mul(base, carry_k)),
            )
            c.constraint(o.mul(is_mul, expr))
            prev_carry = carry_k

        self._eval_divmod(ctx, sels, a, b, out, carries, base)
        self._eval_shifts(ctx, sels, a, b, out, base)
        self._eval_byte(ctx, sels, a, b, out)
        self._eval_sext(ctx, sels, a, b, out)
        self._eval_modop(ctx, sels, a, b, out, carries, base)
        # binary-op rows carry IN2 = 0 (the CTL tuple includes it)
        is_modop = o.add(is_addmod, is_mulmod)
        not_modop = o.sub(ctx.local(FILTER), is_modop)
        for i in range(N_LIMBS):
            c.constraint(o.mul(not_modop, ctx.local(IN2[i])))

    # -- DIV / MOD -------------------------------------------------------------

    def _eval_divmod(self, ctx, sels, a, b, out, carries, base):
        c, o = ctx.consumer, ctx.ops
        one = o.one()
        is_div, is_mod = sels[4], sels[5]
        is_divmod = o.add(is_div, is_mod)
        quo = [ctx.local(i) for i in QUO]
        rem = [ctx.local(i) for i in REM]
        b_nz = ctx.local(B_NZ)
        binv = ctx.local(BINV)
        g = ctx.local(G_DIV)

        s_b = b[0]
        for i in range(1, N_LIMBS):
            s_b = o.add(s_b, b[i])
        c.constraint(o.mul(b_nz, o.sub(b_nz, one)))
        # b_nz <=> sum(b) != 0, on divmod rows only
        c.constraint(o.mul(is_divmod, o.sub(o.mul(s_b, binv), b_nz)))
        c.constraint(o.mul(is_divmod, o.mul(o.sub(one, b_nz), s_b)))
        # g = b_nz * is_divmod (degree control for the gated identities)
        c.constraint(o.sub(g, o.mul(b_nz, is_divmod)))
        # b == 0 -> quo = rem = 0 (and thus out = 0)
        zg = o.sub(is_divmod, g)
        for i in range(N_LIMBS):
            c.constraint(o.mul(zg, quo[i]))
            c.constraint(o.mul(zg, rem[i]))
            c.constraint(o.mul(is_div, o.sub(out[i], quo[i])))
            c.constraint(o.mul(is_mod, o.sub(out[i], rem[i])))

        # QUO * b + REM == a over Z: convolution limbs 0..30, final carry 0
        prev_carry = o.zero()
        for k in range(2 * N_LIMBS - 1):
            acc = None
            for i in range(max(0, k - (N_LIMBS - 1)), min(k, N_LIMBS - 1) + 1):
                term = o.mul(quo[i], b[k - i])
                acc = term if acc is None else o.add(acc, term)
            if k < N_LIMBS:
                acc = o.add(acc, rem[k])
            lhs = o.add(acc, prev_carry)
            if k < N_LIMBS:
                lhs = o.sub(lhs, a[k])
            if k < 2 * N_LIMBS - 2:
                if k < N_LIMBS:
                    carry_k = o.add(
                        ctx.local(MCLO[k]), o.mul(base, ctx.local(MCHI[k]))
                    )
                else:
                    carry_k = o.add(
                        ctx.local(DCLO2[k - N_LIMBS]),
                        o.mul(base, ctx.local(DCHI2[k - N_LIMBS])),
                    )
                lhs = o.sub(lhs, o.mul(base, carry_k))
                prev_carry = carry_k
            c.constraint(o.mul(ctx.local(G_DIV), lhs))

        # REM < b when b != 0, encoded as b - rem - 1 >= 0: borrow chain
        # whose SCRATCH limbs are the 16-bit limbs of b - rem - 1 and whose
        # final borrow is pinned to 0. (The non-negative difference keeps
        # the range-checked scratch limbs small for small operands, so the
        # encoding is testable below the 2^16 production floor.)
        g = ctx.local(G_DIV)
        for i in range(N_LIMBS):
            cin = carries[i - 1] if i > 0 else one
            expr = o.sub(
                o.add(
                    o.sub(o.sub(b[i], rem[i]), cin),
                    o.mul(base, carries[i]),
                ),
                ctx.local(SCRATCH[i]),
            )
            c.constraint(o.mul(g, expr))
        c.constraint(o.mul(g, carries[N_LIMBS - 1]))

    # -- SHR / SHL -------------------------------------------------------------

    def _eval_shifts(self, ctx, sels, a, b, out, base):
        c, o = ctx.consumer, ctx.ops
        one = o.one()
        is_shr, is_shl, is_byte = sels[6], sels[7], sels[8]
        is_sar, is_sext = sels[12], sels[13]
        is_shift = o.add(o.add(is_shr, is_shl), is_sar)
        # BYTE/SIGNEXTEND share the validity/one-hot machinery
        uses_v = o.add(o.add(is_shift, is_byte), is_sext)
        ksel = [ctx.local(i) for i in KSEL]
        tsel = [ctx.local(i) for i in TSEL]
        v = ctx.local(B_VALID)
        b0_hi = ctx.local(B0_HI)
        biginv = ctx.local(BIGINV)
        g_sh = ctx.local(G_SHIFT)
        sh_lo = [ctx.local(i) for i in SH_LO]
        sh_hi = [ctx.local(i) for i in SH_HI]
        scaled = [ctx.local(i) for i in SHR_SCALED]

        for s in ksel + tsel:
            c.constraint(o.mul(s, o.sub(s, one)))
        c.constraint(o.mul(v, o.sub(v, one)))
        sum_k = ksel[0]
        sum_t = tsel[0]
        k16 = o.mul(o.constant(0), ksel[0])
        t_lin = o.mul(o.constant(0), tsel[0])
        pow2t = tsel[0]
        pow2r = o.mul(o.constant(1 << 16), tsel[0])
        for j in range(1, 16):
            sum_k = o.add(sum_k, ksel[j])
            sum_t = o.add(sum_t, tsel[j])
            k16 = o.add(k16, o.mul(o.constant(16 * j), ksel[j]))
            t_lin = o.add(t_lin, o.mul(o.constant(j), tsel[j]))
            pow2t = o.add(pow2t, o.mul(o.constant(1 << j), tsel[j]))
            pow2r = o.add(pow2r, o.mul(o.constant(1 << (16 - j)), tsel[j]))
        # selector banks sum to the validity bit (all-zero when count>=256,
        # which zeroes the one-hot-selected output sums below)
        c.constraint(o.mul(is_shift, o.sub(sum_k, v)))
        c.constraint(o.mul(is_shift, o.sub(sum_t, v)))
        # count_limb0 = 256*b0_hi + 16K + T (b0_hi 16-bit-checked makes the
        # field equation exact over Z)
        c.constraint(
            o.mul(
                is_shift,
                o.sub(
                    b[0],
                    o.add(o.mul(o.constant(256), b0_hi), o.add(k16, t_lin)),
                ),
            )
        )
        # v <=> count < 256: bigsum = b0_hi + sum(high limbs of count)
        bigsum = b0_hi
        for i in range(1, N_LIMBS):
            bigsum = o.add(bigsum, b[i])
        c.constraint(o.mul(uses_v, o.mul(v, bigsum)))
        # g_sh = (is_shift + is_byte) * (1 - v); when set, bigsum must be
        # invertible (shift: count >= 256; byte: index >= 32)
        c.constraint(o.sub(g_sh, o.mul(uses_v, o.sub(one, v))))
        c.constraint(o.mul(g_sh, o.sub(o.mul(bigsum, biginv), one)))

        # SHL: a_i * 2^t = 2^16 hi + lo, out_j = sum_k ksel_k (lo_{j-k} + hi_{j-k-1})
        for i in range(N_LIMBS):
            c.constraint(
                o.mul(
                    is_shl,
                    o.sub(
                        o.mul(a[i], pow2t),
                        o.add(o.mul(base, sh_hi[i]), sh_lo[i]),
                    ),
                )
            )
        for j in range(N_LIMBS):
            acc = None
            for k in range(j + 1):
                part = sh_lo[j - k]
                if j - k - 1 >= 0:
                    part = o.add(part, sh_hi[j - k - 1])
                term = o.mul(ksel[k], part)
                acc = term if acc is None else o.add(acc, term)
            c.constraint(o.mul(is_shl, o.sub(out[j], acc)))

        # SHR/SAR: a_i = 2^t hi + lo with lo < 2^t (scaled check), then
        # s_i = hi_i + scaled_{i+1}, out_j = sum_k ksel_k s_{j+k}
        shr_like = o.add(is_shr, is_sar)
        for i in range(N_LIMBS):
            c.constraint(
                o.mul(
                    shr_like,
                    o.sub(a[i], o.add(o.mul(pow2t, sh_hi[i]), sh_lo[i])),
                )
            )
            c.constraint(
                o.mul(shr_like, o.sub(scaled[i], o.mul(sh_lo[i], pow2r)))
            )
        shr_acc = []
        for j in range(N_LIMBS):
            acc = None
            for k in range(16):
                if j + k > N_LIMBS - 1:
                    break
                part = sh_hi[j + k]
                if j + k + 1 <= N_LIMBS - 1:
                    part = o.add(part, scaled[j + k + 1])
                term = o.mul(ksel[k], part)
                acc = term if acc is None else o.add(acc, term)
            shr_acc.append(acc)
            c.constraint(o.mul(is_shr, o.sub(out[j], acc)))

        # SAR: SHR plus the sign-extension mask. Sign split of in0's top
        # limb reuses the SLT scheme (SGN0 + MCLO[0]/MCLO[2]); G_SAR =
        # is_sar*sign keeps the mask terms at degree 3. Invalid counts
        # (>= 256) zero the selectors, leaving out = sign * ~0.
        sgn0_ = ctx.local(SGN0)
        g_sar = ctx.local(G_SAR)
        c.constraint(o.sub(g_sar, o.mul(is_sar, sgn0_)))
        l0_ = ctx.local(MCLO[0])
        c.constraint(
            o.mul(
                is_sar,
                o.sub(a[15], o.add(l0_, o.mul(o.constant(1 << 15), sgn0_))),
            )
        )
        c.constraint(
            o.mul(
                is_sar,
                o.sub(ctx.local(MCLO[2]), o.mul(o.constant(2), l0_)),
            )
        )
        inv_fill = o.mul(g_sar, o.mul(o.sub(one, v), o.constant(0xFFFF)))
        for j in range(N_LIMBS):
            himask = None
            for k in range(16):
                if k > 15 - j:
                    t = o.mul(ksel[k], o.constant(0xFFFF))
                elif k == 15 - j:
                    t = o.mul(ksel[k], o.sub(o.constant(1 << 16), pow2r))
                else:
                    continue
                himask = t if himask is None else o.add(himask, t)
            expr = o.sub(o.mul(is_sar, o.sub(out[j], shr_acc[j])),
                         o.mul(g_sar, himask) if himask is not None else o.zero())
            c.constraint(o.sub(expr, inv_fill))

    # -- ADDMOD / MULMOD ---------------------------------------------------------

    def _eval_modop(self, ctx, sels, a, b, out, carries, base):
        """(a + b) mod N and (a * b) mod N at full precision (EVM: the
        intermediate does NOT wrap 2^256; N == 0 -> 0).

        Identity A pins ACC = a op b over Z (32 limbs, carry pairs);
        identity B pins Q*N + out == ACC over Z with out < N (borrow
        chain on CARRY/SCRATCH, like divmod's REM < divisor). Q reuses
        QUO||REM; identity B's carry pairs reuse MCLO/MCHI + DCLO2/DCHI2
        for conv limbs 0..29 and QC2LO/QC2HI above — all row-disjoint
        from MUL/DIV/MOD rows."""
        c, o = ctx.consumer, ctx.ops
        one = o.one()
        is_addmod, is_mulmod = sels[9], sels[10]
        is_modop = o.add(is_addmod, is_mulmod)
        n_limbs = [ctx.local(i) for i in IN2]
        acc_l = [ctx.local(i) for i in ACC]
        q = [ctx.local(i) for i in QUO] + [ctx.local(i) for i in REM]
        m_nz = ctx.local(M_NZ)
        minv = ctx.local(MINV)
        g = ctx.local(G_MOD)

        s_n = n_limbs[0]
        for i in range(1, N_LIMBS):
            s_n = o.add(s_n, n_limbs[i])
        c.constraint(o.mul(m_nz, o.sub(m_nz, one)))
        c.constraint(o.mul(is_modop, o.sub(o.mul(s_n, minv), m_nz)))
        c.constraint(o.mul(is_modop, o.mul(o.sub(one, m_nz), s_n)))
        c.constraint(o.sub(g, o.mul(m_nz, is_modop)))
        zg = o.sub(is_modop, g)  # N == 0 rows
        for i in range(N_LIMBS):
            c.constraint(o.mul(zg, out[i]))
        for i in range(2 * N_LIMBS):
            c.constraint(o.mul(zg, q[i]))

        # identity A: ACC == a + b (addmod) / a * b (mulmod) over Z
        prev = o.zero()
        for k in range(2 * N_LIMBS):
            carry_k = (
                o.add(ctx.local(ACLO[k]), o.mul(base, ctx.local(ACHI[k])))
                if k < 2 * N_LIMBS - 1
                else o.zero()
            )
            add_lhs = o.add(a[k], b[k]) if k < N_LIMBS else o.zero()
            c.constraint(
                o.mul(
                    is_addmod,
                    o.sub(
                        o.add(add_lhs, prev),
                        o.add(acc_l[k], o.mul(base, carry_k)),
                    ),
                )
            )
            mul_lhs = None
            for i in range(max(0, k - (N_LIMBS - 1)), min(k, N_LIMBS - 1) + 1):
                t = o.mul(a[i], b[k - i])
                mul_lhs = t if mul_lhs is None else o.add(mul_lhs, t)
            mul_lhs = mul_lhs if mul_lhs is not None else o.zero()
            c.constraint(
                o.mul(
                    is_mulmod,
                    o.sub(
                        o.add(mul_lhs, prev),
                        o.add(acc_l[k], o.mul(base, carry_k)),
                    ),
                )
            )
            prev = carry_k

        # identity B: Q * N + out == ACC over Z (conv limbs 0..46)
        def qcarry(k):
            if k < N_LIMBS:
                return o.add(ctx.local(MCLO[k]), o.mul(base, ctx.local(MCHI[k])))
            if k < 2 * N_LIMBS - 2:
                return o.add(
                    ctx.local(DCLO2[k - N_LIMBS]),
                    o.mul(base, ctx.local(DCHI2[k - N_LIMBS])),
                )
            return o.add(
                ctx.local(QC2LO[k - (2 * N_LIMBS - 2)]),
                o.mul(base, ctx.local(QC2HI[k - (2 * N_LIMBS - 2)])),
            )

        prev = o.zero()
        for k in range(3 * N_LIMBS - 1):
            lhs = None
            for i in range(max(0, k - (N_LIMBS - 1)), min(k, 2 * N_LIMBS - 1) + 1):
                t = o.mul(q[i], n_limbs[k - i])
                lhs = t if lhs is None else o.add(lhs, t)
            lhs = lhs if lhs is not None else o.zero()
            if k < N_LIMBS:
                lhs = o.add(lhs, out[k])
            lhs = o.add(lhs, prev)
            if k < 2 * N_LIMBS:
                lhs = o.sub(lhs, acc_l[k])
            if k < 3 * N_LIMBS - 2:
                ck = qcarry(k)
                lhs = o.sub(lhs, o.mul(base, ck))
                prev = ck
            c.constraint(o.mul(g, lhs))

        # out < N: borrow chain on N - out - 1 >= 0 (divmod pattern)
        for i in range(N_LIMBS):
            cin = carries[i - 1] if i > 0 else one
            expr = o.sub(
                o.add(
                    o.sub(o.sub(n_limbs[i], out[i]), cin),
                    o.mul(base, carries[i]),
                ),
                ctx.local(SCRATCH[i]),
            )
            c.constraint(o.mul(g, expr))
        c.constraint(o.mul(g, carries[N_LIMBS - 1]))

    # -- BYTE --------------------------------------------------------------------

    def _eval_byte(self, ctx, sels, a, b, out):
        c, o = ctx.consumer, ctx.ops
        is_byte = sels[8]
        # 32-slot one-hot over little-endian byte position j = 31 - index
        sel = [ctx.local(i) for i in KSEL] + [ctx.local(i) for i in TSEL]
        v = ctx.local(B_VALID)
        b0_hi = ctx.local(B0_HI)
        idx5 = ctx.local(IDX5)
        blo = ctx.local(BYTE_LO)
        bhi = ctx.local(BYTE_HI)
        blo_sc = ctx.local(BYTE_LO_SC)

        # index low limb decomposition: exact over Z with both parts
        # range-checked 16-bit; when v = 1, bigsum = 0 forces B0_HI = 0 so
        # IDX5 = b_0 = the true index, and j_lin below pins the slot
        c.constraint(
            o.mul(
                is_byte,
                o.sub(b[0], o.add(o.mul(o.constant(32), b0_hi), idx5)),
            )
        )
        # one-hot sums to validity bit; selected slot matches the index
        s_all = sel[0]
        j_lin = o.mul(o.constant(31), sel[0])
        for j in range(1, 32):
            s_all = o.add(s_all, sel[j])
            j_lin = o.add(j_lin, o.mul(o.constant(31 - j), sel[j]))
        c.constraint(o.mul(is_byte, o.sub(s_all, v)))
        c.constraint(o.mul(is_byte, o.sub(j_lin, o.mul(v, idx5))))
        # selected limb splits into bytes; BYTE_LO < 256 via scaled check,
        # BYTE_HI < 256 then follows over Z from limb < 2^16
        limb_sel = None
        half_sel = None
        for j in range(32):
            t1 = o.mul(sel[j], a[j >> 1])
            limb_sel = t1 if limb_sel is None else o.add(limb_sel, t1)
            t2 = o.mul(sel[j], bhi if (j & 1) else blo)
            half_sel = t2 if half_sel is None else o.add(half_sel, t2)
        c.constraint(
            o.mul(
                is_byte,
                o.sub(limb_sel, o.add(o.mul(o.constant(256), bhi), blo)),
            )
        )
        c.constraint(o.mul(is_byte, o.sub(blo_sc, o.mul(o.constant(256), blo))))
        c.constraint(o.mul(is_byte, o.sub(out[0], half_sel)))
        for i in range(1, N_LIMBS):
            c.constraint(o.mul(is_byte, out[i]))

    # -- SIGNEXTEND --------------------------------------------------------------

    def _eval_sext(self, ctx, sels, a, b, out):
        """SIGNEXTEND(b=index, x=in0): bytes above LE byte `index` fill
        with the sign bit of byte `index`. Reuses the 32-slot one-hot as
        a DIRECT byte-position selector (no 31-j flip) and the BYTE limb
        split; the selected byte's sign splits as 0x80*SX_S + SX_LOW7
        with 512*SX_LOW7 range-checked (reusing MCLO[4]). Index >= 32
        (v = 0) leaves the value unchanged — consensus semantics (index
        31 is an ordinary slot whose fill region is empty)."""
        c, o = ctx.consumer, ctx.ops
        one = o.one()
        is_sext = sels[13]
        sel = [ctx.local(i) for i in KSEL] + [ctx.local(i) for i in TSEL]
        v = ctx.local(B_VALID)
        b0_hi = ctx.local(B0_HI)
        idx5 = ctx.local(IDX5)
        blo = ctx.local(BYTE_LO)
        bhi = ctx.local(BYTE_HI)
        blo_sc = ctx.local(BYTE_LO_SC)
        sx_s, sx_l7 = ctx.local(SX_S), ctx.local(SX_LOW7)
        c.constraint(o.mul(sx_s, o.sub(sx_s, one)))
        # index decomposition + DIRECT slot binding (slot j == index)
        c.constraint(
            o.mul(
                is_sext,
                o.sub(b[0], o.add(o.mul(o.constant(32), b0_hi), idx5)),
            )
        )
        s_all = sel[0]
        j_lin = o.mul(o.constant(0), sel[0])
        for j in range(1, 32):
            s_all = o.add(s_all, sel[j])
            j_lin = o.add(j_lin, o.mul(o.constant(j), sel[j]))
        c.constraint(o.mul(is_sext, o.sub(s_all, v)))
        c.constraint(o.mul(is_sext, o.sub(j_lin, o.mul(v, idx5))))
        # selected limb split (the BYTE columns, is_sext-gated)
        limb_sel = None
        half_sel = None
        for j in range(32):
            t1 = o.mul(sel[j], a[j >> 1])
            limb_sel = t1 if limb_sel is None else o.add(limb_sel, t1)
            t2 = o.mul(sel[j], bhi if (j & 1) else blo)
            half_sel = t2 if half_sel is None else o.add(half_sel, t2)
        c.constraint(
            o.mul(
                is_sext,
                o.sub(limb_sel, o.add(o.mul(o.constant(256), bhi), blo)),
            )
        )
        c.constraint(o.mul(is_sext, o.sub(blo_sc, o.mul(o.constant(256), blo))))
        # sign of the selected byte
        c.constraint(
            o.mul(
                is_sext,
                o.sub(half_sel, o.add(o.mul(o.constant(0x80), sx_s), sx_l7)),
            )
        )
        c.constraint(
            o.mul(
                is_sext,
                o.sub(ctx.local(MCLO[4]), o.mul(o.constant(512), sx_l7)),
            )
        )
        # outputs: keep limbs at or below the boundary, fill above; on an
        # even boundary the limb's high byte takes the fill
        for i in range(N_LIMBS):
            acc = o.mul(o.sub(one, v), a[i])  # index >= 32: unchanged
            for j in range(32):
                if j >= 2 * i + 1:
                    t = o.mul(sel[j], a[i])
                elif j == 2 * i:
                    t = o.mul(
                        sel[j],
                        o.add(blo, o.mul(o.constant(0xFF00), sx_s)),
                    )
                else:
                    t = o.mul(sel[j], o.mul(o.constant(0xFFFF), sx_s))
                acc = o.add(acc, t)
            c.constraint(o.mul(is_sext, o.sub(out[i], acc)))


def fill_row(tr: np.ndarray, r: int, req: Tuple) -> int:
    """Fill row r of `tr` for one request (op, a, b) or (op, a, b, n);
    -> the result. `generate_trace` without the range pass, one row."""
    op, a, b = req[0], req[1], req[2]
    n2 = req[3] if len(req) > 3 else 0
    a_l, b_l, n_l = int_to_limbs(a), int_to_limbs(b), int_to_limbs(n2)
    tr[OP_ID, r] = op
    tr[FILTER, r] = 1
    tr[_SEL_OF_OP[op], r] = 1
    for i in range(N_LIMBS):
        tr[IN0[i], r] = a_l[i]
        tr[IN1[i], r] = b_l[i]
        tr[IN2[i], r] = n_l[i]
    if op == OP_ADD:
        res = (a + b) % (1 << 256)
        out_l = int_to_limbs(res)
        carry = 0
        for i in range(N_LIMBS):
            s = a_l[i] + b_l[i] + carry
            carry = s >> 16
            tr[CARRY[i], r] = carry
            tr[OUT[i], r] = out_l[i]
    elif op in (OP_SUB, OP_LT):
        diff = (a - b) % (1 << 256)
        d_l = int_to_limbs(diff)
        borrow = 0
        for i in range(N_LIMBS):
            s = a_l[i] - b_l[i] - borrow
            borrow = 1 if s < 0 else 0
            tr[CARRY[i], r] = borrow
        if op == OP_SUB:
            res = diff
            for i in range(N_LIMBS):
                tr[OUT[i], r] = d_l[i]
        else:
            res = 1 if a < b else 0
            tr[OUT[0], r] = res
            for i in range(N_LIMBS):
                tr[SCRATCH[i], r] = d_l[i]
    elif op == OP_MUL:
        res = (a * b) % (1 << 256)
        out_l = int_to_limbs(res)
        carry = 0
        for k in range(N_LIMBS):
            acc = sum(a_l[i] * b_l[k - i] for i in range(k + 1)) + carry
            out_k = acc & 0xFFFF
            assert out_k == out_l[k]
            carry = acc >> 16
            tr[OUT[k], r] = out_k
            tr[MCLO[k], r] = carry & 0xFFFF
            tr[MCHI[k], r] = carry >> 16
    elif op in (OP_DIV, OP_MOD):
        res = _fill_divmod(tr, r, op, a, b, a_l, b_l)
    elif op in (OP_SHR, OP_SHL):
        res = _fill_shift(tr, r, op, a, b, a_l, b_l)
    elif op == OP_SAR:
        res = _fill_sar(tr, r, a, b, a_l, b_l)
    elif op == OP_SEXT:
        res = _fill_sext(tr, r, a, b, a_l, b_l)
    elif op == OP_BYTE:
        res = _fill_byte(tr, r, a, b, a_l, b_l)
    elif op == OP_SLT:
        sa, sb = a >> 255, b >> 255
        tr[SGN0, r], tr[SGN1, r] = sa, sb
        l0 = a_l[15] - 0x8000 * sa
        l1 = b_l[15] - 0x8000 * sb
        tr[MCLO[0], r], tr[MCLO[1], r] = l0, l1
        tr[MCLO[2], r], tr[MCLO[3], r] = 2 * l0, 2 * l1
        a2, b2 = a ^ (1 << 255), b ^ (1 << 255)
        d_l = int_to_limbs((a2 - b2) % (1 << 256))
        a2_l, b2_l = int_to_limbs(a2), int_to_limbs(b2)
        borrow = 0
        for i in range(N_LIMBS):
            s_ = a2_l[i] - b2_l[i] - borrow
            borrow = 1 if s_ < 0 else 0
            tr[CARRY[i], r] = borrow
            tr[SCRATCH[i], r] = d_l[i]
        res = 1 if a2 < b2 else 0
        tr[OUT[0], r] = res
    elif op in (OP_ADDMOD, OP_MULMOD):
        res = _fill_modop(tr, r, op, a, b, n2, a_l, b_l)
    else:
        raise ValueError(f"unknown arithmetic op {op}")
    return res



def generate_trace(
    requests: List[Tuple], n_rows: int
) -> Tuple[np.ndarray, List[int]]:
    """requests: [(op, a, b)] or [(op, a, b, n)] (ternary modops)
    -> (trace (NUM_COLUMNS, n_rows) u64, results).

    The fixed range column is min(row, 2^16-1): production (n >= 2^16)
    proves a sound 16-bit bound; smaller test tables only bound limbs by
    n and must use correspondingly small values.
    """
    assert len(requests) <= n_rows
    bound = min(n_rows, RANGE_BOUND)
    tr = np.zeros((NUM_COLUMNS, n_rows), dtype=np.uint64)
    results: List[int] = []

    for r, req in enumerate(requests):
        results.append(fill_row(tr, r, req))

    # one logUp multiplicity pass over every range-checked cell (request
    # AND padding rows — padding contributes zeros)
    vals = tr[np.asarray(RANGE_CHECKED, dtype=np.intp)]
    if vals.size:
        mx = int(vals.max())
        assert mx < bound, (
            f"range-checked value {mx} exceeds range table (bound {bound})"
        )
    tr[RC_MULT] = np.bincount(
        vals.ravel().astype(np.int64), minlength=n_rows
    )[:n_rows].astype(np.uint64)
    return tr, results


def _fill_divmod(tr, r, op, a, b, a_l, b_l) -> int:
    if b:
        q, rem = divmod(a, b)
        tr[B_NZ, r] = 1
        tr[G_DIV, r] = 1
        tr[BINV, r] = fh.inv(sum(b_l) % fh.P)
    else:
        q = rem = 0
    res = q if op == OP_DIV else rem
    q_l, r_l = int_to_limbs(q), int_to_limbs(rem)
    out_l = int_to_limbs(res)
    for i in range(N_LIMBS):
        tr[QUO[i], r] = q_l[i]
        tr[REM[i], r] = r_l[i]
        tr[OUT[i], r] = out_l[i]
    if not b:
        return res
    # convolution carries for QUO * b + REM == a (limbs 0..30)
    carry = 0
    for k in range(2 * N_LIMBS - 1):
        conv = sum(
            q_l[i] * b_l[k - i]
            for i in range(max(0, k - (N_LIMBS - 1)), min(k, N_LIMBS - 1) + 1)
        )
        tot = conv + (r_l[k] if k < N_LIMBS else 0) + carry
        expect = a_l[k] if k < N_LIMBS else 0
        assert tot & 0xFFFF == expect, "divmod identity broke"
        carry = tot >> 16
        if k < N_LIMBS:
            tr[MCLO[k], r] = carry & 0xFFFF
            tr[MCHI[k], r] = carry >> 16
        elif k < 2 * N_LIMBS - 2:
            tr[DCLO2[k - N_LIMBS], r] = carry & 0xFFFF
            tr[DCHI2[k - N_LIMBS], r] = carry >> 16
    assert carry == 0
    # REM < b as b - rem - 1 >= 0: borrow chain with small scratch limbs
    borrow = 1  # the -1 enters as an initial borrow at limb 0
    for i in range(N_LIMBS):
        s = b_l[i] - r_l[i] - borrow
        borrow = 1 if s < 0 else 0
        tr[CARRY[i], r] = borrow
        tr[SCRATCH[i], r] = s + (LIMB_BASE if borrow else 0)
    assert borrow == 0, "remainder >= divisor"
    return res


def _fill_shift(tr, r, op, a, b, a_l, b_l) -> int:
    valid = b < 256
    if valid:
        res = (a << b) % (1 << 256) if op == OP_SHL else a >> b
        k, t = b >> 4, b & 15
        tr[B_VALID, r] = 1
        tr[KSEL[k], r] = 1
        tr[TSEL[t], r] = 1
    else:
        res = 0
        tr[G_SHIFT, r] = 1
        b0_hi = b_l[0] >> 8
        tr[B0_HI, r] = b0_hi
        bigsum = (b0_hi + sum(b_l[1:])) % fh.P
        tr[BIGINV, r] = fh.inv(bigsum)
        t = 0  # selector banks all zero; pow2t = 0 -> lo = hi = 0 (SHL)
    out_l = int_to_limbs(res)
    for i in range(N_LIMBS):
        tr[OUT[i], r] = out_l[i]
    if op == OP_SHL:
        if valid:
            for i in range(N_LIMBS):
                prod = a_l[i] << t
                tr[SH_HI[i], r] = prod >> 16
                tr[SH_LO[i], r] = prod & 0xFFFF
    else:  # SHR
        if valid:
            for i in range(N_LIMBS):
                tr[SH_HI[i], r] = a_l[i] >> t
                lo = a_l[i] & ((1 << t) - 1)
                tr[SH_LO[i], r] = lo
                tr[SHR_SCALED[i], r] = lo << (16 - t)
        else:
            # pow2t = 0: a_i = 0*hi + lo forces lo = a_i; scaled = lo*0 = 0
            for i in range(N_LIMBS):
                tr[SH_LO[i], r] = a_l[i]
    return res


def _fill_sar(tr, r, a, b, a_l, b_l) -> int:
    sign = a >> 255
    tr[SGN0, r] = sign
    l0 = a_l[15] - 0x8000 * sign
    tr[MCLO[0], r] = l0
    tr[MCLO[2], r] = 2 * l0
    tr[G_SAR, r] = sign
    valid = b < 256
    if valid:
        shr = a >> b
        mask = ((1 << 256) - (1 << (256 - b))) if b else 0
        res = shr | mask if sign else shr
        k, t = b >> 4, b & 15
        tr[B_VALID, r] = 1
        tr[KSEL[k], r] = 1
        tr[TSEL[t], r] = 1
        for i in range(N_LIMBS):
            tr[SH_HI[i], r] = a_l[i] >> t
            lo = a_l[i] & ((1 << t) - 1)
            tr[SH_LO[i], r] = lo
            tr[SHR_SCALED[i], r] = lo << (16 - t)
    else:
        res = (1 << 256) - 1 if sign else 0
        tr[G_SHIFT, r] = 1
        b0_hi = b_l[0] >> 8
        tr[B0_HI, r] = b0_hi
        bigsum = (b0_hi + sum(b_l[1:])) % fh.P
        tr[BIGINV, r] = fh.inv(bigsum)
        for i in range(N_LIMBS):
            tr[SH_LO[i], r] = a_l[i]
    out_l = int_to_limbs(res)
    for i in range(N_LIMBS):
        tr[OUT[i], r] = out_l[i]
    return res


def _fill_sext(tr, r, a, b, a_l, b_l) -> int:
    valid = b < 32
    if valid:
        j = b
        sel = KSEL[j] if j < 16 else TSEL[j - 16]
        tr[sel, r] = 1
        tr[B_VALID, r] = 1
        tr[IDX5, r] = j
        limb = a_l[j >> 1]
        blo, bhi = limb & 0xFF, limb >> 8
        tr[BYTE_LO, r], tr[BYTE_HI, r] = blo, bhi
        tr[BYTE_LO_SC, r] = blo << 8
        sbyte = bhi if (j & 1) else blo
        sign = sbyte >> 7
        tr[SX_S, r] = sign
        low7 = sbyte & 0x7F
        tr[SX_LOW7, r] = low7
        tr[MCLO[4], r] = 512 * low7
        bits = 8 * (j + 1)
        low = a & ((1 << bits) - 1)
        res = low | ((1 << 256) - (1 << bits)) if sign else low
    else:
        res = a
        # BYTE-style invalidity: b0 = 32*b0_hi + idx5 with bigsum nonzero
        b0_hi, idx5 = b_l[0] >> 5, b_l[0] & 31
        tr[B0_HI, r] = b0_hi
        tr[IDX5, r] = idx5
        tr[G_SHIFT, r] = 1  # g_sh = uses_v * (1 - v)
        bigsum = (b0_hi + sum(b_l[1:])) % fh.P
        tr[BIGINV, r] = fh.inv(bigsum)
    out_l = int_to_limbs(res)
    for i in range(N_LIMBS):
        tr[OUT[i], r] = out_l[i]
    return res


def _fill_modop(tr, r, op, a, b, n2, a_l, b_l) -> int:
    acc = a + b if op == OP_ADDMOD else a * b
    if n2 == 0:
        res = 0
        acc_l = [(acc >> (16 * k)) & 0xFFFF for k in range(2 * N_LIMBS)]
        for k in range(2 * N_LIMBS):
            tr[ACC[k], r] = acc_l[k]
        # identity-A carries for the zero-modulus row too (A is gated by
        # the op selector, not by M_NZ)
        _fill_acc_carries(tr, r, op, a_l, b_l, acc_l)
        return 0
    n_l = int_to_limbs(n2)
    q, res = divmod(acc, n2)
    tr[M_NZ, r] = 1
    tr[G_MOD, r] = 1
    tr[MINV, r] = fh.inv(sum(n_l) % fh.P)
    acc_l = [(acc >> (16 * k)) & 0xFFFF for k in range(2 * N_LIMBS)]
    q_l = [(q >> (16 * k)) & 0xFFFF for k in range(2 * N_LIMBS)]
    out_l = int_to_limbs(res)
    for k in range(2 * N_LIMBS):
        tr[ACC[k], r] = acc_l[k]
        tr[(QUO + REM)[k], r] = q_l[k]
    for i in range(N_LIMBS):
        tr[OUT[i], r] = out_l[i]
    _fill_acc_carries(tr, r, op, a_l, b_l, acc_l)
    # identity B carries
    carry = 0
    for k in range(3 * N_LIMBS - 1):
        conv = sum(
            q_l[i] * n_l[k - i]
            for i in range(max(0, k - (N_LIMBS - 1)), min(k, 2 * N_LIMBS - 1) + 1)
        )
        tot = conv + (out_l[k] if k < N_LIMBS else 0) + carry
        expect = acc_l[k] if k < 2 * N_LIMBS else 0
        assert tot & 0xFFFF == expect, "modop identity broke"
        carry = tot >> 16
        if k < N_LIMBS:
            tr[MCLO[k], r] = carry & 0xFFFF
            tr[MCHI[k], r] = carry >> 16
        elif k < 2 * N_LIMBS - 2:
            tr[DCLO2[k - N_LIMBS], r] = carry & 0xFFFF
            tr[DCHI2[k - N_LIMBS], r] = carry >> 16
        elif k < 3 * N_LIMBS - 2:
            tr[QC2LO[k - (2 * N_LIMBS - 2)], r] = carry & 0xFFFF
            tr[QC2HI[k - (2 * N_LIMBS - 2)], r] = carry >> 16
    assert carry == 0
    # out < N borrow chain
    borrow = 1
    for i in range(N_LIMBS):
        s = n_l[i] - out_l[i] - borrow
        borrow = 1 if s < 0 else 0
        tr[CARRY[i], r] = borrow
        tr[SCRATCH[i], r] = s + (LIMB_BASE if borrow else 0)
    assert borrow == 0, "modop remainder >= modulus"
    return res


def _fill_acc_carries(tr, r, op, a_l, b_l, acc_l) -> None:
    carry = 0
    for k in range(2 * N_LIMBS - 1):
        if op == OP_ADDMOD:
            lhs = (a_l[k] + b_l[k]) if k < N_LIMBS else 0
        else:
            lhs = sum(
                a_l[i] * b_l[k - i]
                for i in range(max(0, k - (N_LIMBS - 1)), min(k, N_LIMBS - 1) + 1)
            )
        tot = lhs + carry
        assert tot & 0xFFFF == acc_l[k]
        carry = tot >> 16
        tr[ACLO[k], r] = carry & 0xFFFF
        tr[ACHI[k], r] = carry >> 16
    assert carry == acc_l[2 * N_LIMBS - 1]


def _fill_byte(tr, r, a, b, a_l, b_l) -> int:
    """EVM BYTE: in0 = value, in1 = index i from the MSB; i >= 32 -> 0."""
    idx5 = b_l[0] & 31
    b0_hi = b_l[0] >> 5
    tr[IDX5, r] = idx5
    tr[B0_HI, r] = b0_hi
    valid = b < 32
    if valid:
        j = 31 - b  # little-endian byte position
        limb = a_l[j >> 1]
        lo, hi = limb & 0xFF, limb >> 8
        tr[B_VALID, r] = 1
        if j < 16:
            tr[KSEL[j], r] = 1
        else:
            tr[TSEL[j - 16], r] = 1
        tr[BYTE_LO, r] = lo
        tr[BYTE_HI, r] = hi
        tr[BYTE_LO_SC, r] = lo << 8
        res = hi if (j & 1) else lo
    else:
        bigsum = (b0_hi + sum(b_l[1:])) % fh.P
        tr[BIGINV, r] = fh.inv(bigsum)
        tr[G_SHIFT, r] = 1
        res = 0
    tr[OUT[0], r] = res
    return res

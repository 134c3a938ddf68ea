"""CPU table: the kernel executor.

Counterpart: ethproof_tpu/tables/cpu.py:1 (a copy).

Reference equivalent: evm_arithmetization's CPU STARK — the Kernel, an
interpreter whose program drives every other table through cross-table
lookups [dep: from knowledge; pin Cargo.lock:1675; table
named at common/src/prover_state/circuit.rs:63].

Design: a micro-coded 3-address word machine whose PROGRAM is a
set of preprocessed (fixed) columns — the program ROM is part of the
circuit definition, evaluated analytically by the verifier (no
commitment), exactly the role the reference's assembly kernel plays.
Every active row:

  IN0 <- memory[(0, 1, F_SRC0)] @ ts=3*clk      (CTL -> Memory)
  IN1 <- memory[(0, 1, F_SRC1)] @ ts=3*clk+1    (CTL -> Memory)
  OUT  = op(IN0, IN1)                           (CTL -> Arithmetic/Logic)
  memory[(0, 1, F_DST)] <- OUT @ ts=3*clk+2     (CTL -> Memory)

plus in-table ops: LOAD_PI (binds OUT to a public-input word via one-hot
fixed selectors), CONST (OUT = fixed immediate), ASSERT0 (IN0 must be 0),
COPY. Fresh memory reads are zero (Memory table semantics), which is what
LOAD_PI/CONST rows read.

256-bit words are 16 x 16-bit limbs; public inputs are flat limb lists
(16 per word). Range sanity of CPU values comes from their provenance:
every OUT is either an arithmetic/logic result (range-checked there), a
public input (checked by the outer protocol), or a fixed immediate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..stark.stark import CtlSpec, LC, Stark
from .arithmetic import (
    OP_ADD,
    OP_DIV,
    OP_LT,
    OP_MOD,
    OP_MUL,
    OP_SHL,
    OP_SHR,
    OP_SUB,
)
from .common import Cols, N_LIMBS, int_to_limbs, limbs_to_int
from .logic import OP_AND, OP_OR, OP_XOR
from .memory import MemoryOp

OP_NOP = 0
OP_LOAD_PI = 9
OP_CONST = 10
OP_ASSERT0 = 11
OP_COPY = 12
# OUT = prover-supplied word, written to dst with NO constraint — the
# kernel must validate every OP_WIT value with explicit asserts (the
# reference's ProverInput/prover_input! mechanism in the asm kernel).
OP_WIT = 17
# dynamic load: OUT = IN0 = memory[(0, 1, low32(IN1))] — the address is a
# COMPUTED word (the reference kernel's MLOAD_GENERAL). The src0 memory
# CTL reads at DYN_ADDR, a committed column constrained to
# F_IS_LOADW * (IN1[0] + 2^16 IN1[1]); on all other rows DYN_ADDR = 0 and
# the CTL reads at the program-fixed F_SRC0 (LC: F_SRC0 + DYN_ADDR).
OP_LOADW = 20
# declare a keccak sponge request starting at word F_IMM[0], ts F_IMM[1]
# (consumes the request's IS_FIRST sponge row via first_ctl_spec)
OP_HASH_START = 18
# OUT = keccak256 digest (LE word) of the request whose final block sits
# at word IN0 with final-block length IN1; ts F_IMM[0] (consumes the
# IS_FINAL sponge row via digest_ctl_spec)
OP_DIGEST = 19

ARITH_OPS = (OP_ADD, OP_SUB, OP_LT, OP_MUL, OP_DIV, OP_MOD, OP_SHR, OP_SHL)
LOGIC_OPS = (OP_AND, OP_OR, OP_XOR)

KERNEL_CTX = 0
KERNEL_SEG = 1

# witness columns
_c = Cols()
IN0 = _c.many(N_LIMBS)
IN1 = _c.many(N_LIMBS)
OUT = _c.many(N_LIMBS)
DYN_ADDR = _c.one()  # OP_LOADW effective address (0 on all other rows)
NUM_COLUMNS = _c.count


@dataclass(frozen=True)
class Instr:
    op: int
    src0: int = 0
    src1: int = 0
    dst: int = 0
    pi_word: int = -1  # LOAD_PI
    imm: int = 0  # CONST


class CpuStark(Stark):
    """One instance per PROGRAM (the program defines the fixed columns)."""

    num_columns = NUM_COLUMNS
    constraint_degree = 3
    lookups = []

    def __init__(self, program: List[Instr], num_pi_words: int):
        self.program = list(program)
        self.num_pi_words = num_pi_words
        self.num_public_inputs = num_pi_words * N_LIMBS
        # fixed layout
        f = Cols()
        self.F_ACTIVE = f.one()
        self.F_CLK = f.one()
        self.F_OP = f.one()
        self.F_IS_ARITH = f.one()
        self.F_IS_LOGIC = f.one()
        self.F_IS_LOADPI = f.one()
        self.F_IS_CONST = f.one()
        self.F_IS_ASSERT0 = f.one()
        self.F_IS_COPY = f.one()
        self.F_IS_HSTART = f.one()
        self.F_IS_DIGEST = f.one()
        self.F_IS_LOADW = f.one()
        self.F_SRC0 = f.one()
        self.F_SRC1 = f.one()
        self.F_DST = f.one()
        self.F_PI_SEL = f.many(num_pi_words)
        self.F_IMM = f.many(N_LIMBS)
        self.num_fixed_columns = f.count

    # -- fixed columns (program ROM) ----------------------------------------

    def fixed_columns(self, n: int) -> np.ndarray:
        assert len(self.program) <= n
        fx = np.zeros((self.num_fixed_columns, n), dtype=np.uint64)
        fx[self.F_CLK] = np.arange(n, dtype=np.uint64)
        for r, ins in enumerate(self.program):
            if ins.op == OP_NOP:
                continue
            fx[self.F_ACTIVE, r] = 1
            fx[self.F_OP, r] = ins.op
            fx[self.F_SRC0, r] = ins.src0
            fx[self.F_SRC1, r] = ins.src1
            fx[self.F_DST, r] = ins.dst
            if ins.op in ARITH_OPS:
                fx[self.F_IS_ARITH, r] = 1
            elif ins.op in LOGIC_OPS:
                fx[self.F_IS_LOGIC, r] = 1
            elif ins.op == OP_LOAD_PI:
                fx[self.F_IS_LOADPI, r] = 1
                fx[self.F_PI_SEL[ins.pi_word], r] = 1
            elif ins.op == OP_CONST:
                fx[self.F_IS_CONST, r] = 1
                for i, l in enumerate(int_to_limbs(ins.imm)):
                    fx[self.F_IMM[i], r] = l
            elif ins.op == OP_ASSERT0:
                fx[self.F_IS_ASSERT0, r] = 1
            elif ins.op == OP_COPY:
                fx[self.F_IS_COPY, r] = 1
            elif ins.op == OP_WIT:
                pass  # OUT unconstrained by design
            elif ins.op == OP_HASH_START:
                fx[self.F_IS_HSTART, r] = 1
                fx[self.F_IMM[0], r] = ins.imm & 0xFFFFFFFF  # virt
                fx[self.F_IMM[1], r] = ins.imm >> 32  # ts
            elif ins.op == OP_DIGEST:
                fx[self.F_IS_DIGEST, r] = 1
                fx[self.F_IMM[0], r] = ins.imm  # ts
            elif ins.op == OP_LOADW:
                fx[self.F_IS_LOADW, r] = 1
                assert ins.src0 == 0, "OP_LOADW src0 must be 0 (dynamic)"
            else:
                raise ValueError(f"unknown op {ins.op}")
        return fx

    # -- CTL specs (fixed columns addressed at offset NUM_COLUMNS) ----------

    def _f(self, i: int) -> int:
        return NUM_COLUMNS + i

    def arith_ctl_spec(self) -> CtlSpec:
        zero16 = [LC(terms=(), const=0)] * N_LIMBS  # binary ops: IN2 = 0
        return CtlSpec(
            columns=tuple([self._f(self.F_OP)] + IN0 + IN1 + zero16 + OUT),
            filter_col=self._f(self.F_IS_ARITH),
        )

    def logic_ctl_spec(self) -> CtlSpec:
        return CtlSpec(
            columns=tuple([self._f(self.F_OP)] + IN0 + IN1 + OUT),
            filter_col=self._f(self.F_IS_LOGIC),
        )

    def sponge_ctl_specs(self) -> List[CtlSpec]:
        """[first_spec, digest_spec] mirroring keccak_sponge.first_ctl_spec
        / digest_ctl_spec. Multiset-exact: every sponge request's first row
        is consumed by exactly one OP_HASH_START and its final row by
        exactly one OP_DIGEST, so the kernel cannot ignore or double-count
        a hash, and the sponge cannot smuggle unconsumed requests."""
        from .keccak_sponge import OP_KECCAK_DIGEST, OP_SPONGE_INIT

        first = CtlSpec(
            columns=tuple(
                [
                    LC(terms=(), const=OP_SPONGE_INIT),
                    LC(terms=(), const=KERNEL_CTX),
                    LC(terms=(), const=KERNEL_SEG),
                    self._f(self.F_IMM[0]),  # virt (static)
                    self._f(self.F_IMM[1]),  # ts (static)
                ]
            ),
            filter_col=self._f(self.F_IS_HSTART),
        )
        digest = CtlSpec(
            columns=tuple(
                [
                    LC(terms=(), const=OP_KECCAK_DIGEST),
                    LC(terms=(), const=KERNEL_CTX),
                    LC(terms=(), const=KERNEL_SEG),
                    # virt_final < 2^32: two limbs of the computed IN0 word
                    LC(terms=((IN0[0], 1), (IN0[1], 1 << 16)), const=0),
                    self._f(self.F_IMM[0]),  # ts (static)
                    LC(terms=((IN1[0], 1),), const=0),  # final-block len < 136
                ]
                + list(OUT)
            ),
            filter_col=self._f(self.F_IS_DIGEST),
        )
        return [first, digest]

    @property
    def uses_sponge(self) -> bool:
        return any(i.op in (OP_HASH_START, OP_DIGEST) for i in self.program)

    def memory_ctl_specs(self) -> List[CtlSpec]:
        """(ctx, seg, virt, ts, is_read, value...) x {read0, read1, write}."""
        out = []
        for which, (addr_col, k, is_read, val) in enumerate(
            (
                (self.F_SRC0, 0, 1, IN0),
                (self.F_SRC1, 1, 1, IN1),
                (self.F_DST, 2, 0, OUT),
            )
        ):
            if k == 0:
                # src0 address: program-fixed, plus the dynamic OP_LOADW
                # address (exactly one is nonzero per row — eval pins
                # DYN_ADDR to 0 off loadw rows and F_SRC0 is 0 on them)
                addr = LC(
                    terms=((self._f(addr_col), 1), (DYN_ADDR, 1)), const=0
                )
            else:
                addr = self._f(addr_col)
            cols: List = [
                LC(terms=(), const=KERNEL_CTX),
                LC(terms=(), const=KERNEL_SEG),
                addr,
                LC(terms=((self._f(self.F_CLK), 3),), const=k),
                LC(terms=(), const=is_read),
            ] + list(val)
            out.append(CtlSpec(columns=tuple(cols), filter_col=self._f(self.F_ACTIVE)))
        return out

    # -- constraints ---------------------------------------------------------

    def eval(self, ctx):
        c, o = ctx.consumer, ctx.ops
        in0 = ctx.local_stack(IN0)
        out = ctx.local_stack(OUT)
        # LOAD_PI: one vec constraint per word
        for w in range(self.num_pi_words):
            sel = ctx.fixed(self.F_PI_SEL[w])
            pi = ctx.public_stack(range(w * N_LIMBS, (w + 1) * N_LIMBS))
            c.constraint_vec(o.mul(sel, o.sub(out, pi)))
        # CONST: OUT = immediate
        imm = ctx.fixed_stack(self.F_IMM)
        c.constraint_vec(o.mul(ctx.fixed(self.F_IS_CONST), o.sub(out, imm)))
        # ASSERT0: IN0 == 0
        c.constraint_vec(o.mul(ctx.fixed(self.F_IS_ASSERT0), in0))
        # ASSERT0 / COPY / LOADW: OUT = IN0
        copyish = o.add(
            o.add(ctx.fixed(self.F_IS_ASSERT0), ctx.fixed(self.F_IS_COPY)),
            ctx.fixed(self.F_IS_LOADW),
        )
        c.constraint_vec(o.mul(copyish, o.sub(out, in0)))
        # DYN_ADDR = is_loadw * low32(IN1); zero elsewhere
        low32 = o.add(
            ctx.local(IN1[0]),
            o.mul(o.constant(1 << 16), ctx.local(IN1[1])),
        )
        c.constraint(
            o.sub(
                ctx.local(DYN_ADDR), o.mul(ctx.fixed(self.F_IS_LOADW), low32)
            )
        )


# -- host execution (trace generation) ---------------------------------------


@dataclass
class CpuTraceResult:
    trace: np.ndarray
    mem_ops: List[MemoryOp]
    arith_requests: List[Tuple[int, int, int]]
    logic_requests: List[Tuple[int, int, int]]


def execute(
    program: List[Instr],
    pi_words: List[int],
    n_rows: int,
    witness: Optional[List[int]] = None,
) -> CpuTraceResult:
    """Run the kernel on host, emitting the CPU trace + table requests.

    `witness` feeds OP_WIT and OP_DIGEST rows in program order (the
    digest values are part of the witness; the sponge CTL is what forces
    them to be the true keccak256 outputs)."""
    assert len(program) <= n_rows
    wit_iter = iter(witness or ())
    tr = np.zeros((NUM_COLUMNS, n_rows), dtype=np.uint64)
    memory: Dict[int, int] = {}
    mem_ops: List[MemoryOp] = []
    arith: List[Tuple[int, int, int]] = []
    logic: List[Tuple[int, int, int]] = []
    for clk, ins in enumerate(program):
        if ins.op == OP_NOP:
            continue
        b = memory.get(ins.src1, 0)
        if ins.op == OP_LOADW:
            src0 = b & 0xFFFFFFFF  # dynamic address = low32(IN1)
            tr[DYN_ADDR, clk] = src0
        else:
            src0 = ins.src0
        a = memory.get(src0, 0)
        mem_ops.append(MemoryOp(KERNEL_CTX, KERNEL_SEG, src0, 3 * clk, 1, a))
        mem_ops.append(MemoryOp(KERNEL_CTX, KERNEL_SEG, ins.src1, 3 * clk + 1, 1, b))
        if ins.op == OP_ADD:
            res = (a + b) % (1 << 256)
            arith.append((OP_ADD, a, b))
        elif ins.op == OP_SUB:
            res = (a - b) % (1 << 256)
            arith.append((OP_SUB, a, b))
        elif ins.op == OP_LT:
            res = 1 if a < b else 0
            arith.append((OP_LT, a, b))
        elif ins.op == OP_MUL:
            res = (a * b) % (1 << 256)
            arith.append((OP_MUL, a, b))
        elif ins.op == OP_DIV:
            res = a // b if b else 0  # EVM: x / 0 = 0
            arith.append((OP_DIV, a, b))
        elif ins.op == OP_MOD:
            res = a % b if b else 0  # EVM: x % 0 = 0
            arith.append((OP_MOD, a, b))
        elif ins.op == OP_SHR:
            res = a >> b if b < 256 else 0
            arith.append((OP_SHR, a, b))
        elif ins.op == OP_SHL:
            res = (a << b) % (1 << 256) if b < 256 else 0
            arith.append((OP_SHL, a, b))
        elif ins.op == OP_AND:
            res = a & b
            logic.append((OP_AND, a, b))
        elif ins.op == OP_OR:
            res = a | b
            logic.append((OP_OR, a, b))
        elif ins.op == OP_XOR:
            res = a ^ b
            logic.append((OP_XOR, a, b))
        elif ins.op == OP_LOAD_PI:
            res = pi_words[ins.pi_word]
        elif ins.op == OP_CONST:
            res = ins.imm
        elif ins.op in (OP_ASSERT0, OP_COPY):
            if ins.op == OP_ASSERT0 and a != 0:
                raise AssertionError(f"kernel assert failed at clk {clk}")
            res = a
        elif ins.op in (OP_WIT, OP_DIGEST):
            res = next(wit_iter)
        elif ins.op == OP_HASH_START:
            res = 0
        elif ins.op == OP_LOADW:
            res = a
        else:
            raise ValueError(f"unknown op {ins.op}")
        memory[ins.dst] = res
        mem_ops.append(MemoryOp(KERNEL_CTX, KERNEL_SEG, ins.dst, 3 * clk + 2, 0, res))
        for i, l in enumerate(int_to_limbs(a)):
            tr[IN0[i], clk] = l
        for i, l in enumerate(int_to_limbs(b)):
            tr[IN1[i], clk] = l
        for i, l in enumerate(int_to_limbs(res)):
            tr[OUT[i], clk] = l
    return CpuTraceResult(tr, mem_ops, arith, logic)


def pi_limbs(pi_words: List[int]) -> List[int]:
    out: List[int] = []
    for w in pi_words:
        out.extend(int_to_limbs(w))
    return out

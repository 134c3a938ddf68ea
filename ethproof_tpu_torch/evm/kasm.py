"""Kernel assembler: gadget library for straight-line CPU-table programs.

Counterpart: ethproof_tpu/evm/kasm.py:1 (a copy).

Reference equivalent: evm_arithmetization's zkEVM assembly macro layer —
the kernel asm's `%macro` gadgets (mload_packing, prover_input, keccak
dispatch) that the Rust Kernel assembles into its interpreter program
[dep: from knowledge; pin Cargo.lock:1675]. Here the
"assembler" is a python builder emitting `tables.cpu.Instr` lists plus,
in concrete mode, the matching OP_WIT/OP_DIGEST witness stream and
sponge HashRequests.

Two build modes, one code path:

- concrete=True (prover): every `wit(fn)` evaluates `fn()` against the
  builder's host memory model, growing the witness stream; `keccak_*`
  grows the HashRequest list.
- concrete=False (verifier): only the instruction stream is produced —
  value thunks are never called. Builder code must therefore never
  branch on model values; the PROGRAM shape is a pure function of the
  builder's static parameters (the same contract as plonky2 circuit
  generators vs their witness generation).

All words are 256-bit. Untrusted OP_WIT values must be validated by
emitted asserts — helpers here (`wit_bool`, `extract`, `byte_at`) do so
where they introduce witnesses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..hash.keccak import keccak256
from ..tables.cpu import (
    Instr,
    OP_ADD,
    OP_AND,
    OP_ASSERT0,
    OP_CONST,
    OP_COPY,
    OP_DIGEST,
    OP_DIV,
    OP_HASH_START,
    OP_LOAD_PI,
    OP_LOADW,
    OP_LT,
    OP_MOD,
    OP_MUL,
    OP_OR,
    OP_SHL,
    OP_SHR,
    OP_SUB,
    OP_WIT,
    OP_XOR,
)
from ..tables.keccak_sponge import HashRequest, RATE_BYTES

KERNEL_CTX = 0
KERNEL_SEG = 1

M256 = (1 << 256) - 1


def le_word(b: bytes) -> int:
    """The kernel-word encoding of a byte string: little-endian packing
    (matches the sponge's staged-word and digest layouts)."""
    assert len(b) <= 32
    return int.from_bytes(b, "little")


@dataclass
class PendingHash:
    virt: int
    ts: int
    message: bytes


class KAsm:
    """Straight-line kernel builder. Registers are memory cells in
    (KERNEL_CTX, KERNEL_SEG); `alloc_region` reserves static word arrays
    (node staging areas) disjoint from scratch temporaries."""

    def __init__(self, concrete: bool = True, region_words: int = 0):
        self.concrete = concrete
        self.prog: List[Instr] = []
        self.witness: List[int] = []
        self.requests: List[PendingHash] = []
        self.mem: Dict[int, int] = {}
        # address space must stay compact: the Memory table range-checks
        # addresses against its own size. Regions (node staging) occupy
        # [16, 16 + region_words); temporaries follow.
        self._region_next = 16
        self._region_end = 16 + region_words
        self._next = self._region_end
        self._consts: Dict[int, int] = {}
        self._ts_next = 0

    # -- register / region allocation -----------------------------------------

    def _reg(self) -> int:
        r = self._next
        self._next += 1
        return r

    def alloc_region(self, n_words: int) -> int:
        """Static word array inside the pre-declared region space."""
        base = self._region_next
        self._region_next += n_words
        assert self._region_next <= self._region_end, (
            "region space exhausted: pass a larger region_words to KAsm"
        )
        return base

    # -- host model ------------------------------------------------------------

    def val(self, r: int) -> int:
        """Host-model value of a register (concrete mode only)."""
        return self.mem.get(r, 0)

    def _emit(self, ins: Instr, res: Optional[int]) -> int:
        self.prog.append(ins)
        if self.concrete and res is not None:
            self.mem[ins.dst] = res & M256
        return ins.dst

    # -- primitive ops ----------------------------------------------------------

    def const(self, v: int) -> int:
        v &= M256
        if v in self._consts:
            return self._consts[v]
        d = self._reg()
        self._emit(Instr(OP_CONST, dst=d, imm=v), v)
        self._consts[v] = d
        return d

    def _bin(self, op: int, a: int, b: int, f) -> int:
        d = self._reg()
        res = f(self.val(a), self.val(b)) if self.concrete else None
        return self._emit(Instr(op, src0=a, src1=b, dst=d), res)

    def add(self, a, b):
        return self._bin(OP_ADD, a, b, lambda x, y: x + y)

    def sub(self, a, b):
        return self._bin(OP_SUB, a, b, lambda x, y: x - y)

    def mul(self, a, b):
        return self._bin(OP_MUL, a, b, lambda x, y: x * y)

    def div(self, a, b):
        return self._bin(OP_DIV, a, b, lambda x, y: x // y if y else 0)

    def mod(self, a, b):
        return self._bin(OP_MOD, a, b, lambda x, y: x % y if y else 0)

    def lt(self, a, b):
        return self._bin(OP_LT, a, b, lambda x, y: 1 if x < y else 0)

    def shr(self, a, b):
        return self._bin(OP_SHR, a, b, lambda x, y: x >> y if y < 256 else 0)

    def shl(self, a, b):
        return self._bin(
            OP_SHL, a, b, lambda x, y: (x << y) & M256 if y < 256 else 0
        )

    def and_(self, a, b):
        return self._bin(OP_AND, a, b, lambda x, y: x & y)

    def or_(self, a, b):
        return self._bin(OP_OR, a, b, lambda x, y: x | y)

    def xor(self, a, b):
        return self._bin(OP_XOR, a, b, lambda x, y: x ^ y)

    def read(self, addr: int) -> int:
        """Read a STATIC address into a fresh register (COPY)."""
        d = self._reg()
        return self._emit(
            Instr(OP_COPY, src0=addr, dst=d),
            self.mem.get(addr, 0) if self.concrete else None,
        )

    def copy_to(self, src: int, dst: int) -> int:
        """Write register `src`'s word to static address `dst`."""
        return self._emit(
            Instr(OP_COPY, src0=src, dst=dst), self.val(src) if self.concrete else None
        )

    def load_pi(self, word: int, value: Optional[int] = None) -> int:
        d = self._reg()
        return self._emit(
            Instr(OP_LOAD_PI, dst=d, pi_word=word),
            value if self.concrete else None,
        )

    def assert0(self, a: int) -> None:
        if self.concrete and self.val(a) != 0:
            raise AssertionError(
                f"kasm assert0 fails at instr {len(self.prog)}: {self.val(a):#x}"
            )
        self._emit(Instr(OP_ASSERT0, src0=a, dst=self._reg()), 0)

    def assert_eq(self, a: int, b: int) -> None:
        self.assert0(self.sub(a, b))

    def wit(self, fn: Callable[[], int]) -> int:
        """Untrusted prover input; `fn` is evaluated only in concrete mode.
        The CALLER must constrain the value."""
        d = self._reg()
        v = None
        if self.concrete:
            v = fn() & M256
            self.witness.append(v)
        return self._emit(Instr(OP_WIT, dst=d), v)

    def wit_to(self, dst: int, fn: Callable[[], int]) -> int:
        """Untrusted prover input written to a STATIC address (region
        staging). The caller must constrain the value."""
        v = None
        if self.concrete:
            v = fn() & M256
            self.witness.append(v)
        return self._emit(Instr(OP_WIT, dst=dst), v)

    def stage_bytes(self, base: int, data: Callable[[], bytes], n_words: int) -> None:
        """Stage a byte string at region `base` in sponge word layout
        (5 words per 136-byte block, LE within words). All n_words are
        written (zero-padded) so re-proving with shorter data leaves no
        stale words."""

        def word_fn(w: int) -> Callable[[], int]:
            def fn() -> int:
                msg = data()
                blk, u = divmod(w, 5)
                start = blk * RATE_BYTES + 32 * u
                width = 8 if u == 4 else 32
                chunk = msg[start : start + width]
                return le_word(chunk)

            return fn

        for w in range(n_words):
            self.wit_to(base + w, word_fn(w))

    def loadw(self, addr: int) -> int:
        """Dynamic load: value at memory[low32(addr register)]."""
        d = self._reg()
        v = self.mem.get(self.val(addr) & 0xFFFFFFFF, 0) if self.concrete else None
        return self._emit(Instr(OP_LOADW, src1=addr, dst=d), v)

    # -- derived gadgets ---------------------------------------------------------

    def wit_bool(self, fn: Callable[[], int]) -> int:
        b = self.wit(fn)
        # b*(b-1) == 0 over Z/2^256: b and b-1 coprime => b in {0,1}
        self.assert0(self.mul(b, self.sub(b, self.const(1))))
        return b

    def select(self, bit: int, x: int, y: int) -> int:
        """bit ? x : y — bit must be a sound boolean."""
        return self.add(y, self.mul(bit, self.sub(x, y)))

    def is_zero(self, a: int) -> int:
        return self.lt(a, self.const(1))

    def eq(self, a: int, b: int) -> int:
        return self.is_zero(self.sub(a, b))

    def gassert0(self, gate: int, a: int) -> None:
        """assert a == 0 when gate == 1 (gate a sound boolean)."""
        self.assert0(self.mul(gate, a))

    def gassert_eq(self, gate: int, a: int, b: int) -> None:
        self.gassert0(gate, self.sub(a, b))

    def assert_lt(self, a: int, b: int) -> None:
        self.assert0(self.sub(self.lt(a, b), self.const(1)))

    # -- sponge plumbing ---------------------------------------------------------

    def auto_ts(self) -> int:
        """Serial timestamp placeholder; finalize_ts() rebases all of them
        past the program's own (3*clk+2) write timestamps."""
        t = self._ts_next
        self._ts_next += 1
        return t

    def finalize_ts(self) -> None:
        """Rewrite every sponge timestamp serial s -> 3*len(prog) + 3 + s.
        Must be called exactly once, after the last instruction."""
        base = 3 * len(self.prog) + 3
        for i, ins in enumerate(self.prog):
            if ins.op == OP_HASH_START:
                self.prog[i] = Instr(
                    OP_HASH_START,
                    dst=ins.dst,
                    imm=((base + (ins.imm >> 32)) << 32) | (ins.imm & 0xFFFFFFFF),
                )
            elif ins.op == OP_DIGEST:
                self.prog[i] = Instr(
                    OP_DIGEST,
                    src0=ins.src0,
                    src1=ins.src1,
                    dst=ins.dst,
                    imm=base + ins.imm,
                )
        for p in self.requests:
            p.ts += base

    def keccak_region(
        self,
        virt: int,
        ts: int,
        blocks,
        msg_fn: Callable[[], bytes],
        blocks_reg: Optional[int] = None,
    ) -> int:
        """Hash the message staged at word `virt` -> digest (LE word) reg.

        `blocks` is the static block count, or pass `blocks_reg` for a
        witness-dependent count (the region must hold the maximum; the
        message's true extent is CTL-bound: the first_ctl row pins the
        start at `virt`, the intra-request chaining constraints advance
        VIRT by 5 per block, and the digest_ctl row pins the final
        block's address (virt + 5*(blocks-1), computed here) and length).

        Emits OP_HASH_START (consumes the request's IS_FIRST sponge row)
        and OP_DIGEST (consumes IS_FINAL). Returns the digest register;
        the message byte length is 136*(blocks-1) + lenf where the lenf
        witness below is CTL-forced to the sponge's true value."""
        self._emit(
            Instr(OP_HASH_START, dst=self._reg(), imm=(ts << 32) | virt), 0
        )
        if blocks_reg is None:
            assert blocks >= 1
            vf = self.const(virt + 5 * (blocks - 1))
        else:
            vf = self.add(
                self.const(virt - 5), self.mul(self.const(5), blocks_reg)
            )
        # untrusted claim, but CTL-sound: the digest tuple's len element
        # is forced to the sponge's true final-block length
        lenf = self.wit(lambda: len(msg_fn()) % RATE_BYTES)
        d = self._reg()
        dv = None
        if self.concrete:
            msg = msg_fn()
            nblk = len(msg) // RATE_BYTES + 1
            if blocks_reg is None:
                assert nblk == blocks, (
                    f"message of {len(msg)}B needs {nblk} blocks, "
                    f"program has {blocks}"
                )
            else:
                assert nblk == self.val(blocks_reg), "blocks_reg mismatch"
            self.requests.append(PendingHash(virt=virt, ts=ts, message=msg))
            dv = le_word(keccak256(msg))
            self.witness.append(dv)
        digest = self._emit(Instr(OP_DIGEST, src0=vf, src1=lenf, dst=d, imm=ts), dv)
        self.last_lenf = lenf  # CTL-bound final-block length register
        return digest

    def message_len(self, blocks_reg: int, lenf_reg: int) -> int:
        """Total message length from a dynamic block count + final length:
        136*(blocks-1) + lenf, with range asserts."""
        self.assert_lt(self.const(0), blocks_reg)
        self.assert_lt(lenf_reg, self.const(RATE_BYTES))
        return self.add(
            self.mul(
                self.const(RATE_BYTES), self.sub(blocks_reg, self.const(1))
            ),
            lenf_reg,
        )

    def hash_requests(self) -> List[HashRequest]:
        return [
            HashRequest(
                ctx=KERNEL_CTX,
                seg=KERNEL_SEG,
                virt=p.virt,
                ts=p.ts,
                message=p.message,
                staged=False,
            )
            for p in self.requests
        ]

    # -- byte-stream addressing ----------------------------------------------
    # A message staged for the sponge occupies 5 words per 136-byte block:
    # byte p lives in word 5*(p//136) + (p%136)//32 at little-endian byte
    # index (p%136)%32 (the 5th word of each block holds bytes 128..135).

    def _word_of(self, off: int):
        """(word_index, byte_in_word, block_pos) regs for byte offset reg."""
        c136, c32 = self.const(136), self.const(32)
        d = self.div(off, c136)
        j = self.mod(off, c136)
        u = self.div(j, c32)
        k = self.mod(j, c32)
        w = self.add(self.mul(self.const(5), d), u)
        return w, k, u

    def byte_at(self, base: int, off: int) -> int:
        """Byte at offset `off` (reg) of the message staged at word `base`."""
        w, k, _u = self._word_of(off)
        word = self.loadw(self.add(self.const(base), w))
        return self.mod(self.shr(word, self.mul(self.const(8), k)), self.const(256))

    def extract(self, base: int, off: int, nbytes: int) -> int:
        """LE-packed value of message bytes [off, off+nbytes), nbytes <= 32
        static. Reads at most three staged words (a 32-byte window can
        straddle a full word, a block's 8-byte tail word, and the next
        block's first word). The caller must separately ensure
        off + nbytes <= message length."""
        assert 1 <= nbytes <= 32
        c8 = self.const(8)
        nb = self.const(nbytes)
        w0, k0, u0 = self._word_of(off)
        addr0 = self.add(self.const(base), w0)
        word0 = self.loadw(addr0)
        word1 = self.loadw(self.add(addr0, self.const(1)))
        word2 = self.loadw(self.add(addr0, self.const(2)))
        # capacity of word w: 8 bytes when w % 5 == 4 (block tail), else 32
        c32v, c8v = self.const(32), self.const(8)
        cap0 = self.select(self.eq(u0, self.const(4)), c8v, c32v)
        cap1 = self.select(self.eq(u0, self.const(3)), c8v, c32v)
        avail0 = self.sub(cap0, k0)
        c0 = self.select(self.lt(avail0, nb), avail0, nb)
        rem = self.sub(nb, c0)
        c1 = self.select(self.lt(cap1, rem), cap1, rem)
        c2 = self.sub(rem, c1)

        def piece(word, k_reg, c_reg):
            sh = self.shr(word, self.mul(c8, k_reg)) if k_reg is not None else word
            full = self.eq(c_reg, c32v)
            m = self.mod(sh, self.shl(self.const(1), self.mul(c8, c_reg)))
            return self.select(full, sh, m)

        p0 = piece(word0, k0, c0)
        p1 = piece(word1, None, c1)
        p2 = piece(word2, None, c2)
        out = self.add(p0, self.shl(p1, self.mul(c8, c0)))
        out = self.add(out, self.shl(p2, self.mul(c8, self.add(c0, c1))))
        return out

    def be_value(self, le_reg: int, len_reg: int, max_len: int) -> int:
        """Big-endian integer value of the `len` low bytes of an
        LE-extracted field (RLP integers are big-endian in the stream).
        len <= max_len static; len == 0 -> 0."""
        one = self.const(1)
        nz = self.lt(self.const(0), len_reg)
        # p = 256^(len-1) (0 if len == 0 after gating)
        p = self.shl(one, self.mul(self.const(8), self.sub(len_reg, nz)))
        acc = self.const(0)
        for t in range(max_len):
            byte = self.mod(self.shr(le_reg, self.const(8 * t)), self.const(256))
            inside = self.lt(self.const(t), len_reg)
            acc = self.add(acc, self.mul(inside, self.mul(byte, p)))
            p = self.div(p, self.const(256))
        return self.mul(nz, acc)

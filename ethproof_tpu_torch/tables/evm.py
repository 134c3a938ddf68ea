"""EVM machine table: a bytecode-interpreting CPU STARK.

Counterpart: ethproof_tpu/tables/evm.py:1 (a copy: the machine's layout,
`EvmShape`, `asm`, the precompiles, `execute_evm`, `discover_and_execute`
and `EvmStark`).

Reference equivalent: evm_arithmetization's CPU STARK running the asm
Kernel — fetch/decode/execute over committed contract code, with the
stack and memory in the Memory table, word packing via BytePacking,
hashing via KeccakSponge, and 256-bit ops via Arithmetic/Logic CTLs
[dep: from knowledge; pin Cargo.lock:1675; table named
at common/src/prover_state/circuit.rs:63]. Where the
reference interprets EVM inside a hand-written kernel assembly program,
this machine arithmetizes the EVM cycle directly: one row = one cycle,
the opcode is FETCHED from code committed in the Memory table and bound
to the account's code_hash by an in-proof keccak sponge request.

Row phases (the pre-exec schedule is FIXED per `EvmShape`; execution
length is dynamic via a sticky HALTED bit):

  INIT    write calldata bytes into SEG_CALLDATA, each byte pair bound
          to the matching public-input limb (one-hot fixed selectors);
  SVINIT  write the storage directory SEG_SKEYS[i] (touched keys, a
          public input each, distinct/sorted — checked by the VERIFIER
          on the public inputs) and pre-values SEG_SVALS[i] (PI-bound);
  REPACK  load code: write byte pair (REVB[0], REVB[1]) to SEG_CODE and
          the packed limb to SEG_CODE_PACKED (bytes range-checked; the
          values are bound transitively by the code-hash sponge);
  SCAN    jumpdest analysis: read code byte, maintain the inside-push
          counter, write validity to SEG_JUMPDEST; (byte, pushlen,
          is_jumpdest) is bound by one logUp against a fixed 256-entry
          opcode-info table;
  CHASH   declare + consume the keccak sponge request over
          SEG_CODE_PACKED and bind the digest to the CODEHASH public
          input word;
  EXEC    fetch code[PC] (memory channel 0), decode via a one-hot
          opcode bank, execute; STOP/RETURN/REVERT set HALTED (sticky)
          and bind the SUCCESS public input; KECCAK256 expands into
          KPACK staging micro-rows + a KDIG digest row; SLOAD/SSTORE
          take a continuation row (S_SLX/S_SSX) for the warm-flag
          journal and the SSTORE journal writes;
  FINAL   (last rows, timestamps after everything) read the storage
          journal's final values and bind them to the post-value public
          inputs; requires HALTED == 1.

Memory segment conventions (per-address value shape):
  SEG_STACK        one 256-bit word per address (addr = stack slot)
  SEG_CODE         one byte per address (addr = pc)
  SEG_CODE_PACKED  one 16-bit limb per address (sponge message layout)
  SEG_MAIN         one byte per address (EVM byte-addressed memory)
  SEG_CALLDATA     one byte per address
  SEG_HASH         one 16-bit limb per address (KECCAK256 repack scratch)
  SEG_JUMPDEST     0/1 per code address
  SEG_SKEYS        one word per address (storage key directory)
  SEG_SVALS        one word per address (storage journal values)
  SEG_SWARM        0/1 per storage index (EIP-2929 warm flags)
  SEG_SORIG        one word per storage index (EIP-2200 originals)

Endianness: EVM values are big-endian byte strings; words here are 16
little-endian 16-bit limbs. The 32-byte REVB bank mediates: a value
word V and a byte-stream image R of the same bytes satisfy
  V_limb[j] = REVB[31-2j] + 256*REVB[30-2j]
  R_limb[j] = REVB[2j]    + 256*REVB[2j+1]
so PUSH/MLOAD/MSTORE/CALLDATALOAD route through one BytePacking CTL
(little-endian packed limbs = R) while the stack value is V.

Gas (in-circuit): a running GAS column charges consensus costs per
cycle — static opcode costs, 30 + 6*ceil(len/32) for KECCAK256 (word
count via a division witness), shape-static LOG costs, quadratic memory
expansion (high-water mark MW + floor-division witnesses), EIP-2929
cold/warm storage via a SEG_SWARM journal (two-row SLOAD/SSTORE), and
EIP-2200 net-metered SSTORE with the EIP-3529 REFUND counter (chunked
equality-predicate witnesses against SEG_SORIG). GAS and REFUND bind to
public inputs on the last row; evm/contract.py adds the intrinsic cost
and the refund cap and checks the witness's gas delta (evm/gas.py).

Supported opcode families: STOP, ADD/MUL/SUB/DIV/MOD/ADDMOD/MULMOD/EXP
(square-and-multiply micro-rows, exact MSB termination, 50/byte gas),
LT/GT/SLT/SGT/EQ/ISZERO, AND/OR/XOR/NOT/BYTE/SHL/SHR/SAR/SIGNEXTEND,
KECCAK256 (any length, multi-block), ADDRESS/ORIGIN/CALLER/CALLVALUE/
CALLDATALOAD/CALLDATASIZE/CALLDATACOPY/CODESIZE/CODECOPY/
RETURNDATASIZE/RETURNDATACOPY/GASPRICE/COINBASE/TIMESTAMP/NUMBER/
GASLIMIT/CHAINID/BASEFEE/GAS, BALANCE/SELFBALANCE/EXTCODESIZE/
EXTCODEHASH/BLOCKHASH (environment-query directory: PI 4-tuples the
verifier re-derives from the witness; EIP-2929 account-access gas),
CALL/STATICCALL to precompiles 1-4 (ecrecover/sha256/ripemd160/
identity; input+output words PI-bound, the verifier replays the
precompile), POP/MLOAD/MSTORE/MSTORE8/MSIZE, SLOAD/SSTORE,
JUMP/JUMPI/PC/JUMPDEST, PUSH0-32/DUP1-16/SWAP1-16, LOG0-4 (8 events,
256-byte payloads), RETURN/REVERT. The 1024-slot EVM stack-depth limit
is enforced in-circuit (SP decomposition columns).

Documented envelope (host generator raises Unsupported outside it; each
item is a completeness gap, never a soundness gap):
  - inner CALL/STATICCALL frames into contract code ARE supported:
    each frame is proved by its OWN machine proof of the callee's
    shape, linked through the caller's per-call PI directory
    ([addr, gas, refund] + input/output words; evm/contract.py).
    Frame envelope: value == 0, args length 1..256, returndata <= 256
    bytes with retLen <= out_len, the frame must SUCCEED (no reverting
    inner frames), one frame per address per tx (no re-entrancy),
    depth < MAX_FRAME_DEPTH. Precompile calls (1-7, 9) need value 0,
    args 1..256, retLen 0 or the output length, and success. No
    DELEGATECALL, no CREATE*, no EXTCODECOPY;
  - REVERT halts with success=0 but state rollback is not replayed
    (the outer kernel must not use the journal of a reverted frame);
  - LOG* pops its operands; topics + data bind to per-log public
    inputs (receipts re-assembled and root-checked by evm/contract.py);
  - RETURN data is popped but not exposed;
  - memory high-water mark < 2^16 words (2 MB; ~8.5M expansion gas, so
    consensus-reachable traces fit) — larger offsets are Unsupported
    rather than EVM's read-zeros semantics; KECCAK256 and copy lengths
    < 2^16;
  - running out of gas mid-frame is not modelled (an OOG tx is outside
    the envelope; the witness gas limit is assumed sufficient); the GAS
    opcode needs a 32-bit gas budget witness (tx gas limit-intrinsic).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..stark.stark import CtlSpec, LC, LookupSpec, Stark
from . import arithmetic as ar
from .common import Cols, N_LIMBS, int_to_limbs
from .logic import OP_AND, OP_OR, OP_XOR
from .memory import MemoryOp

# -- EVM opcodes (the supported set) ------------------------------------------

STOP = 0x00
ADD, MUL, SUB, DIV, MOD = 0x01, 0x02, 0x03, 0x04, 0x06
ADDMOD, MULMOD = 0x08, 0x09
EXP = 0x0A
SIGNEXTEND = 0x0B
LT, GT, SLT, SGT, EQ, ISZERO = 0x10, 0x11, 0x12, 0x13, 0x14, 0x15
AND_, OR_, XOR_, NOT_, BYTE_ = 0x16, 0x17, 0x18, 0x19, 0x1A
SHL, SHR, SAR = 0x1B, 0x1C, 0x1D
KECCAK256 = 0x20
ADDRESS, ORIGIN, CALLER, CALLVALUE = 0x30, 0x32, 0x33, 0x34
BALANCE = 0x31
CALLDATALOAD, CALLDATASIZE, CALLDATACOPY = 0x35, 0x36, 0x37
CODESIZE, CODECOPY = 0x38, 0x39
GASPRICE = 0x3A
EXTCODESIZE, EXTCODEHASH = 0x3B, 0x3F
RETURNDATASIZE = 0x3D
RETURNDATACOPY = 0x3E
BLOCKHASH = 0x40
COINBASE, TIMESTAMP, NUMBER = 0x41, 0x42, 0x43
GASLIMIT, CHAINID, BASEFEE = 0x45, 0x46, 0x48
SELFBALANCE = 0x47
GAS_OP = 0x5A
POP = 0x50
MLOAD, MSTORE, MSTORE8 = 0x51, 0x52, 0x53
SLOAD, SSTORE = 0x54, 0x55
JUMP, JUMPI = 0x56, 0x57
PC_OP = 0x58
MSIZE = 0x59
JUMPDEST = 0x5B
PUSH0 = 0x5F  # PUSH0..PUSH32 = 0x5F + n
DUP1 = 0x80  # DUP1..DUP16
SWAP1 = 0x90  # SWAP1..SWAP16
LOG0 = 0xA0  # LOG0..LOG4
RETURN, REVERT = 0xF3, 0xFD
CALL, STATICCALL = 0xF1, 0xFA
# supported precompiles: 1 = ecrecover, 2 = sha256, 3 = ripemd160,
# 4 = identity; each succeeds or the witness is Unsupported
# 0x01..0x09 except 0x08 (bn128 pairing — Fp12 Miller loop, out of the
# envelope; calls to it are Unsupported, never unsound)
PRECOMPILES = (1, 2, 3, 4, 5, 6, 7, 9)
# call_shapes target marker for an inner CONTRACT frame (proved by a
# separate machine proof of the callee's own EvmShape; the per-call PI
# directory words [addr, gas, refund] link the two statements)
FRAME_TARGET = 0
# precompiles whose gas cost is input-dependent (modexp EIP-2565,
# blake2f EIP-152): charged via a per-call gas PI word, like frames
DYNGAS_PRECOMPILES = (5, 9)

# opcode -> (pops, pushes) for the simple selectors
_BINARITH = {ADD: ar.OP_ADD, MUL: ar.OP_MUL, SUB: ar.OP_SUB, DIV: ar.OP_DIV,
             MOD: ar.OP_MOD, LT: ar.OP_LT, SLT: ar.OP_SLT,
             SHL: None, SHR: None, SAR: None, BYTE_: None,
             SIGNEXTEND: None}
# EVM shift/byte operand order differs from the arithmetic table's:
#   EVM SHL/SHR pop (shift, value); the table wants (value, shift).
#   EVM BYTE pops (index, value); the table wants (value, index).

_LOGIC = {AND_: OP_AND, OR_: OP_OR, XOR_: OP_XOR}

# static gas per simple opcode (consensus; evm/gas.py has the dynamic
# parts: memory expansion, keccak words, logs, EIP-2929/2200 storage)
STATIC_GAS = {
    STOP: 0, ADD: 3, MUL: 5, SUB: 3, DIV: 5, MOD: 5, ADDMOD: 8, MULMOD: 8,
    EXP: 10,  # + 50 per exponent byte, charged on the TERM row
    LT: 3, GT: 3, SLT: 3, SGT: 3, EQ: 3, ISZERO: 3, AND_: 3, OR_: 3,
    XOR_: 3, NOT_: 3, SIGNEXTEND: 5,
    BYTE_: 3, SHL: 3, SHR: 3, SAR: 3, KECCAK256: 0,
    ADDRESS: 2, ORIGIN: 2, CALLER: 2, CALLVALUE: 2, CALLDATALOAD: 3,
    CALLDATASIZE: 2, CALLDATACOPY: 3, CODESIZE: 2, CODECOPY: 3,
    RETURNDATASIZE: 2,
    GASPRICE: 2, COINBASE: 2, TIMESTAMP: 2, NUMBER: 2,
    GASLIMIT: 2, CHAINID: 2, BASEFEE: 2, GAS_OP: 2,
    # query-directory ops: gas is dynamic (EIP-2929 account access /
    # BLOCKHASH 20 / SELFBALANCE 5), charged via the per-query gas PI
    BALANCE: 0, EXTCODESIZE: 0, EXTCODEHASH: 0, BLOCKHASH: 0,
    SELFBALANCE: 0,
    POP: 2, MLOAD: 3, MSTORE: 3, MSTORE8: 3, MSIZE: 2, SLOAD: 0, SSTORE: 0,
    JUMP: 8, JUMPI: 10, PC_OP: 2, JUMPDEST: 1, RETURN: 0, REVERT: 0,
    RETURNDATACOPY: 3,
    # precompile calls: 100 warm access + the precompile's own cost +
    # memory expansion, all charged on the op row (shape-static parts)
    CALL: 0, STATICCALL: 0,
}

# memory segments (KERNEL_CTX/SEG 0/1 belong to the kasm kernel)
SEG_STACK = 2
SEG_CODE = 3
SEG_CODE_PACKED = 4
SEG_MAIN = 5
SEG_CALLDATA = 6
SEG_HASH = 7
SEG_JUMPDEST = 8
SEG_SKEYS = 9
SEG_SVALS = 10
SEG_SWARM = 11  # EIP-2929 warm flags per storage index (0/1)
SEG_SORIG = 12  # EIP-2200 original (pre-tx) values per storage index
SEG_RETDATA = 13  # last call's output bytes (one byte per address)
SEG_EXPS = 14  # EXP scratch words: per EXP t at XP: exp, S (square), ACC

EVM_CTX = 0

N_CHAN = 5  # ch0 = instruction fetch, ch1..4 general
TS_SLOTS = 8  # per-row timestamp slots: channels 0..4, pack 5, sponge 6

WORD_MASK = (1 << 256) - 1


class Unsupported(Exception):
    """Witness outside the machine's documented envelope."""


class UnknownLogShape(Exception):
    """A LOG event fell outside shape.log_shapes — the discovery loop
    (evm/contract.py) extends the shape and re-runs."""

    def __init__(self, index: int, n_topics: int, data_len: int):
        self.index, self.n_topics, self.data_len = index, n_topics, data_len


class UnknownStorageKey(Exception):
    """SLOAD/SSTORE touched a key absent from storage_pre — the caller
    (evm/contract.py discovery loop) adds the key and re-runs."""

    def __init__(self, key: int):
        self.key = key


class UnknownQueryCount(Exception):
    """Execution used more environment queries than shape.n_queries —
    the discovery loop re-runs with the larger count."""

    def __init__(self, count: int):
        self.count = count


class UnknownCallShape(Exception):
    """A precompile call fell outside shape.call_shapes — the discovery
    loop extends the shape and re-runs."""

    def __init__(self, index: int, entry: tuple):
        self.index, self.entry = index, entry


# -- shape (fixes the circuit) -------------------------------------------------


MAX_LOGS = 8  # LSEL selector bank width (envelope: <= 8 LOG events/frame)
MAX_LOG_DATA = 256  # bytes; words beyond the first stage on LOGD rows
MAX_QUERIES = 8  # QSEL bank width (BALANCE/EXTCODE*/BLOCKHASH/SELFBALANCE)
MAX_CALLS = 4  # CSEL bank width (precompile calls per frame)


@dataclass(frozen=True)
class EvmShape:
    """Static parameters that define one EvmStark circuit (the analogue
    of the reference's per-degree circuit in the recursion ladder)."""

    code_len: int
    calldata_len: int
    n_skeys: int  # touched storage slots
    log_rows: int
    # environment-query directory: BALANCE/EXTCODESIZE/EXTCODEHASH/
    # BLOCKHASH/SELFBALANCE answers, one (opcode, arg, result, gas)
    # PI 4-tuple per query in execution order; the verifier re-derives
    # every tuple from the witness (state trie / block hashes / EIP-2929
    # address warmth replay). Discovery raises UnknownQueryCount.
    n_queries: int = 0
    # inner calls in execution order: (opcode, target, args_len,
    # ret_len, out_len) per call — opcode is CALL or STATICCALL, target
    # a precompile id (1..9) or FRAME_TARGET (0) for a contract frame,
    # args_len the popped input length, ret_len the popped return-area
    # length (envelope: precompiles need ret_len in {0, out_len};
    # frames need ret_len <= out_len), out_len the returned byte
    # length. Each call's input and output words are public inputs; the
    # verifier replays precompiles on the input words, and checks a
    # contract frame's words against the callee frame's own machine
    # proof (evm/contract.py). Frame entries carry 3 extra directory PI
    # words [addr, gas, refund]; dyngas precompiles (5, 9) carry 1
    # [gas]. Discovery: UnknownCallShape.
    call_shapes: Tuple[Tuple[int, int, int, int, int], ...] = ()
    # emitted LOG events in execution order: (n_topics, data_len) each;
    # topics and ceil(data_len/32) data words per log become public
    # inputs (the receipts-root binding consumes them, evm/contract.py).
    # Envelope: data_len <= MAX_LOG_DATA, at most MAX_LOGS events; data
    # words beyond the first stage on S_LOGD continuation rows.
    log_shapes: Tuple[Tuple[int, int], ...] = ()

    @staticmethod
    def n_data_words(dl: int) -> int:
        """PI data words for a log payload (>= 1 — a zero word when
        empty, keeping the receipts rebuild uniform)."""
        return max((dl + 31) // 32, 1)

    @staticmethod
    def call_out_len(pre_id: int, args_len: int, ret_len: int = 0) -> int:
        """Output byte length of a supported precompile. For modexp
        (0x05) the length is content-dependent (msize), so the envelope
        pins it to the popped retLen (generation checks the equality)."""
        if pre_id == 4:
            return args_len
        if pre_id == 5:
            return ret_len
        if pre_id in (6, 7, 9):
            return 64
        return 32

    @staticmethod
    def call_in_words(args_len: int) -> int:
        return (args_len + 31) // 32

    @staticmethod
    def call_dir_words(target: int) -> int:
        """Per-call directory PI words before the input words: frames
        carry [addr, gas, refund]; dyngas precompiles [gas]."""
        if target == FRAME_TARGET:
            return 3
        return 1 if target in DYNGAS_PRECOMPILES else 0

    @staticmethod
    def entry_in_words(entry) -> int:
        return (entry[2] + 31) // 32

    @staticmethod
    def entry_out_words(entry) -> int:
        return (entry[4] + 31) // 32

    @staticmethod
    def entry_words(entry) -> int:
        return (
            EvmShape.call_dir_words(entry[1])
            + EvmShape.entry_in_words(entry)
            + EvmShape.entry_out_words(entry)
        )

    @property
    def n_calldata_words(self) -> int:
        return (self.calldata_len + 31) // 32

    @property
    def n_init_rows(self) -> int:
        return self.n_calldata_words

    @property
    def code_padded_len(self) -> int:
        return self.code_len + (self.code_len % 2)

    @property
    def repack_windows(self) -> List[Tuple[int, int, int]]:
        """(byte_base, word_addr, length) per staged word of the padded
        code: the sponge stages 5 words per 136-byte block (words 0-3 are
        32 bytes, word 4 is 8), word addresses advancing 5 per block."""
        out = []
        L = self.code_padded_len
        n_blocks = L // 136 + 1
        for b in range(n_blocks):
            for w in range(5):
                base = 136 * b + 32 * w
                cap = 8 if w == 4 else 32
                ln = min(cap, L - base)
                if ln > 0:
                    out.append((base, 5 * b + w, ln))
        return out

    @property
    def n_repack_rows(self) -> int:
        return len(self.repack_windows)

    @property
    def n_scan_rows(self) -> int:
        return self.code_len

    # public input words: the environment section (caller, callvalue,
    # address, origin, gasprice, coinbase, timestamp, number, gaslimit,
    # chainid, basefee), CALLDATA..., CODEHASH, per-key (KEY, WARM0,
    # VPRE, VPOST) — WARM0 is the EIP-2929 access-list pre-warm flag —
    # per-log (topics..., data words), GAS (frame execution gas,
    # in-circuit metered), REFUND (EIP-3529 counter at halt), SUCCESS
    @property
    def pi_layout(self) -> Dict[str, int]:
        lay = {
            "caller": 0, "callvalue": 1, "address": 2, "origin": 3,
            "gasprice": 4, "coinbase": 5, "timestamp": 6, "number": 7,
            "gaslimit": 8, "chainid": 9, "basefee": 10, "gasbudget": 11,
            "calldata": 12,
        }
        at = 12 + self.n_calldata_words
        lay["codehash"] = at
        lay["storage"] = at + 1
        at = at + 1 + 4 * self.n_skeys
        # (qop, qarg, qres, qgas) per environment query
        lay["queries"] = at
        at += 4 * self.n_queries
        # per call: directory words, then input words, then output words
        lay["calls"] = at
        lay["call_words"] = [None] * len(self.call_shapes)
        for i, entry in enumerate(self.call_shapes):
            lay["call_words"][i] = at
            at += self.entry_words(entry)
        lay["logs"] = at
        lay["log_words"] = [None] * len(self.log_shapes)
        for i, (nt, dl) in enumerate(self.log_shapes):
            lay["log_words"][i] = at
            at += nt + self.n_data_words(dl)
        lay["gas"] = at
        lay["refund"] = at + 1
        lay["success"] = at + 2
        return lay

    @property
    def num_pi_words(self) -> int:
        return self.pi_layout["success"] + 1


# -- witness columns -----------------------------------------------------------

_c = Cols()
PC = _c.one()
SP = _c.one()
HALTED = _c.one()  # sticky; set by STOP/RETURN/REVERT
R0 = _c.one()  # repack source pointer (byte addr)
R1 = _c.one()  # repack destination pointer (limb addr)
R2 = _c.one()  # repack bytes remaining
HP = _c.one()  # next free SEG_HASH limb address
INPUSH = _c.one()  # scan: bytes of push data still to skip
PUSHLEN = _c.one()  # scan: pushlen(code byte) from the opcode-info table
IS_JD = _c.one()  # scan: byte is a JUMPDEST opcode (and INPUSH == 0)
SCAN_COMB = _c.one()  # byte + 256*PUSHLEN + 2^16*IS_JD (logUp-bound)
SIDX = _c.one()  # storage journal index witness
LOGIDX = _c.one()  # count of completed LOG events so far
S_LOGX = _c.one()  # internal: LOG continuation row (topics 3/4)
S_LOGD = _c.one()  # internal: LOG data-word staging row (words 1..7)
S_SLX = _c.one()  # internal: SLOAD continuation row (warm-flag journal)
S_SSX = _c.one()  # internal: SSTORE continuation row (journal writes)
S_CPR = _c.one()  # internal: copy read row (CALLDATACOPY/CODECOPY)
S_CPW = _c.one()  # internal: copy write row (REVB carried from S_CPR)
# -- in-circuit gas (consensus frame gas; see evm/gas.py for the rules)
GAS = _c.one()  # running execution gas (first row 0, bound to PI at end)
REFUND = _c.one()  # running EIP-3529 refund counter (bound to PI at end)
MW = _c.one()  # memory high-water mark, in 32-byte words (< 2^16)
CQ = _c.one()  # C(MW) = 3*MW + floor(MW^2/512) (memory expansion cost)
NW = _c.one()  # touch rows: ceil((offset + length)/32)
NW2 = _c.one()  # touch rows: NW^2 (degree reducer for the quad witness)
GROW = _c.one()  # touch rows: 1 iff NW > MW
TCH = _c.one()  # 1 on rows that touch SEG_MAIN with nonzero length
RB0 = _c.one()  # |NW - MW| comparison witness, low byte (byte-checked)
RB1 = _c.one()  # comparison witness, high byte
NB0 = _c.one()  # NW low byte (bounds NW < 2^16)
NB1 = _c.one()  # NW high byte
RQB = _c.one()  # quad remainder low byte: NW2 = 512*(CQ'-3NW) + RQ
RQBIT = _c.one()  # quad remainder bit 8 (RQ = RQB + 256*RQBIT < 512)
PB = _c.many(5)  # pad bits: 32*NW = offset + length + pad, pad < 32
# -- SSTORE net-metering predicates (EIP-2200/3529). Words compared as
# six 48-bit chunks of their canonical 16-bit limbs (injective mod p).
# E*: equality bit; S*: one-hot nonzero-chunk pick (sums to gate*(1-E));
# D*: picked chunk difference; I*: its inverse.
E_VC = _c.one()  # value == current
D_VC = _c.one()
I_VC = _c.one()
S_VC = _c.many(6)
E_CO = _c.one()  # current == original
D_CO = _c.one()
I_CO = _c.one()
S_CO = _c.many(6)
E_VO = _c.one()  # value == original
D_VO = _c.one()
I_VO = _c.one()
S_VO = _c.many(6)
EO0 = _c.one()  # original == 0 (iszero over canonical limbs)
SO0 = _c.one()
IO0 = _c.one()
EV0 = _c.one()  # value == 0
SV0 = _c.one()
IV0 = _c.one()
P1 = _c.one()  # sel[SSTORE]*(1-E_VC)*E_CO (clean-slot branch gate)
P2 = _c.one()  # sel[SSTORE]*(1-E_VC)*(1-E_CO) (dirty-slot branch gate)
# -- multi-block KECCAK256 staging (sponge layout: 4x32B + 1x8B words
# per 136-byte block, mirroring the code-hash repack windows)
KP = _c.many(5)  # one-hot phase within the current block (kpack rows)
FULLC = _c.one()  # 1 = full chunk (cap bytes), 0 = final partial chunk
CSW = _c.one()  # chunk size staged this row (min(cap, R2); 0 off kpack)
KBLK = _c.one()  # completed-block counter within the current hash
KLEN = _c.one()  # message length, carried from setup through the digest
KWORDS = _c.one()  # setup row: ceil(len/32) (gas word cost witness)
KPD = _c.many(5)  # setup row: pad bits for 32*KWORDS = len + pad
M8B0 = _c.one()  # MSTORE8: low byte of the popped value (byte-checked);
M8B1 = _c.one()  # second byte (completes the canonical limb-0 split);
#                  MSIZE reuses the pair for its limb-0 decomposition
LSEL = _c.many(MAX_LOGS)  # one-hot log index on LOG/LOGX/LOGD rows
QIDX = _c.one()  # count of completed environment queries so far
QSEL = _c.many(MAX_QUERIES)  # one-hot query index on query-op rows
CIDX = _c.one()  # count of STARTED precompile calls (increments on op row)
CSEL = _c.many(MAX_CALLS)  # one-hot call index on call rows
S_CLA = _c.one()  # internal: call row 2 (retOfs/retLen pops, success push)
S_CLI = _c.one()  # internal: call input-word staging row (NSEL = word)
S_CLO = _c.one()  # internal: call output-word staging row (NSEL = word)
RDS = _c.one()  # RETURNDATASIZE register (last call's output length)
CBGO = _c.one()  # boolean: this (last S_CLO) row hands off to copy-back
# -- EXP micro-machine (LSB-first square-and-multiply; see the S_EXM/
# S_EXQ constraint section). NSEL doubles as the one-hot limb index,
# KWORDS as the exponent byte-length witness, PB[0:3] as its pad bits.
S_EXI = _c.one()  # internal: EXP row 2 (scratch init: exp, S=base, ACC=1)
S_EXM = _c.one()  # internal: EXP multiply row (one exponent bit)
S_EXQ = _c.one()  # internal: EXP square row
XB = _c.one()  # current exponent bit (bool)
POW = _c.one()  # 2^(bit position within the current limb)
LACC = _c.one()  # bits of the current limb accumulated so far
LB = _c.one()  # boolean: limb boundary (POW == 2^15)
LBI = _c.one()  # inverse witness for POW - 2^15 != 0
TERM = _c.one()  # boolean: final multiply row (the exponent's MSB)
LACN = _c.one()  # LACC + XB*POW (the post-bit accumulator; M/Q rows)
BITC = _c.one()  # bit counter (0-based index of the processed bit)
XP = _c.one()  # next free SEG_EXPS address (3 words per EXP)
# -- stack-depth limit (EVM: at most 1024 items): every row proves
# SP = SPMX*1024 + (1-SPMX)*(SPB0 + 256*(SPH0 + 2*SPH1)), SPB0 a
# byte, SPH* bits — so SP <= 1024 always (overflow traces unprovable)
SPMX = _c.one()
SPB0 = _c.one()
SPH0 = _c.one()
SPH1 = _c.one()
Z = _c.one()  # iszero/eq/jumpi/scan zero-flag (1 on rows that bind no ZS)
ZINV = _c.one()  # inverse witness for the nonzero branch
ZS = _c.one()  # the limb-sum whose zeroness Z decides (bound per op)
KINV = _c.one()  # storage: inverse witness (directory key sum != 0)
H_FVIRT = _c.one()  # sponge final-block virt (digest row)
H_FLEN = _c.one()  # sponge final-block length (digest row)
H_TS = _c.one()  # sponge request ts (set at declare, carried to digest)
HS_SEG = _c.one()  # sponge message segment (declare + digest rows)
HS_VIRT = _c.one()  # sponge message base address (declare row)
SP_FIRST = _c.one()  # sponge first-row CTL filter
SP_FINAL = _c.one()  # sponge final-row CTL filter
AR_PLAIN = _c.one()  # arithmetic CTL filter (EVM operand order)
AR_SWAP = _c.one()  # arithmetic CTL filter (swapped operand order)
AR_TERN = _c.one()  # arithmetic CTL filter (ternary modops)
LG_PLAIN = _c.one()  # logic CTL filter (AND/OR/XOR)
IS_PACK = _c.one()  # bytepacking CTL filter
PACK_WRITE = _c.one()  # bytepacking direction (1 = unpack-to-memory)
PACK_SEG = _c.one()  # bytepacking segment
PACK_VIRT = _c.one()  # bytepacking base byte address
PACK_LEN = _c.one()  # bytepacking window length (32 on exec rows)

# channels: USED, IS_READ, SEG, VIRT, VALUE[16]
CH_USED: List[int] = []
CH_ISREAD: List[int] = []
CH_SEG: List[int] = []
CH_VIRT: List[int] = []
CH_VAL: List[List[int]] = []
for _i in range(N_CHAN):
    CH_USED.append(_c.one())
    CH_ISREAD.append(_c.one())
    CH_SEG.append(_c.one())
    CH_VIRT.append(_c.one())
    CH_VAL.append(_c.many(N_LIMBS))

REVB = _c.many(32)  # byte bank (value <-> byte-stream mediation)

# opcode selectors: simple one-hots + family selectors with an N bank
SIMPLE_OPS = (
    STOP, ADD, MUL, SUB, DIV, MOD, LT, GT, SLT, SGT, EQ, ISZERO,
    ADDMOD, MULMOD,
    AND_, OR_, XOR_, NOT_, BYTE_, SHL, SHR, SAR, SIGNEXTEND, KECCAK256,
    ADDRESS, ORIGIN, CALLER, CALLVALUE, CALLDATALOAD, CALLDATASIZE,
    CALLDATACOPY, CODECOPY, RETURNDATASIZE,
    GASPRICE, COINBASE, TIMESTAMP, NUMBER, GASLIMIT, CHAINID, BASEFEE,
    POP, MLOAD, MSTORE, MSTORE8, MSIZE, SLOAD, SSTORE, JUMP, JUMPI,
    PC_OP, JUMPDEST, RETURN, REVERT,
    CODESIZE, GAS_OP, BALANCE, EXTCODESIZE, EXTCODEHASH, BLOCKHASH,
    SELFBALANCE, RETURNDATACOPY, CALL, STATICCALL, EXP,
)
# the environment-query directory ops (PI 4-tuples, QSEL-selected)
QUERY_OPS = (BALANCE, EXTCODESIZE, EXTCODEHASH, BLOCKHASH, SELFBALANCE)
# environment opcodes and their PI word (pushed verbatim from the env
# section; the verifier re-derives every word from the tx + block
# metadata — evm/contract.py expected_machine_pi)
ENV_OPS = {
    ADDRESS: "address", ORIGIN: "origin", CALLER: "caller",
    CALLVALUE: "callvalue", GASPRICE: "gasprice", COINBASE: "coinbase",
    TIMESTAMP: "timestamp", NUMBER: "number", GASLIMIT: "gaslimit",
    CHAINID: "chainid", BASEFEE: "basefee",
}
SEL = {op: _c.one() for op in SIMPLE_OPS}
F_PUSH = _c.one()  # PUSH0..32 family
F_DUP = _c.one()  # DUP1..16
F_SWAP = _c.one()  # SWAP1..16
F_LOG = _c.one()  # LOG0..4
NSEL = _c.many(33)  # one-hot n for PUSH (0..32), DUP/SWAP (1..16), LOG (0..4)
S_KPACK = _c.one()  # internal: KECCAK256 repack micro-cycle
S_KDIG = _c.one()  # internal: KECCAK256 digest cycle

BYTE_MULT = _c.one()  # byte range-check multiplicities
COMB_MULT = _c.one()  # opcode-info lookup multiplicities
NUM_COLUMNS = _c.count

# fixed columns: row counter, byte counter, opcode-info table, and the
# per-shape phase schedule built in EvmStark.__init__
OPINFO_SHIFT_PL = 256  # combined = byte + 256*pushlen + 2^16*is_jd
OPINFO_SHIFT_JD = 1 << 16


def _opinfo(byte: int) -> int:
    pushlen = byte - PUSH0 if PUSH0 <= byte <= PUSH0 + 32 else 0
    is_jd = 1 if byte == JUMPDEST else 0
    return byte + OPINFO_SHIFT_PL * pushlen + OPINFO_SHIFT_JD * is_jd


# -- host-side program assembly (tests / tx front-end) --------------------------


def asm(*items) -> bytes:
    """Tiny assembler: ints are opcodes; ("push", value, n?) pushes."""
    out = bytearray()
    for it in items:
        if isinstance(it, int):
            out.append(it)
        elif isinstance(it, tuple) and it[0] == "push":
            val = it[1]
            n = it[2] if len(it) > 2 else max((val.bit_length() + 7) // 8, 1)
            if val == 0 and len(it) <= 2:
                n = 1
            out.append(PUSH0 + n)
            out.extend(val.to_bytes(n, "big"))
        else:
            raise ValueError(f"bad asm item {it!r}")
    return bytes(out)


# -- host interpreter / trace generation ----------------------------------------


@dataclass
class EvmInputs:
    code: bytes
    calldata: bytes
    caller: int
    callvalue: int
    storage_pre: Dict[int, int]  # touched key -> pre value (sorted by key)
    # EIP-2929 pre-warmed slots (tx access-list keys for this contract)
    warm_pre: Tuple[int, ...] = ()
    # environment words (PI-bound; verifier re-derives from tx + block)
    address: int = 0  # the executing contract
    origin: int = 0  # tx sender (== caller in the single-frame envelope)
    gasprice: int = 0  # effective gas price (EIP-1559)
    coinbase: int = 0
    timestamp: int = 0
    number: int = 0
    gaslimit: int = 0  # block gas limit
    chainid: int = 0
    basefee: int = 0
    # frame gas allotment (tx gas limit - intrinsic); the GAS opcode
    # pushes gas_budget - used. 0 = unavailable (GAS -> Unsupported)
    gas_budget: int = 0
    # environment-query answers: fn(opcode, arg) -> int result word
    # (BALANCE/EXTCODESIZE/EXTCODEHASH take the masked address, BLOCKHASH
    # the block number). None = query opcodes are Unsupported.
    query_resolver: object = None
    # EIP-2929 pre-warmed ADDRESSES (origin, to, coinbase, precompiles,
    # access-list addresses) for account-access gas
    warm_addrs: Tuple[int, ...] = ()
    # inner contract-frame resolver: fn(addr, value, data, gas_budget,
    # warm_addrs_tuple) -> (success, output_bytes, gas_used, refund,
    # warm_addrs_post) or None (target outside the resolver's scope).
    # None = calls to non-precompile targets are Unsupported.
    frame_resolver: object = None
    # optional shared list collecting (address, topics, data) in
    # tx-global execution order across call frames (receipts rebuild)
    log_sink: object = None


@dataclass
class EvmResult:
    trace: np.ndarray
    mem_ops: List[MemoryOp]
    arith_requests: List[Tuple[int, int, int]]
    logic_requests: List[Tuple[int, int, int]]
    pack_requests: List  # bytepacking.PackRequest
    hash_requests: List  # keccak_sponge.HashRequest
    pi_words: List[int]
    storage_post: Dict[int, int]
    success: int
    logs: List[Tuple[List[int], bytes]]  # (topics, data) — host-side receipts
    return_data: bytes
    gas_used: int = 0  # frame execution gas (evm/gas.py; excl. intrinsic)
    gas_refund: int = 0  # EIP-3529 refund counter (uncapped, pre-revert)
    # EIP-2929 warm address set at frame exit (threads through nested
    # call frames back to the caller)
    warm_addrs_post: Tuple[int, ...] = ()

def _word_limbs(v: int) -> List[int]:
    return int_to_limbs(v)


def _le_word(data32: bytes) -> int:
    return int.from_bytes(data32, "little")


class _Emitter:
    """Host-side row/trace emitter shared by all phases."""

    def __init__(self, shape: EvmShape):
        n = 1 << shape.log_rows
        self.shape = shape
        self.n = n
        self.tr = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
        self.tr[Z, :] = 1
        self.mem_ops: List[MemoryOp] = []
        self.arith: List[Tuple[int, int, int]] = []
        self.logic: List[Tuple[int, int, int]] = []
        self.packs: List = []
        self.hashes: List = []
        self.mem: Dict[Tuple[int, int], int] = {}  # (seg, virt) -> value
        self.byte_mult = np.zeros(n, dtype=np.uint64)
        self.comb_mult = np.zeros(n, dtype=np.uint64)

    def chan(self, r: int, i: int, is_read: int, seg: int, virt: int,
             value: int) -> None:
        assert 0 <= virt < self.n * TS_SLOTS
        self.tr[CH_USED[i], r] = 1
        self.tr[CH_ISREAD[i], r] = is_read
        self.tr[CH_SEG[i], r] = seg
        self.tr[CH_VIRT[i], r] = virt
        for k, l in enumerate(_word_limbs(value)):
            self.tr[CH_VAL[i][k], r] = l
        self.mem_ops.append(
            MemoryOp(EVM_CTX, seg, virt, TS_SLOTS * r + i, is_read, value)
        )
        if is_read:
            assert self.mem.get((seg, virt), 0) == value, (seg, virt)
        else:
            self.mem[(seg, virt)] = value

    def revb(self, r: int, data: bytes) -> None:
        for i, b in enumerate(data):
            self.tr[REVB[i], r] = b

    def pack(self, r: int, is_read: int, seg: int, virt: int, data: bytes) -> None:
        """One BytePacking request; REVB holds the bytes (zero-extended —
        the packing CTL sends exactly len(data) bytes)."""
        from .bytepacking import PackRequest

        self.tr[IS_PACK, r] = 1
        self.tr[PACK_WRITE, r] = 1 - is_read
        self.tr[PACK_SEG, r] = seg
        self.tr[PACK_VIRT, r] = virt
        self.tr[PACK_LEN, r] = len(data)
        self.revb(r, data)
        self.packs.append(
            PackRequest(is_read, EVM_CTX, seg, virt, TS_SLOTS * r + 5, data)
        )
        for i, b in enumerate(data):
            if is_read:
                assert self.mem.get((seg, virt + i), 0) == b
            else:
                self.mem[(seg, virt + i)] = b

    def finish_mults(self) -> None:
        assert self.n >= 256, "byte range check needs >= 2^8 rows"
        byte_cols = list(REVB) + [RB0, RB1, NB0, NB1, RQB, M8B0, M8B1, SPB0]
        revb_vals = self.tr[np.asarray(byte_cols, dtype=np.intp)]
        bc = np.bincount(revb_vals.ravel().astype(np.int64), minlength=256)
        assert bc.shape[0] <= 256 or bc[256:].sum() == 0
        # fixed byte counter is min(row, 255): row b < 256 holds value b
        self.byte_mult[:256] += bc[:256].astype(np.uint64)
        self.tr[BYTE_MULT] = self.byte_mult
        comb_vals = self.tr[SCAN_COMB]
        # opcode-info fixed table: row i holds _opinfo(i) for i < 256, 0 above
        lut = {(_opinfo(i)): i for i in range(255, -1, -1)}
        cm = np.zeros(self.n, dtype=np.uint64)
        for v in comb_vals:
            cm[lut[int(v)]] += 1
        self.tr[COMB_MULT] = cm


def _run_precompile(pre_id: int, data: bytes) -> bytes:
    """Host evaluation of a supported precompile; Unsupported on failure
    (the envelope proves only succeeding calls)."""
    import hashlib

    if pre_id == 1:  # ecrecover
        from ..evm.secp256k1 import N as CURVE_N, recover_address

        buf = data.ljust(128, b"\0")[:128]
        h, v, r_, s_ = buf[:32], buf[32:64], buf[64:96], buf[96:128]
        vi = int.from_bytes(v, "big")
        ri = int.from_bytes(r_, "big")
        si = int.from_bytes(s_, "big")
        if vi not in (27, 28) or not (1 <= ri < CURVE_N) or not (
            1 <= si < CURVE_N
        ):
            raise Unsupported("failing ecrecover call (bad v/r/s)")
        try:
            addr = recover_address(h, ri, si, vi - 27)
        except Exception as e:
            raise Unsupported(f"failing ecrecover call: {e}")
        return b"\0" * 12 + addr
    if pre_id == 2:
        return hashlib.sha256(data).digest()
    if pre_id == 3:
        try:
            h = hashlib.new("ripemd160", data).digest()
        except Exception:
            raise Unsupported("ripemd160 unavailable on this host")
        return b"\0" * 12 + h
    if pre_id == 4:
        return data
    if pre_id == 5:  # modexp (EIP-198/2565)
        bsize, esize, msize = _modexp_sizes(data)
        body = data[96:]
        b_ = int.from_bytes(body[:bsize], "big")
        e_ = int.from_bytes(body[bsize : bsize + esize], "big")
        m_ = int.from_bytes(body[bsize + esize : bsize + esize + msize], "big")
        if msize == 0:
            return b""
        out = pow(b_, e_, m_) if m_ else 0
        return out.to_bytes(msize, "big")
    if pre_id == 6:  # alt_bn128 G1 add (EIP-196)
        buf = data.ljust(128, b"\0")[:128]
        p1 = _bn128_point(buf[:64])
        p2 = _bn128_point(buf[64:128])
        x, y = _bn128_add(p1, p2)
        return x.to_bytes(32, "big") + y.to_bytes(32, "big")
    if pre_id == 7:  # alt_bn128 G1 scalar mul (EIP-196)
        buf = data.ljust(96, b"\0")[:96]
        p1 = _bn128_point(buf[:64])
        k = int.from_bytes(buf[64:96], "big")
        x, y = _bn128_mul(p1, k)
        return x.to_bytes(32, "big") + y.to_bytes(32, "big")
    if pre_id == 9:  # blake2f (EIP-152)
        if len(data) != 213:
            raise Unsupported("blake2f input must be exactly 213 bytes")
        if data[212] not in (0, 1):
            raise Unsupported("blake2f final flag must be 0 or 1")
        rounds = int.from_bytes(data[:4], "big")
        if rounds > 1 << 16:
            # row-budget envelope guard (consensus allows any u32; a
            # 2^16-round call costs 65k gas, ample for real traffic)
            raise Unsupported("blake2f rounds > 2^16 outside the envelope")
        h = [int.from_bytes(data[4 + 8 * i : 12 + 8 * i], "little") for i in range(8)]
        m = [int.from_bytes(data[68 + 8 * i : 76 + 8 * i], "little") for i in range(16)]
        t = [
            int.from_bytes(data[196:204], "little"),
            int.from_bytes(data[204:212], "little"),
        ]
        out = _blake2f(rounds, h, m, t, data[212] == 1)
        return b"".join(v.to_bytes(8, "little") for v in out)
    raise Unsupported(f"precompile {pre_id} not supported")


# -- precompile 5-9 helpers -----------------------------------------------------

# alt_bn128 base field (EIP-196)
_BN_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583


def _modexp_sizes(data: bytes):
    hdr = data.ljust(96, b"\0")
    bsize = int.from_bytes(hdr[:32], "big")
    esize = int.from_bytes(hdr[32:64], "big")
    msize = int.from_bytes(hdr[64:96], "big")
    if bsize > 64 or esize > 64 or msize > 64:
        # the 256-byte call-args envelope caps real inputs anyway; huge
        # declared sizes are gas-griefing calls outside the envelope
        raise Unsupported("modexp operand size > 64 bytes")
    return bsize, esize, msize


def modexp_gas(data: bytes) -> int:
    """EIP-2565 pricing (replayed by the verifier via the shared host
    generator)."""
    bsize, esize, msize = _modexp_sizes(data)
    body = data[96:]
    ehead = int.from_bytes(body[bsize : bsize + min(esize, 32)], "big")
    words = (max(bsize, msize) + 7) // 8
    mult = words * words
    if esize <= 32:
        it = max(ehead.bit_length() - 1, 0)
    else:
        it = 8 * (esize - 32) + max(ehead.bit_length() - 1, 0)
    return max(200, mult * max(it, 1) // 3)


def _bn128_point(buf: bytes):
    x = int.from_bytes(buf[:32], "big")
    y = int.from_bytes(buf[32:64], "big")
    if x >= _BN_P or y >= _BN_P:
        raise Unsupported("bn128 coordinate >= field modulus")
    if x == 0 and y == 0:
        return None  # point at infinity
    if (y * y - x * x * x - 3) % _BN_P != 0:
        raise Unsupported("bn128 point not on curve")
    return (x, y)


def _bn128_add(p1, p2):
    if p1 is None:
        return p2 or (0, 0)
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % _BN_P == 0:
        return (0, 0)
    if p1 == p2:
        lam = 3 * x1 * x1 * pow(2 * y1, _BN_P - 2, _BN_P) % _BN_P
    else:
        lam = (y2 - y1) * pow(x2 - x1, _BN_P - 2, _BN_P) % _BN_P
    x3 = (lam * lam - x1 - x2) % _BN_P
    y3 = (lam * (x1 - x3) - y1) % _BN_P
    return (x3, y3)


def _bn128_mul(p, k: int):
    acc = None
    base = p
    while k:
        if k & 1:
            acc = _bn128_add(acc, base) if acc is not None else base
            if acc == (0, 0):
                acc = None
        base = _bn128_add(base, base)
        if base == (0, 0):
            base = None
        k >>= 1
        if base is None and k:
            break
    return acc if acc is not None else (0, 0)


_B2_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]
_B2_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]
_M64 = (1 << 64) - 1


def _blake2f(rounds: int, h, m, t, final: bool):
    """The blake2b F compression function (RFC 7693 / EIP-152)."""

    def rotr(x, n):
        return ((x >> n) | (x << (64 - n))) & _M64

    v = list(h) + list(_B2_IV)
    v[12] ^= t[0]
    v[13] ^= t[1]
    if final:
        v[14] ^= _M64

    def G(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _M64
        v[d] = rotr(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = rotr(v[b] ^ v[c], 24)
        v[a] = (v[a] + v[b] + y) & _M64
        v[d] = rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = rotr(v[b] ^ v[c], 63)

    for r in range(rounds):
        s = _B2_SIGMA[r % 10]
        G(0, 4, 8, 12, m[s[0]], m[s[1]])
        G(1, 5, 9, 13, m[s[2]], m[s[3]])
        G(2, 6, 10, 14, m[s[4]], m[s[5]])
        G(3, 7, 11, 15, m[s[6]], m[s[7]])
        G(0, 5, 10, 15, m[s[8]], m[s[9]])
        G(1, 6, 11, 12, m[s[10]], m[s[11]])
        G(2, 7, 8, 13, m[s[12]], m[s[13]])
        G(3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def _kpack_rows(ln: int) -> int:
    """KPACK rows of a KECCAK256 of `ln` bytes: chunks of 32, 32, 32, 32
    and 8 bytes per 136-byte block, the last one partial."""
    rows = phase = 0
    while ln > 0:
        ln -= min(8 if phase == 4 else 32, ln)
        phase = (phase + 1) % 5
        rows += 1
    return rows


def execute_evm(shape: EvmShape, inputs: EvmInputs) -> EvmResult:
    """Run the machine on host, emitting the trace + all table requests.

    Phases follow the fixed schedule (EvmStark.fixed_columns must agree)."""
    from .keccak_sponge import HashRequest

    code, calldata = inputs.code, inputs.calldata
    assert len(code) == shape.code_len and len(calldata) == shape.calldata_len
    skeys = sorted(inputs.storage_pre)
    assert len(skeys) == shape.n_skeys
    em = _Emitter(shape)
    tr = em.tr
    lay = shape.pi_layout

    # public input words
    cd_words = [
        int.from_bytes(calldata[32 * w: 32 * w + 32].ljust(32, b"\0"), "big")
        for w in range(shape.n_calldata_words)
    ]
    from ..hash.keccak import keccak256

    code_padded = code + b"\0" * (len(code) % 2)
    codehash = _le_word(keccak256(code_padded))
    warm0 = {k: (1 if k in inputs.warm_pre else 0) for k in skeys}
    pi_words = [
        inputs.caller, inputs.callvalue, inputs.address, inputs.origin,
        inputs.gasprice, inputs.coinbase, inputs.timestamp, inputs.number,
        inputs.gaslimit, inputs.chainid, inputs.basefee, inputs.gas_budget,
    ] + cd_words + [codehash]
    for k in skeys:
        # (key, warm0, vpre, vpost) — vpost patched below
        pi_words += [k, warm0[k], inputs.storage_pre[k], 0]
    # (qop, qarg, qres, qgas) per environment query — patched in EXEC
    pi_words += [0] * (4 * shape.n_queries)
    # per-call directory/input/output words — patched in EXEC
    for entry in shape.call_shapes:
        pi_words += [0] * shape.entry_words(entry)
    for nt, dl in shape.log_shapes:
        # topics + data words, patched on LOG
        pi_words += [0] * (nt + shape.n_data_words(dl))

    r = 0
    # -- INIT: one row per calldata word — a bytepacking window WRITES the
    # word's bytes; REVB equals the PI word's big-endian bytes
    for w in range(shape.n_calldata_words):
        ln = min(32, shape.calldata_len - 32 * w)
        data = calldata[32 * w: 32 * w + ln]
        em.pack(r, 0, SEG_CALLDATA, 32 * w, data)
        em.revb(r, cd_words[w].to_bytes(32, "big"))
        r += 1
    # -- SVINIT: storage directory, pre values, warm flags, originals
    for i, k in enumerate(skeys):
        em.chan(r, 1, 0, SEG_SKEYS, i, k)
        em.chan(r, 2, 0, SEG_SVALS, i, inputs.storage_pre[k])
        em.chan(r, 3, 0, SEG_SWARM, i, warm0[k])
        em.chan(r, 4, 0, SEG_SORIG, i, inputs.storage_pre[k])
        r += 1
    # -- REPACK: one row per staged word — a bytepacking window WRITES the
    # code bytes; channel 1 writes the little-endian word to SEG_CODE_PACKED
    code_padded_now = code + b"\0" * (len(code) % 2)
    for base, waddr, ln in shape.repack_windows:
        data = code_padded_now[base: base + ln]
        em.pack(r, 0, SEG_CODE, base, data)
        word = int.from_bytes(data, "little")
        em.chan(r, 1, 0, SEG_CODE_PACKED, waddr, word)
        r += 1
    # -- SCAN: jumpdest analysis
    inpush = 0
    jumpdests = set()
    for i in range(shape.code_len):
        b = code[i]
        # PUSHLEN/IS_JD always hold the byte's TRUE properties (bound by
        # the opcode-info logUp); the zero-flag Z (INPUSH == 0) gates them
        pl = b - PUSH0 if PUSH0 <= b <= PUSH0 + 32 else 0
        is_jd = 1 if b == JUMPDEST else 0
        valid = 1 if (inpush == 0 and is_jd) else 0
        tr[INPUSH, r] = inpush
        tr[PUSHLEN, r] = pl
        tr[IS_JD, r] = is_jd
        tr[SCAN_COMB, r] = _opinfo(b)
        _fill_iszero(tr, r, inpush)
        em.chan(r, 1, 1, SEG_CODE, i, b)
        em.chan(r, 2, 0, SEG_JUMPDEST, i, valid)
        if valid:
            jumpdests.add(i)
        inpush = pl if inpush == 0 else inpush - 1
        r += 1
    assert inpush == 0, "code ends inside push data"
    # -- CHASH: declare + digest of the packed code
    hash_ts = TS_SLOTS * r + 6
    em.hashes.append(
        HashRequest(EVM_CTX, SEG_CODE_PACKED, 0, hash_ts, code_padded, staged=False)
    )
    tr[SP_FIRST, r] = 1
    tr[HS_SEG, r] = SEG_CODE_PACKED
    tr[HS_VIRT, r] = 0
    tr[H_TS, r] = hash_ts
    r += 1
    n_blocks = len(code_padded) // 136 + 1
    final_virt = (n_blocks - 1) * 5
    final_len = len(code_padded) - (n_blocks - 1) * 136
    tr[SP_FINAL, r] = 1
    tr[HS_SEG, r] = SEG_CODE_PACKED
    tr[H_TS, r] = hash_ts
    tr[H_FVIRT, r] = final_virt
    tr[H_FLEN, r] = final_len
    em.revb(r, codehash.to_bytes(32, "little"))
    r += 1

    exec_start = r
    # -- EXEC ------------------------------------------------------------------
    from ..evm.gas import GasMeter
    from ..gf import field_host as fh

    meter = GasMeter(
        original=dict(inputs.storage_pre), warm=set(inputs.warm_pre)
    )
    # per-row witness bookkeeping for the in-circuit gas columns (the
    # GAS/REFUND/MW/CQ columns and the touch-row quotient witnesses are
    # derived from these after the loop — vectorized, O(n) numpy)
    gd = np.zeros(em.n, dtype=np.uint64)  # per-row gas delta
    rdl = np.zeros(em.n, dtype=np.int64)  # per-row refund delta (signed)
    tnw = np.zeros(em.n, dtype=np.uint64)  # touch rows: NW (0 = no touch)
    tofl = np.zeros(em.n, dtype=np.uint64)  # touch rows: offset + length

    def touch(row: int, ofs: int, ln: int) -> None:
        if ln == 0:
            return
        nw_ = (ofs + ln + 31) // 32
        if nw_ >= 1 << 16:
            raise Unsupported("memory high-water mark beyond 2^16 words")
        tnw[row] = nw_
        tofl[row] = ofs + ln

    stack: List[int] = []
    evm_mem: Dict[int, int] = {}  # byte-addressed
    qd = np.zeros(em.n, dtype=np.uint64)  # 1 on query-op rows (QIDX cumsum)
    qcount = 0
    warm_addrs = set(inputs.warm_addrs)
    ccount = 0  # precompile calls so far
    xp = 0  # next free SEG_EXPS word address (3 per EXP)
    xp_rows = np.zeros(em.n, dtype=np.uint64)  # XP register per-row image
    retdata = b""  # last call's output (RETURNDATASIZE/RETURNDATACOPY)
    rds_rows = np.zeros(em.n, dtype=np.uint64)  # RDS register per-row image
    cd_calls = np.zeros(em.n, dtype=np.uint64)  # 1 on call op rows
    storage = dict(inputs.storage_pre)
    logs: List[Tuple[List[int], bytes]] = []
    return_data = b""
    success = 1
    pc = 0
    hp = 0  # SEG_HASH allocation pointer
    sp = 0
    n_final = shape.n_skeys
    exec_end = em.n - n_final

    def spush(row: int, ch: int, v: int) -> None:
        nonlocal sp
        if sp >= 1024:
            raise Unsupported(
                "stack depth beyond 1024 (EVM would fail the frame)"
            )
        em.chan(row, ch, 0, SEG_STACK, sp, v)
        stack.append(v)
        sp += 1

    def spop(row: int, ch: int) -> int:
        nonlocal sp
        v = stack.pop()
        sp -= 1
        em.chan(row, ch, 1, SEG_STACK, sp, v)
        return v

    # with no FINAL rows, reserve one padding row after the halt row so
    # the halt row's gas transition (charged on row -> row+1) exists
    budget_end = exec_end - (1 if n_final == 0 else 0)
    halted = False
    while not halted:
        if r >= budget_end:
            raise Unsupported(
                f"execution needs more than {budget_end - exec_start} rows"
            )
        op = code[pc] if pc < len(code) else STOP
        op_row = r
        u0, rf0 = meter.used, meter.refund
        tr[PC, r] = pc
        tr[SP, r] = sp
        tr[HP, r] = hp
        tr[LOGIDX, r] = len(logs)
        em.chan(r, 0, 1, SEG_CODE, pc, op)  # fetch
        if op in SEL:
            tr[SEL[op], r] = 1
        adv = 1
        if op in STATIC_GAS:
            meter.charge(STATIC_GAS[op])
        elif PUSH0 <= op <= PUSH0 + 32:
            meter.charge(2 if op == PUSH0 else 3)
        elif DUP1 <= op <= DUP1 + 15 or SWAP1 <= op <= SWAP1 + 15:
            meter.charge(3)
        # LOG* is fully dynamic — charged in its branch

        if op == STOP:
            halted = True
        elif op in _BINARITH:
            a = spop(r, 1)
            b = spop(r, 2)
            if op == ADD:
                res = (a + b) & WORD_MASK
                em.arith.append((ar.OP_ADD, a, b))
            elif op == MUL:
                res = (a * b) & WORD_MASK
                em.arith.append((ar.OP_MUL, a, b))
            elif op == SUB:
                res = (a - b) & WORD_MASK
                em.arith.append((ar.OP_SUB, a, b))
            elif op == DIV:
                res = a // b if b else 0
                em.arith.append((ar.OP_DIV, a, b))
            elif op == MOD:
                res = a % b if b else 0
                em.arith.append((ar.OP_MOD, a, b))
            elif op == LT:
                res = 1 if a < b else 0
                em.arith.append((ar.OP_LT, a, b))
            elif op == SLT:
                sa = a - (1 << 256) if a >> 255 else a
                sb = b - (1 << 256) if b >> 255 else b
                res = 1 if sa < sb else 0
                em.arith.append((ar.OP_SLT, a, b))
            elif op == SHL:  # EVM pops (shift, value)
                res = (b << a) & WORD_MASK if a < 256 else 0
                em.arith.append((ar.OP_SHL, b, a))
            elif op == SHR:
                res = (b >> a) if a < 256 else 0
                em.arith.append((ar.OP_SHR, b, a))
            elif op == SAR:
                sign = b >> 255
                if a < 256:
                    shr = b >> a
                    mask = ((1 << 256) - (1 << (256 - a))) if a else 0
                    res = (shr | mask) if sign else shr
                else:
                    res = (1 << 256) - 1 if sign else 0
                em.arith.append((ar.OP_SAR, b, a))
            elif op == SIGNEXTEND:
                if a < 32:
                    bits = 8 * (a + 1)
                    low = b & ((1 << bits) - 1)
                    sign = (b >> (bits - 1)) & 1
                    res = low | ((1 << 256) - (1 << bits)) if sign else low
                else:
                    res = b
                em.arith.append((ar.OP_SEXT, b, a))
            elif op == BYTE_:  # EVM pops (index, value)
                res = (b >> (8 * (31 - a))) & 0xFF if a < 32 else 0
                em.arith.append((ar.OP_BYTE, b, a))
            tr[
                AR_SWAP if op in (SHL, SHR, SAR, BYTE_, SIGNEXTEND)
                else AR_PLAIN,
                r,
            ] = 1
            spush(r, 3, res)
        elif op in (ADDMOD, MULMOD):
            x = spop(r, 1)
            y = spop(r, 2)
            n = spop(r, 3)
            acc = x + y if op == ADDMOD else x * y
            res = acc % n if n else 0
            em.arith.append(
                (ar.OP_ADDMOD if op == ADDMOD else ar.OP_MULMOD, x, y, n)
            )
            tr[AR_TERN, r] = 1
            spush(r, 4, res)
        elif op in (GT, SGT):  # a > b == b < a: swapped compare
            a = spop(r, 1)
            b = spop(r, 2)
            if op == GT:
                res = 1 if a > b else 0
                em.arith.append((ar.OP_LT, b, a))
            else:
                sa = a - (1 << 256) if a >> 255 else a
                sb = b - (1 << 256) if b >> 255 else b
                res = 1 if sa > sb else 0
                em.arith.append((ar.OP_SLT, b, a))
            tr[AR_SWAP, r] = 1
            spush(r, 3, res)
        elif op == EQ:
            a = spop(r, 1)
            b = spop(r, 2)
            d = (a - b) & WORD_MASK
            em.arith.append((ar.OP_SUB, a, b))
            for k, l in enumerate(_word_limbs(d)):
                tr[CH_VAL[4][k], r] = l  # scratch (no memory op: USED=0)
            _fill_iszero(tr, r, d)
            spush(r, 3, 1 if d == 0 else 0)
        elif op == ISZERO:
            a = spop(r, 1)
            _fill_iszero(tr, r, a)
            spush(r, 2, 1 if a == 0 else 0)
        elif op in _LOGIC:
            a = spop(r, 1)
            b = spop(r, 2)
            res = {AND_: a & b, OR_: a | b, XOR_: a ^ b}[op]
            em.logic.append((_LOGIC[op], a, b))
            tr[LG_PLAIN, r] = 1
            spush(r, 3, res)
        elif op == NOT_:
            a = spop(r, 1)
            res = a ^ WORD_MASK
            em.logic.append((OP_XOR, a, WORD_MASK))
            spush(r, 2, res)
        elif PUSH0 <= op <= PUSH0 + 32:
            n = op - PUSH0
            tr[F_PUSH, r] = 1
            tr[NSEL[n], r] = 1
            val = int.from_bytes(code[pc + 1: pc + 1 + n], "big") if n else 0
            if n:
                window = bytes(
                    code[pc + 1 + k] if pc + 1 + k < len(code) else 0
                    for k in range(32)
                )
                em.pack(r, 1, SEG_CODE, pc + 1, window)
            spush(r, 1, val)
            adv = 1 + n
        elif DUP1 <= op <= DUP1 + 15:
            n = op - DUP1 + 1
            tr[F_DUP, r] = 1
            tr[NSEL[n], r] = 1
            v = stack[-n]
            em.chan(r, 1, 1, SEG_STACK, sp - n, v)
            spush(r, 2, v)
        elif SWAP1 <= op <= SWAP1 + 15:
            n = op - SWAP1 + 1
            tr[F_SWAP, r] = 1
            tr[NSEL[n], r] = 1
            a, b = stack[-1], stack[-1 - n]
            em.chan(r, 1, 1, SEG_STACK, sp - 1, a)
            em.chan(r, 2, 1, SEG_STACK, sp - 1 - n, b)
            em.chan(r, 3, 0, SEG_STACK, sp - 1, b)
            em.chan(r, 4, 0, SEG_STACK, sp - 1 - n, a)
            stack[-1], stack[-1 - n] = b, a
        elif LOG0 <= op <= LOG0 + 4:
            n = op - LOG0
            li = len(logs)
            ofs, ln = stack[-1], stack[-2]
            topics = [stack[-3 - k] for k in range(n)]
            if li >= len(shape.log_shapes) or shape.log_shapes[li] != (n, ln):
                raise UnknownLogShape(li, n, ln)
            if li >= MAX_LOGS:
                raise Unsupported(f"more than {MAX_LOGS} LOG events")
            if ln > MAX_LOG_DATA:
                raise Unsupported(f"LOG data longer than {MAX_LOG_DATA} bytes")
            meter.charge_log(n, ln)
            meter.charge_mem(ofs, ln)
            touch(r, ofs, ln)
            dw = (ln + 31) // 32  # real data words (0 for empty payload)
            tr[F_LOG, r] = 1
            tr[NSEL[n], r] = 1
            tr[LSEL[li], r] = 1
            if dw >= 2:
                tr[R0, r] = ofs
            em.chan(r, 1, 1, SEG_STACK, sp - 1, ofs)
            em.chan(r, 2, 1, SEG_STACK, sp - 2, ln)
            if n >= 1:
                em.chan(r, 3, 1, SEG_STACK, sp - 3, topics[0])
            if n >= 2:
                em.chan(r, 4, 1, SEG_STACK, sp - 4, topics[1])
            data = bytes(evm_mem.get(ofs + k, 0) for k in range(ln))
            if ln:
                em.pack(r, 1, SEG_MAIN, ofs, data[:32])
            lay_logs = lay["log_words"][li]
            for t in range(n):
                pi_words[lay_logs + t] = topics[t]
            for w in range(shape.n_data_words(ln)):
                chunk = data[32 * w: 32 * w + 32]
                pi_words[lay_logs + n + w] = int.from_bytes(
                    chunk.ljust(32, b"\0"), "big"
                )
            logs.append((topics, data))
            if inputs.log_sink is not None:
                # tx-global log order across call frames (receipts)
                inputs.log_sink.append((inputs.address, topics, data))
            del stack[-2 - n:]
            if n >= 3:
                # continuation row reads topics 3/4 and drops the slots
                tr[HALTED, r] = 0
                r += 1
                if r >= budget_end:
                    raise Unsupported("execution rows exhausted in LOG")
                tr[S_LOGX, r] = 1
                tr[LSEL[li], r] = 1
                tr[PC, r] = pc
                tr[SP, r] = sp
                tr[HP, r] = hp
                tr[LOGIDX, r] = li
                if dw >= 2:
                    tr[R0, r] = ofs
                em.chan(r, 1, 1, SEG_STACK, sp - 5, topics[2])
                if n >= 4:
                    em.chan(r, 2, 1, SEG_STACK, sp - 6, topics[3])
            sp -= 2 + n
            # data words 1.. stage on LOGD continuation rows
            for w in range(1, dw):
                r += 1
                if r >= budget_end:
                    raise Unsupported("execution rows exhausted in LOG data")
                tr[S_LOGD, r] = 1
                tr[LSEL[li], r] = 1
                tr[NSEL[w], r] = 1
                tr[R0, r] = ofs
                tr[PC, r] = pc
                tr[SP, r] = sp
                tr[HP, r] = hp
                tr[LOGIDX, r] = li
                em.pack(r, 1, SEG_MAIN, ofs + 32 * w, data[32 * w: 32 * w + 32])
        elif op == POP:
            stack.pop()
            sp -= 1  # pure sp drop: dead cell needs no read
        elif op == PC_OP:
            spush(r, 1, pc)
        elif op in ENV_OPS:
            spush(r, 1, pi_words[lay[ENV_OPS[op]]])
        elif op == RETURNDATASIZE:
            spush(r, 1, len(retdata))
        elif op in (CALLDATACOPY, CODECOPY, RETURNDATACOPY):
            dest = spop(r, 1)
            src = spop(r, 2)
            ln = spop(r, 3)
            if ln >= 1 << 16:
                raise Unsupported("copy length >= 2^16")
            if src >= 1 << 32:
                raise Unsupported("copy source offset >= 2^32")
            if op == RETURNDATACOPY:
                # EIP-211: reading past the returndata end reverts; the
                # envelope proves only in-bounds copies, and the bound is
                # enforced in-circuit via the byte-checked M8B witness
                if src + ln > len(retdata):
                    raise Unsupported("RETURNDATACOPY out of bounds")
                slack = len(retdata) - (src + ln)
                tr[M8B0, r] = slack & 0xFF
                tr[M8B1, r] = slack >> 8
            meter.charge(3 * ((ln + 31) // 32))
            meter.charge_mem(dest, ln)
            touch(r, dest, ln)
            _fill_iszero(tr, r, ln)  # ln == 0 -> no copy rows
            kwords = (ln + 31) // 32
            tr[KWORDS, r] = kwords
            kpad = 32 * kwords - ln
            for b in range(5):
                tr[KPD[b], r] = (kpad >> b) & 1
            seg_src = {CALLDATACOPY: SEG_CALLDATA, CODECOPY: SEG_CODE,
                       RETURNDATACOPY: SEG_RETDATA}[op]
            src_len = {CALLDATACOPY: shape.calldata_len,
                       CODECOPY: len(code),
                       RETURNDATACOPY: len(retdata)}[op]
            src_bytes = {CALLDATACOPY: calldata, CODECOPY: code,
                         RETURNDATACOPY: retdata}[op]
            tr[R0, r], tr[R1, r], tr[R2, r] = src, dest, ln
            tr[HS_SEG, r] = seg_src
            r0, r1, r2 = src, dest, ln
            while r2 > 0:
                cs = min(32, r2)
                fullc = 1 if r2 > 32 else 0
                rck = (r2 - 33) if fullc else (32 - r2)
                data = bytes(
                    src_bytes[r0 + k] if r0 + k < src_len else 0
                    for k in range(cs)
                )
                for row_kind in (S_CPR, S_CPW):
                    r += 1
                    if r >= budget_end:
                        raise Unsupported("execution rows exhausted in copy")
                    tr[row_kind, r] = 1
                    tr[FULLC, r] = fullc
                    tr[CSW, r] = cs
                    if row_kind == S_CPR:
                        tr[RB0, r], tr[RB1, r] = rck & 0xFF, rck >> 8
                    tr[R0, r], tr[R1, r], tr[R2, r] = r0, r1, r2
                    tr[HS_SEG, r] = seg_src
                    tr[PC, r] = pc
                    tr[SP, r] = sp
                    tr[HP, r] = hp
                    tr[LOGIDX, r] = len(logs)
                    if row_kind == S_CPR:
                        em.pack(r, 1, seg_src, r0, data)
                    else:
                        em.pack(r, 0, SEG_MAIN, r1, data)
                        for k, byte in enumerate(data):
                            evm_mem[r1 + k] = byte
                r0, r1, r2 = r0 + cs, r1 + cs, r2 - cs
        elif op == EXP:
            base_v = stack[-1]
            exp_v = stack[-2]
            res_v = pow(base_v, exp_v, 1 << 256)
            # setup row: pop base (ch1), exp (ch2); for e == 0 push the
            # result 1 directly (ch3); else write exp and ACC=1 to the
            # scratch segment (ch3/ch4) and run the micro-machine
            em.chan(r, 1, 1, SEG_STACK, sp - 1, base_v)
            em.chan(r, 2, 1, SEG_STACK, sp - 2, exp_v)
            _fill_iszero(tr, r, exp_v)
            del stack[-2:]
            sp -= 2
            if exp_v == 0:
                em.chan(r, 3, 0, SEG_STACK, sp, 1)
                stack.append(1)
                sp += 1
            else:
                em.chan(r, 3, 0, SEG_EXPS, xp, exp_v)
                em.chan(r, 4, 0, SEG_EXPS, xp + 2, 1)
                # EXI row: write S = base, copy exp/base words across
                r += 1
                if r >= budget_end:
                    raise Unsupported("execution rows exhausted in EXP")
                tr[S_EXI, r] = 1
                tr[PC, r] = pc
                tr[SP, r] = sp
                tr[HP, r] = hp
                tr[LOGIDX, r] = len(logs)
                em.chan(r, 1, 1, SEG_STACK, sp + 1, base_v)  # re-read base
                em.chan(r, 2, 0, SEG_EXPS, xp + 1, base_v)  # S_0
                nbits = exp_v.bit_length()
                acc_v, s_v = 1, base_v
                exp_limbs = _word_limbs(exp_v)
                for i in range(nbits):
                    b = (exp_v >> i) & 1
                    j, w = i // 16, i % 16
                    is_term = i == nbits - 1
                    # M row: ACC' = ACC * (b ? S : 1)
                    r += 1
                    if r >= budget_end:
                        raise Unsupported("execution rows exhausted in EXP")
                    mult = s_v if b else 1
                    acc_n = acc_v * mult % (1 << 256)
                    tr[S_EXM, r] = 1
                    tr[XB, r] = b
                    tr[POW, r] = 1 << w
                    tr[LACC, r] = sum(
                        ((exp_v >> (16 * j + k)) & 1) << k for k in range(w)
                    )
                    tr[LACN, r] = int(tr[LACC, r]) + b * (1 << w)
                    tr[BITC, r] = i
                    tr[NSEL[j], r] = 1
                    if w == 15:
                        tr[LB, r] = 1
                    else:
                        tr[LBI, r] = fh.inv(((1 << w) - (1 << 15)) % fh.P)
                    tr[PC, r] = pc
                    tr[SP, r] = sp
                    tr[HP, r] = hp
                    tr[LOGIDX, r] = len(logs)
                    em.chan(r, 1, 1, SEG_EXPS, xp + 2, acc_v)
                    if b:
                        em.chan(r, 2, 1, SEG_EXPS, xp + 1, s_v)
                    else:
                        for k, l in enumerate(_word_limbs(1)):
                            tr[CH_VAL[2][k], r] = l
                    if is_term:
                        tr[TERM, r] = 1
                        blen = (nbits + 7) // 8
                        meter.charge(50 * blen)
                        gd[r] += 50 * blen
                        u0 += 50 * blen  # charged here, not on the op row
                        tr[KWORDS, r] = blen
                        pad = 8 * blen - i - 1
                        for pb_ in range(3):
                            tr[PB[pb_], r] = (pad >> pb_) & 1
                        em.chan(r, 3, 0, SEG_STACK, sp, acc_n)
                        stack.append(acc_n)
                        sp += 1
                    else:
                        em.chan(r, 3, 0, SEG_EXPS, xp + 2, acc_n)
                    em.chan(r, 4, 1, SEG_EXPS, xp, exp_v)
                    em.arith.append((ar.OP_MUL, acc_v, mult))
                    tr[AR_PLAIN, r] = 1
                    acc_v = acc_n
                    if is_term:
                        break
                    # Q row: S' = S * S
                    r += 1
                    if r >= budget_end:
                        raise Unsupported("execution rows exhausted in EXP")
                    s_n = s_v * s_v % (1 << 256)
                    tr[S_EXQ, r] = 1
                    tr[XB, r] = b
                    tr[POW, r] = 1 << w
                    tr[LACC, r] = int(tr[LACC, r - 1])
                    tr[LACN, r] = int(tr[LACN, r - 1])
                    tr[BITC, r] = i
                    tr[NSEL[j], r] = 1
                    if w == 15:
                        tr[LB, r] = 1
                    else:
                        tr[LBI, r] = fh.inv(((1 << w) - (1 << 15)) % fh.P)
                    tr[PC, r] = pc
                    tr[SP, r] = sp
                    tr[HP, r] = hp
                    tr[LOGIDX, r] = len(logs)
                    em.chan(r, 1, 1, SEG_EXPS, xp + 1, s_v)
                    em.chan(r, 2, 1, SEG_EXPS, xp + 1, s_v)
                    em.chan(r, 3, 0, SEG_EXPS, xp + 1, s_n)
                    em.arith.append((ar.OP_MUL, s_v, s_v))
                    tr[AR_PLAIN, r] = 1
                    s_v = s_n
                assert acc_v == res_v
                xp_rows[r + 1:] = xp + 3
                xp += 3
        elif op in (CALL, STATICCALL):
            is_call = op == CALL
            d = 1 if is_call else 0
            # stack (top down): gas, addr, [value,] argsOfs, argsLen,
            # retOfs, retLen — spread over the op row and the CLA row
            gasw = stack[-1]
            addr = stack[-2]
            value = stack[-3] if is_call else 0
            args_ofs = stack[-3 - d]
            args_len = stack[-4 - d]
            ret_ofs = stack[-5 - d]
            ret_len = stack[-6 - d]
            is_frame = addr not in PRECOMPILES
            if value != 0:
                raise Unsupported("inner call with value")
            if not (1 <= args_len <= 256):
                raise Unsupported("call args length outside 1..256")
            if args_ofs >= 1 << 32 or ret_ofs >= 1 << 32:
                raise Unsupported("call memory offset >= 2^32")
            from ..evm.gas import memory_cost, words_for

            data = bytes(evm_mem.get(args_ofs + k, 0) for k in range(args_len))
            new_words = max(
                meter.mem_words,
                words_for(args_ofs, args_len),
                words_for(ret_ofs, ret_len) if ret_len else 0,
            )
            mem_delta = memory_cost(new_words) - memory_cost(meter.mem_words)
            f_refund = 0
            if is_frame:
                # inner CONTRACT frame: proved by a separate machine
                # proof of the callee's own shape; the resolver (the tx
                # driver, evm/contract.py) executes it recursively and
                # this frame binds [addr, gas, refund] + input/output
                # words as its per-call PI directory
                if inputs.frame_resolver is None:
                    raise Unsupported(
                        f"inner call target {addr:#x} is not a supported "
                        "precompile and no frame resolver is available"
                    )
                if inputs.gas_budget <= 0:
                    raise Unsupported("inner frame call needs a gas budget")
                acost = 100 if addr in warm_addrs else 2600
                warm_addrs.add(addr)
                rem = inputs.gas_budget - meter.used - acost - mem_delta
                if rem < 0:
                    raise Unsupported("out of gas at inner call")
                fwd_cap = min(gasw, rem - rem // 64)  # EIP-150
                outcome = inputs.frame_resolver(
                    addr, value, data, fwd_cap, tuple(sorted(warm_addrs))
                )
                if outcome is None:
                    raise Unsupported(
                        f"inner call target {addr:#x} outside the frame "
                        "resolver's scope"
                    )
                f_success, output, f_gas, f_refund, warm_post = outcome
                if f_success != 1:
                    raise Unsupported(
                        "reverting inner frames are outside the envelope"
                    )
                if f_gas > fwd_cap:
                    raise Unsupported("inner frame overran its forwarded gas")
                warm_addrs.update(warm_post)
                out_len = len(output)
                if out_len > 256:
                    raise Unsupported("frame returndata beyond 256 bytes")
                if not 0 <= ret_len <= out_len:
                    raise Unsupported("frame retLen beyond the returndata")
                entry = (op, FRAME_TARGET, args_len, ret_len, out_len)
                call_gas = acost + f_gas
            else:
                out_len = shape.call_out_len(addr, args_len, ret_len)
                if addr != 5 and ret_len not in (0, out_len):
                    raise Unsupported(
                        "call retLen must be 0 or the output length"
                    )
                entry = (op, addr, args_len, ret_len, out_len)
                output = _run_precompile(addr, data)
                if len(output) != out_len:
                    # modexp: retLen must equal msize; others can't differ
                    raise Unsupported(
                        f"precompile {addr:#x} output {len(output)}B != "
                        f"declared retLen {out_len}B"
                    )
                # gas: warm account access + precompile cost on the op
                # row; ret-area expansion charges on the CLA transition
                wcount = (args_len + 31) // 32
                if addr == 5:
                    pre_cost = modexp_gas(data)  # EIP-2565
                elif addr == 6:
                    pre_cost = 150  # EIP-1108
                elif addr == 7:
                    pre_cost = 6000  # EIP-1108
                elif addr == 9:
                    pre_cost = int.from_bytes(data[:4], "big")  # EIP-152
                else:
                    pre_cost = {1: 3000, 2: 60 + 12 * wcount,
                                3: 600 + 120 * wcount, 4: 15 + 3 * wcount}[addr]
                # EIP-150 forwarding: consensus sends min(gasw, 63/64 of
                # the gas remaining after the access + memory-expansion
                # charges); a precompile receiving less than its cost
                # fails with success=0 and consumes only the forwarded
                # gas — a path the machine does not prove. Gas-starved
                # calls therefore leave the envelope HERE (explicit
                # Unsupported at generation time) instead of surfacing
                # later as a state-root/gas mismatch.
                fwd_cap = gasw
                if inputs.gas_budget > 0:
                    rem = inputs.gas_budget - meter.used - 100 - mem_delta
                    if rem < 0:
                        raise Unsupported("out of gas at precompile call")
                    fwd_cap = min(gasw, rem - rem // 64)
                if fwd_cap < pre_cost:
                    raise Unsupported(
                        f"precompile {addr:#x} forwarded gas {fwd_cap} < "
                        f"cost {pre_cost} (call would fail in consensus)"
                    )
                call_gas = 100 + pre_cost
            # over-limit traces must fail fast, BEFORE the discovery
            # loop grows call_shapes past the CSEL bank width and pays
            # an extra re-execution with an oversized PI layout
            if ccount >= MAX_CALLS:
                raise Unsupported(f"more than {MAX_CALLS} inner calls")
            if ccount >= len(shape.call_shapes):
                raise UnknownCallShape(ccount, entry)
            if shape.call_shapes[ccount] != entry:
                raise UnknownCallShape(ccount, entry)
            ci = ccount
            cd_calls[r] = 1
            in_words = shape.call_in_words(args_len)
            out_words = (out_len + 31) // 32
            meter.charge(call_gas)
            meter.refund += f_refund
            meter.charge_mem(args_ofs, args_len)
            touch(r, args_ofs, args_len)
            # op row: ch1 argsOfs, ch2 argsLen, ch3 gas, ch4 addr
            tr[CSEL[ci], r] = 1
            tr[R0, r] = args_ofs
            em.chan(r, 1, 1, SEG_STACK, sp - 3 - d, args_ofs)
            em.chan(r, 2, 1, SEG_STACK, sp - 4 - d, args_len)
            em.chan(r, 3, 1, SEG_STACK, sp - 1, gasw)
            em.chan(r, 4, 1, SEG_STACK, sp - 2, addr)
            del stack[-4 - d:]
            sp -= 4 + d
            gd[op_row] += meter.used - u0
            u0 = meter.used
            # CLA row: ch1 retOfs, ch2 retLen, ch3 success write,
            # ch4 value read (CALL only)
            r += 1
            if r >= budget_end:
                raise Unsupported("execution rows exhausted in call")
            tr[S_CLA, r] = 1
            tr[CSEL[ci], r] = 1
            cla_row = r
            tr[PC, r] = pc
            tr[SP, r] = sp
            tr[HP, r] = hp
            tr[LOGIDX, r] = len(logs)
            tr[R0, r] = args_ofs
            tr[R1, r] = ret_ofs
            em.chan(r, 1, 1, SEG_STACK, sp - 1, ret_ofs)
            em.chan(r, 2, 1, SEG_STACK, sp - 2, ret_len)
            em.chan(r, 3, 0, SEG_STACK, sp - 2, 1)  # success
            if is_call:
                em.chan(r, 4, 1, SEG_STACK, sp + 2, value)
            if ret_len:
                meter.charge_mem(ret_ofs, ret_len)
                touch(r, ret_ofs, ret_len)
            gd[r] += meter.used - u0
            u0 = meter.used
            del stack[-2:]
            stack.append(1)
            sp -= 1
            # per-call PI directory words ([addr, gas, refund] for
            # frames, [gas] for dyngas precompiles), then input words
            qb = lay["call_words"][ci]
            dirw = shape.call_dir_words(entry[1])
            if entry[1] == FRAME_TARGET:
                pi_words[qb] = addr
                pi_words[qb + 1] = call_gas
                pi_words[qb + 2] = f_refund % fh.P
            elif dirw:
                pi_words[qb] = call_gas
            qb += dirw
            # input-word staging rows (PI-bound via REVB)
            for w in range(in_words):
                r += 1
                if r >= budget_end:
                    raise Unsupported("execution rows exhausted in call")
                tr[S_CLI, r] = 1
                tr[CSEL[ci], r] = 1
                tr[NSEL[w], r] = 1
                tr[PC, r] = pc
                tr[SP, r] = sp
                tr[HP, r] = hp
                tr[LOGIDX, r] = len(logs)
                tr[R0, r] = args_ofs
                tr[R1, r] = ret_ofs
                cs = min(32, args_len - 32 * w)
                em.pack(r, 1, SEG_MAIN, args_ofs + 32 * w,
                        data[32 * w: 32 * w + cs])
                pi_words[qb + w] = int.from_bytes(
                    data[32 * w: 32 * w + 32].ljust(32, b"\0"), "big"
                )
            # output-word staging rows (write SEG_RETDATA, PI-bound)
            cb = ret_len  # copy-back length (0 or out_len)
            for w in range(out_words):
                r += 1
                if r >= budget_end:
                    raise Unsupported("execution rows exhausted in call")
                tr[S_CLO, r] = 1
                tr[CSEL[ci], r] = 1
                tr[NSEL[w], r] = 1
                tr[PC, r] = pc
                tr[SP, r] = sp
                tr[HP, r] = hp
                tr[LOGIDX, r] = len(logs)
                tr[R1, r] = ret_ofs
                tr[R2, r] = cb
                tr[HS_SEG, r] = SEG_RETDATA
                cs = min(32, out_len - 32 * w)
                em.pack(r, 0, SEG_RETDATA, 32 * w,
                        output[32 * w: 32 * w + cs])
                pi_words[qb + in_words + w] = int.from_bytes(
                    output[32 * w: 32 * w + 32].ljust(32, b"\0"), "big"
                )
            retdata = output
            # the RDS register flips on the op->CLA transition
            rds_rows[cla_row:] = out_len
            # copy-back to memory[retOfs:retOfs+retLen] via CPR/CPW rows
            if cb:
                tr[CBGO, r] = 1
                r0, r1, r2 = 0, ret_ofs, cb
                while r2 > 0:
                    cs = min(32, r2)
                    fullc = 1 if r2 > 32 else 0
                    rck = (r2 - 33) if fullc else (32 - r2)
                    chunk = output[r0: r0 + cs]
                    for row_kind in (S_CPR, S_CPW):
                        r += 1
                        if r >= budget_end:
                            raise Unsupported(
                                "execution rows exhausted in call copy"
                            )
                        tr[row_kind, r] = 1
                        tr[FULLC, r] = fullc
                        tr[CSW, r] = cs
                        if row_kind == S_CPR:
                            tr[RB0, r], tr[RB1, r] = rck & 0xFF, rck >> 8
                        tr[R0, r], tr[R1, r], tr[R2, r] = r0, r1, r2
                        tr[HS_SEG, r] = SEG_RETDATA
                        tr[PC, r] = pc
                        tr[SP, r] = sp
                        tr[HP, r] = hp
                        tr[LOGIDX, r] = len(logs)
                        if row_kind == S_CPR:
                            em.pack(r, 1, SEG_RETDATA, r0, chunk)
                        else:
                            em.pack(r, 0, SEG_MAIN, r1, chunk)
                            for k, byte in enumerate(chunk):
                                evm_mem[r1 + k] = byte
                    r0, r1, r2 = r0 + cs, r1 + cs, r2 - cs
            ccount += 1
        elif op == MSIZE:
            msize = 32 * meter.mem_words
            tr[M8B0, r] = msize & 0xFF
            tr[M8B1, r] = (msize >> 8) & 0xFF
            for b in range(5):
                tr[PB[b], r] = (msize >> (16 + b)) & 1
            spush(r, 1, msize)
        elif op == MSTORE8:
            ofs = spop(r, 1)
            val = spop(r, 2)
            meter.charge_mem(ofs, 1)
            touch(r, ofs, 1)
            byte = val & 0xFF
            tr[M8B0, r] = byte
            tr[M8B1, r] = (val >> 8) & 0xFF
            em.pack(r, 0, SEG_MAIN, ofs, bytes([byte]))
            evm_mem[ofs] = byte
        elif op == CALLDATASIZE:
            spush(r, 1, shape.calldata_len)
        elif op == CODESIZE:
            spush(r, 1, shape.code_len)
        elif op == GAS_OP:
            # pushes gas remaining AFTER this op's own charge (already
            # applied via STATIC_GAS); bound in-circuit to the gasbudget
            # PI minus the running GAS column via a 4-byte decomposition
            v = inputs.gas_budget - meter.used
            if inputs.gas_budget <= 0 or v < 0 or v >= 1 << 32:
                raise Unsupported("GAS opcode needs a 32-bit gas budget")
            tr[M8B0, r] = v & 0xFF
            tr[M8B1, r] = (v >> 8) & 0xFF
            tr[RB0, r] = (v >> 16) & 0xFF
            tr[RB1, r] = (v >> 24) & 0xFF
            spush(r, 1, v)
        elif op in QUERY_OPS:
            # environment-query directory: (opcode, arg, result, gas)
            # binds to PI 4-tuple qcount; the verifier re-derives every
            # tuple from the witness (state trie / block hashes / warmth)
            if qcount >= shape.n_queries:
                raise UnknownQueryCount(qcount + 1)
            if qcount >= MAX_QUERIES:
                raise Unsupported(f"more than {MAX_QUERIES} env queries")
            if inputs.query_resolver is None:
                raise Unsupported(f"opcode {op:#x} needs a query resolver")
            if op == SELFBALANCE:
                arg = pi_words[lay["address"]]
                res = int(inputs.query_resolver(op, arg))
                cost = 5
                spush(r, 1, res)
            else:
                arg = spop(r, 1)
                if op == BLOCKHASH:
                    res = int(inputs.query_resolver(op, arg))
                    cost = 20
                else:
                    addr = arg & ((1 << 160) - 1)
                    res = int(inputs.query_resolver(op, addr))
                    cost = 100 if addr in warm_addrs else 2600
                    warm_addrs.add(addr)
                spush(r, 2, res)
            meter.charge(cost)
            qd[r] = 1
            tr[QSEL[qcount], r] = 1
            qbase = lay["queries"] + 4 * qcount
            pi_words[qbase] = op
            pi_words[qbase + 1] = arg
            pi_words[qbase + 2] = res
            pi_words[qbase + 3] = cost
            qcount += 1
        elif op == CALLDATALOAD:
            ofs = spop(r, 1)
            if ofs >= 1 << 32:
                raise Unsupported("calldata offset >= 2^32")
            window = bytes(
                calldata[ofs + k] if ofs + k < len(calldata) else 0
                for k in range(32)
            )
            em.pack(r, 1, SEG_CALLDATA, ofs, window)
            spush(r, 2, int.from_bytes(window, "big"))
        elif op == MLOAD:
            ofs = spop(r, 1)
            meter.charge_mem(ofs, 32)
            touch(r, ofs, 32)
            window = bytes(evm_mem.get(ofs + k, 0) for k in range(32))
            em.pack(r, 1, SEG_MAIN, ofs, window)
            spush(r, 2, int.from_bytes(window, "big"))
        elif op == MSTORE:
            ofs = spop(r, 1)
            val = spop(r, 2)
            meter.charge_mem(ofs, 32)
            touch(r, ofs, 32)
            data = val.to_bytes(32, "big")
            em.pack(r, 0, SEG_MAIN, ofs, data)
            for k, byte in enumerate(data):
                evm_mem[ofs + k] = byte
        elif op == KECCAK256:
            # SETUP row: pop (ofs, len), declare the sponge request; KPACK
            # micro-rows stage the message in the sponge layout (4x32B +
            # 1x8B words per 136-byte block, partial final chunk); a KDIG
            # row consumes the digest. Arbitrary lengths < 2^16.
            ofs = spop(r, 1)
            ln = spop(r, 2)
            if ln >= 1 << 16:
                raise Unsupported("KECCAK256 length >= 2^16")
            meter.charge_keccak(ln)
            meter.charge_mem(ofs, ln)
            touch(r, ofs, ln)
            _fill_iszero(tr, r, ln)  # ln == 0 -> no touch, no KPACK rows
            msg = bytes(evm_mem.get(ofs + k, 0) for k in range(ln))
            tr[R0, r] = ofs
            tr[R1, r] = hp
            tr[R2, r] = ln
            tr[KLEN, r] = ln
            kwords = (ln + 31) // 32
            tr[KWORDS, r] = kwords
            kpad = 32 * kwords - ln
            for b in range(5):
                tr[KPD[b], r] = (kpad >> b) & 1
            tr[SP_FIRST, r] = 1
            # the sponge reads the staged words at the KDIG row's sponge
            # slot, after the KPACK rows wrote them (the counterpart reads
            # at the SETUP row's slot, before the writes: a read of an
            # unwritten address with a nonzero value, which the Memory
            # table's constraints reject)
            hash_ts = TS_SLOTS * (r + 1 + _kpack_rows(ln)) + 6
            tr[HS_SEG, r] = SEG_HASH
            tr[HS_VIRT, r] = hp
            tr[H_TS, r] = hash_ts
            em.hashes.append(
                HashRequest(EVM_CTX, SEG_HASH, hp, hash_ts, msg, staged=False)
            )
            base_hp = hp
            r += 1
            r0, r1, r2 = ofs, hp, ln
            phase = 0
            kblk = 0
            while r2 > 0:
                if r >= budget_end:
                    raise Unsupported("execution rows exhausted in KECCAK256")
                cap = 8 if phase == 4 else 32
                cs = min(cap, r2)
                tr[S_KPACK, r] = 1
                tr[KP[phase], r] = 1
                # strict: FULLC <=> more remains after this chunk
                fullc = 1 if r2 > cap else 0
                tr[FULLC, r] = fullc
                tr[CSW, r] = cs
                rck = (r2 - cap - 1) if fullc else (cap - r2)
                tr[RB0, r], tr[RB1, r] = rck & 0xFF, rck >> 8
                tr[KBLK, r] = kblk
                tr[KLEN, r] = ln
                tr[PC, r] = pc
                tr[SP, r] = sp
                tr[R0, r], tr[R1, r], tr[R2, r] = r0, r1, r2
                tr[HP, r] = base_hp
                tr[LOGIDX, r] = len(logs)
                tr[HS_SEG, r] = SEG_HASH
                tr[H_TS, r] = hash_ts
                data = bytes(evm_mem.get(r0 + k, 0) for k in range(cs))
                em.pack(r, 1, SEG_MAIN, r0, data)
                em.chan(r, 1, 0, SEG_HASH, r1, int.from_bytes(data, "little"))
                if phase == 4:
                    kblk += 1
                r0, r1, r2 = r0 + cs, r1 + 1, r2 - cs
                phase = (phase + 1) % 5
                r += 1
            if r >= budget_end:
                raise Unsupported("execution rows exhausted in KECCAK256")
            digest = keccak256(msg)
            n_blocks = ln // 136 + 1
            assert kblk == n_blocks - 1
            tr[S_KDIG, r] = 1
            tr[SP_FINAL, r] = 1
            tr[PC, r] = pc
            tr[SP, r] = sp
            tr[LOGIDX, r] = len(logs)
            tr[R1, r] = r1
            tr[KBLK, r] = kblk
            tr[KLEN, r] = ln
            tr[HS_SEG, r] = SEG_HASH
            tr[H_TS, r] = hash_ts
            tr[H_FVIRT, r] = base_hp + 5 * kblk
            tr[H_FLEN, r] = ln - 136 * kblk
            em.revb(r, digest)  # LE byte stream of the LE digest word
            hp = base_hp + 5 * n_blocks  # each block reserves 5 word slots
            tr[HP, r] = hp
            spush(r, 1, int.from_bytes(digest, "big"))
        elif op in (SLOAD, SSTORE):
            # two-row ops: the op row does the stack/journal work, the
            # continuation row (S_SLX/S_SSX) reads + sets the EIP-2929
            # warm flag (and lands the SSTORE journal writes)
            key = spop(r, 1)
            if key not in skeys:
                raise UnknownStorageKey(key)
            idx = skeys.index(key)
            tr[SIDX, r] = idx
            ksum = sum(_word_limbs(key))
            tr[KINV, r] = fh.inv(ksum % fh.P)
            wold = 1 if key in meter.warm else 0
            if op == SLOAD:
                meter.charge_sload(key)
                em.chan(r, 2, 1, SEG_SKEYS, idx, key)
                em.chan(r, 3, 1, SEG_SVALS, idx, storage[key])
                spush(r, 4, storage[key])
            else:
                val = spop(r, 2)
                current = storage[key]
                original = inputs.storage_pre.get(key, 0)
                meter.charge_sstore(key, current, val)
                em.chan(r, 3, 1, SEG_SVALS, idx, current)
                em.chan(r, 4, 1, SEG_SORIG, idx, original)
                _fill_iszero(tr, r, current)  # C0 (current == 0)
                _fill_eq(tr, r, (E_VC, D_VC, I_VC, S_VC), val, current)
                _fill_eq(tr, r, (E_CO, D_CO, I_CO, S_CO), current, original)
                _fill_eq(tr, r, (E_VO, D_VO, I_VO, S_VO), val, original)
                _fill_iszero3(tr, r, (EO0, SO0, IO0), original)
                _fill_iszero3(tr, r, (EV0, SV0, IV0), val)
                e_vc = 1 if val == current else 0
                e_co = 1 if current == original else 0
                tr[P1, r] = (1 - e_vc) * e_co
                tr[P2, r] = (1 - e_vc) * (1 - e_co)
                storage[key] = val
            r += 1
            if r >= budget_end:
                raise Unsupported("execution rows exhausted in storage op")
            tr[S_SLX if op == SLOAD else S_SSX, r] = 1
            tr[PC, r] = pc
            tr[SP, r] = sp
            tr[HP, r] = hp
            tr[LOGIDX, r] = len(logs)
            if op == SLOAD:
                em.chan(r, 1, 1, SEG_SWARM, idx, wold)
                em.chan(r, 2, 0, SEG_SWARM, idx, 1)
            else:
                em.chan(r, 1, 0, SEG_SVALS, idx, storage[key])
                em.chan(r, 2, 1, SEG_SKEYS, idx, key)
                em.chan(r, 3, 1, SEG_SWARM, idx, wold)
                em.chan(r, 4, 0, SEG_SWARM, idx, 1)
        elif op == JUMP:
            dest = spop(r, 1)
            em.chan(r, 2, 1, SEG_JUMPDEST, dest, 1)
            assert dest in jumpdests, f"invalid jump dest {dest}"
            pc = dest
            adv = 0
        elif op == JUMPI:
            dest = spop(r, 1)
            cond = spop(r, 2)
            _fill_iszero(tr, r, cond)
            if cond:
                em.chan(r, 3, 1, SEG_JUMPDEST, dest, 1)
                assert dest in jumpdests, f"invalid jump dest {dest}"
                pc = dest
                adv = 0
        elif op == JUMPDEST:
            pass
        elif op in (RETURN, REVERT):
            # pops are real channel reads (the gas circuit needs the
            # operands for memory expansion); data itself stays unexposed
            ofs = spop(r, 1)
            ln = spop(r, 2)
            _fill_iszero(tr, r, ln)  # ln == 0 -> no memory touch
            meter.charge_mem(ofs, ln)
            touch(r, ofs, ln)
            return_data = bytes(evm_mem.get(ofs + k, 0) for k in range(ln))
            success = 1 if op == RETURN else 0
            halted = True
        else:
            raise Unsupported(f"opcode {op:#x} not in the machine's set")
        # in-circuit gas: the op row's transition carries the whole charge
        # (KECCAK256 reassigns u0 after distributing 6/word to KPACK rows)
        gd[op_row] += meter.used - u0
        rdl[op_row] += meter.refund - rf0
        if op != KECCAK256:
            pc += adv
        else:
            pc += 1
        r += 1

    assert ccount == len(shape.call_shapes), "unused call shapes"
    halt_row = r - 1
    # padding exec rows: HALTED sticks, registers carry
    for rr in range(r, exec_end):
        tr[HALTED, rr] = 1
        tr[PC, rr] = pc
        tr[SP, rr] = sp
        tr[HP, rr] = hp
        tr[LOGIDX, rr] = len(logs)
    tr[HALTED, halt_row] = 0  # halt row itself is active; sticky from next
    # -- FINAL: bind post-values
    for i, k in enumerate(skeys):
        rr = exec_end + i
        tr[HALTED, rr] = 1
        tr[PC, rr] = pc
        tr[SP, rr] = sp
        tr[HP, rr] = hp
        tr[LOGIDX, rr] = len(logs)
        em.chan(rr, 1, 1, SEG_SVALS, i, storage[k])
        pi_words[lay["storage"] + 4 * i + 3] = storage[k]

    # -- in-circuit gas columns (vectorized from the per-row deltas)
    n = em.n
    gas_col = np.zeros(n, dtype=np.uint64)
    gas_col[1:] = np.cumsum(gd)[:-1]
    tr[GAS] = gas_col
    ref_cum = np.concatenate(([0], np.cumsum(rdl)[:-1]))
    ref_field = ref_cum.astype(np.uint64)
    neg = ref_cum < 0
    # transiently negative counters map to field elements P - |v|
    ref_field[neg] = np.uint64(fh.P) - (-ref_cum[neg]).astype(np.uint64)
    tr[REFUND] = ref_field
    # memory high-water mark: max of all earlier touch NWs
    mw_col = np.zeros(n, dtype=np.uint64)
    mw_col[1:] = np.maximum.accumulate(tnw)[:-1]
    tr[MW] = mw_col
    tr[CQ] = 3 * mw_col + (mw_col * mw_col) // 512
    touch_rows = np.nonzero(tnw)[0]
    for rr in touch_rows:
        nw_, mw_ = int(tnw[rr]), int(mw_col[rr])
        tr[TCH, rr] = 1
        tr[NW, rr] = nw_
        tr[NW2, rr] = nw_ * nw_
        tr[NB0, rr], tr[NB1, rr] = nw_ & 0xFF, nw_ >> 8
        pad = 32 * nw_ - int(tofl[rr])
        for b in range(5):
            tr[PB[b], rr] = (pad >> b) & 1
        grow = 1 if nw_ > mw_ else 0
        tr[GROW, rr] = grow
        rcd = (nw_ - mw_ - 1) if grow else (mw_ - nw_)
        tr[RB0, rr], tr[RB1, rr] = rcd & 0xFF, rcd >> 8
        if grow:
            rq = nw_ * nw_ - 512 * ((nw_ * nw_) // 512)
            tr[RQB, rr], tr[RQBIT, rr] = rq & 0xFF, rq >> 8
    # QIDX: completed queries before each row (uniform over all phases)
    tr[QIDX, 1:] = np.cumsum(qd)[:-1]
    tr[RDS] = rds_rows
    tr[XP] = xp_rows
    # CIDX: calls STARTED before each row (increments on call op rows)
    tr[CIDX, 1:] = np.cumsum(cd_calls)[:-1]
    # stack-depth decomposition: SP = SPMX*1024 + (1-SPMX)*(SPB0+256*hi)
    spv = tr[SP].astype(np.int64)
    assert spv.max() <= 1024
    mx = spv == 1024
    tr[SPMX] = mx.astype(np.uint64)
    rem = np.where(mx, 0, spv)
    tr[SPB0] = (rem & 0xFF).astype(np.uint64)
    hi = rem >> 8
    tr[SPH0] = (hi & 1).astype(np.uint64)
    tr[SPH1] = (hi >> 1).astype(np.uint64)
    assert int(gd.sum()) == meter.used, "gas column diverges from the meter"
    assert int(rdl.sum()) == meter.refund, "refund column diverges"
    pi_words.append(meter.used)
    pi_words.append(meter.refund % fh.P)
    pi_words.append(success)

    em.finish_mults()
    return EvmResult(
        trace=em.tr,
        mem_ops=em.mem_ops,
        arith_requests=em.arith,
        logic_requests=em.logic,
        pack_requests=em.packs,
        hash_requests=em.hashes,
        pi_words=pi_words,
        storage_post=storage,
        success=success,
        logs=logs,
        return_data=return_data,
        gas_used=meter.used,
        gas_refund=meter.refund,
        warm_addrs_post=tuple(sorted(warm_addrs)),
    )


def discover_and_execute(
    code: bytes,
    calldata: bytes,
    caller: int,
    callvalue: int,
    storage_pre: Dict[int, int],
    log_rows: int,
    warm_pre: Tuple[int, ...] = (),
    env: Optional[Dict[str, int]] = None,
) -> Tuple[EvmShape, EvmInputs, EvmResult]:
    """Run the host interpreter, growing the shape's log list on
    UnknownLogShape misses (storage discovery is the caller's job —
    evm/contract.py reads missing slots from the witness trie). `env`
    carries the environment-opcode words (EvmInputs field names)."""
    log_shapes: List[Tuple[int, int]] = []
    call_shapes: List[Tuple[int, int, int, int]] = []
    n_queries = 0
    while True:
        shape = EvmShape(
            code_len=len(code),
            calldata_len=len(calldata),
            n_skeys=len(storage_pre),
            log_rows=log_rows,
            n_queries=n_queries,
            call_shapes=tuple(call_shapes),
            log_shapes=tuple(log_shapes),
        )
        inputs = EvmInputs(
            code, calldata, caller, callvalue, dict(storage_pre),
            warm_pre=warm_pre, **(env or {}),
        )
        try:
            return shape, inputs, execute_evm(shape, inputs)
        except UnknownLogShape as miss:
            assert miss.index == len(log_shapes)
            log_shapes.append((miss.n_topics, miss.data_len))
        except UnknownQueryCount as miss:
            assert miss.count > n_queries
            n_queries = miss.count
        except UnknownCallShape as miss:
            if miss.index < len(call_shapes):
                call_shapes[miss.index] = miss.entry
            else:
                assert miss.index == len(call_shapes)
                call_shapes.append(miss.entry)


def _fill_iszero(tr, r, v: int) -> None:
    from ..gf import field_host as fh

    s = sum(_word_limbs(v)) % fh.P
    tr[ZS, r] = s
    if v == 0:
        tr[Z, r] = 1
    else:
        tr[Z, r] = 0
        tr[ZINV, r] = fh.inv(s)


def _chunks(v: int) -> List[int]:
    """Six 48-bit chunks of the word's canonical limbs (3 limbs each;
    injective mod p, so chunkwise equality == word equality)."""
    limbs = _word_limbs(v)
    return [
        sum(l << (16 * i) for i, l in enumerate(limbs[3 * j: 3 * j + 3]))
        for j in range(6)
    ]


def _fill_eq(tr, r, cols, a: int, b: int) -> None:
    """Equality-predicate witness (E, D, I, S[6]): E bit; on inequality,
    S one-hot picks a differing chunk, D its difference, I = 1/D."""
    from ..gf import field_host as fh

    E, D, I, S = cols
    if a == b:
        tr[E, r] = 1
        return
    ca, cb = _chunks(a), _chunks(b)
    j = next(i for i in range(6) if ca[i] != cb[i])
    tr[S[j], r] = 1
    d = (ca[j] - cb[j]) % fh.P
    tr[D, r] = d
    tr[I, r] = fh.inv(d)


def _fill_iszero3(tr, r, cols, v: int) -> None:
    """Standalone iszero triple (E, S, I) over canonical limbs."""
    from ..gf import field_host as fh

    E, S, I = cols
    s = sum(_word_limbs(v)) % fh.P
    tr[S, r] = s
    if v == 0:
        tr[E, r] = 1
    else:
        tr[I, r] = fh.inv(s)

# -- the STARK -----------------------------------------------------------------

# per-opcode SP delta and PC advance for the simple selectors
_SP_DELTA = {
    STOP: 0, ADD: -1, MUL: -1, SUB: -1, DIV: -1, MOD: -1, LT: -1, GT: -1,
    SLT: -1, SGT: -1, SAR: -1, SIGNEXTEND: -1,
    ADDMOD: -2, MULMOD: -2,
    EQ: -1, ISZERO: 0, AND_: -1, OR_: -1, XOR_: -1, NOT_: 0, BYTE_: -1,
    SHL: -1, SHR: -1, KECCAK256: -2, CALLER: 1, CALLVALUE: 1,
    CALLDATALOAD: 0, CALLDATASIZE: 1, CALLDATACOPY: -3, CODECOPY: -3,
    RETURNDATASIZE: 1, POP: -1, MLOAD: 0, MSTORE: -2,
    MSTORE8: -2, MSIZE: 1,
    SLOAD: 0, SSTORE: -2, JUMP: -1, JUMPI: -2, PC_OP: 1, JUMPDEST: 0,
    RETURN: -2, REVERT: -2, ADDRESS: 1, ORIGIN: 1, GASPRICE: 1,
    COINBASE: 1, TIMESTAMP: 1, NUMBER: 1, GASLIMIT: 1, CHAINID: 1,
    BASEFEE: 1, CODESIZE: 1, GAS_OP: 1, SELFBALANCE: 1,
    BALANCE: 0, EXTCODESIZE: 0, EXTCODEHASH: 0, BLOCKHASH: 0,
    RETURNDATACOPY: -3,
    CALL: -5, STATICCALL: -4,  # the S_CLA row drops one more
    EXP: -2,  # the TERM micro-row pushes the result (+1 there)
}
_PC_ADV = {op: 1 for op in SIMPLE_OPS}
_PC_ADV[JUMP] = 0  # handled by the jump correction term
_PC_ADV[KECCAK256] = 0  # the trailing KDIG row advances pc
_PC_ADV[SLOAD] = 0  # the S_SLX continuation row advances pc
_PC_ADV[SSTORE] = 0  # the S_SSX continuation row advances pc
_PC_ADV[CALLDATACOPY] = 0  # the final S_CPW row advances pc (or the op
_PC_ADV[CODECOPY] = 0  # row itself for a zero-length copy)
_PC_ADV[RETURNDATACOPY] = 0  # same copy choreography as CALLDATACOPY
_PC_ADV[CALL] = 0  # advances on the call's completion row
_PC_ADV[STATICCALL] = 0
_PC_ADV[EXP] = 0  # advances on the TERM row (or the setup row if e == 0)

# arithmetic-table ops in EVM operand order (ch1, ch2 as popped)
_ARITH_PLAIN = {ADD: ar.OP_ADD, MUL: ar.OP_MUL, SUB: ar.OP_SUB,
                DIV: ar.OP_DIV, MOD: ar.OP_MOD, LT: ar.OP_LT,
                SLT: ar.OP_SLT}
# swapped: the table wants (value, count) / (value, index) / LT reversed
_ARITH_SWAP = {GT: ar.OP_LT, SGT: ar.OP_SLT, SHL: ar.OP_SHL,
               SHR: ar.OP_SHR, SAR: ar.OP_SAR, BYTE_: ar.OP_BYTE,
               SIGNEXTEND: ar.OP_SEXT}
_ARITH_TERN = {ADDMOD: ar.OP_ADDMOD, MULMOD: ar.OP_MULMOD}


class EvmStark(Stark):
    """One instance per EvmShape (shape fixes the pre-exec schedule)."""

    num_columns = NUM_COLUMNS
    constraint_degree = 3

    def __init__(self, shape: EvmShape):
        self.shape = shape
        self.num_public_inputs = shape.num_pi_words * N_LIMBS
        f = Cols()
        self.F_ROW = f.one()
        self.F_BYTE = f.one()  # min(row, 255)
        self.F_OPINFO = f.one()  # opcode-info table (rows 0..255)
        self.F_INIT = f.one()
        self.F_SVINIT = f.one()
        self.F_REPACK = f.one()
        self.F_SCAN = f.one()
        self.F_SCAN_FIRST = f.one()
        self.F_SCAN_TRANS = f.one()  # scan rows except the last
        self.F_SCAN_LAST = f.one()
        self.F_CHD = f.one()  # code-hash declare row
        self.F_CHG = f.one()  # code-hash digest row
        self.F_EXEC = f.one()
        self.F_FINAL = f.one()
        self.F_LAST = f.one()  # last row (GAS/REFUND public-input binding)
        self.F_A1 = f.one()  # per-row static addresses
        self.F_A2 = f.one()
        self.F_A3 = f.one()
        self.F_PLEN = f.one()  # INIT/REPACK: bytepacking window length
        self.F_CDSEL = f.many(shape.n_calldata_words)  # INIT: PI word one-hot
        self.F_SKSEL = f.many(shape.n_skeys)  # SVINIT row i
        self.F_SVPOSTSEL = f.many(shape.n_skeys)  # FINAL row i
        self.num_fixed_columns = f.count
        self.exec_start = (
            shape.n_init_rows + shape.n_skeys + shape.n_repack_rows
            + shape.n_scan_rows + 2
        )
        self.lookups = [
            LookupSpec(
                # REVB plus the gas circuit's byte-decomposition columns
                looking_cols=tuple(REVB)
                + (RB0, RB1, NB0, NB1, RQB, M8B0, M8B1, SPB0),
                table_col=NUM_COLUMNS + self.F_BYTE,
                multiplicity_col=BYTE_MULT,
            ),
            LookupSpec(
                looking_cols=(SCAN_COMB,),
                table_col=NUM_COLUMNS + self.F_OPINFO,
                multiplicity_col=COMB_MULT,
            ),
        ]

    # -- fixed schedule -------------------------------------------------------

    def fixed_columns(self, n: int) -> np.ndarray:
        s = self.shape
        assert n == 1 << s.log_rows and n >= 256
        fx = np.zeros((self.num_fixed_columns, n), dtype=np.uint64)
        fx[self.F_ROW] = np.arange(n, dtype=np.uint64)
        fx[self.F_BYTE] = np.minimum(np.arange(n), 255)
        for i in range(256):
            fx[self.F_OPINFO, i] = _opinfo(i)
        r = 0
        for w in range(s.n_calldata_words):
            fx[self.F_INIT, r] = 1
            fx[self.F_A1, r] = 32 * w
            fx[self.F_PLEN, r] = min(32, s.calldata_len - 32 * w)
            fx[self.F_CDSEL[w], r] = 1
            r += 1
        for i in range(s.n_skeys):
            fx[self.F_SVINIT, r] = 1
            fx[self.F_A1, r] = i
            fx[self.F_SKSEL[i], r] = 1
            r += 1
        for base, waddr, ln in s.repack_windows:
            fx[self.F_REPACK, r] = 1
            fx[self.F_A1, r] = base
            fx[self.F_A3, r] = waddr
            fx[self.F_PLEN, r] = ln
            r += 1
        scan_start = r
        for i in range(s.n_scan_rows):
            fx[self.F_SCAN, r] = 1
            fx[self.F_A1, r] = i
            fx[self.F_SCAN_FIRST, r] = 1 if i == 0 else 0
            fx[self.F_SCAN_TRANS, r] = 1 if i < s.n_scan_rows - 1 else 0
            fx[self.F_SCAN_LAST, r] = 1 if i == s.n_scan_rows - 1 else 0
            r += 1
        fx[self.F_CHD, r] = 1
        r += 1
        fx[self.F_CHG, r] = 1
        r += 1
        assert r == self.exec_start
        exec_end = n - s.n_skeys
        fx[self.F_EXEC, r:exec_end] = 1
        for i in range(s.n_skeys):
            rr = exec_end + i
            fx[self.F_FINAL, rr] = 1
            fx[self.F_A1, rr] = i
            fx[self.F_SVPOSTSEL[i], rr] = 1
        fx[self.F_LAST, n - 1] = 1
        return fx

    # -- CTL specs --------------------------------------------------------------

    def _f(self, i: int) -> int:
        return NUM_COLUMNS + i

    def _ts(self, slot: int) -> LC:
        return LC(terms=((self._f(self.F_ROW), TS_SLOTS),), const=slot)

    def memory_ctl_specs(self) -> List[CtlSpec]:
        out = []
        for i in range(N_CHAN):
            cols: List = [
                LC(terms=(), const=EVM_CTX),
                CH_SEG[i],
                CH_VIRT[i],
                self._ts(i),
                CH_ISREAD[i],
            ] + list(CH_VAL[i])
            out.append(CtlSpec(columns=tuple(cols), filter_col=CH_USED[i]))
        return out

    def _r_limb(self, j: int) -> LC:
        return LC(terms=((REVB[2 * j], 1), (REVB[2 * j + 1], 256)), const=0)

    def bytepack_ctl_spec(self) -> CtlSpec:
        """(op, ctx, seg, virt, ts, len=32, limbs) — little-endian packed
        window = R-limbs of REVB (bytepacking.ctl_spec layout)."""
        from .bytepacking import OP_BYTEPACK

        cols: List = [
            LC(terms=(), const=OP_BYTEPACK),
            LC(terms=(), const=EVM_CTX),
            PACK_SEG,
            PACK_VIRT,
            self._ts(5),
            PACK_LEN,
        ] + [self._r_limb(j) for j in range(N_LIMBS)]
        return CtlSpec(columns=tuple(cols), filter_col=IS_PACK)

    def _opid_lc(self, table: Dict[int, int]) -> LC:
        return LC(terms=tuple((SEL[op], tid) for op, tid in table.items()), const=0)

    def arith_ctl_specs(self) -> List[CtlSpec]:
        zero16 = [LC(terms=(), const=0)] * N_LIMBS  # binary ops: IN2 = 0
        plain_opid = LC(
            terms=tuple((SEL[op], tid) for op, tid in _ARITH_PLAIN.items())
            + ((S_EXM, ar.OP_MUL), (S_EXQ, ar.OP_MUL)),
            const=0,
        )
        plain = CtlSpec(
            columns=tuple(
                [plain_opid] + CH_VAL[1] + CH_VAL[2] + zero16 + CH_VAL[3]
            ),
            filter_col=AR_PLAIN,
        )
        swapped = CtlSpec(
            columns=tuple(
                [self._opid_lc(_ARITH_SWAP)]
                + CH_VAL[2] + CH_VAL[1] + zero16 + CH_VAL[3]
            ),
            filter_col=AR_SWAP,
        )
        eq = CtlSpec(
            columns=tuple(
                [LC(terms=(), const=ar.OP_SUB)]
                + CH_VAL[1] + CH_VAL[2] + zero16 + CH_VAL[4]
            ),
            filter_col=SEL[EQ],
        )
        tern = CtlSpec(
            columns=tuple(
                [self._opid_lc(_ARITH_TERN)]
                + CH_VAL[1] + CH_VAL[2] + CH_VAL[3] + CH_VAL[4]
            ),
            filter_col=AR_TERN,
        )
        return [plain, swapped, eq, tern]

    def logic_ctl_specs(self) -> List[CtlSpec]:
        plain = CtlSpec(
            columns=tuple(
                [self._opid_lc(_LOGIC)] + CH_VAL[1] + CH_VAL[2] + CH_VAL[3]
            ),
            filter_col=LG_PLAIN,
        )
        allones = [LC(terms=(), const=0xFFFF)] * N_LIMBS
        notspec = CtlSpec(
            columns=tuple(
                [LC(terms=(), const=OP_XOR)] + CH_VAL[1] + allones + CH_VAL[2]
            ),
            filter_col=SEL[NOT_],
        )
        return [plain, notspec]

    def sponge_ctl_specs(self) -> List[CtlSpec]:
        from .keccak_sponge import OP_KECCAK_DIGEST, OP_SPONGE_INIT

        first = CtlSpec(
            columns=tuple(
                [
                    LC(terms=(), const=OP_SPONGE_INIT),
                    LC(terms=(), const=EVM_CTX),
                    HS_SEG,
                    HS_VIRT,
                    # H_TS, pinned to the declaring row's sponge slot (code
                    # hash) or the KDIG row's (KECCAK256); the counterpart
                    # sends this row's own slot, self._ts(6)
                    H_TS,
                ]
            ),
            filter_col=SP_FIRST,
        )
        digest = CtlSpec(
            columns=tuple(
                [
                    LC(terms=(), const=OP_KECCAK_DIGEST),
                    LC(terms=(), const=EVM_CTX),
                    HS_SEG,
                    H_FVIRT,
                    H_TS,
                    H_FLEN,
                ]
                + [self._r_limb(j) for j in range(N_LIMBS)]
            ),
            filter_col=SP_FINAL,
        )
        return [first, digest]

    uses_sponge = True

    # -- constraints --------------------------------------------------------------

    def eval(self, ctx):
        c, o = ctx.consumer, ctx.ops
        one, zero = o.one(), o.zero()
        s = self.shape
        lay = s.pi_layout

        def L(i):
            return ctx.local(i)

        def N(i):
            return ctx.next(i)

        def F(i):
            return ctx.fixed(i)

        def FN(i):
            return ctx.fixed_next(i)

        def const(v):
            return o.constant(v)

        sel = {op: L(SEL[op]) for op in SIMPLE_OPS}
        fpush, fdup, fswap, flog = L(F_PUSH), L(F_DUP), L(F_SWAP), L(F_LOG)
        nsel = [L(NSEL[n]) for n in range(33)]
        kpack, kdig = L(S_KPACK), L(S_KDIG)
        slx, ssx = L(S_SLX), L(S_SSX)
        cpr, cpw = L(S_CPR), L(S_CPW)
        cla, cli, clo = L(S_CLA), L(S_CLI), L(S_CLO)
        exi, exm, exq = L(S_EXI), L(S_EXM), L(S_EXQ)
        term = L(TERM)
        csel = [L(CSEL[i]) for i in range(MAX_CALLS)]
        callop = o.add(sel[CALL], sel[STATICCALL])
        n_calls = len(s.call_shapes)
        # per-call static data (entry = (op, target, alen, rlen, olen);
        # target 0 = contract frame, else precompile id)
        call_op_i = [cs_[0] for cs_ in s.call_shapes]
        call_tgt = [cs_[1] for cs_ in s.call_shapes]
        call_alen = [cs_[2] for cs_ in s.call_shapes]
        call_rlen = [cs_[3] for cs_ in s.call_shapes]
        call_outlen = [cs_[4] for cs_ in s.call_shapes]
        call_inw = [s.call_in_words(a) for a in call_alen]
        call_outw = [(ol + 31) // 32 for ol in call_outlen]
        call_dirw = [s.call_dir_words(t) for t in call_tgt]
        call_is_frame = [t == FRAME_TARGET for t in call_tgt]
        halted = L(HALTED)
        pc, sp = L(PC), L(SP)
        z, zinv, zs = L(Z), L(ZINV), L(ZS)
        revb = [L(i) for i in REVB]

        f_exec = F(self.F_EXEC)
        act = o.mul(f_exec, o.sub(one, halted))

        # -- booleans
        bools = (
            [HALTED, Z, F_PUSH, F_DUP, F_SWAP, F_LOG, S_KPACK, S_KDIG,
             S_LOGX, S_LOGD, S_SLX, S_SSX, S_CPR, S_CPW, SP_FIRST,
             SP_FINAL, IS_PACK, PACK_WRITE,
             AR_PLAIN, AR_SWAP, LG_PLAIN, IS_JD,
             GROW, RQBIT, E_VC, E_CO, E_VO, EO0, EV0, FULLC]
            + list(PB) + list(KP) + list(KPD)
            + list(S_VC) + list(S_CO) + list(S_VO)
            + list(LSEL) + list(QSEL) + [SPMX, SPH0, SPH1]
            + list(CSEL) + [S_CLA, S_CLI, S_CLO, CBGO]
            + [S_EXI, S_EXM, S_EXQ, XB, LB, TERM]
            + [SEL[op] for op in SIMPLE_OPS]
            + list(NSEL)
            + CH_USED
            + CH_ISREAD
        )
        for i in bools:
            b = L(i)
            c.constraint(o.mul(b, o.sub(b, one)))

        # -- iszero machinery (global; rows that bind no ZS set Z=1, ZS=0)
        c.constraint(o.mul(z, zs))
        c.constraint(o.sub(o.mul(zs, zinv), o.sub(one, z)))

        # -- first row
        c.constraint_first_row(pc)
        c.constraint_first_row(sp)
        c.constraint_first_row(halted)

        # -- opcode selector accounting
        simple_sum = None
        for op in SIMPLE_OPS:
            simple_sum = sel[op] if simple_sum is None else o.add(simple_sum, sel[op])
        fam_sum = o.add(o.add(fpush, fdup), o.add(fswap, flog))
        logx, logd = L(S_LOGX), L(S_LOGD)
        all_sum = o.add(
            o.add(o.add(simple_sum, fam_sum), o.add(o.add(kpack, kdig), logx)),
            o.add(
                o.add(
                    o.add(o.add(slx, ssx), logd), o.add(exi, o.add(exm, exq))
                ),
                o.add(o.add(cpr, cpw), o.add(cla, o.add(cli, clo))),
            ),
        )
        c.constraint(o.sub(all_sum, act))
        nsel_sum = None
        nlin = None
        for n in range(33):
            nsel_sum = nsel[n] if nsel_sum is None else o.add(nsel_sum, nsel[n])
            t = o.mul(const(n), nsel[n])
            nlin = t if nlin is None else o.add(nlin, t)
        # NSEL doubles as the LOGD data-word index (1..7) and the call
        # staging rows' word index (0..7)
        c.constraint(
            o.sub(
                nsel_sum,
                o.add(
                    o.add(o.add(fam_sum, logd), o.add(cli, clo)),
                    o.add(exm, exq),
                ),
            )
        )
        # family n ranges: DUP/SWAP 1..16, LOG 0..4, LOGD words 1..7
        c.constraint(o.mul(o.add(fdup, fswap), nsel[0]))
        for n in range(17, 33):
            c.constraint(o.mul(o.add(fdup, fswap), nsel[n]))
        for n in range(5, 33):
            c.constraint(o.mul(flog, nsel[n]))
        c.constraint(o.mul(logd, nsel[0]))
        for n in range(8, 33):
            c.constraint(o.mul(logd, nsel[n]))

        # -- fetch channel 0
        ch0u = L(CH_USED[0])
        non_fetch = o.add(
            o.add(o.add(o.add(kpack, kdig), o.add(logx, logd)), o.add(slx, ssx)),
            o.add(
                o.add(o.add(cpr, cpw), o.add(cla, o.add(cli, clo))),
                o.add(exi, o.add(exm, exq)),
            ),
        )
        c.constraint(o.sub(ch0u, o.sub(act, non_fetch)))
        c.constraint(o.mul(ch0u, o.sub(L(CH_ISREAD[0]), one)))
        c.constraint(o.mul(ch0u, o.sub(L(CH_SEG[0]), const(SEG_CODE))))
        c.constraint(o.mul(ch0u, o.sub(L(CH_VIRT[0]), pc)))
        for k in range(1, N_LIMBS):
            c.constraint(o.mul(ch0u, L(CH_VAL[0][k])))
        # decode: selected opcode value == fetched byte
        dec = None
        for op in SIMPLE_OPS:
            t = o.mul(const(op), sel[op])
            dec = t if dec is None else o.add(dec, t)
        dec = o.add(dec, o.mul(fpush, o.add(const(PUSH0), nlin)))
        dec = o.add(dec, o.mul(fdup, o.add(const(DUP1 - 1), nlin)))
        dec = o.add(dec, o.mul(fswap, o.add(const(SWAP1 - 1), nlin)))
        dec = o.add(dec, o.mul(flog, o.add(const(LOG0), nlin)))
        c.constraint(o.sub(dec, o.mul(ch0u, L(CH_VAL[0][0]))))

        # -- channel usage accounting (ch1..ch4)
        # per-log static topic counts / data presence (shape constants)
        nt_of = [nt for nt, _dl in s.log_shapes]
        dl_of = [dl for _nt, dl in s.log_shapes]
        lsel = [L(LSEL[i]) for i in range(len(s.log_shapes))]
        nsel_le2 = o.add(nsel[0], o.add(nsel[1], nsel[2]))
        nsel_ge2 = o.add(nsel[2], o.add(nsel[3], nsel[4]))
        nsel_ge3 = o.add(nsel[3], nsel[4])
        logx_t4 = None  # LOGX rows of logs with 4 topics
        for i in range(len(s.log_shapes)):
            if nt_of[i] >= 4:
                t = o.mul(logx, lsel[i])
                logx_t4 = t if logx_t4 is None else o.add(logx_t4, t)
        logx_t4 = logx_t4 if logx_t4 is not None else zero
        log_data = None  # LOG rows of logs with data
        for i in range(len(s.log_shapes)):
            if dl_of[i] > 0:
                t = o.mul(flog, lsel[i])
                log_data = t if log_data is None else o.add(log_data, t)
        log_data = log_data if log_data is not None else zero
        ch1_users = [
            F(self.F_SVINIT), F(self.F_REPACK), F(self.F_SCAN),
            F(self.F_FINAL), fpush, fdup, fswap, kpack, kdig, flog, logx,
            slx, ssx,
        ] + [
            sel[op]
            for op in (ADD, MUL, SUB, DIV, MOD, LT, GT, SLT, SGT, SHL, SHR, SAR, SIGNEXTEND,
                       BYTE_, EQ,
                       ISZERO, AND_, OR_, XOR_, NOT_, KECCAK256,
                       CALLDATASIZE, PC_OP, CALLDATALOAD, MLOAD,
                       MSTORE, MSTORE8, MSIZE, SLOAD, SSTORE, JUMP, JUMPI,
                       ADDMOD, MULMOD, RETURN, REVERT,
                       CALLDATACOPY, CODECOPY, RETURNDATASIZE,
                       CODESIZE, GAS_OP, BALANCE, EXTCODESIZE,
                       EXTCODEHASH, BLOCKHASH, SELFBALANCE,
                       RETURNDATACOPY, CALL, STATICCALL)
        ] + [sel[op] for op in ENV_OPS] + [cla, exi, exm, exq, sel[EXP]]
        ch2_users = [
            F(self.F_SVINIT), F(self.F_SCAN), fdup, fswap, slx, ssx,
        ] + [
            sel[op]
            for op in (ADD, MUL, SUB, DIV, MOD, LT, GT, SLT, SGT, SHL, SHR, SAR, SIGNEXTEND,
                       BYTE_, EQ,
                       ISZERO, AND_, OR_, XOR_, NOT_, KECCAK256, CALLDATALOAD,
                       MLOAD, MSTORE, MSTORE8, SLOAD, SSTORE, JUMP, JUMPI,
                       ADDMOD, MULMOD, RETURN, REVERT,
                       CALLDATACOPY, CODECOPY,
                       BALANCE, EXTCODESIZE, EXTCODEHASH, BLOCKHASH,
                       RETURNDATACOPY, CALL, STATICCALL, EXP)
        ] + [cla, exi, exq]
        ch3_users = [fswap, F(self.F_SVINIT), ssx] + [
            sel[op]
            for op in (ADD, MUL, SUB, DIV, MOD, LT, GT, SLT, SGT, SHL, SHR, SAR, SIGNEXTEND,
                       BYTE_, EQ,
                       AND_, OR_, XOR_, SLOAD, SSTORE, ADDMOD, MULMOD,
                       CALLDATACOPY, CODECOPY,
                       RETURNDATACOPY, CALL, STATICCALL, EXP)
        ] + [cla, exm, exq]
        ch4_users = [
            fswap, F(self.F_SVINIT), ssx,
            sel[SLOAD], sel[SSTORE], sel[ADDMOD], sel[MULMOD],
            sel[CALL], sel[STATICCALL],
        ]
        cla_value_read = None
        for i in range(n_calls):
            if call_op_i[i] == CALL:
                t = o.mul(cla, csel[i])
                cla_value_read = (
                    t if cla_value_read is None else o.add(cla_value_read, t)
                )
        cla_value_read = cla_value_read if cla_value_read is not None else zero

        def acc(users, extra=None):
            tot = None
            for u in users:
                tot = u if tot is None else o.add(tot, u)
            if extra is not None:
                tot = o.add(tot, extra)
            return tot

        jumpi_taken = o.mul(sel[JUMPI], o.sub(one, z))
        c.constraint(o.sub(L(CH_USED[1]), acc(ch1_users)))
        c.constraint(
            o.sub(
                L(CH_USED[2]),
                acc(ch2_users, o.add(o.add(flog, logx_t4), o.mul(exm, L(XB)))),
            )
        )
        c.constraint(
            o.sub(
                L(CH_USED[3]),
                acc(
                    ch3_users,
                    o.add(jumpi_taken, o.mul(flog, o.sub(one, nsel[0]))),
                ),
            )
        )
        c.constraint(
            o.sub(
                L(CH_USED[4]),
                acc(
                    ch4_users,
                    o.add(
                        o.add(o.mul(flog, nsel_ge2), cla_value_read),
                        o.add(exm, o.mul(sel[EXP], o.sub(one, z))),
                    ),
                ),
            )
        )

        # -- generic channel binding helper
        def bind(gate, ch, is_read, seg_expr, virt_expr):
            c.constraint(o.mul(gate, o.sub(L(CH_ISREAD[ch]), const(is_read))))
            c.constraint(o.mul(gate, o.sub(L(CH_SEG[ch]), seg_expr)))
            c.constraint(o.mul(gate, o.sub(L(CH_VIRT[ch]), virt_expr)))

        def bind_byte(gate, ch, byte_expr):
            c.constraint(o.mul(gate, o.sub(L(CH_VAL[ch][0]), byte_expr)))
            for k in range(1, N_LIMBS):
                c.constraint(o.mul(gate, L(CH_VAL[ch][k])))

        def bind_word_eq(gate, ch_a, ch_b):
            for k in range(N_LIMBS):
                c.constraint(
                    o.mul(gate, o.sub(L(CH_VAL[ch_a][k]), L(CH_VAL[ch_b][k])))
                )

        def bind_word_pi(gate, ch, pi_word):
            for k in range(N_LIMBS):
                c.constraint(
                    o.mul(
                        gate,
                        o.sub(L(CH_VAL[ch][k]), ctx.public_input(16 * pi_word + k)),
                    )
                )

        def v_limb(j):
            return o.add(revb[31 - 2 * j], o.mul(const(256), revb[30 - 2 * j]))

        def r_limb(j):
            return o.add(revb[2 * j], o.mul(const(256), revb[2 * j + 1]))

        def bind_word_v(gate, ch):
            for k in range(N_LIMBS):
                c.constraint(o.mul(gate, o.sub(L(CH_VAL[ch][k]), v_limb(k))))

        spm = lambda k: o.sub(sp, const(k))  # SP - k

        # -- INIT rows: one calldata word per row, REVB = the PI word's
        # big-endian bytes; the pack CTL writes the first F_PLEN of them
        f_init = F(self.F_INIT)
        cd_base = 16 * lay["calldata"]
        for w in range(s.n_calldata_words):
            for j in range(N_LIMBS):
                c.constraint(
                    o.mul(
                        F(self.F_CDSEL[w]),
                        o.sub(v_limb(j), ctx.public_input(cd_base + 16 * w + j)),
                    )
                )

        # -- SVINIT rows: directory key, pre value, EIP-2929 warm flag,
        # and the EIP-2200 original value (all PI-bound; storage tuples
        # are (key, warm0, vpre, vpost) at stride 4)
        f_sv = F(self.F_SVINIT)
        bind(f_sv, 1, 0, const(SEG_SKEYS), F(self.F_A1))
        bind(f_sv, 2, 0, const(SEG_SVALS), F(self.F_A1))
        bind(f_sv, 3, 0, const(SEG_SWARM), F(self.F_A1))
        bind(f_sv, 4, 0, const(SEG_SORIG), F(self.F_A1))
        for i in range(s.n_skeys):
            bind_word_pi(F(self.F_SKSEL[i]), 1, lay["storage"] + 4 * i)
            bind_word_pi(F(self.F_SKSEL[i]), 2, lay["storage"] + 4 * i + 2)
            bind_word_pi(F(self.F_SKSEL[i]), 3, lay["storage"] + 4 * i + 1)
            bind_word_pi(F(self.F_SKSEL[i]), 4, lay["storage"] + 4 * i + 2)

        # -- REPACK rows: pack CTL writes the code bytes; channel 1 writes
        # the little-endian staged word to SEG_CODE_PACKED
        f_rp = F(self.F_REPACK)
        bind(f_rp, 1, 0, const(SEG_CODE_PACKED), F(self.F_A3))
        for j in range(N_LIMBS):
            c.constraint(o.mul(f_rp, o.sub(L(CH_VAL[1][j]), r_limb(j))))

        # -- SCAN rows
        f_sc = F(self.F_SCAN)
        bind(f_sc, 1, 1, const(SEG_CODE), F(self.F_A1))
        bind(f_sc, 2, 0, const(SEG_JUMPDEST), F(self.F_A1))
        sb = L(CH_VAL[1][0])
        c.constraint(o.mul(f_sc, o.sub(L(ZS), L(INPUSH))))
        comb = o.add(
            sb,
            o.add(
                o.mul(const(OPINFO_SHIFT_PL), L(PUSHLEN)),
                o.mul(const(OPINFO_SHIFT_JD), L(IS_JD)),
            ),
        )
        c.constraint(o.mul(f_sc, o.sub(L(SCAN_COMB), comb)))
        c.constraint(o.mul(o.sub(one, f_sc), L(SCAN_COMB)))
        bind_byte(f_sc, 2, o.mul(z, L(IS_JD)))
        # inside-push counter
        next_inpush = o.add(
            o.mul(z, L(PUSHLEN)),
            o.mul(o.sub(one, z), o.sub(L(INPUSH), one)),
        )
        c.constraint_transition(
            o.mul(F(self.F_SCAN_TRANS), o.sub(N(INPUSH), next_inpush))
        )
        c.constraint(o.mul(F(self.F_SCAN_FIRST), L(INPUSH)))
        c.constraint(o.mul(F(self.F_SCAN_LAST), next_inpush))

        # -- CHASH rows + sponge filters
        f_chd, f_chg = F(self.F_CHD), F(self.F_CHG)
        c.constraint(o.sub(L(SP_FIRST), o.add(f_chd, sel[KECCAK256])))
        c.constraint(o.sub(L(SP_FINAL), o.add(f_chg, kdig)))
        c.constraint(o.mul(f_chd, o.sub(L(HS_SEG), const(SEG_CODE_PACKED))))
        c.constraint(o.mul(f_chd, L(HS_VIRT)))
        decl_ts = LCts = o.add(
            o.mul(const(TS_SLOTS), F(self.F_ROW)), const(6)
        )
        # the code hash declares at its CHD row; KECCAK256 at its KDIG row
        # (H_TS is carried from its SETUP row through the KPACK rows)
        c.constraint(o.mul(o.add(f_chd, kdig), o.sub(L(H_TS), decl_ts)))
        # code-hash digest row: final-block virt/len are static
        L_cp = s.code_padded_len
        nb = L_cp // 136 + 1
        c.constraint(o.mul(f_chg, o.sub(L(H_FVIRT), const(5 * (nb - 1)))))
        c.constraint(
            o.mul(f_chg, o.sub(L(H_FLEN), const(L_cp - 136 * (nb - 1))))
        )
        # digest == CODEHASH public input (LE word limbs are the R-limbs)
        ch_base = 16 * lay["codehash"]
        for j in range(N_LIMBS):
            c.constraint(
                o.mul(f_chg, o.sub(r_limb(j), ctx.public_input(ch_base + j)))
            )

        # carries into sponge-consuming rows (kpack/kdig/chash-digest)
        carry_gate = o.add(o.add(N(S_KPACK), N(S_KDIG)), FN(self.F_CHG))
        c.constraint_transition(o.mul(carry_gate, o.sub(N(H_TS), L(H_TS))))
        c.constraint_transition(o.mul(carry_gate, o.sub(N(HS_SEG), L(HS_SEG))))
        # chunk-size witness: CSW = min(cap, R2) on KPACK and copy-read
        # rows, 0 elsewhere (cap = 32 on sponge phases 0-3 and on copy
        # rows, 8 on sponge phase 4); the byte-checked RB witness proves
        # the min with the STRICT full convention FULLC <=> R2 > cap
        kps = [L(KP[j]) for j in range(5)]
        kp_sum = None
        for j in range(5):
            kp_sum = kps[j] if kp_sum is None else o.add(kp_sum, kps[j])
        c.constraint(o.sub(kp_sum, kpack))  # one-hot exactly on kpack rows
        cap = o.add(
            o.add(
                o.mul(const(32), o.sub(kp_sum, kps[4])),
                o.mul(const(8), kps[4]),
            ),
            o.mul(const(32), cpr),
        )
        chunk_gate = o.add(kpack, cpr)
        fullc, csw = L(FULLC), L(CSW)
        c.constraint(o.mul(o.sub(one, o.add(chunk_gate, cpw)), csw))
        c.constraint(
            o.mul(
                chunk_gate,
                o.sub(csw, o.add(o.mul(fullc, cap), o.mul(o.sub(one, fullc), L(R2)))),
            )
        )
        rck = o.add(L(RB0), o.mul(const(256), L(RB1)))
        c.constraint(
            o.mul(
                chunk_gate,
                o.sub(
                    rck,
                    o.add(
                        o.mul(fullc, o.sub(o.sub(L(R2), cap), one)),
                        o.mul(o.sub(one, fullc), o.sub(cap, L(R2))),
                    ),
                ),
            )
        )
        # a partial chunk exhausts the message: the next row is the digest
        c.constraint_transition(
            o.mul(o.mul(kpack, o.sub(one, fullc)), o.sub(one, N(S_KDIG)))
        )
        # phase rotation 0->1->2->3->4->0 across consecutive KPACK rows
        c.constraint_transition(
            o.mul(sel[KECCAK256], o.sub(N(KP[0]), N(S_KPACK)))
        )
        for j in range(5):
            c.constraint_transition(
                o.mul(o.mul(kpack, N(S_KPACK)), o.sub(N(KP[(j + 1) % 5]), kps[j]))
            )
        c.constraint_transition(
            o.mul(N(S_KPACK), o.sub(N(R0), o.add(L(R0), csw)))
        )
        kk = o.add(N(S_KPACK), N(S_KDIG))
        c.constraint_transition(o.mul(kk, o.sub(N(R1), o.add(L(R1), kpack))))
        c.constraint_transition(o.mul(kk, o.sub(o.add(N(R2), csw), L(R2))))
        # block counter + carried length (multi-block digests)
        c.constraint(o.mul(sel[KECCAK256], L(KBLK)))
        c.constraint(
            o.mul(sel[KECCAK256], o.sub(L(KLEN), L(CH_VAL[2][0])))
        )
        c.constraint_transition(
            o.mul(kk, o.sub(N(KBLK), o.add(L(KBLK), kps[4])))
        )
        c.constraint_transition(o.mul(kk, o.sub(N(KLEN), L(KLEN))))
        # digest-row final-block virt/len from the block counter
        c.constraint_transition(
            o.mul(
                N(S_KDIG),
                o.sub(
                    N(H_FVIRT), o.add(L(HP), o.mul(const(5), N(KBLK)))
                ),
            )
        )
        c.constraint_transition(
            o.mul(
                N(S_KDIG),
                o.sub(N(H_FLEN), o.sub(N(KLEN), o.mul(const(136), N(KBLK)))),
            )
        )
        c.constraint(o.mul(kdig, L(R2)))  # staging ran to completion
        # phase integrity (an empty message goes straight to the digest)
        c.constraint_transition(
            o.mul(N(S_KPACK), o.sub(o.add(kpack, sel[KECCAK256]), one))
        )
        c.constraint_transition(
            o.mul(N(S_KDIG), o.sub(o.add(kpack, sel[KECCAK256]), one))
        )
        c.constraint_transition(
            o.mul(kpack, o.sub(o.add(N(S_KPACK), N(S_KDIG)), one))
        )
        c.constraint_transition(
            o.mul(sel[KECCAK256], o.sub(o.add(N(S_KPACK), N(S_KDIG)), one))
        )
        # HP: constant except entering KDIG (5 word slots per block)
        c.constraint_transition(
            o.mul(o.sub(one, N(S_KDIG)), o.sub(N(HP), L(HP)))
        )
        c.constraint_transition(
            o.mul(
                N(S_KDIG),
                o.sub(
                    N(HP),
                    o.add(L(HP), o.add(o.mul(const(5), N(KBLK)), const(5))),
                ),
            )
        )

        # -- KECCAK256 setup
        skec = sel[KECCAK256]
        bind(skec, 1, 1, const(SEG_STACK), spm(1))  # pop offset
        bind(skec, 2, 1, const(SEG_STACK), spm(2))  # pop length
        ofs32 = o.add(L(CH_VAL[1][0]), o.mul(const(1 << 16), L(CH_VAL[1][1])))
        for k in range(2, N_LIMBS):
            c.constraint(o.mul(skec, L(CH_VAL[1][k])))
        for k in range(1, N_LIMBS):
            c.constraint(o.mul(skec, L(CH_VAL[2][k])))
        c.constraint(o.mul(skec, o.sub(L(R0), ofs32)))
        c.constraint(o.mul(skec, o.sub(L(R2), L(CH_VAL[2][0]))))
        c.constraint(o.mul(skec, o.sub(L(R1), L(HP))))
        c.constraint(o.mul(skec, o.sub(L(HS_SEG), const(SEG_HASH))))
        c.constraint(o.mul(skec, o.sub(L(HS_VIRT), L(HP))))
        # Z bank decides ln == 0 (no memory touch, no staging rows)
        zsum_kl = None
        for k in range(N_LIMBS):
            t = L(CH_VAL[2][k])
            zsum_kl = t if zsum_kl is None else o.add(zsum_kl, t)
        c.constraint(o.mul(skec, o.sub(zs, zsum_kl)))
        # gas word count: 32*KWORDS = ln + pad (unique field solution per
        # 5-bit pad, so KWORDS is exactly ceil(ln/32))
        kpad_lin = None
        for b in range(5):
            t = o.mul(const(1 << b), L(KPD[b]))
            kpad_lin = t if kpad_lin is None else o.add(kpad_lin, t)
        c.constraint(
            o.mul(
                skec,
                o.sub(
                    o.mul(const(32), L(KWORDS)),
                    o.add(L(CH_VAL[2][0]), kpad_lin),
                ),
            )
        )

        # -- KPACK micro-rows: pack CTL reads 32 message bytes; channel 1
        # writes the little-endian staged word to SEG_HASH
        bind(kpack, 1, 0, const(SEG_HASH), L(R1))
        for j in range(N_LIMBS):
            c.constraint(o.mul(kpack, o.sub(L(CH_VAL[1][j]), r_limb(j))))

        # -- KDIG: push the big-endian digest
        bind(kdig, 1, 0, const(SEG_STACK), sp)
        bind_word_v(kdig, 1)

        # -- binary arithmetic/logic ops (pop 2, push 1)
        bin_sels = [sel[op] for op in (ADD, MUL, SUB, DIV, MOD, LT, GT, SLT,
                                       SGT, SHL, SHR, SAR, SIGNEXTEND,
                                       BYTE_, EQ, AND_, OR_, XOR_)]
        bin_gate = acc(bin_sels)
        bind(bin_gate, 1, 1, const(SEG_STACK), spm(1))
        bind(bin_gate, 2, 1, const(SEG_STACK), spm(2))
        bind(bin_gate, 3, 0, const(SEG_STACK), spm(2))
        # CTL filter columns
        c.constraint(
            o.sub(
                L(AR_PLAIN),
                acc(
                    [sel[op] for op in (ADD, MUL, SUB, DIV, MOD, LT, SLT)],
                    o.add(L(S_EXM), L(S_EXQ)),
                ),
            )
        )
        c.constraint(
            o.sub(
                L(AR_SWAP),
                acc([sel[op] for op in (GT, SGT, SHL, SHR, SAR, BYTE_,
                                        SIGNEXTEND)]),
            )
        )
        c.constraint(
            o.sub(L(LG_PLAIN), acc([sel[op] for op in (AND_, OR_, XOR_)]))
        )
        # EQ: scratch d in ch4 (no memory op), pushed value is Z
        seq = sel[EQ]
        zsum4 = None
        for k in range(N_LIMBS):
            zsum4 = L(CH_VAL[4][k]) if zsum4 is None else o.add(zsum4, L(CH_VAL[4][k]))
        c.constraint(o.mul(seq, o.sub(zs, zsum4)))
        bind_byte(seq, 3, z)

        # -- ADDMOD / MULMOD (pop 3, push 1)
        tern_gate = o.add(sel[ADDMOD], sel[MULMOD])
        bind(tern_gate, 1, 1, const(SEG_STACK), spm(1))
        bind(tern_gate, 2, 1, const(SEG_STACK), spm(2))
        bind(tern_gate, 3, 1, const(SEG_STACK), spm(3))
        bind(tern_gate, 4, 0, const(SEG_STACK), spm(3))
        c.constraint(o.sub(L(AR_TERN), tern_gate))

        # -- ISZERO / NOT (pop 1, push 1 in place)
        siz = sel[ISZERO]
        bind(siz, 1, 1, const(SEG_STACK), spm(1))
        bind(siz, 2, 0, const(SEG_STACK), spm(1))
        zsum1 = None
        for k in range(N_LIMBS):
            zsum1 = L(CH_VAL[1][k]) if zsum1 is None else o.add(zsum1, L(CH_VAL[1][k]))
        c.constraint(o.mul(siz, o.sub(zs, zsum1)))
        bind_byte(siz, 2, z)
        snot = sel[NOT_]
        bind(snot, 1, 1, const(SEG_STACK), spm(1))
        bind(snot, 2, 0, const(SEG_STACK), spm(1))

        # -- PUSH / DUP / SWAP
        bind(fpush, 1, 0, const(SEG_STACK), sp)
        for j in range(N_LIMBS):
            compj = None
            for n in range(1, 33):
                hi_i, lo_i = n - 2 - 2 * j, n - 1 - 2 * j
                if lo_i < 0:
                    continue
                e = revb[lo_i]
                if hi_i >= 0:
                    e = o.add(e, o.mul(const(256), revb[hi_i]))
                t = o.mul(nsel[n], e)
                compj = t if compj is None else o.add(compj, t)
            compj = compj if compj is not None else zero
            c.constraint(o.mul(fpush, o.sub(L(CH_VAL[1][j]), compj)))
        bind(fdup, 1, 1, const(SEG_STACK), o.sub(sp, nlin))
        bind(fdup, 2, 0, const(SEG_STACK), sp)
        bind_word_eq(fdup, 2, 1)
        bind(fswap, 1, 1, const(SEG_STACK), spm(1))
        bind(fswap, 2, 1, const(SEG_STACK), o.sub(spm(1), nlin))
        bind(fswap, 3, 0, const(SEG_STACK), spm(1))
        bind(fswap, 4, 0, const(SEG_STACK), o.sub(spm(1), nlin))
        bind_word_eq(fswap, 3, 2)
        bind_word_eq(fswap, 4, 1)

        # -- environment pushes (each binds a PI word from the env section)
        for op, word_name in ENV_OPS.items():
            g = sel[op]
            bind(g, 1, 0, const(SEG_STACK), sp)
            bind_word_pi(g, 1, lay[word_name])
        g = sel[CALLDATASIZE]
        bind(g, 1, 0, const(SEG_STACK), sp)
        bind_byte(g, 1, const(s.calldata_len))
        g = sel[PC_OP]
        bind(g, 1, 0, const(SEG_STACK), sp)
        bind_byte(g, 1, pc)
        # MSIZE: push 32*MW (the high-water mark in bytes); canonical
        # limbs via the M8B byte pair (limb 0) and the PB bits (limb 1)
        g = sel[MSIZE]
        bind(g, 1, 0, const(SEG_STACK), sp)
        msz_l0 = o.add(L(M8B0), o.mul(const(256), L(M8B1)))
        msz_l1 = None
        for b in range(5):
            t = o.mul(const(1 << b), L(PB[b]))
            msz_l1 = t if msz_l1 is None else o.add(msz_l1, t)
        c.constraint(o.mul(g, o.sub(L(CH_VAL[1][0]), msz_l0)))
        c.constraint(o.mul(g, o.sub(L(CH_VAL[1][1]), msz_l1)))
        for k in range(2, N_LIMBS):
            c.constraint(o.mul(g, L(CH_VAL[1][k])))
        c.constraint(
            o.mul(
                g,
                o.sub(
                    o.add(msz_l0, o.mul(const(1 << 16), msz_l1)),
                    o.mul(const(32), L(MW)),
                ),
            )
        )
        # MSTORE8: pop (offset, value), write value's low byte
        m8 = sel[MSTORE8]
        bind(m8, 1, 1, const(SEG_STACK), spm(1))
        bind(m8, 2, 1, const(SEG_STACK), spm(2))
        for k in range(2, N_LIMBS):
            c.constraint(o.mul(m8, L(CH_VAL[1][k])))
        c.constraint(
            o.mul(
                m8,
                o.sub(L(CH_VAL[2][0]), o.add(L(M8B0), o.mul(const(256), L(M8B1)))),
            )
        )
        c.constraint(o.mul(m8, o.sub(revb[0], L(M8B0))))
        for i in range(1, 32):
            c.constraint(o.mul(m8, revb[i]))
        # RETURNDATASIZE: push the RDS register (last call's output size)
        g = sel[RETURNDATASIZE]
        bind(g, 1, 0, const(SEG_STACK), sp)
        bind_byte(g, 1, L(RDS))

        # CODESIZE: push the shape's code length (a circuit constant)
        g = sel[CODESIZE]
        bind(g, 1, 0, const(SEG_STACK), sp)
        bind_byte(g, 1, const(s.code_len))

        # GAS: push gasbudget - GAS' (gas remaining after this op's own
        # charge) via a byte-checked 4-byte decomposition; the budget is
        # the gasbudget PI word (verifier: tx gas limit - intrinsic)
        g = sel[GAS_OP]
        bind(g, 1, 0, const(SEG_STACK), sp)
        gas_l0 = o.add(L(M8B0), o.mul(const(256), L(M8B1)))
        gas_l1 = o.add(L(RB0), o.mul(const(256), L(RB1)))
        c.constraint(o.mul(g, o.sub(L(CH_VAL[1][0]), gas_l0)))
        c.constraint(o.mul(g, o.sub(L(CH_VAL[1][1]), gas_l1)))
        for k in range(2, N_LIMBS):
            c.constraint(o.mul(g, L(CH_VAL[1][k])))
        budget = None
        for k in range(4):
            t = o.mul(
                const(1 << (16 * k)),
                ctx.public_input(16 * lay["gasbudget"] + k),
            )
            budget = t if budget is None else o.add(budget, t)
        c.constraint_transition(
            o.mul(
                g,
                o.sub(
                    o.add(
                        o.add(gas_l0, o.mul(const(1 << 16), gas_l1)),
                        N(GAS),
                    ),
                    budget,
                ),
            )
        )

        # -- environment queries: each query row binds its (opcode, arg,
        # result) to the QSEL-selected PI 4-tuple; gas rides the qgas PI
        qops_pop = acc(
            [sel[op] for op in (BALANCE, EXTCODESIZE, EXTCODEHASH, BLOCKHASH)]
        )
        sselfb = sel[SELFBALANCE]
        qgate = o.add(qops_pop, sselfb)
        bind(qops_pop, 1, 1, const(SEG_STACK), spm(1))  # pop arg
        bind(qops_pop, 2, 0, const(SEG_STACK), spm(1))  # push result
        bind(sselfb, 1, 0, const(SEG_STACK), sp)  # push result
        qsel = [L(QSEL[i]) for i in range(MAX_QUERIES)]
        qsum = None
        qlin = None
        for i in range(MAX_QUERIES):
            qsum = qsel[i] if qsum is None else o.add(qsum, qsel[i])
            t = o.mul(const(i), qsel[i])
            qlin = t if qlin is None else o.add(qlin, t)
        c.constraint(o.sub(qsum, qgate))  # one-hot exactly on query rows
        c.constraint(o.mul(qgate, o.sub(qlin, L(QIDX))))
        c.constraint_first_row(L(QIDX))
        c.constraint_transition(o.sub(N(QIDX), o.add(L(QIDX), qgate)))
        for i in range(s.n_queries, MAX_QUERIES):
            c.constraint(qsel[i])
        for i in range(s.n_queries):
            qb = lay["queries"] + 4 * i
            # the fetched opcode byte must equal the tuple's qop word
            c.constraint(
                o.mul(
                    qsel[i],
                    o.sub(L(CH_VAL[0][0]), ctx.public_input(16 * qb)),
                )
            )
            for k in range(N_LIMBS):
                arg_pi = ctx.public_input(16 * (qb + 1) + k)
                res_pi = ctx.public_input(16 * (qb + 2) + k)
                c.constraint(
                    o.mul(
                        o.mul(qsel[i], qops_pop),
                        o.sub(L(CH_VAL[1][k]), arg_pi),
                    )
                )
                c.constraint(
                    o.mul(
                        o.mul(qsel[i], qops_pop),
                        o.sub(L(CH_VAL[2][k]), res_pi),
                    )
                )
                c.constraint(
                    o.mul(
                        o.mul(qsel[i], sselfb),
                        o.sub(L(CH_VAL[1][k]), res_pi),
                    )
                )
                # SELFBALANCE queries carry the frame's own address
                c.constraint(
                    o.mul(
                        o.mul(qsel[i], sselfb),
                        o.sub(
                            arg_pi,
                            ctx.public_input(16 * lay["address"] + k),
                        ),
                    )
                )

        # -- stack-depth limit: SP <= 1024 on every row (EVM consensus)
        sp_hi = o.add(L(SPH0), o.mul(const(2), L(SPH1)))
        sp_comp = o.add(
            o.mul(L(SPMX), const(1024)),
            o.mul(
                o.sub(one, L(SPMX)),
                o.add(L(SPB0), o.mul(const(256), sp_hi)),
            ),
        )
        c.constraint(o.sub(sp, sp_comp))

        # ================== precompile calls ==============================
        # op row: ch1 = argsOfs @ sp-3-d, ch2 = argsLen @ sp-4-d (d = 1
        # for CALL), ch3 = gas @ sp-1, ch4 = addr @ sp-2; CLA row: ch1 =
        # retOfs, ch2 = retLen, ch3 = success write, ch4 = value (CALL).
        d_call = sel[CALL]
        c.constraint(o.mul(callop, o.sub(L(CH_ISREAD[1]), one)))
        c.constraint(o.mul(callop, o.sub(L(CH_SEG[1]), const(SEG_STACK))))
        c.constraint(
            o.mul(
                callop,
                o.sub(L(CH_VIRT[1]), o.sub(o.sub(sp, const(3)), d_call)),
            )
        )
        c.constraint(o.mul(callop, o.sub(L(CH_ISREAD[2]), one)))
        c.constraint(o.mul(callop, o.sub(L(CH_SEG[2]), const(SEG_STACK))))
        c.constraint(
            o.mul(
                callop,
                o.sub(L(CH_VIRT[2]), o.sub(o.sub(sp, const(4)), d_call)),
            )
        )
        bind(callop, 3, 1, const(SEG_STACK), spm(1))  # gas (value unused)
        bind(callop, 4, 1, const(SEG_STACK), spm(2))  # addr
        # argsOfs fits 32 bits and loads R0
        for k in range(2, N_LIMBS):
            c.constraint(o.mul(callop, L(CH_VAL[1][k])))
        c.constraint(o.mul(callop, o.sub(L(R0), ofs32)))
        # argsLen / opcode are shape constants per CSEL slot
        lay_cw = lay.get("call_words", [])
        alen_c = None
        opc_c = None
        for i in range(n_calls):
            t = o.mul(csel[i], const(call_alen[i]))
            alen_c = t if alen_c is None else o.add(alen_c, t)
            t = o.mul(csel[i], const(call_op_i[i]))
            opc_c = t if opc_c is None else o.add(opc_c, t)
        alen_c = alen_c if alen_c is not None else zero
        opc_c = opc_c if opc_c is not None else zero
        c.constraint(o.mul(callop, o.sub(L(CH_VAL[2][0]), alen_c)))
        for k in range(1, N_LIMBS):
            c.constraint(o.mul(callop, L(CH_VAL[2][k])))
        # ch4 addr: precompile entries pin their constant id (limb 0);
        # frame entries bind all 16 limbs to the call's `addr` PI word
        for k in range(N_LIMBS):
            want = None
            for i in range(n_calls):
                if call_is_frame[i]:
                    t = o.mul(
                        csel[i], ctx.public_input(16 * lay_cw[i] + k)
                    )
                elif k == 0:
                    t = o.mul(csel[i], const(call_tgt[i]))
                else:
                    continue
                want = t if want is None else o.add(want, t)
            want = want if want is not None else zero
            c.constraint(o.mul(callop, o.sub(L(CH_VAL[4][k]), want)))
        c.constraint(o.mul(callop, o.sub(L(CH_VAL[0][0]), opc_c)))
        # CSEL: one-hot on call rows, linked to the CIDX counter
        call_rows = o.add(callop, o.add(cla, o.add(cli, clo)))
        csum = None
        clin = None
        for i in range(MAX_CALLS):
            csum = csel[i] if csum is None else o.add(csum, csel[i])
            t = o.mul(const(i), csel[i])
            clin = t if clin is None else o.add(clin, t)
        c.constraint(o.sub(csum, call_rows))
        c.constraint(o.mul(callop, o.sub(clin, L(CIDX))))
        c.constraint(
            o.mul(
                o.add(cla, o.add(cli, clo)),
                o.sub(o.add(clin, one), L(CIDX)),
            )
        )
        c.constraint_first_row(L(CIDX))
        c.constraint_transition(o.sub(N(CIDX), o.add(L(CIDX), callop)))
        for i in range(n_calls, MAX_CALLS):
            c.constraint(csel[i])
        # CSEL carries along the call's rows (op->CLA->CLI...->CLO...);
        # CLI rows carry only while the call continues (the next row is
        # CLI or CLO) — a zero-output call's last CLI row hands back to
        # normal execution and the next op row may select another call
        for i in range(n_calls):
            carry = o.add(
                o.add(callop, cla), o.mul(cli, o.add(N(S_CLI), N(S_CLO)))
            )
            c.constraint_transition(o.mul(carry, o.sub(N(CSEL[i]), csel[i])))
            c.constraint_transition(
                o.mul(o.mul(clo, N(S_CLO)), o.sub(N(CSEL[i]), csel[i]))
            )
        # CLA follows exactly the call op rows
        c.constraint_first_row(cla)
        c.constraint_transition(o.sub(N(S_CLA), callop))
        c.constraint_transition(o.mul(callop, o.sub(N(R0), L(R0))))
        # CLA bindings
        bind(cla, 1, 1, const(SEG_STACK), spm(1))  # retOfs
        bind(cla, 2, 1, const(SEG_STACK), spm(2))  # retLen
        bind(cla, 3, 0, const(SEG_STACK), spm(2))  # success push
        bind_byte(cla, 3, one)  # envelope: precompile calls succeed
        for k in range(2, N_LIMBS):
            c.constraint(o.mul(cla, L(CH_VAL[1][k])))
        rlen_c = None
        for i in range(n_calls):
            t = o.mul(csel[i], const(call_rlen[i]))
            rlen_c = t if rlen_c is None else o.add(rlen_c, t)
        rlen_c = rlen_c if rlen_c is not None else zero
        c.constraint(o.mul(cla, o.sub(L(CH_VAL[2][0]), rlen_c)))
        for k in range(1, N_LIMBS):
            c.constraint(o.mul(cla, L(CH_VAL[2][k])))
        c.constraint(o.mul(cla, o.sub(L(R1), ofs32)))  # retOfs register
        # CALL frames read (and require zero) the value slot on ch4
        c.constraint(o.mul(cla_value_read, o.sub(L(CH_ISREAD[4]), one)))
        c.constraint(o.mul(cla_value_read, o.sub(L(CH_SEG[4]), const(SEG_STACK))))
        c.constraint(
            o.mul(cla_value_read, o.sub(L(CH_VIRT[4]), o.add(sp, const(2))))
        )
        for k in range(N_LIMBS):
            c.constraint(o.mul(cla_value_read, L(CH_VAL[4][k])))
        # phase choreography: CLA -> first CLI; CLI advances its word
        # counter until the call's input words are staged, then CLO
        # (zero-output calls complete on their last CLI row instead)
        cli_notlast = None
        cli_last_out = None
        cli_last_noout = None
        for i in range(n_calls):
            base = o.mul(csel[i], cli)
            for w in range(call_inw[i] - 1):
                t = o.mul(base, nsel[w])
                cli_notlast = t if cli_notlast is None else o.add(cli_notlast, t)
            t = o.mul(base, nsel[call_inw[i] - 1])
            if call_outw[i] > 0:
                cli_last_out = t if cli_last_out is None else o.add(cli_last_out, t)
            else:
                cli_last_noout = (
                    t if cli_last_noout is None else o.add(cli_last_noout, t)
                )
        cli_notlast = cli_notlast if cli_notlast is not None else zero
        cli_last_out = cli_last_out if cli_last_out is not None else zero
        cli_last_noout = cli_last_noout if cli_last_noout is not None else zero
        clo_notlast = None
        clo_last = None
        clo_last_nocb = None
        cbgo_def = None
        for i in range(n_calls):
            base = o.mul(csel[i], clo)
            for w in range(call_outw[i] - 1):
                t = o.mul(base, nsel[w])
                clo_notlast = t if clo_notlast is None else o.add(clo_notlast, t)
            t = o.mul(base, nsel[call_outw[i] - 1])
            clo_last = t if clo_last is None else o.add(clo_last, t)
            if call_rlen[i] > 0:
                cbgo_def = t if cbgo_def is None else o.add(cbgo_def, t)
            else:
                clo_last_nocb = (
                    t if clo_last_nocb is None else o.add(clo_last_nocb, t)
                )
        clo_notlast = clo_notlast if clo_notlast is not None else zero
        clo_last = clo_last if clo_last is not None else zero
        clo_last_nocb = clo_last_nocb if clo_last_nocb is not None else zero
        cbgo_def = cbgo_def if cbgo_def is not None else zero
        c.constraint(o.sub(L(CBGO), cbgo_def))
        c.constraint_transition(o.sub(N(S_CLI), o.add(cla, cli_notlast)))
        c.constraint_transition(
            o.sub(N(S_CLO), o.add(cli_last_out, clo_notlast))
        )
        c.constraint_transition(o.mul(cla, o.sub(N(NSEL[0]), one)))
        c.constraint_transition(
            o.mul(o.mul(cli, N(S_CLO)), o.sub(N(NSEL[0]), one))
        )
        for w in range(0, 7):
            c.constraint_transition(
                o.mul(o.mul(cli, N(S_CLI)), o.sub(N(NSEL[w + 1]), nsel[w]))
            )
            c.constraint_transition(
                o.mul(o.mul(clo, N(S_CLO)), o.sub(N(NSEL[w + 1]), nsel[w]))
            )
        # word indices beyond the call's counts are forbidden
        for i in range(n_calls):
            for w in range(call_inw[i], 33):
                c.constraint(o.mul(o.mul(cli, csel[i]), nsel[w]))
            for w in range(call_outw[i], 33):
                c.constraint(o.mul(o.mul(clo, csel[i]), nsel[w]))
        # registers: R0 (argsOfs) rides op->CLA->CLI; R1 (retOfs) rides
        # CLA->CLI->CLO; on CLO rows R0 = 0, R2 = the copy-back length,
        # HS_SEG = SEG_RETDATA
        c.constraint_transition(
            o.mul(o.add(cla, o.mul(cli, N(S_CLI))), o.sub(N(R0), L(R0)))
        )
        c.constraint_transition(
            o.mul(
                o.add(cla, o.add(cli, o.mul(clo, N(S_CLO)))),
                o.sub(N(R1), L(R1)),
            )
        )
        c.constraint(o.mul(clo, L(R0)))
        cb_c = None
        for i in range(n_calls):
            t = o.mul(csel[i], const(call_rlen[i]))
            cb_c = t if cb_c is None else o.add(cb_c, t)
        cb_c = cb_c if cb_c is not None else zero
        c.constraint(o.mul(clo, o.sub(L(R2), cb_c)))
        c.constraint(o.mul(clo, o.sub(L(HS_SEG), const(SEG_RETDATA))))
        # RDS register: set on the op->CLA transition, constant elsewhere
        outlen_c = None
        for i in range(n_calls):
            t = o.mul(csel[i], const(call_outlen[i]))
            outlen_c = t if outlen_c is None else o.add(outlen_c, t)
        outlen_c = outlen_c if outlen_c is not None else zero
        c.constraint_first_row(L(RDS))
        c.constraint_transition(o.mul(callop, o.sub(N(RDS), outlen_c)))
        c.constraint_transition(
            o.mul(o.sub(one, callop), o.sub(N(RDS), L(RDS)))
        )
        # input/output words bind to the call's public-input words
        # (offset past the entry's directory words)
        for k in range(N_LIMBS):
            combo_in = None
            combo_out = None
            for i in range(n_calls):
                for w in range(call_inw[i]):
                    piv = ctx.public_input(
                        16 * (lay_cw[i] + call_dirw[i] + w) + k
                    )
                    t = o.mul(o.mul(csel[i], nsel[w]), piv)
                    combo_in = t if combo_in is None else o.add(combo_in, t)
                for w in range(call_outw[i]):
                    piv = ctx.public_input(
                        16 * (lay_cw[i] + call_dirw[i] + call_inw[i] + w) + k
                    )
                    t = o.mul(o.mul(csel[i], nsel[w]), piv)
                    combo_out = t if combo_out is None else o.add(combo_out, t)
            if combo_in is not None:
                c.constraint(o.mul(cli, o.sub(v_limb(k), combo_in)))
            if combo_out is not None:
                c.constraint(o.mul(clo, o.sub(v_limb(k), combo_out)))
        if not s.call_shapes:
            c.constraint(cla)
            c.constraint(cli)
            c.constraint(clo)

        # ================== EXP micro-machine =============================
        # LSB-first square-and-multiply. Scratch words per EXP at XP:
        # exp word, S (running square), ACC. Row sequence:
        # setup (pop base/exp; e == 0 pushes 1 directly) -> EXI (write
        # S = base) -> [M (ACC *= b ? S : 1), Q (S *= S)]* -> final M row
        # (TERM = 1, pushes ACC) exactly at the exponent's MSB.
        sexp = sel[EXP]
        xp = L(XP)
        b_ = L(XB)
        pow_, lacc, lacn, bitc = L(POW), L(LACC), L(LACN), L(BITC)
        lb, lbi = L(LB), L(LBI)
        exrow = o.add(exm, exq)
        # -- setup row: pops; Z decides e == 0
        bind(sexp, 1, 1, const(SEG_STACK), spm(1))  # base
        bind(sexp, 2, 1, const(SEG_STACK), spm(2))  # exponent
        zsum_e = None
        for k in range(N_LIMBS):
            t = L(CH_VAL[2][k])
            zsum_e = t if zsum_e is None else o.add(zsum_e, t)
        c.constraint(o.mul(sexp, o.sub(zs, zsum_e)))
        # ch3: e == 0 -> push 1 at spm(2); else write the exp word at XP
        c.constraint(o.mul(sexp, L(CH_ISREAD[3])))
        c.constraint(
            o.mul(
                sexp,
                o.sub(
                    L(CH_SEG[3]),
                    o.add(
                        o.mul(z, const(SEG_STACK)),
                        o.mul(o.sub(one, z), const(SEG_EXPS)),
                    ),
                ),
            )
        )
        c.constraint(
            o.mul(
                sexp,
                o.sub(
                    L(CH_VIRT[3]),
                    o.add(o.mul(z, spm(2)), o.mul(o.sub(one, z), xp)),
                ),
            )
        )
        c.constraint(
            o.mul(o.mul(sexp, z), o.sub(L(CH_VAL[3][0]), one))
        )
        for k in range(1, N_LIMBS):
            c.constraint(o.mul(o.mul(sexp, z), L(CH_VAL[3][k])))
        for k in range(N_LIMBS):
            c.constraint(
                o.mul(
                    o.mul(sexp, o.sub(one, z)),
                    o.sub(L(CH_VAL[3][k]), L(CH_VAL[2][k])),
                )
            )
        # ch4 (e != 0): write ACC = 1 at XP + 2
        g4 = o.mul(sexp, o.sub(one, z))
        c.constraint(o.mul(g4, L(CH_ISREAD[4])))
        c.constraint(o.mul(g4, o.sub(L(CH_SEG[4]), const(SEG_EXPS))))
        c.constraint(o.mul(g4, o.sub(L(CH_VIRT[4]), o.add(xp, const(2)))))
        c.constraint(o.mul(g4, o.sub(L(CH_VAL[4][0]), one)))
        for k in range(1, N_LIMBS):
            c.constraint(o.mul(g4, L(CH_VAL[4][k])))
        # XP allocation: 3 scratch words per completed EXP (the TERM
        # transition), so the whole micro-sequence sees its own base
        c.constraint_first_row(xp)
        c.constraint_transition(
            o.sub(N(XP), o.add(xp, o.mul(const(3), term)))
        )
        # -- choreography
        c.constraint_first_row(exi)
        c.constraint_first_row(exm)
        c.constraint_first_row(exq)
        c.constraint_transition(o.sub(N(S_EXI), g4))
        c.constraint_transition(o.sub(N(S_EXM), o.add(exi, exq)))
        c.constraint_transition(o.sub(N(S_EXQ), o.sub(exm, term)))
        # -- EXI row: re-read base from its (dead) stack slot, write S_0
        bind(exi, 1, 1, const(SEG_STACK), o.add(sp, one))
        bind(exi, 2, 0, const(SEG_EXPS), o.add(xp, one))
        bind_word_eq(exi, 2, 1)
        # -- M row: ACC' = ACC * (b ? S : 1)
        bind(exm, 1, 1, const(SEG_EXPS), o.add(xp, const(2)))  # ACC
        mb = o.mul(exm, b_)
        c.constraint(o.mul(mb, o.sub(L(CH_ISREAD[2]), one)))
        c.constraint(o.mul(mb, o.sub(L(CH_SEG[2]), const(SEG_EXPS))))
        c.constraint(o.mul(mb, o.sub(L(CH_VIRT[2]), o.add(xp, one))))
        mnb = o.mul(exm, o.sub(one, b_))
        c.constraint(o.mul(mnb, o.sub(L(CH_VAL[2][0]), one)))
        for k in range(1, N_LIMBS):
            c.constraint(o.mul(mnb, L(CH_VAL[2][k])))
        # ch3: ACC' to scratch, or to the stack on the TERM row
        c.constraint(o.mul(exm, L(CH_ISREAD[3])))
        c.constraint(
            o.mul(
                exm,
                o.sub(
                    L(CH_SEG[3]),
                    o.add(
                        const(SEG_EXPS),
                        o.mul(term, const(SEG_STACK - SEG_EXPS)),
                    ),
                ),
            )
        )
        xp2 = o.add(xp, const(2))
        c.constraint(
            o.mul(
                exm,
                o.sub(L(CH_VIRT[3]), o.add(xp2, o.mul(term, o.sub(sp, xp2)))),
            )
        )
        bind(exm, 4, 1, const(SEG_EXPS), xp)  # the exponent word
        # -- Q row: S' = S * S
        bind(exq, 1, 1, const(SEG_EXPS), o.add(xp, one))
        bind(exq, 2, 1, const(SEG_EXPS), o.add(xp, one))
        bind(exq, 3, 0, const(SEG_EXPS), o.add(xp, one))
        # -- bit machinery
        c.constraint(o.mul(term, o.sub(one, exm)))
        c.constraint(o.mul(term, o.sub(b_, one)))  # MSB is a set bit
        c.constraint(o.mul(lb, o.sub(one, exrow)))
        c.constraint(o.mul(lb, o.sub(pow_, const(1 << 15))))
        c.constraint(
            o.sub(
                o.mul(o.sub(pow_, const(1 << 15)), lbi),
                o.sub(exrow, lb),
            )
        )
        c.constraint(o.mul(exrow, o.sub(lacn, o.add(lacc, o.mul(b_, pow_)))))
        # limb selected from the exponent word read on the M row (ch4)
        limbsel = None
        for j in range(16):
            t = o.mul(nsel[j], L(CH_VAL[4][j]))
            limbsel = t if limbsel is None else o.add(limbsel, t)
        # at a limb boundary, the accumulated bits equal the limb
        c.constraint(o.mul(o.mul(lb, exm), o.sub(limbsel, lacn)))
        # at termination: same mid-limb check + all higher limbs zero
        c.constraint(o.mul(term, o.sub(limbsel, lacn)))
        for j in range(16):
            hi_sum = None
            for k in range(j + 1, 16):
                t = L(CH_VAL[4][k])
                hi_sum = t if hi_sum is None else o.add(hi_sum, t)
            if hi_sum is not None:
                c.constraint(o.mul(o.mul(term, nsel[j]), hi_sum))
        # init on EXI -> first M
        c.constraint_transition(o.mul(exi, o.sub(N(POW), one)))
        c.constraint_transition(o.mul(exi, N(LACC)))
        c.constraint_transition(o.mul(exi, N(BITC)))
        c.constraint_transition(o.mul(exi, o.sub(N(NSEL[0]), one)))
        # M -> Q carries (non-TERM rows only)
        mq = o.sub(exm, term)
        for col in (XB, POW, LACC, LACN, BITC, LB):
            c.constraint_transition(o.mul(mq, o.sub(N(col), L(col))))
        for j in range(16):
            c.constraint_transition(o.mul(mq, o.sub(N(NSEL[j]), nsel[j])))
        # Q -> next M advance (boundary LB resets the limb accumulator)
        c.constraint_transition(
            o.mul(exq, o.sub(N(BITC), o.add(bitc, one)))
        )
        c.constraint_transition(
            o.mul(
                exq,
                o.sub(
                    N(POW),
                    o.add(o.mul(const(2), o.mul(pow_, o.sub(one, lb))), lb),
                ),
            )
        )
        c.constraint_transition(
            o.mul(exq, o.sub(N(LACC), o.mul(lacn, o.sub(one, lb))))
        )
        for j in range(16):
            prev = nsel[j - 1] if j >= 1 else zero
            c.constraint_transition(
                o.mul(
                    exq,
                    o.sub(
                        N(NSEL[j]),
                        o.add(
                            o.mul(nsel[j], o.sub(one, lb)), o.mul(prev, lb)
                        ),
                    ),
                )
            )
        # byte-length witness on the TERM row: 8*KWORDS = BITC + 1 + pad,
        # pad < 8 (3 bits) — the 50/byte gas charge uses KWORDS
        pad3 = None
        for bbit in range(3):
            t = o.mul(const(1 << bbit), L(PB[bbit]))
            pad3 = t if pad3 is None else o.add(pad3, t)
        c.constraint(
            o.mul(
                term,
                o.sub(
                    o.mul(const(8), L(KWORDS)),
                    o.add(o.add(bitc, one), pad3),
                ),
            )
        )

        # -- CALLDATACOPY / CODECOPY: pop (dest, src, len); the copy runs
        # as CPR/CPW row pairs (pack-read into REVB, pack-write to MAIN)
        scdc, sccc = sel[CALLDATACOPY], sel[CODECOPY]
        srdc = sel[RETURNDATACOPY]
        copyop = o.add(o.add(scdc, sccc), srdc)
        bind(copyop, 1, 1, const(SEG_STACK), spm(1))  # dest
        bind(copyop, 2, 1, const(SEG_STACK), spm(2))  # src
        bind(copyop, 3, 1, const(SEG_STACK), spm(3))  # len
        for k in range(2, N_LIMBS):
            c.constraint(o.mul(copyop, L(CH_VAL[1][k])))
            c.constraint(o.mul(copyop, L(CH_VAL[2][k])))
        for k in range(1, N_LIMBS):
            c.constraint(o.mul(copyop, L(CH_VAL[3][k])))
        # Z decides len == 0 (no copy rows, no memory touch)
        zsum_cl = None
        for k in range(N_LIMBS):
            t = L(CH_VAL[3][k])
            zsum_cl = t if zsum_cl is None else o.add(zsum_cl, t)
        c.constraint(o.mul(copyop, o.sub(zs, zsum_cl)))
        src32 = o.add(L(CH_VAL[2][0]), o.mul(const(1 << 16), L(CH_VAL[2][1])))
        c.constraint(o.mul(copyop, o.sub(L(R0), src32)))
        c.constraint(o.mul(copyop, o.sub(L(R1), ofs32)))
        c.constraint(o.mul(copyop, o.sub(L(R2), L(CH_VAL[3][0]))))
        c.constraint(
            o.sub(
                o.mul(copyop, L(HS_SEG)),
                o.add(
                    o.add(
                        o.mul(scdc, const(SEG_CALLDATA)),
                        o.mul(sccc, const(SEG_CODE)),
                    ),
                    o.mul(srdc, const(SEG_RETDATA)),
                ),
            )
        )
        # EIP-211 bound: src + len <= RDS, via the byte-checked M8B pair
        rdc_slack = o.add(L(M8B0), o.mul(const(256), L(M8B1)))
        c.constraint(
            o.mul(
                srdc,
                o.sub(
                    L(RDS),
                    o.add(o.add(src32, L(CH_VAL[3][0])), rdc_slack),
                ),
            )
        )
        # gas word count (3/word, charged on the op row)
        kpad_cl = None
        for b in range(5):
            t = o.mul(const(1 << b), L(KPD[b]))
            kpad_cl = t if kpad_cl is None else o.add(kpad_cl, t)
        c.constraint(
            o.mul(
                copyop,
                o.sub(
                    o.mul(const(32), L(KWORDS)),
                    o.add(L(CH_VAL[3][0]), kpad_cl),
                ),
            )
        )
        # phase choreography: op(len>0) -> CPR; CPR -> CPW; CPW -> CPR
        # while the chunk was full, else back to normal execution
        c.constraint_transition(
            o.sub(
                N(S_CPR),
                o.add(
                    o.add(o.mul(copyop, o.sub(one, z)), o.mul(cpw, L(FULLC))),
                    L(CBGO),
                ),
            )
        )
        # call copy-back register hand-off (R0 = 0, R1 = retOfs,
        # R2 = copy length, HS_SEG = SEG_RETDATA, set on the last CLO row)
        for col in (R0, R1, R2, HS_SEG):
            c.constraint_transition(o.mul(L(CBGO), o.sub(N(col), L(col))))
        c.constraint_transition(o.sub(N(S_CPW), cpr))
        # CPR -> CPW: registers, chunk witness, and REVB carry verbatim
        for col in (R0, R1, R2, CSW, FULLC, HS_SEG):
            c.constraint_transition(o.mul(cpr, o.sub(N(col), L(col))))
        for i in range(32):
            c.constraint_transition(o.mul(cpr, o.sub(N(REVB[i]), revb[i])))
        # CPW -> next CPR: pointers advance by the chunk size
        adv_gate = o.mul(cpw, N(S_CPR))
        c.constraint_transition(
            o.mul(adv_gate, o.sub(N(R0), o.add(L(R0), L(CSW))))
        )
        c.constraint_transition(
            o.mul(adv_gate, o.sub(N(R1), o.add(L(R1), L(CSW))))
        )
        c.constraint_transition(
            o.mul(adv_gate, o.sub(o.add(N(R2), L(CSW)), L(R2)))
        )
        c.constraint_transition(
            o.mul(adv_gate, o.sub(N(HS_SEG), L(HS_SEG)))
        )
        # op row -> first CPR: pointers and source segment carry in
        enter_gate = o.mul(copyop, N(S_CPR))
        for col in (R0, R1, R2, HS_SEG):
            c.constraint_transition(o.mul(enter_gate, o.sub(N(col), L(col))))

        # -- CALLDATALOAD / MLOAD / MSTORE (bytepacking window ops)
        scdl, sml, sms = sel[CALLDATALOAD], sel[MLOAD], sel[MSTORE]
        window_pop = acc([scdl, sml, sms])
        bind(window_pop, 1, 1, const(SEG_STACK), spm(1))  # pop offset
        for k in range(2, N_LIMBS):
            c.constraint(o.mul(window_pop, L(CH_VAL[1][k])))
        push_back = o.add(scdl, sml)
        bind(push_back, 2, 0, const(SEG_STACK), spm(1))
        bind_word_v(push_back, 2)
        bind(sms, 2, 1, const(SEG_STACK), spm(2))  # pop value
        bind_word_v(sms, 2)
        # pack request fields
        push_packs = o.mul(fpush, o.sub(one, nsel[0]))
        pre_packs = o.add(f_init, f_rp)
        c.constraint(
            o.sub(
                L(IS_PACK),
                o.add(
                    o.add(
                        o.add(o.add(push_packs, window_pop), o.add(kpack, pre_packs)),
                        o.add(o.add(o.add(log_data, logd), m8), o.add(cpr, cpw)),
                    ),
                    o.add(cli, clo),
                ),
            )
        )
        c.constraint(
            o.sub(
                L(PACK_WRITE),
                o.add(o.add(o.add(o.add(sms, m8), cpw), pre_packs), clo),
            )
        )
        seg_expr = o.add(
            o.add(
                o.mul(push_packs, const(SEG_CODE)),
                o.mul(f_init, const(SEG_CALLDATA)),
            ),
            o.add(
                o.add(
                    o.mul(scdl, const(SEG_CALLDATA)),
                    o.mul(f_rp, const(SEG_CODE)),
                ),
                o.mul(
                    o.add(
                        o.add(o.add(sml, sms), o.add(kpack, m8)),
                        o.add(o.add(log_data, logd), cpw),
                    ),
                    const(SEG_MAIN),
                ),
            ),
        )
        # copy-read rows source from the carried segment register
        seg_expr = o.add(seg_expr, o.mul(cpr, L(HS_SEG)))
        seg_expr = o.add(
            seg_expr,
            o.add(o.mul(cli, const(SEG_MAIN)), o.mul(clo, const(SEG_RETDATA))),
        )
        c.constraint(o.sub(o.mul(L(IS_PACK), L(PACK_SEG)), seg_expr))
        # LOGD rows pack data word NSEL at base offset R0 (carried from
        # the LOG row's popped offset)
        virt_expr = o.add(
            o.add(
                o.mul(push_packs, o.add(pc, one)),
                o.mul(o.add(window_pop, m8), ofs32),
            ),
            o.add(
                o.add(
                    o.mul(o.add(kpack, cpr), L(R0)),
                    o.add(o.mul(cpw, L(R1)), o.mul(pre_packs, F(self.F_A1))),
                ),
                o.add(
                    o.mul(log_data, ofs32),
                    o.add(o.mul(logd, L(R0)), o.mul(const(32), o.mul(logd, nlin))),
                ),
            ),
        )
        virt_expr = o.add(
            virt_expr,
            o.add(
                o.add(o.mul(cli, L(R0)), o.mul(const(32), o.mul(cli, nlin))),
                o.mul(const(32), o.mul(clo, nlin)),
            ),
        )
        c.constraint(o.sub(o.mul(L(IS_PACK), L(PACK_VIRT)), virt_expr))
        # pack lengths: the LOG row stages min(32, dl) bytes; LOGD row w
        # stages min(32, dl - 32w)
        log_len = None
        for i in range(len(s.log_shapes)):
            if dl_of[i] > 0:
                t = o.mul(o.mul(flog, lsel[i]), const(min(32, dl_of[i])))
                log_len = t if log_len is None else o.add(log_len, t)
        logd_len = None
        for i in range(len(s.log_shapes)):
            dwi = (dl_of[i] + 31) // 32
            for w in range(1, dwi):
                # logd-gated: (lsel, nsel) pairs also occur on LOG rows
                t = o.mul(
                    o.mul(logd, o.mul(lsel[i], nsel[w])),
                    const(min(32, dl_of[i] - 32 * w)),
                )
                logd_len = t if logd_len is None else o.add(logd_len, t)
        len_expr = o.add(
            o.add(
                o.add(
                    o.mul(o.add(push_packs, window_pop), const(32)),
                    o.add(L(CSW), m8),  # kpack chunk size; MSTORE8 = 1 byte
                ),
                o.mul(pre_packs, F(self.F_PLEN)),
            ),
            o.add(
                log_len if log_len is not None else zero,
                logd_len if logd_len is not None else zero,
            ),
        )
        call_pack_len = None
        for i in range(n_calls):
            for w in range(call_inw[i]):
                t = o.mul(
                    o.mul(cli, o.mul(csel[i], nsel[w])),
                    const(min(32, call_alen[i] - 32 * w)),
                )
                call_pack_len = (
                    t if call_pack_len is None else o.add(call_pack_len, t)
                )
            for w in range(call_outw[i]):
                t = o.mul(
                    o.mul(clo, o.mul(csel[i], nsel[w])),
                    const(min(32, call_outlen[i] - 32 * w)),
                )
                call_pack_len = (
                    t if call_pack_len is None else o.add(call_pack_len, t)
                )
        if call_pack_len is not None:
            len_expr = o.add(len_expr, call_pack_len)
        c.constraint(o.sub(o.mul(L(IS_PACK), L(PACK_LEN)), len_expr))

        # -- SLOAD / SSTORE (two-row ops; the continuation row handles
        # the EIP-2929 warm-flag journal and the SSTORE journal writes)
        ssl, sss = sel[SLOAD], sel[SSTORE]
        bind(ssl, 1, 1, const(SEG_STACK), spm(1))  # pop key
        bind(ssl, 2, 1, const(SEG_SKEYS), L(SIDX))
        bind(ssl, 3, 1, const(SEG_SVALS), L(SIDX))
        bind(ssl, 4, 0, const(SEG_STACK), spm(1))  # push value
        bind_word_eq(ssl, 2, 1)
        bind_word_eq(ssl, 4, 3)
        bind(sss, 1, 1, const(SEG_STACK), spm(1))  # pop key
        bind(sss, 2, 1, const(SEG_STACK), spm(2))  # pop value
        bind(sss, 3, 1, const(SEG_SVALS), L(SIDX))  # current (pre-store)
        bind(sss, 4, 1, const(SEG_SORIG), L(SIDX))  # original (pre-tx)
        # phase integrity: continuation rows follow exactly their op rows
        c.constraint_first_row(slx)
        c.constraint_first_row(ssx)
        c.constraint_transition(o.sub(N(S_SLX), ssl))
        c.constraint_transition(o.sub(N(S_SSX), sss))

        def bind_next(gate, ch, is_read, seg, virt_expr):
            """Channel bindings for the NEXT row, gated by this row."""
            c.constraint_transition(
                o.mul(gate, o.sub(N(CH_ISREAD[ch]), const(is_read)))
            )
            c.constraint_transition(o.mul(gate, o.sub(N(CH_SEG[ch]), seg)))
            c.constraint_transition(o.mul(gate, o.sub(N(CH_VIRT[ch]), virt_expr)))

        def bind_next_const1(gate, ch):
            c.constraint_transition(
                o.mul(gate, o.sub(N(CH_VAL[ch][0]), one))
            )
            for k in range(1, N_LIMBS):
                c.constraint_transition(o.mul(gate, N(CH_VAL[ch][k])))

        def bind_next_flag(gate, ch):
            # warm-flag read: boolean limb 0, upper limbs zero
            w = N(CH_VAL[ch][0])
            c.constraint_transition(o.mul(gate, o.mul(w, o.sub(w, one))))
            for k in range(1, N_LIMBS):
                c.constraint_transition(o.mul(gate, N(CH_VAL[ch][k])))

        # SLOAD continuation: read warm flag (ch1), set it (ch2)
        bind_next(ssl, 1, 1, const(SEG_SWARM), L(SIDX))
        bind_next_flag(ssl, 1)
        bind_next(ssl, 2, 0, const(SEG_SWARM), L(SIDX))
        bind_next_const1(ssl, 2)
        # SSTORE continuation: journal write (ch1 = popped value), key
        # directory read (ch2 = popped key), warm flag read+set (ch3/ch4)
        bind_next(sss, 1, 0, const(SEG_SVALS), L(SIDX))
        for k in range(N_LIMBS):
            c.constraint_transition(
                o.mul(sss, o.sub(N(CH_VAL[1][k]), L(CH_VAL[2][k])))
            )
        bind_next(sss, 2, 1, const(SEG_SKEYS), L(SIDX))
        for k in range(N_LIMBS):
            c.constraint_transition(
                o.mul(sss, o.sub(N(CH_VAL[2][k]), L(CH_VAL[1][k])))
            )
        bind_next(sss, 3, 1, const(SEG_SWARM), L(SIDX))
        bind_next_flag(sss, 3)
        bind_next(sss, 4, 0, const(SEG_SWARM), L(SIDX))
        bind_next_const1(sss, 4)
        # directory cell must be nonzero (points at a PI-bound key):
        # SLOAD reads it locally (ch2); SSTORE on the continuation row
        ks = None
        for k in range(N_LIMBS):
            ks = L(CH_VAL[2][k]) if ks is None else o.add(ks, L(CH_VAL[2][k]))
        c.constraint(o.mul(ssl, o.sub(o.mul(ks, L(KINV)), one)))
        ks_n = None
        for k in range(N_LIMBS):
            t = N(CH_VAL[2][k])
            ks_n = t if ks_n is None else o.add(ks_n, t)
        c.constraint_transition(
            o.mul(sss, o.sub(o.mul(ks_n, L(KINV)), one))
        )

        # -- SSTORE net-metering predicates (EIP-2200/3529): equality of
        # (value=ch2, current=ch3, original=ch4) word pairs via 48-bit
        # chunks; C0 (current == 0) rides the row's Z bank
        def chunk(ch, j):
            e = None
            for i in range(3):
                li = 3 * j + i
                if li >= N_LIMBS:
                    break
                t = o.mul(const(1 << (16 * i)), L(CH_VAL[ch][li]))
                e = t if e is None else o.add(e, t)
            return e

        zsum_cur = None
        for k in range(N_LIMBS):
            t = L(CH_VAL[3][k])
            zsum_cur = t if zsum_cur is None else o.add(zsum_cur, t)
        c.constraint(o.mul(sss, o.sub(zs, zsum_cur)))

        for (ecol, dcol, icol, scols, ch_a, ch_b) in (
            (E_VC, D_VC, I_VC, S_VC, 2, 3),
            (E_CO, D_CO, I_CO, S_CO, 3, 4),
            (E_VO, D_VO, I_VO, S_VO, 2, 4),
        ):
            e_, d_, i_ = L(ecol), L(dcol), L(icol)
            s_ = [L(x) for x in scols]
            ssum = None
            dsum = None
            for j in range(6):
                dj = o.sub(chunk(ch_a, j), chunk(ch_b, j))
                # equality direction: every chunk matches
                c.constraint(o.mul(o.mul(sss, e_), dj))
                ssum = s_[j] if ssum is None else o.add(ssum, s_[j])
                t = o.mul(s_[j], dj)
                dsum = t if dsum is None else o.add(dsum, t)
            # inequality direction: pick one differing chunk, prove != 0
            c.constraint(o.sub(ssum, o.mul(sss, o.sub(one, e_))))
            c.constraint(o.sub(d_, dsum))
            c.constraint(o.sub(o.mul(d_, i_), ssum))
        for (ecol, scol, icol, ch) in ((EO0, SO0, IO0, 4), (EV0, SV0, IV0, 2)):
            e_, s_, i_ = L(ecol), L(scol), L(icol)
            lsum = None
            for k in range(N_LIMBS):
                t = L(CH_VAL[ch][k])
                lsum = t if lsum is None else o.add(lsum, t)
            c.constraint(o.mul(sss, o.sub(s_, lsum)))
            c.constraint(o.mul(o.sub(one, sss), s_))
            c.constraint(o.mul(e_, s_))
            c.constraint(o.sub(o.mul(s_, i_), o.sub(sss, o.mul(sss, e_))))
        # branch gates: P1 = sss*(1-E_VC)*E_CO, P2 = sss*(1-E_VC)*(1-E_CO)
        e_vc, e_co = L(E_VC), L(E_CO)
        c.constraint(
            o.sub(L(P1), o.mul(sss, o.mul(o.sub(one, e_vc), e_co)))
        )
        c.constraint(
            o.sub(L(P2), o.mul(sss, o.mul(o.sub(one, e_vc), o.sub(one, e_co))))
        )

        # -- JUMP / JUMPI
        sj, sji = sel[JUMP], sel[JUMPI]
        bind(sj, 1, 1, const(SEG_STACK), spm(1))
        for k in range(1, N_LIMBS):
            c.constraint(o.mul(sj, L(CH_VAL[1][k])))
        bind(sj, 2, 1, const(SEG_JUMPDEST), L(CH_VAL[1][0]))
        c.constraint(o.mul(sj, o.sub(L(CH_VAL[2][0]), one)))
        bind(sji, 1, 1, const(SEG_STACK), spm(1))
        bind(sji, 2, 1, const(SEG_STACK), spm(2))
        zsum2 = None
        for k in range(N_LIMBS):
            zsum2 = L(CH_VAL[2][k]) if zsum2 is None else o.add(zsum2, L(CH_VAL[2][k]))
        c.constraint(o.mul(sji, o.sub(zs, zsum2)))
        bind(jumpi_taken, 3, 1, const(SEG_JUMPDEST), L(CH_VAL[1][0]))
        c.constraint(o.mul(jumpi_taken, o.sub(L(CH_VAL[3][0]), one)))
        for k in range(1, N_LIMBS):
            c.constraint(o.mul(jumpi_taken, L(CH_VAL[1][k])))

        # -- LOG events: operands read from the stack, topics + data word
        # bound to per-log public inputs; >2 topics spill to a LOGX row
        lay_lw = lay.get("log_words", [])
        bind(flog, 1, 1, const(SEG_STACK), spm(1))  # offset
        bind(flog, 2, 1, const(SEG_STACK), spm(2))  # length
        for k in range(2, N_LIMBS):
            c.constraint(o.mul(flog, L(CH_VAL[1][k])))
        for k in range(1, N_LIMBS):
            c.constraint(o.mul(flog, L(CH_VAL[2][k])))
        dl_sum = None
        nt_sum = None
        for i in range(len(s.log_shapes)):
            t = o.mul(lsel[i], const(dl_of[i]))
            dl_sum = t if dl_sum is None else o.add(dl_sum, t)
            t2 = o.mul(lsel[i], const(nt_of[i]))
            nt_sum = t2 if nt_sum is None else o.add(nt_sum, t2)
        dl_sum = dl_sum if dl_sum is not None else zero
        nt_sum = nt_sum if nt_sum is not None else zero
        c.constraint(o.mul(flog, o.sub(L(CH_VAL[2][0]), dl_sum)))
        c.constraint(o.mul(flog, o.sub(nlin, nt_sum)))  # shape topic count
        t1gate = o.mul(flog, o.sub(one, nsel[0]))
        bind(t1gate, 3, 1, const(SEG_STACK), spm(3))
        t2gate = o.mul(flog, nsel_ge2)
        bind(t2gate, 4, 1, const(SEG_STACK), spm(4))
        bind(logx, 1, 1, const(SEG_STACK), spm(5))
        bind(logx_t4, 2, 1, const(SEG_STACK), spm(6))
        for i in range(len(s.log_shapes)):
            base_w = lay_lw[i]
            nt, dl = nt_of[i], dl_of[i]
            for k in range(N_LIMBS):
                if nt >= 1:
                    c.constraint(o.mul(o.mul(flog, lsel[i]), o.sub(
                        L(CH_VAL[3][k]), ctx.public_input(16 * base_w + k))))
                if nt >= 2:
                    c.constraint(o.mul(o.mul(flog, lsel[i]), o.sub(
                        L(CH_VAL[4][k]),
                        ctx.public_input(16 * (base_w + 1) + k))))
                if nt >= 3:
                    c.constraint(o.mul(o.mul(logx, lsel[i]), o.sub(
                        L(CH_VAL[1][k]),
                        ctx.public_input(16 * (base_w + 2) + k))))
                if nt >= 4:
                    c.constraint(o.mul(o.mul(logx, lsel[i]), o.sub(
                        L(CH_VAL[2][k]),
                        ctx.public_input(16 * (base_w + 3) + k))))
                # data word 0: big-endian composition of the packed bytes
                if dl > 0:
                    c.constraint(o.mul(o.mul(flog, lsel[i]), o.sub(
                        v_limb(k), ctx.public_input(16 * (base_w + nt) + k))))
                else:
                    c.constraint(o.mul(o.mul(flog, lsel[i]),
                                       ctx.public_input(16 * (base_w + nt) + k)))
        # LOGD rows: data word NSEL binds to its per-log PI word (the PI
        # combination is a scalar, so the gated constraint stays deg 3)
        dw_of = [(dl + 31) // 32 for dl in dl_of]
        for k in range(N_LIMBS):
            combo = None
            for i in range(len(s.log_shapes)):
                for w in range(1, dw_of[i]):
                    piv = ctx.public_input(16 * (lay_lw[i] + nt_of[i] + w) + k)
                    t = o.mul(o.mul(lsel[i], nsel[w]), piv)
                    combo = t if combo is None else o.add(combo, t)
            if combo is not None:
                c.constraint(o.mul(logd, o.sub(v_limb(k), combo)))
        # forbid LOGD word indices beyond a log's payload
        for i in range(len(s.log_shapes)):
            for w in range(max(dw_of[i], 1), 8):
                c.constraint(o.mul(logd, o.mul(lsel[i], nsel[w])))
        if not s.log_shapes:
            c.constraint(logd)

        # LOGX phase: follows exactly the LOG rows with >= 3 topics
        c.constraint_transition(
            o.mul(N(S_LOGX), o.sub(o.mul(flog, nsel_ge3), one))
        )
        c.constraint_transition(
            o.mul(o.mul(flog, nsel_ge3), o.sub(one, N(S_LOGX)))
        )
        # LOGD phase: enter after the log's last topic row when the
        # payload has more than one word; continue while words remain
        logd_enter = None
        for i in range(len(s.log_shapes)):
            if dw_of[i] < 2:
                continue
            head = logx if nt_of[i] >= 3 else flog
            t = o.mul(head, lsel[i])
            logd_enter = t if logd_enter is None else o.add(logd_enter, t)
        logd_enter = logd_enter if logd_enter is not None else zero
        logd_cont = None
        for i in range(len(s.log_shapes)):
            for w in range(1, dw_of[i] - 1):
                t = o.mul(logd, o.mul(lsel[i], nsel[w]))
                logd_cont = t if logd_cont is None else o.add(logd_cont, t)
        logd_cont = logd_cont if logd_cont is not None else zero
        c.constraint_transition(
            o.sub(N(S_LOGD), o.add(logd_enter, logd_cont))
        )
        # first data word is 1; consecutive LOGD rows increment it
        c.constraint_transition(o.mul(logd_enter, o.sub(N(NSEL[1]), one)))
        for w in range(1, 7):
            c.constraint_transition(
                o.mul(o.mul(logd, N(S_LOGD)), o.sub(N(NSEL[w + 1]), nsel[w]))
            )
        # the staging base offset rides R0 across the whole sequence
        logd_multi = None
        for i in range(len(s.log_shapes)):
            if dw_of[i] >= 2:
                t = o.mul(flog, lsel[i])
                logd_multi = t if logd_multi is None else o.add(logd_multi, t)
        if logd_multi is not None:
            c.constraint(o.mul(logd_multi, o.sub(L(R0), ofs32)))
            c.constraint_transition(o.mul(N(S_LOGX), o.sub(N(R0), L(R0))))
            c.constraint_transition(o.mul(N(S_LOGD), o.sub(N(R0), L(R0))))

        # log counter + index selector: a log completes at its LAST row
        c.constraint_first_row(L(LOGIDX))
        completion = None
        for i in range(len(s.log_shapes)):
            if dw_of[i] >= 2:
                t = o.mul(logd, o.mul(lsel[i], nsel[dw_of[i] - 1]))
            elif nt_of[i] >= 3:
                t = o.mul(logx, lsel[i])
            else:
                t = o.mul(flog, lsel[i])
            completion = t if completion is None else o.add(completion, t)
        completion = completion if completion is not None else zero
        c.constraint_transition(
            o.sub(N(LOGIDX), o.add(L(LOGIDX), completion))
        )
        lsum = None
        lidx = None
        for i in range(len(s.log_shapes)):
            lsum = lsel[i] if lsum is None else o.add(lsum, lsel[i])
            t = o.mul(const(i), lsel[i])
            lidx = t if lidx is None else o.add(lidx, t)
        lsum = lsum if lsum is not None else zero
        lidx = lidx if lidx is not None else zero
        log_rows_all = o.add(o.add(flog, logx), logd)
        c.constraint(o.sub(lsum, log_rows_all))
        c.constraint(o.mul(log_rows_all, o.sub(lidx, L(LOGIDX))))
        # unused LSEL slots (beyond the shape's log count) stay zero
        for i in range(len(s.log_shapes), MAX_LOGS):
            c.constraint(L(LSEL[i]))

        # -- halting + success; RETURN/REVERT pop (offset, length) for
        # the gas circuit's memory expansion (data itself stays unexposed)
        retrev = o.add(sel[RETURN], sel[REVERT])
        bind(retrev, 1, 1, const(SEG_STACK), spm(1))  # offset
        bind(retrev, 2, 1, const(SEG_STACK), spm(2))  # length
        zsum_len = None
        for k in range(N_LIMBS):
            t = L(CH_VAL[2][k])
            zsum_len = t if zsum_len is None else o.add(zsum_len, t)
        c.constraint(o.mul(retrev, o.sub(zs, zsum_len)))  # Z = (len == 0)
        # nonzero length: offset/length fit in two limbs (2MB envelope)
        retrev_touch = o.mul(retrev, o.sub(one, z))
        for k in range(2, N_LIMBS):
            c.constraint(o.mul(retrev_touch, L(CH_VAL[1][k])))
            c.constraint(o.mul(retrev_touch, L(CH_VAL[2][k])))
        halt_fired = acc([sel[STOP], sel[RETURN], sel[REVERT]])
        c.constraint_transition(o.sub(N(HALTED), o.add(halted, halt_fired)))
        pi_success = ctx.public_input(16 * lay["success"])
        c.constraint(
            o.mul(o.add(sel[STOP], sel[RETURN]), o.sub(pi_success, one))
        )
        c.constraint(o.mul(sel[REVERT], pi_success))

        # -- FINAL rows
        f_fin = F(self.F_FINAL)
        c.constraint(o.mul(f_fin, o.sub(one, halted)))
        bind(f_fin, 1, 1, const(SEG_SVALS), F(self.F_A1))
        for i in range(s.n_skeys):
            bind_word_pi(F(self.F_SVPOSTSEL[i]), 1, lay["storage"] + 4 * i + 3)

        # -- PC / SP transitions
        pc_adv = None
        for op in SIMPLE_OPS:
            a = _PC_ADV[op]
            if a:
                t = o.mul(const(a), sel[op])
                pc_adv = t if pc_adv is None else o.add(pc_adv, t)
        pc_adv = o.add(pc_adv, o.mul(fpush, o.add(one, nlin)))
        pc_adv = o.add(pc_adv, o.add(fdup, fswap))
        # a LOG sequence advances pc on its completion row (LOG, LOGX, or
        # the final LOGD data word — same expression as LOGIDX); copies
        # advance on the final CPW row (or the op row for len == 0)
        pc_adv = o.add(pc_adv, completion)
        # calls complete on the last CLO row (no copy-back), the final
        # CPW row (copy-back), or the last CLI row (zero-output calls)
        pc_adv = o.add(pc_adv, o.add(clo_last_nocb, cli_last_noout))
        pc_adv = o.add(pc_adv, o.add(L(TERM), o.mul(sel[EXP], z)))
        pc_adv = o.add(pc_adv, o.add(kdig, o.add(slx, ssx)))
        pc_adv = o.add(
            pc_adv,
            o.add(o.mul(copyop, z), o.mul(cpw, o.sub(one, L(FULLC)))),
        )
        pc_adv = o.add(pc_adv, o.mul(sj, o.sub(L(CH_VAL[1][0]), pc)))
        pc_adv = o.add(
            pc_adv,
            o.mul(jumpi_taken, o.sub(o.sub(L(CH_VAL[1][0]), pc), one)),
        )
        c.constraint_transition(o.sub(N(PC), o.add(pc, pc_adv)))
        sp_d = None
        for op in SIMPLE_OPS:
            d = _SP_DELTA[op]
            if d:
                t = o.mul(const(d % ar.fh.P), sel[op])
                sp_d = t if sp_d is None else o.add(sp_d, t)
        sp_d = o.add(sp_d, o.add(fpush, fdup))
        sp_d = o.add(sp_d, kdig)
        sp_d = o.sub(sp_d, cla)
        sp_d = o.add(sp_d, o.add(L(TERM), o.mul(sel[EXP], z)))
        # LOG0-2 drop on the LOG row; LOG3/4 drop on the LOGX row
        log_drop = o.mul(o.mul(flog, nsel_le2), o.add(const(2), nlin))
        logx_drop = None
        for i in range(len(s.log_shapes)):
            if nt_of[i] >= 3:
                t = o.mul(o.mul(logx, lsel[i]), const(2 + nt_of[i]))
                logx_drop = t if logx_drop is None else o.add(logx_drop, t)
        sp_d = o.sub(sp_d, log_drop)
        if logx_drop is not None:
            sp_d = o.sub(sp_d, logx_drop)
        c.constraint_transition(o.sub(N(SP), o.add(sp, sp_d)))

        # ===================== in-circuit gas =============================
        # (consensus frame gas per evm/gas.py; GAS/REFUND run as columns
        # and bind to public inputs on the last row)
        grow, tch = L(GROW), L(TCH)
        nw, nw2, mw, cq = L(NW), L(NW2), L(MW), L(CQ)
        c.constraint_first_row(L(GAS))
        c.constraint_first_row(L(REFUND))
        c.constraint_first_row(mw)
        c.constraint_first_row(cq)

        # -- memory touch rows: TCH = ops that touch SEG_MAIN, length > 0
        cla_touch = None
        for i in range(n_calls):
            if call_rlen[i] > 0:
                t = o.mul(cla, csel[i])
                cla_touch = t if cla_touch is None else o.add(cla_touch, t)
        cla_touch = cla_touch if cla_touch is not None else zero
        tch_def = acc(
            [sml, sms, m8],
            o.add(
                o.add(log_data, o.add(callop, cla_touch)),
                o.mul(o.add(o.add(retrev, skec), copyop), o.sub(one, z)),
            ),
        )
        c.constraint(o.sub(tch, tch_def))
        c.constraint(o.mul(grow, o.sub(one, tch)))  # GROW only on touches
        # NW bounded < 2^16 (byte-checked decomposition)
        c.constraint(
            o.mul(tch, o.sub(nw, o.add(L(NB0), o.mul(const(256), L(NB1)))))
        )
        # 32*NW = offset + length + pad, pad < 32
        pad_lin = None
        for b in range(5):
            t = o.mul(const(1 << b), L(PB[b]))
            pad_lin = t if pad_lin is None else o.add(pad_lin, t)
        ofs_touch = o.add(
            L(CH_VAL[1][0]), o.mul(const(1 << 16), L(CH_VAL[1][1]))
        )
        len16 = o.add(L(CH_VAL[2][0]), o.mul(const(1 << 16), L(CH_VAL[2][1])))
        # memory expansion covers the FULL log payload (the pack length
        # `log_len` is only the first staged window)
        log_full = None
        for i in range(len(s.log_shapes)):
            if dl_of[i] > 0:
                t = o.mul(o.mul(flog, lsel[i]), const(dl_of[i]))
                log_full = t if log_full is None else o.add(log_full, t)
        len_expr = o.add(
            o.add(
                o.add(o.mul(acc([sml, sms]), const(32)), m8),
                o.add(
                    o.mul(skec, L(CH_VAL[2][0])),
                    o.mul(copyop, L(CH_VAL[3][0])),
                ),
            ),
            o.add(
                log_full if log_full is not None else zero,
                o.mul(o.add(retrev, o.add(callop, cla)), len16),
            ),
        )
        c.constraint(
            o.mul(
                tch,
                o.sub(
                    o.mul(const(32), nw),
                    o.add(o.add(ofs_touch, len_expr), pad_lin),
                ),
            )
        )
        # GROW correctness: byte-checked |NW - MW| witness
        rcd = o.add(L(RB0), o.mul(const(256), L(RB1)))
        cmp_expr = o.add(
            o.mul(grow, o.sub(o.sub(nw, mw), one)),
            o.mul(o.sub(one, grow), o.sub(mw, nw)),
        )
        c.constraint(o.mul(tch, o.sub(rcd, cmp_expr)))
        # quadratic cost witness: NW2 = NW^2; on growth the next row's
        # CQ becomes C(NW) = 3*NW + floor(NW^2/512) with remainder < 512
        c.constraint(o.mul(tch, o.sub(nw2, o.mul(nw, nw))))
        rq = o.add(L(RQB), o.mul(const(256), L(RQBIT)))
        c.constraint_transition(
            o.mul(
                grow,
                o.sub(
                    o.add(nw2, o.mul(const(1536), nw)),
                    o.add(o.mul(const(512), N(CQ)), rq),
                ),
            )
        )
        c.constraint_transition(o.mul(o.sub(one, grow), o.sub(N(CQ), cq)))
        c.constraint_transition(
            o.sub(N(MW), o.add(mw, o.mul(grow, o.sub(nw, mw))))
        )

        # -- GAS transition: static costs + dynamic parts
        delta = None

        def dadd(term):
            nonlocal delta
            delta = term if delta is None else o.add(delta, term)

        for op in SIMPLE_OPS:
            g = STATIC_GAS.get(op, 0)
            if g:
                dadd(o.mul(const(g), sel[op]))
        dadd(o.mul(const(3), o.add(fdup, fswap)))
        dadd(o.sub(o.mul(const(3), fpush), o.mul(fpush, nsel[0])))  # PUSH0=2
        # keccak: 30 + 6*ceil(len/32), all charged on the setup row
        dadd(o.mul(skec, o.add(const(30), o.mul(const(6), L(KWORDS)))))
        # copies: 3/word on top of the static 3
        dadd(o.mul(copyop, o.mul(const(3), L(KWORDS))))
        log_gas = None
        for i in range(len(s.log_shapes)):
            gl = 375 + 375 * nt_of[i] + 8 * dl_of[i]
            t = o.mul(o.mul(flog, lsel[i]), const(gl))
            log_gas = t if log_gas is None else o.add(log_gas, t)
        if log_gas is not None:
            dadd(log_gas)
        # EIP-2929 storage: the warm flag W is read on the NEXT row
        w_sl = N(CH_VAL[1][0])
        dadd(o.mul(ssl, o.sub(const(2100), o.mul(const(2000), w_sl))))
        w_ss = N(CH_VAL[3][0])
        dadd(o.mul(o.mul(sss, const(2100)), o.sub(one, w_ss)))
        # EIP-2200 net metering: 100 no-op/dirty, 20000 set, 2900 reset
        dadd(o.mul(const(100), o.mul(sss, L(E_VC))))
        dadd(o.mul(L(P1), o.add(const(2900), o.mul(const(17100), L(EO0)))))
        dadd(o.mul(const(100), L(P2)))
        # EXP: 50 per exponent byte on the TERM row (10 static on setup)
        dadd(o.mul(L(TERM), o.mul(const(50), L(KWORDS))))
        # inner calls, charged on the op row (memory expansion rides the
        # generic grow terms): static-cost precompiles use the shape
        # constant 100 + cost; dynamic charges (modexp/blake2f, and
        # contract frames' access + inner gas) ride the call's gas
        # directory PI word (4 limbs, like the last-row GAS binding)
        for i in range(n_calls):
            gate = o.mul(callop, csel[i])
            if call_dirw[i]:
                gw = lay_cw[i] + (1 if call_is_frame[i] else 0)
                comp = None
                for k in range(4):
                    t = o.mul(
                        const(1 << (16 * k)), ctx.public_input(16 * gw + k)
                    )
                    comp = t if comp is None else o.add(comp, t)
                dadd(o.mul(gate, comp))
            else:
                wcount_i = (call_alen[i] + 31) // 32
                pc_cost = {1: 3000, 2: 60 + 12 * wcount_i,
                           3: 600 + 120 * wcount_i, 4: 15 + 3 * wcount_i,
                           6: 150, 7: 6000}[call_tgt[i]]
                dadd(o.mul(gate, const(100 + pc_cost)))
        # environment queries: per-query gas rides the qgas PI word
        for i in range(s.n_queries):
            dadd(
                o.mul(
                    L(QSEL[i]),
                    ctx.public_input(16 * (lay["queries"] + 4 * i + 3)),
                )
            )
        # memory expansion: C(NW) - C(MW) on growth
        dadd(o.mul(grow, o.sub(N(CQ), cq)))
        c.constraint_transition(o.sub(N(GAS), o.add(L(GAS), delta)))

        # -- REFUND transition (EIP-3529)
        neg4800 = const(ar.fh.P - 4800)
        not_eo0 = o.sub(one, L(EO0))
        rdelta = o.mul(const(4800), o.mul(L(P1), o.mul(not_eo0, L(EV0))))
        rdelta = o.add(
            rdelta, o.mul(neg4800, o.mul(L(P2), o.mul(not_eo0, z)))
        )
        rdelta = o.add(
            rdelta, o.mul(const(4800), o.mul(L(P2), o.mul(not_eo0, L(EV0))))
        )
        rdelta = o.add(
            rdelta, o.mul(const(19900), o.mul(L(P2), o.mul(L(E_VO), L(EO0))))
        )
        rdelta = o.add(
            rdelta, o.mul(const(2800), o.mul(L(P2), o.mul(L(E_VO), not_eo0)))
        )
        # inner contract frames contribute their own (mod-p) refund via
        # the call's refund directory PI word, charged on the op row
        for i in range(n_calls):
            if not call_is_frame[i]:
                continue
            rw = lay_cw[i] + 2
            comp = None
            for k in range(4):
                t = o.mul(const(1 << (16 * k)), ctx.public_input(16 * rw + k))
                comp = t if comp is None else o.add(comp, t)
            rdelta = o.add(rdelta, o.mul(o.mul(callop, csel[i]), comp))
        c.constraint_transition(o.sub(N(REFUND), o.add(L(REFUND), rdelta)))

        # -- bind GAS/REFUND to public inputs on the last row (values fit
        # four 16-bit limbs; the verifier recomputes the full words)
        f_last = F(self.F_LAST)
        for col, word in ((GAS, lay["gas"]), (REFUND, lay["refund"])):
            comp = None
            for k in range(4):
                t = o.mul(const(1 << (16 * k)), ctx.public_input(16 * word + k))
                comp = t if comp is None else o.add(comp, t)
            c.constraint(o.mul(f_last, o.sub(L(col), comp)))

"""Contract-call transactions: the EVM machine as the tx kernel.

Counterpart: ethproof_tpu/evm/contract.py:1 (a copy, with `device` and
`phase_times` threaded through the provers and verifiers).

Reference equivalent: evm_arithmetization's kernel executing an
arbitrary message call — `generate_txn_proof` on a witness whose tx
targets a contract (ops/src/lib.rs:52; SURVEY.md §2b
evm_arithmetization row). Here the call frame runs on the EVM machine
STARK (tables/evm.py): the machine proves the execution itself —
fetch/decode/execute over code bound to the account's code_hash,
storage reads/writes journaled against public inputs — while this
module supplies the transaction plumbing:

  - decode the signed tx, recover the sender, pull the callee's code
    from `contract_code` by the account's code_hash;
  - DISCOVER the touched storage slots by re-running the machine's
    host interpreter, growing `storage_pre` on UnknownStorageKey
    (values read from the callee's witness storage trie);
  - prove the 7-table machine proof;
  - host-side trie binding (documented fallback, like the transfer
    kernel's pre-binding era): re-derive the post state root from the
    witness tries + the machine's public journal (sender nonce/balance,
    miner fee, callee balance + storage-root update) and compare to
    `trie_roots_after.state_root`.

Envelope (Unsupported otherwise): type-0/1/2 txs (legacy, EIP-2930,
EIP-1559 — fee split per evm/tx.py: sender pays the effective gas
price, the miner receives the tip, the base fee is burned), direct
calls to an existing contract (no creation, no inner CALLs — the
machine is single-context), successful or reverting frames (a reverted
frame leaves storage untouched), machine opcode/keccak envelope per
tables/evm.py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import resolve_device
from ..fri.config import StarkConfig
from ..hash.keccak import keccak256
from ..stark.multi import MultiProof
from ..tables import all as A
from ..tables import evm as E
from ..trie.nibbles import Nibbles
from ..witness.mpt import decode_account, encode_account
from ..witness.types import GenerationInputs
from .kasm import le_word
from .transfer import _acct_key, _empty_account
from .tx import decode_tx

EMPTY_CODE_HASH = keccak256(b"")

# highest precompile address in the target fork (Shanghai: 0x09 blake2f;
# Cancun would raise this to 0x0a) — drives the EIP-2929 pre-warm set
N_PRECOMPILES_SHANGHAI = 9


def _slot_key(slot: int) -> Nibbles:
    return Nibbles.from_bytes(keccak256(slot.to_bytes(32, "big")))


def _storage_trie(gi: GenerationInputs, hashed_addr: bytes):
    for h, trie in gi.tries.storage_tries:
        if h == hashed_addr:
            return trie
    return None


def _decode_slot_value(raw: Optional[bytes]) -> int:
    if raw is None:
        return 0
    # storage values are RLP(minimal big-endian int), <= 32 bytes
    if len(raw) == 1 and raw[0] < 0x80:
        return raw[0]
    assert raw and 0x80 <= raw[0] < 0xB8, "storage slot RLP must be a short string"
    return int.from_bytes(raw[1: 1 + raw[0] - 0x80], "big")


def _encode_slot_value(v: int) -> bytes:
    if v == 0:
        return b"\x80"
    b = v.to_bytes((v.bit_length() + 7) // 8, "big")
    if len(b) == 1 and b[0] < 0x80:
        return b
    return bytes([0x80 + len(b)]) + b


@dataclass
class ContractCallProof:
    """Per-tx proof for a contract call: the machine multi-proof plus
    the witness-binding data the (host) verifier re-derives.

    In-circuit binding (evm/cbinding.py): `binding_multi` is a second
    kasm multi-proof whose kernel proves the storage-slot chain and the
    (sender, callee, miner) account updates against the state-root PI
    words; `cb_pi`/`cb_n_slots`/`cb_kshape` are its statement. When
    None, the binding is host-checked only (documented fallback tier)."""

    multi: Optional[MultiProof]
    shape: E.EvmShape
    machine_pi: List[int]
    gen_inputs: GenerationInputs
    sender: bytes
    to: bytes
    miner: bytes
    gas_used: int
    # succinct mode: the root machine proof subsumes `multi`
    root_proof: Optional[object] = None  # recursion.wrap.MachineProof
    # in-circuit state binding (second multi-proof; None = host tier)
    binding_multi: Optional[MultiProof] = None
    cb_pi: Optional[List[int]] = None
    cb_n_slots: int = 0
    cb_kshape: Optional[object] = None  # binding.KernelShape
    # inner call frames (tx-global completion order): each one a full
    # machine proof of the callee's own EvmShape; the outer frame's
    # per-call PI directory ([addr, gas, refund] + input/output words)
    # is linked to these statements by the verifier's witness replay
    inner_frames: List["InnerFrameProof"] = None

    @property
    def pi_words(self) -> List[int]:
        """Statement words (tx_statement_digest input) — the machine PI."""
        return self.machine_pi


@dataclass
class InnerFrameProof:
    """Machine proof of one inner call frame (callee's own shape)."""

    address: bytes
    shape: E.EvmShape
    machine_pi: List[int]
    multi: Optional[MultiProof] = None
    # succinct mode: a root machine proof subsumes `multi`
    root_proof: Optional[object] = None  # recursion.wrap.MachineProof

DEFAULT_LOG_ROWS = 10

# inner-frame envelope bounds (documented; Unsupported beyond them)
MAX_FRAME_DEPTH = 4


@dataclass
class FrameRun:
    """One resolved inner call frame (host execution artifacts)."""

    address: bytes
    shape: E.EvmShape
    inputs: E.EvmInputs
    result: "E.EvmResult"


def _slot_warm_pre(tx, addr_b: bytes) -> Tuple[int, ...]:
    """EIP-2929 access-list pre-warmed storage keys for one address."""
    return tuple(
        int.from_bytes(k, "big")
        for a, keys in tx.access_list
        if a == addr_b
        for k in keys
    )


def _account_code(gi: GenerationInputs, addr_b: bytes):
    """(code bytes | None) for an address: None = no code (EOA/empty)."""
    raw = gi.tries.state_trie.get(_acct_key(addr_b))
    if raw is None:
        return None
    ch = decode_account(raw)["code_hash"]
    if ch == EMPTY_CODE_HASH:
        return None
    code = gi.contract_code.get(ch)
    assert code is not None, "callee code missing from contract_code"
    return code


def _discover_frame(
    gi, tx, env_base, code, calldata, caller, callvalue, addr_b,
    gas_budget, warm_addrs, log_rows, seen, frames_out, depth, log_sink,
):
    """Converged (shape, inputs, result) for ONE frame, recursively
    resolving its inner calls. Appends sub-frames in tx-global
    completion order to `frames_out` exactly once (per-attempt local
    lists are discarded on discovery re-runs)."""
    strie = _storage_trie(gi, keccak256(addr_b))

    def slot_pre(slot: int) -> int:
        if strie is None:
            return 0
        return _decode_slot_value(strie.get(_slot_key(slot)))

    storage_pre: Dict[int, int] = {}
    log_shapes: list = []
    call_shapes: list = []
    n_queries = 0
    while True:
        attempt_frames: list = []
        attempt_logs: list = []
        # one frame per address per tx (a second frame of the same
        # address would journal against stale pre-state); fresh copy per
        # attempt so discovery re-runs start clean
        attempt_seen = set(seen)

        def resolve(a_int, value, data, fwd_gas, warm):
            callee_b = a_int.to_bytes(20, "big")
            inner_code = _account_code(gi, callee_b)
            if inner_code is None:
                # calls to code-less accounts succeed with empty
                # returndata; no frame proof is needed (value == 0)
                return (1, b"", 0, 0, warm)
            if depth + 1 >= MAX_FRAME_DEPTH:
                raise E.Unsupported("call frame depth beyond the envelope")
            if callee_b in attempt_seen:
                raise E.Unsupported(
                    "repeated frame address (one frame per address per tx)"
                )
            attempt_seen.add(callee_b)
            fshape, finputs, fres = _discover_frame(
                gi, tx, env_base, inner_code, data,
                int.from_bytes(addr_b, "big"), value, callee_b,
                fwd_gas, warm, log_rows, attempt_seen, attempt_frames,
                depth + 1, attempt_logs,
            )
            attempt_frames.append(FrameRun(callee_b, fshape, finputs, fres))
            # sub-frames of the callee also consumed their addresses
            attempt_seen.update(fr.address for fr in attempt_frames)
            warm_post = tuple(
                sorted(set(warm) | set(fres.warm_addrs_post))
            )
            return (
                fres.success, fres.return_data, fres.gas_used,
                fres.gas_refund, warm_post,
            )

        shape = E.EvmShape(
            code_len=len(code),
            calldata_len=len(calldata),
            n_skeys=len(storage_pre),
            log_rows=log_rows,
            n_queries=n_queries,
            call_shapes=tuple(call_shapes),
            log_shapes=tuple(log_shapes),
        )
        inputs = E.EvmInputs(
            code, calldata, caller, callvalue, dict(storage_pre),
            warm_pre=_slot_warm_pre(tx, addr_b),
            address=int.from_bytes(addr_b, "big"),
            origin=env_base["origin"],
            gasprice=env_base["gasprice"],
            coinbase=env_base["coinbase"],
            timestamp=env_base["timestamp"],
            number=env_base["number"],
            gaslimit=env_base["gaslimit"],
            chainid=env_base["chainid"],
            basefee=env_base["basefee"],
            gas_budget=gas_budget,
            query_resolver=env_base["query_resolver"],
            warm_addrs=warm_addrs,
            frame_resolver=resolve,
            log_sink=attempt_logs,
        )
        try:
            res = E.execute_evm(shape, inputs)
        except E.UnknownLogShape as miss:
            assert miss.index == len(log_shapes)
            log_shapes.append((miss.n_topics, miss.data_len))
            continue
        except E.UnknownQueryCount as miss:
            assert miss.count > n_queries
            n_queries = miss.count
            continue
        except E.UnknownCallShape as miss:
            if miss.index < len(call_shapes):
                call_shapes[miss.index] = miss.entry
            else:
                assert miss.index == len(call_shapes)
                call_shapes.append(miss.entry)
            continue
        except E.UnknownStorageKey as miss:
            storage_pre[miss.key] = slot_pre(miss.key)
            continue
        frames_out.extend(attempt_frames)
        if log_sink is not None:
            log_sink.extend(attempt_logs)
        return shape, inputs, res


def machine_inputs_for_tx(
    gi: GenerationInputs,
    log_rows: int = 10,
    frames_out: Optional[list] = None,
    log_sink: Optional[list] = None,
) -> Tuple[E.EvmShape, E.EvmInputs, "E.EvmResult"]:
    """Decode the tx, discover touched slots (outer frame AND inner
    call frames, recursively), run the machine host interpreter.
    -> (shape, inputs, result) of the OUTER frame; inner frames are
    appended to `frames_out` (FrameRun, completion order) and the
    tx-global log order to `log_sink` [(address, topics, data)]."""
    tx = decode_tx(gi.signed_txn)
    assert tx.chain_id in (None, gi.block_metadata.block_chain_id), (
        "EIP-155 chain id mismatch"
    )
    assert len(tx.to) == 20, "contract creation unsupported"
    sender = tx.sender()
    code = _account_code(gi, tx.to)
    if code is None:
        raise E.Unsupported("callee has no code (plain transfer)")
    caller = int.from_bytes(sender, "big")
    env = tx_env_words(gi, tx, caller)
    frames = frames_out if frames_out is not None else []
    logs = log_sink if log_sink is not None else []
    frames.clear()
    logs.clear()
    seen = {tx.to}
    shape, inputs, res = _discover_frame(
        gi, tx, env, code, tx.data, caller, tx.value, tx.to,
        env["gas_budget"], tuple(env["warm_addrs"]), log_rows,
        seen, frames, 0, logs,
    )
    return shape, inputs, res


def tx_env_words(gi: GenerationInputs, tx, caller: int) -> Dict[str, int]:
    """The machine's environment-opcode words, derived from the tx and
    the block metadata (single-frame: origin == caller), plus the gas
    budget, EIP-2929 pre-warmed addresses, and the environment-query
    resolver (BALANCE/EXTCODE*/BLOCKHASH answers from the witness)."""
    from .gas import intrinsic_gas

    bm = gi.block_metadata
    env = {
        "address": int.from_bytes(tx.to, "big"),
        "origin": caller,
        "gasprice": tx.effective_gas_price(bm.block_base_fee),
        "coinbase": int.from_bytes(bm.block_beneficiary, "big"),
        "timestamp": bm.block_timestamp,
        "number": bm.block_number,
        "gaslimit": bm.block_gaslimit,
        "chainid": bm.block_chain_id,
        "basefee": bm.block_base_fee,
        "gas_budget": tx.gas_limit - intrinsic_gas(tx),
    }
    # EIP-2929 pre-warm: origin, target, coinbase (EIP-3651), the
    # precompile range, and access-list addresses. The range is the
    # SHANGHAI set (0x01..0x09); a Cancun+ target fork must extend it
    # (0x0a point evaluation) or account-access queries against the new
    # precompiles charge cold 2600 instead of warm 100.
    warm = {caller, env["address"], env["coinbase"]}
    warm.update(range(1, N_PRECOMPILES_SHANGHAI + 1))
    warm.update(int.from_bytes(a, "big") for a, _k in tx.access_list)
    env["warm_addrs"] = tuple(sorted(warm))
    env["query_resolver"] = _witness_query_resolver(gi, tx, caller)
    return env


def _witness_query_resolver(gi: GenerationInputs, tx, caller: int):
    """Environment-query answers re-derived from the witness state
    (the same function serves the prover's trace generation and the
    verifier's PI re-derivation — both sides replay it)."""
    from ..tables.evm import (
        BALANCE, BLOCKHASH, EXTCODEHASH, EXTCODESIZE, SELFBALANCE,
    )

    bm = gi.block_metadata
    to_int = int.from_bytes(tx.to, "big")
    base_fee = bm.block_base_fee
    prepaid = tx.gas_limit * tx.effective_gas_price(base_fee)

    def balance_of(addr: int) -> int:
        raw = gi.tries.state_trie.get(
            _acct_key(addr.to_bytes(20, "big"))
        )
        bal = decode_account(raw)["balance"] if raw is not None else 0
        # mid-frame adjustments: the sender prepaid gas and sent value,
        # the callee was credited value (single-frame: no other moves)
        if addr == caller:
            bal -= prepaid + tx.value
        if addr == to_int:
            bal += tx.value
        return bal

    def resolve(op: int, arg: int) -> int:
        if op in (BALANCE, SELFBALANCE):
            return balance_of(arg)
        if op in (EXTCODESIZE, EXTCODEHASH):
            raw = gi.tries.state_trie.get(
                _acct_key(arg.to_bytes(20, "big"))
            )
            if raw is None:
                return 0
            ch = decode_account(raw)["code_hash"]
            if op == EXTCODEHASH:
                return int.from_bytes(ch, "big")
            if ch == EMPTY_CODE_HASH:
                return 0
            code = gi.contract_code.get(ch)
            assert code is not None, "EXTCODESIZE target code not in witness"
            return len(code)
        if op == BLOCKHASH:
            cur = bm.block_number
            n_prev = len(gi.block_hashes.prev_hashes)
            if cur - n_prev <= arg < cur:
                h = gi.block_hashes.prev_hashes[arg - (cur - n_prev)]
                return int.from_bytes(h, "big")
            return 0
        raise AssertionError(f"unexpected query opcode {op:#x}")

    return resolve


def consensus_gas_used(gi: GenerationInputs, res=None) -> int:
    """Re-derive the tx's consensus gas from the witness alone: intrinsic
    (EIP-2028/2930) + the machine frame's metered execution gas, minus
    the EIP-3529-capped refund. Matches gas_used_after - gas_used_before
    on a consensus-valid witness."""
    from .gas import intrinsic_gas, tx_gas_used

    tx = decode_tx(gi.signed_txn)
    if res is None:
        _, _, res = machine_inputs_for_tx(gi)
    return tx_gas_used(
        intrinsic_gas(tx), res.gas_used, res.gas_refund, res.success
    )


def prove_contract_call(
    gi: GenerationInputs,
    config: StarkConfig,
    sizes: Optional[A.TableSizes] = None,
    log_rows: int = 10,
    binding: object = "auto",
    binding_sizes: Optional[A.TableSizes] = None,
    device=None,
    phase_times: Optional[Dict[str, Dict[str, Dict[str, float]]]] = None,
) -> ContractCallProof:
    """Prove one contract call on `device` (None: the CUDA card).

    binding: "auto" (in-circuit state binding when the witness fits
    the envelope; silent host-checked fallback otherwise), None
    (host-checked only), a binding.KernelShape or "require" (in-circuit
    required — Unsupported/CircuitSizeError propagate).

    `phase_times`, when given, receives "host" (seconds of discovery with
    `execute_evm`, the binding witness and the binding kernel's
    assembly), "machine" and "binding" (each multi-proof's
    `prove_all_tables`-style per-table phases) and "frames" (a list, one
    entry per inner frame)."""
    resolve_device(device)
    host: Dict[str, float] = {}
    t0 = time.perf_counter()
    frames: List[FrameRun] = []
    shape, inputs, res = machine_inputs_for_tx(gi, log_rows, frames_out=frames)
    host["discover_execute"] = time.perf_counter() - t0
    tx = decode_tx(gi.signed_txn)
    sender = tx.sender()
    miner = gi.block_metadata.block_beneficiary
    gas_used = gi.gas_used_after - gi.gas_used_before
    assert gas_used == consensus_gas_used(gi, res), (
        "witness gas_used diverges from consensus gas accounting"
    )

    def fit_sizes(shp, rs):
        counts = A.evm_table_counts(shp, rs)
        return A.TableSizes(
            cpu=shp.log_rows,
            arithmetic=16,
            logic=max(counts["logic"] - 1, 1).bit_length(),
            bytepacking=max(9, (counts["bytepacking"] - 1).bit_length()),
            memory=max(13, (counts["memory"] - 1).bit_length()),
            keccak=max(5, (counts["keccak"] - 1).bit_length()),
            keccak_sponge=max(8, (counts["keccak_sponge"] - 1).bit_length()),
        )

    frame_sizes = sizes
    if sizes is None:
        sizes = fit_sizes(shape, res)
    machine = E.EvmStark(shape)
    times = {} if phase_times is not None else None
    frame_times = [] if phase_times is not None else None
    proof = A.prove_evm_tables(machine, res, sizes, config, device,
                               _sub(times, "machine"))
    inner = []
    for fr in frames:
        fsz = frame_sizes or fit_sizes(fr.shape, fr.result)
        fmachine = E.EvmStark(fr.shape)
        ftimes = {} if frame_times is not None else None
        fproof = A.prove_evm_tables(fmachine, fr.result, fsz, config, device, ftimes)
        if frame_times is not None:
            frame_times.append(ftimes)
        inner.append(
            InnerFrameProof(
                address=fr.address,
                shape=fr.shape,
                machine_pi=list(fr.result.pi_words),
                multi=fproof,
            )
        )
    cb_multi = cb_pi = cb_kshape = None
    cb_n_slots = 0
    if binding is not None:
        cb_multi, cb_pi, cb_n_slots, cb_kshape = _prove_binding(
            gi, res.pi_words, shape, sender, tx.to, miner, gas_used,
            config, binding, binding_sizes, device, host, _sub(times, "binding"),
        )
    if phase_times is not None:
        phase_times.update(times, host=host, frames=frame_times)
    ccp = ContractCallProof(
        multi=proof,
        shape=shape,
        machine_pi=list(res.pi_words),
        gen_inputs=gi,
        sender=sender,
        to=tx.to,
        miner=miner,
        gas_used=gas_used,
        binding_multi=cb_multi,
        cb_pi=cb_pi,
        cb_n_slots=cb_n_slots,
        cb_kshape=cb_kshape,
        inner_frames=inner,
    )
    assert check_contract_binding(ccp), "witness binding failed"
    return ccp


def _sub(times, key):
    """times[key] as a fresh dict (None when not timing)."""
    if times is None:
        return None
    return times.setdefault(key, {})


def _binding_table_sizes(counts) -> A.TableSizes:
    """Fit the binding kernel's own multi-proof sizes (floors match the
    transfer binding's slow-tier shapes: 2^16 arithmetic range table for
    digest comparisons)."""

    def lg(n, floor):
        return max(floor, (max(n, 1) - 1).bit_length())

    return A.TableSizes(
        cpu=lg(counts["cpu"], 11),
        arithmetic=16,
        logic=lg(counts["logic"], 4),
        bytepacking=9,
        memory=lg(counts["memory"], 13),
        keccak=lg(counts["keccak"], 5),
        keccak_sponge=lg(counts["keccak_sponge"], 8),
    )


def _prove_binding(
    gi, machine_pi, mshape, sender, to, miner, gas_used, config,
    binding, binding_sizes, device=None, host=None, phase_times=None,
):
    """Build + prove the in-circuit state-binding proof (evm/cbinding.py);
    returns (None, None, 0, None) on a permitted fallback. `host` receives
    the seconds of the binding witness and of the kernel's assembly."""
    from ..tables.all import CircuitSizeError, kernel_counts, prove_all_tables
    from ..tables.cpu import CpuStark
    from . import cbinding as CB
    from .binding import PRODUCTION_SHAPE, KernelShape
    from .binding import Unsupported as BUnsupported

    if isinstance(binding, KernelShape):
        kshape, required = binding, True
    elif binding == "require":
        kshape, required = PRODUCTION_SHAPE, True
    else:
        kshape, required = PRODUCTION_SHAPE, False
    host = host if host is not None else {}
    try:
        t0 = time.perf_counter()
        pi = CB.expected_cb_pi(gi, machine_pi, mshape, sender, to, miner, gas_used)
        bw = CB.build_contract_binding_witness(
            gi, machine_pi, mshape, sender, to, miner, pi, kshape
        )
        host["binding_witness"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_slots = len(bw.slots)
        kasm = CB.build_contract_kernel(n_slots, kshape, pi, bw)
        counts = kernel_counts(kasm.prog, kasm.hash_requests())
        host["binding_kernel"] = time.perf_counter() - t0
        fitted = binding_sizes or _binding_table_sizes(counts)
        for name, log in (
            ("cpu", fitted.cpu), ("arithmetic", fitted.arithmetic),
            ("logic", fitted.logic), ("memory", fitted.memory),
            ("keccak", fitted.keccak), ("keccak_sponge", fitted.keccak_sponge),
        ):
            if counts[name] > (1 << log):
                raise CircuitSizeError(f"{name} needs {counts[name]} > 2^{log}")
        cpu = CpuStark(kasm.prog, CB.cb_num_pi_words(n_slots))
        multi, _ = prove_all_tables(
            cpu, pi, fitted, config,
            hash_requests=kasm.hash_requests(), kernel_witness=kasm.witness,
            device=device, phase_times=phase_times,
        )
        return multi, pi, n_slots, kshape
    except (BUnsupported, CircuitSizeError):
        if required:
            raise
        return None, None, 0, None


def expected_machine_pi(
    gi: GenerationInputs, shape: E.EvmShape
) -> Tuple[List[int], bytes, bytes]:
    """Re-derive the machine's public-input words from the witness alone
    (the verifier-side counterpart of execute_evm's pi_words): caller,
    callvalue, calldata words, codehash — and storage keys/pre-values
    checked against the callee's storage trie. Post-values and success
    are read from the proof's PI and validated by the trie binding."""
    tx = decode_tx(gi.signed_txn)
    sender = tx.sender()
    acct = decode_account(gi.tries.state_trie.get(_acct_key(tx.to)))
    code = gi.contract_code[acct["code_hash"]]
    assert len(code) == shape.code_len and len(tx.data) == shape.calldata_len
    cd_words = [
        int.from_bytes(tx.data[32 * w: 32 * w + 32].ljust(32, b"\0"), "big")
        for w in range(shape.n_calldata_words)
    ]
    code_padded = code + b"\0" * (len(code) % 2)
    caller = int.from_bytes(sender, "big")
    env = tx_env_words(gi, tx, caller)
    pi = [
        caller, tx.value, env["address"], env["origin"], env["gasprice"],
        env["coinbase"], env["timestamp"], env["number"], env["gaslimit"],
        env["chainid"], env["basefee"], env["gas_budget"],
    ] + cd_words
    pi.append(le_word(keccak256(code_padded)))
    return pi, sender, tx.to


def check_contract_binding(proof: ContractCallProof) -> bool:
    """Host-side witness binding: machine PI consistent with the witness
    and the post state root reachable from (tries, machine journal).

    In-circuit status: execution/storage-journal/code-hash are proved by
    the machine STARK; the TRIE binding below (account paths, storage
    trie rebuild) is host-side — the same documented fallback tier as
    check_trie_binding for transfers (evm/binding.py is the in-circuit
    upgrade path)."""
    gi = proof.gen_inputs
    shape = proof.shape
    lay = shape.pi_layout
    pi = proof.machine_pi
    try:
        head, sender, to = expected_machine_pi(gi, shape)
    except Exception:
        return False
    if pi[: len(head)] != head or sender != proof.sender or to != proof.to:
        return False
    tx = decode_tx(gi.signed_txn)
    # storage keys strictly increasing, pre-values match the trie, warm
    # flags match the tx access list (EIP-2929 pre-warming)
    hashed_addr = keccak256(to)
    strie = _storage_trie(gi, hashed_addr)
    warm_keys = {
        int.from_bytes(k, "big")
        for addr, keys_ in tx.access_list
        if addr == to
        for k in keys_
    }
    keys = []
    for i in range(shape.n_skeys):
        k = pi[lay["storage"] + 4 * i]
        warm0 = pi[lay["storage"] + 4 * i + 1]
        vpre = pi[lay["storage"] + 4 * i + 2]
        keys.append(k)
        if warm0 != (1 if k in warm_keys else 0):
            return False
        expect = (
            _decode_slot_value(strie.get(_slot_key(k))) if strie is not None else 0
        )
        if vpre != expect:
            return False
    if any(b <= a for a, b in zip(keys, keys[1:])):
        return False
    # consensus gas: the witness's claimed gas delta must equal the
    # re-derived intrinsic + capped-refund total, and the proof's PI
    # must carry the same frame gas/refund the interpreter re-derives
    from .gas import intrinsic_gas, tx_gas_used
    from ..gf import field_host as fh

    frames_replay: List[FrameRun] = []
    logs_replay: list = []
    try:
        _, _, res = machine_inputs_for_tx(
            gi, frames_out=frames_replay, log_sink=logs_replay
        )
        if proof.gas_used != gi.gas_used_after - gi.gas_used_before:
            return False
        if proof.gas_used != tx_gas_used(
            intrinsic_gas(tx), res.gas_used, res.gas_refund, res.success
        ):
            return False
        if pi[lay["gas"]] != res.gas_used:
            return False
        if pi[lay["refund"]] != res.gas_refund % fh.P:
            return False
        # the full PI vector must equal the witness replay's — this
        # covers the environment-query tuples (BALANCE/EXTCODE*/
        # BLOCKHASH answers + EIP-2929 account-access gas) AND the
        # per-call directories ([addr, gas, refund] + input/output
        # words of every precompile and inner-frame call) verbatim
        if list(pi) != list(res.pi_words):
            return False
        # every inner frame the replay resolves must be present as a
        # machine proof with the identical shape and statement — this is
        # the outer-call-directory <-> inner-frame linkage
        inner = proof.inner_frames or []
        if len(inner) != len(frames_replay):
            return False
        for ip, fr in zip(inner, frames_replay):
            if ip.address != fr.address or ip.shape != fr.shape:
                return False
            if list(ip.machine_pi) != list(fr.result.pi_words):
                return False
    except Exception:
        return False
    success = pi[lay["success"]]
    # rebuild the post state root
    state = gi.tries.state_trie.copy()
    if gi.txn_number_before == 0 and state.hash() != gi.checkpoint_state_trie_root:
        return False
    base_fee = gi.block_metadata.block_base_fee
    fee = tx.effective_gas_price(base_fee) * proof.gas_used
    tip = tx.miner_tip_per_gas(base_fee) * proof.gas_used
    s_acc = decode_account(state.get(_acct_key(sender)))
    if tx.nonce != s_acc["nonce"]:
        return False
    value = tx.value if success else 0  # reverted frames keep their value
    # sequential updates: sender, callee, miner (may overlap)
    def get_acct(addr):
        raw = state.get(_acct_key(addr))
        return decode_account(raw) if raw is not None else _empty_account()

    def put_acct(addr, acc):
        state.insert(_acct_key(addr), encode_account(acc))

    s_acc["nonce"] += 1
    if s_acc["balance"] < value + fee:
        return False
    s_acc["balance"] -= value + fee
    put_acct(sender, s_acc)
    c_acc = get_acct(to)
    c_acc["balance"] += value
    if success and shape.n_skeys:
        st = (strie.copy() if strie is not None else None)
        if st is None:
            from ..trie.trie import PartialTrie

            st = PartialTrie()
        for i in range(shape.n_skeys):
            k = pi[lay["storage"] + 4 * i]
            vpost = pi[lay["storage"] + 4 * i + 3]
            if vpost == 0:
                st.delete(_slot_key(k))
            else:
                st.insert(_slot_key(k), _encode_slot_value(vpost))
        c_acc["storage_root"] = st.hash()
    put_acct(to, c_acc)
    # inner frames: apply each callee's PI-journaled storage updates
    # (frame addresses are unique per tx; outer revert rolls them back)
    if success:
        from ..trie.trie import PartialTrie

        for ip in proof.inner_frames or []:
            if not ip.shape.n_skeys:
                continue
            flay = ip.shape.pi_layout
            ftrie = _storage_trie(gi, keccak256(ip.address))
            st = ftrie.copy() if ftrie is not None else PartialTrie()
            for i in range(ip.shape.n_skeys):
                k = ip.machine_pi[flay["storage"] + 4 * i]
                vpost = ip.machine_pi[flay["storage"] + 4 * i + 3]
                if vpost == 0:
                    st.delete(_slot_key(k))
                else:
                    st.insert(_slot_key(k), _encode_slot_value(vpost))
            f_acc = get_acct(ip.address)
            f_acc["storage_root"] = st.hash()
            put_acct(ip.address, f_acc)
    m_acc = get_acct(proof.miner)
    m_acc["balance"] += tip  # EIP-1559: base_fee * gas is burned
    put_acct(proof.miner, m_acc)
    if state.hash() != gi.trie_roots_after.state_root:
        return False
    # receipts: the PI-bound logs (in tx-global replay order across
    # frames) must reproduce the witness receipts-root transition
    # (skipped if the witness has no receipts commitment)
    return check_receipts_binding(proof, logs_replay)


def verify_binding_proof(proof: ContractCallProof, config: StarkConfig, device=None) -> bool:
    """Verify the in-circuit state-binding proof: its PI words must
    re-derive from the witness + the machine's PI (word equality — this
    is the cross-proof link), and the kasm multi-proof must verify
    against the program rebuilt from the statement (n_slots, kshape)."""
    from ..tables.all import verify_all_tables
    from ..tables.cpu import CpuStark
    from . import cbinding as CB
    from .binding import Unsupported as BUnsupported

    if proof.binding_multi is None or proof.cb_pi is None:
        return False
    try:
        expected = CB.expected_cb_pi(
            proof.gen_inputs, proof.machine_pi, proof.shape,
            proof.sender, proof.to, proof.miner, proof.gas_used,
        )
    except Exception:
        return False
    if expected != proof.cb_pi:
        return False
    if proof.cb_n_slots != (len(expected) - CB.CB_SLOTS) // 2:
        return False
    kasm = CB.build_contract_kernel(proof.cb_n_slots, proof.cb_kshape)
    cpu = CpuStark(kasm.prog, CB.cb_num_pi_words(proof.cb_n_slots))
    return verify_all_tables(cpu, proof.cb_pi, proof.binding_multi, config, device)


def verify_contract_call(proof: ContractCallProof, config: StarkConfig, device=None) -> bool:
    """Full verification: machine STARK + state binding (in-circuit when
    the proof carries a binding multi-proof; the host re-derivation runs
    in both cases as the documented cross-check tier). `device` is where
    the tables' fixed-column caps are committed and leaves digested."""
    resolve_device(device)
    if proof.multi is None:
        return False
    machine = E.EvmStark(proof.shape)
    if not A.verify_evm_tables(machine, proof.machine_pi, proof.multi, config, device):
        return False
    # every inner call frame carries its own machine STARK, verified
    # against its own shape/statement (linked to the outer frame's call
    # directory by check_contract_binding's witness replay)
    for ip in proof.inner_frames or []:
        if ip.multi is None:
            return False
        fmachine = E.EvmStark(ip.shape)
        if not A.verify_evm_tables(fmachine, ip.machine_pi, ip.multi, config, device):
            return False
    if proof.binding_multi is not None:
        if not verify_binding_proof(proof, config, device):
            return False
    return check_contract_binding(proof)


# -- receipts binding -----------------------------------------------------------


def _bloom_of(entries) -> bytes:
    """2048-bit logs bloom (consensus m3:2048): for each entry, set the
    three bits indexed by the first three big-endian 2-byte pairs of
    keccak(entry) mod 2048."""
    bloom = bytearray(256)
    for e in entries:
        h = keccak256(e)
        for k in (0, 2, 4):
            bit = ((h[k] << 8) | h[k + 1]) & 2047
            bloom[256 - 1 - bit // 8] |= 1 << (bit % 8)
    return bytes(bloom)


def machine_logs(proof: ContractCallProof):
    """(address, topics, data) per LOG event, from the machine's public
    inputs (the STARK binds them to the executed LOG operands)."""
    lay = proof.shape.pi_layout
    out = []
    for i, (nt, dl) in enumerate(proof.shape.log_shapes):
        base = lay["log_words"][i]
        topics = [
            proof.machine_pi[base + t].to_bytes(32, "big") for t in range(nt)
        ]
        data = b"".join(
            proof.machine_pi[base + nt + w].to_bytes(32, "big")
            for w in range(E.EvmShape.n_data_words(dl))
        )[:dl]
        out.append((proof.to, topics, data))
    return out


def expected_receipt(
    proof: ContractCallProof, global_logs=None
) -> bytes:
    """Consensus legacy-receipt RLP for this tx, rebuilt from the proof's
    public log inputs + the witness gas accounting. `global_logs` is the
    replay-derived [(address, topics, data)] order across call frames;
    None falls back to the outer frame's PI-bound logs (single-frame
    txs, where the two coincide)."""
    from ..trie import rlp

    gi = proof.gen_inputs
    success = proof.machine_pi[proof.shape.pi_layout["success"]]
    if global_logs is not None:
        logs = (
            [(a.to_bytes(20, "big") if isinstance(a, int) else a,
              [t.to_bytes(32, "big") if isinstance(t, int) else t
               for t in ts], d)
             for a, ts, d in global_logs]
            if success
            else []
        )
    else:
        logs = machine_logs(proof) if success else []
    entries = []
    for addr, topics, _data in logs:
        entries.append(addr)
        entries.extend(topics)
    body = rlp.encode(
        [
            rlp.int_to_bytes(int(success)),
            rlp.int_to_bytes(gi.gas_used_after),
            _bloom_of(entries),
            [[a, t, d] for a, t, d in logs],
        ]
    )
    # typed txs (EIP-2718): the receipts-trie value is type || rlp(receipt)
    tx = decode_tx(gi.signed_txn)
    return (bytes([tx.tx_type]) + body) if tx.tx_type else body


def check_receipts_binding(
    proof: ContractCallProof, global_logs=None
) -> bool:
    """Insert the rebuilt receipt into the witness receipts trie and
    compare against trie_roots_after.receipts_root. Skipped (True) when
    the witness carries no receipts commitment (all-zero root), matching
    the transfer kernel's current scope."""
    from ..trie import rlp

    gi = proof.gen_inputs
    want = gi.trie_roots_after.receipts_root
    if want == b"\x00" * 32:
        return True
    if global_logs is None and proof.inner_frames:
        # multi-frame txs need the tx-global log order from the replay
        try:
            sink: list = []
            machine_inputs_for_tx(gi, log_sink=sink)
            global_logs = sink
        except Exception:
            return False
    rt = gi.tries.receipts_trie.copy()
    rt.insert(
        Nibbles.from_bytes(rlp.encode(rlp.int_to_bytes(gi.txn_number_before))),
        expected_receipt(proof, global_logs),
    )
    return rt.hash() == want

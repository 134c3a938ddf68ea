"""The EVM machine table: the port vs the JAX package.

- `execute_evm` on the ERC-20 cases of tests/test_erc20.py (success,
  insufficient balance, self-transfer, unknown selector, address masking)
  and `machine_inputs_for_tx` + `consensus_gas_used` on contract-call
  witnesses give the reference's trace, PI words, request lists, memory
  ops and results, except for the port's fix of the KECCAK256 sponge
  timestamp: its hash requests and H_TS column carry the KDIG row's slot.
- That fix is pinned both ways: the reference's Memory trace of an ERC-20
  run reads the hashed words before the machine writes them (its Memory
  constraints fail there), while every table of the port's run satisfies
  its constraints and its CTL multisets balance.
- The CTL graph equals the reference's but for the sponge first-row CTL's
  timestamp column.
- Slow tier: the port's machine multi-proofs (tests/test_evm_e2e.py's
  program, the ERC-20 call) pass the port's `verify_evm_tables`.
Exact u64 equality throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ethproof_tpu.evm import contract as jcon
from ethproof_tpu.evm import erc20 as jerc
from ethproof_tpu.tables import all as jall
from ethproof_tpu.tables import bytepacking as jbp
from ethproof_tpu.tables import evm as jevm
from ethproof_tpu.tables import keccak_sponge as jks
from ethproof_tpu.tables import memory as jmem
from ethproof_tpu.witness.types import GenerationInputs as JGenerationInputs
from ethproof_tpu_torch.evm import contract as tcon
from ethproof_tpu_torch.evm import erc20 as terc
from ethproof_tpu_torch.gf import field as tgf
from ethproof_tpu_torch.stark.stark import DeviceOps, EvalContext
from ethproof_tpu_torch.tables import all as tall
from ethproof_tpu_torch.tables import evm as tevm
from ethproof_tpu_torch.tables.cpu import pi_limbs
from ethproof_tpu_torch.witness import synthetic
from test_evm_e2e import ctl_multisets_ok
from test_evm_machine import check_constraints

torch.set_num_threads(1)

ALICE = 0xA11CE00000000000000000000000000000000001
BOB = 0xB0B0000000000000000000000000000000000002
ERC20_SIZES = dict(cpu=9, arithmetic=16, logic=9, bytepacking=9, memory=13, keccak=7,
                   keccak_sponge=8)


def _run(pkg, caller, to, amount, balances, calldata=None):
    """discover_and_execute of transfer(to, amount) (or of `calldata`)."""
    erc, evm = (jerc, jevm) if pkg == "j" else (terc, tevm)
    shape, inputs = erc.transfer_inputs(caller, to, amount, balances)
    return evm.discover_and_execute(inputs.code, calldata or inputs.calldata, inputs.caller,
                                    0, inputs.storage_pre, shape.log_rows)


def _unknown_selector(pkg):
    erc, evm = (jerc, jevm) if pkg == "j" else (terc, tevm)
    shape, inputs = erc.transfer_inputs(ALICE, BOB, 1, {ALICE: 5})
    bad = b"\xde\xad\xbe\xef" + inputs.calldata[4:]
    shape2 = evm.EvmShape(shape.code_len, len(bad), shape.n_skeys, shape.log_rows)
    return shape2, inputs, evm.execute_evm(
        shape2, evm.EvmInputs(inputs.code, bad, ALICE, 0, inputs.storage_pre))


CASES = {
    "success": lambda p: _run(p, ALICE, BOB, 30, {ALICE: 100, BOB: 5}),
    "insufficient_balance": lambda p: _run(p, ALICE, BOB, 101, {ALICE: 100}),
    "self_transfer": lambda p: _run(p, ALICE, ALICE, 10, {ALICE: 100}),
    "unknown_selector": _unknown_selector,
    "address_masking": lambda p: _run(
        p, ALICE, BOB, 7, {ALICE: 10}, calldata=jerc.transfer_calldata((0xFF << 160) | BOB, 7)),
}


def _ops(ops):
    return [(o.ctx, o.seg, o.virt, o.ts, o.is_read, o.value) for o in ops]


def _packs(reqs):
    return [(r.is_read, r.ctx, r.seg, r.virt, r.ts, r.data) for r in reqs]


def assert_run_equals_reference(got, want):
    """Every field of two EvmResults is equal, but for the KECCAK256 sponge
    timestamp: each reference request ts (the SETUP row's sponge slot) is
    the port's KDIG row's slot, in the hash requests and the H_TS column."""
    assert len(got.hash_requests) == len(want.hash_requests)
    ts_map = {}
    for g, w in zip(got.hash_requests, want.hash_requests):
        assert (g.ctx, g.seg, g.virt, g.message, g.staged) == (
            w.ctx, w.seg, w.virt, w.message, w.staged)
        if w.seg == jevm.SEG_HASH:
            # the KDIG row: after the SETUP row and the message's KPACK rows
            kdig = w.ts // jevm.TS_SLOTS + 1 + tevm._kpack_rows(len(w.message))
            assert g.ts == jevm.TS_SLOTS * kdig + 6
            ts_map[w.ts] = g.ts
        else:  # the code hash keeps its declaring row's slot
            assert g.ts == w.ts
    h_ts = want.trace[jevm.H_TS].copy()
    for old, new in ts_map.items():
        h_ts[want.trace[jevm.H_TS] == old] = new
    np.testing.assert_array_equal(got.trace[tevm.H_TS], h_ts)
    keep = np.arange(want.trace.shape[0]) != jevm.H_TS
    np.testing.assert_array_equal(got.trace[keep], want.trace[keep])
    assert got.pi_words == want.pi_words
    assert _ops(got.mem_ops) == _ops(want.mem_ops)
    assert got.arith_requests == want.arith_requests
    assert got.logic_requests == want.logic_requests
    assert _packs(got.pack_requests) == _packs(want.pack_requests)
    for name in ("storage_post", "success", "logs", "return_data", "gas_used", "gas_refund",
                 "warm_addrs_post"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("case", list(CASES))
def test_execute_evm_equals_reference(case):
    j_shape, _, want = CASES[case]("j")
    t_shape, _, got = CASES[case]("t")
    assert dataclasses.asdict(t_shape) == dataclasses.asdict(j_shape)
    assert_run_equals_reference(got, want)


WITNESSES = {
    "success": {},
    "revert": dict(amount=101, sender_tokens=100),
    "empty_recipient": dict(amount=7, sender_tokens=50, bob_tokens=0),
}


@pytest.mark.parametrize("kw", list(WITNESSES))
def test_machine_inputs_for_tx_equals_reference(kw):
    t_gi = synthetic.small_erc20_transfer(**WITNESSES[kw])
    j_gi = JGenerationInputs.from_json(t_gi.to_json())
    j_shape, j_inputs, want = jcon.machine_inputs_for_tx(j_gi)
    t_shape, t_inputs, got = tcon.machine_inputs_for_tx(t_gi)
    assert dataclasses.asdict(t_shape) == dataclasses.asdict(j_shape)
    assert t_inputs.storage_pre == j_inputs.storage_pre
    assert t_inputs.warm_addrs == j_inputs.warm_addrs
    assert_run_equals_reference(got, want)
    assert tcon.consensus_gas_used(t_gi, got) == jcon.consensus_gas_used(j_gi, want)
    assert tcon.consensus_gas_used(t_gi) == t_gi.gas_used_after


class _Violations:
    """A constraint consumer over whole trace columns: records which
    constraints are nonzero on which rows (transition ones off the last)."""

    def __init__(self, n):
        self.n, self.bad, self.i = n, [], 0

    def _check(self, c, rows):
        v = tgf.to_u64(c.expand(self.n) if c.dim() == 0 else c).reshape(-1, self.n)
        for row in v:
            nz = [r for r in np.nonzero(row)[0] if rows is None or r in rows]
            if nz:
                self.bad.append((self.i, nz[:4]))
            self.i += 1

    def constraint(self, c):
        self._check(c, None)

    def constraint_transition(self, c):
        self._check(c, range(self.n - 1))

    def constraint_first_row(self, c):
        self._check(c, (0,))

    def constraint_last_row(self, c):
        self._check(c, (self.n - 1,))

    constraint_vec = constraint
    constraint_vec_transition = constraint_transition
    constraint_vec_first_row = constraint_first_row
    constraint_vec_last_row = constraint_last_row


def violations(stark, trace, pis=()):
    """The port's constraints of `stark` evaluated on every row of `trace`."""
    n = trace.shape[1]
    ops = DeviceOps((n,), torch.device("cpu"))
    t = tgf.from_u64(trace, "cpu")
    f = tgf.from_u64(stark.fixed_columns(n), "cpu") if stark.num_fixed_columns else None
    cons = _Violations(n)
    ctx = EvalContext(ops, list(t), list(torch.roll(t, -1, -1)),
                      [ops.constant(int(x)) for x in pis], cons,
                      [] if f is None else list(f), [] if f is None else list(torch.roll(f, -1, -1)))
    stark.eval(ctx)
    return cons.bad


def _port_traces(res, sizes):
    return [res.trace] + tall._fill_tables(res, res.pack_requests, list(res.hash_requests),
                                           sizes, lambda _name, fn, *args: fn(*args))


def test_reference_memory_trace_reads_hashed_words_before_their_writes():
    """The reference's ERC-20 run: the sponge reads each KECCAK256 message
    word at the SETUP row's slot, the machine writes it on a later KPACK
    row; the reference's own Memory constraints reject that trace (a read
    of an unwritten address with a nonzero value)."""
    _, _, res = CASES["success"]("j")
    bp_tr, bp_ops = jbp.generate_trace(res.pack_requests, 1 << 9)
    sponge = jks.generate_trace(list(res.hash_requests), 1 << 8)
    ops = res.mem_ops + bp_ops + sponge.mem_ops
    hashed = [o for o in sponge.mem_ops if o.seg == jevm.SEG_HASH]
    writes = {(o.ctx, o.seg, o.virt): o.ts for o in res.mem_ops
              if o.seg == jevm.SEG_HASH and not o.is_read}
    staged = [o for o in hashed if (o.ctx, o.seg, o.virt) in writes]
    assert staged and all(o.ts < writes[(o.ctx, o.seg, o.virt)] for o in staged)
    assert check_constraints(jmem.MemoryStark(), jmem.generate_trace(ops, 1 << 13), [])


def test_port_erc20_run_satisfies_every_table_and_balances_its_ctls():
    shape, _, res = CASES["success"]("t")
    machine = tevm.EvmStark(shape)
    sizes = tall.TableSizes(**ERC20_SIZES)
    traces = _port_traces(res, sizes)
    starks = tall.all_starks(machine, with_keccak=True)
    for stark, trace in zip(starks, traces):
        pis = pi_limbs(res.pi_words) if stark is machine else ()
        assert violations(stark, trace, pis) == [], type(stark).__name__
    assert ctl_multisets_ok(starks, traces, tall.build_ctls_evm(machine)) == []


def test_build_ctls_evm_equals_reference_but_for_the_sponge_timestamp():
    """Eight CTL groups, the reference's in every spec but the machine's
    sponge first-row spec, whose timestamp column is H_TS (the reference
    sends the row's own sponge slot)."""
    j_shape, _, _ = CASES["success"]("j")
    t_shape = tevm.EvmShape(**dataclasses.asdict(j_shape))
    j_machine, t_machine = jevm.EvmStark(j_shape), tevm.EvmStark(t_shape)
    want, got = jall.build_ctls_evm(j_machine), tall.build_ctls_evm(t_machine)
    assert len(got) == len(want) == 8
    for g, w in zip(got[:6] + got[7:], want[:6] + want[7:]):
        assert repr(g) == repr(w)
    (t_tbl, t_spec), (j_tbl, j_spec) = got[6].looking[0], want[6].looking[0]
    assert t_tbl == j_tbl and repr(got[6].looked) == repr(want[6].looked)
    assert repr(t_spec.columns[:4]) == repr(j_spec.columns[:4])
    assert t_spec.columns[4] == tevm.H_TS
    assert repr(j_spec.columns[4]) == repr(j_machine._ts(6))
    assert evm_counts_equal(t_shape, j_shape)


def evm_counts_equal(t_shape, j_shape) -> bool:
    _, _, want = CASES["success"]("j")
    _, _, got = CASES["success"]("t")
    return tall.evm_table_counts(t_shape, got) == jall.evm_table_counts(j_shape, want)


# -- slow tier: machine multi-proofs ------------------------------------------------

E2E_SIZES = dict(cpu=9, arithmetic=8, logic=9, bytepacking=9, memory=13, keccak=6,
                 keccak_sponge=8)


def _e2e_run():
    """tests/test_evm_e2e.py's program (storage update, KECCAK256 of a
    scratch pair, RETURN; its assembled bytecode), run by the port."""
    import test_evm_e2e

    return tevm.discover_and_execute(test_evm_e2e.CODE, test_evm_e2e.CALLDATA, 0xC0FFEE, 0,
                                     {0xBEEF: 35}, 9)


@pytest.mark.slow
@pytest.mark.parametrize("program", ["e2e", "erc20"])
def test_machine_proof_verifies_and_rejects_a_forged_post_value(program):
    """The port's machine multi-proof on the CPU: tests/test_evm_e2e.py's
    program at its sizes, and the ERC-20 success case at the 2^16-row
    Arithmetic table its 16-bit operand limbs need. The port's
    `verify_evm_tables` accepts it and rejects a forged post-storage PI
    word. (The reference's verifier rejects every port machine proof: the
    port's sponge first-row CTL sends H_TS, ROADMAP Queue 3.)"""
    from test_torch_stark import T_CFG

    if program == "e2e":
        shape, _, res = _e2e_run()
        sizes = E2E_SIZES
    else:
        shape, _, res = CASES["success"]("t")
        sizes = ERC20_SIZES
    machine = tevm.EvmStark(shape)
    proof = tall.prove_evm_tables(machine, res, tall.TableSizes(**sizes), T_CFG, device="cpu")
    assert tall.verify_evm_tables(machine, res.pi_words, proof, T_CFG, device="cpu")
    bad = list(res.pi_words)
    bad[shape.pi_layout["storage"] + 3] += 1
    assert not tall.verify_evm_tables(machine, bad, proof, T_CFG, device="cpu")

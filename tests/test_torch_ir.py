"""The constraint IR: the port's recorder and level executor vs the JAX package.

- The recorded sweep program (instruction list, inputs, outputs) of the
  Memory, CPU, Arithmetic and Keccak tables, with their CTL specs and
  logUp lookups, equals the JAX recording; the EVM machine's equals it but
  for the port's fix of the KECCAK256 sponge timestamp (one inserted
  instruction, pinned below).
- The port's level executor equals the port's direct sweep
  (`ETHPROOF_SWEEP=eager`) on seeded LDE columns for all five tables, also
  when `ETHPROOF_SWEEP_BUDGET` splits the domain into chunks; and it equals
  the JAX package's eager level executor (`ETHPROOF_JIT_SWEEP=never`, as
  tests/conftest.py sets it) on the same seeded inputs.
- The port's verifier, with IR replay and with direct evaluation, accepts
  an honest proof and rejects a tampered one.
Exact u64 equality throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ethproof_tpu.evm import erc20 as jerc
from ethproof_tpu.gf import field as jgf
from ethproof_tpu.stark import ir as jir
from ethproof_tpu.stark import multi as jmulti
from ethproof_tpu.tables import evm as jevm
from ethproof_tpu.tables import memory as jmem
from ethproof_tpu_torch.gf import field as tgf
from ethproof_tpu_torch.stark import ir as tir
from ethproof_tpu_torch.stark import multi as tmulti
from ethproof_tpu_torch.stark import prove as tprove
from ethproof_tpu_torch.stark.prove import stark_prove
from ethproof_tpu_torch.stark.verify import stark_verify
from ethproof_tpu_torch.tables import evm as tevm
from ethproof_tpu_torch.tables import memory as tmem
from test_torch_stark import OPS, T_CFG, assert_same
from test_torch_tables import TABLES, SEVEN, _ctls, _ctls7, _starks

torch.set_num_threads(1)

P = jgf.P
RATE_BITS = 2
NUM_CHALLENGES = 2
HEAD_KEYS = ("tl", "tn", "fl", "fn", "al", "an")


def _erc20_shapes():
    """(JAX, port) EvmShape of a discovered ERC-20 transfer."""
    _, inputs = jerc.transfer_inputs(1, 2, 3, {1: 5})
    shape, _, _ = jevm.discover_and_execute(inputs.code, inputs.calldata, inputs.caller, 0,
                                            inputs.storage_pre, 9)
    return shape, tevm.EvmShape(**dataclasses.asdict(shape))


def _pair(name):
    """(JAX stark, port stark, JAX specs, port specs) of one table with
    the CTL specs of its wiring (none for Memory, whose CTL is the looked
    side of the transfer's memory group: taken from there too)."""
    if name == "memory":
        j_stark, t_stark, t = jmem.MemoryStark(), tmem.MemoryStark(), 4
    else:
        j_stark, t_stark = _starks(name)
        t = TABLES[name]
    j_ctls, t_ctls = _ctls7() if name in SEVEN else _ctls()
    challenges = [(3, 5), (7, 11)]
    j_inst, _ = jmulti._instances_for_table(t, j_ctls, challenges)
    t_inst, _ = tmulti._instances_for_table(t, t_ctls, challenges)
    return (j_stark, t_stark, tuple(i.spec for i in j_inst), tuple(i.spec for i in t_inst))


@pytest.mark.parametrize("name", ["memory", "cpu", "arithmetic", "keccak"])
def test_recorded_program_equals_reference(name):
    j_stark, t_stark, j_specs, t_specs = _pair(name)
    assert repr(t_specs) == repr(j_specs)
    n_lookup = NUM_CHALLENGES if t_stark.lookups else 0
    want = jir.record_sweep(j_stark, j_specs, NUM_CHALLENGES, n_lookup, True)
    got = tir.record_sweep(t_stark, t_specs, NUM_CHALLENGES, n_lookup, True)
    assert got.input_keys == want.input_keys
    assert got.instrs == want.instrs
    assert got.outputs == want.outputs
    assert got.meta == want.meta


def test_evm_program_equals_reference_but_for_the_sponge_timestamp_fix():
    """The machine's program is the reference's with one instruction
    inserted: (F_CHD + S_KDIG), which replaces SP_FIRST as the gate of the
    sponge-declare timestamp constraint (tables/evm.py: the KECCAK256
    request is declared at its KDIG row's timestamp). Every other
    instruction is the reference's, renumbered past the insertion."""
    j_shape, t_shape = _erc20_shapes()
    want = jir.record_sweep(jevm.EvmStark(j_shape), (), NUM_CHALLENGES, NUM_CHALLENGES, False)
    got = tir.record_sweep(tevm.EvmStark(t_shape), (), NUM_CHALLENGES, NUM_CHALLENGES, False)
    assert got.input_keys == want.input_keys
    n_in = want.n_inputs
    reg = {key: i for i, key in enumerate(want.input_keys)}
    sp_first = reg[("tl", jevm.SP_FIRST)]
    gate = (tir.OP_ADD, *sorted((reg[("tl", jevm.S_KDIG)],
                                 reg[("fl", jevm.EvmStark(j_shape).F_CHD)])))
    at = got.instrs.index(gate)
    assert got.instrs[:at] == want.instrs[:at]
    assert len(got.instrs) == len(want.instrs) + 1

    def shift(r):
        return r + 1 if r >= n_in + at else r

    replaced = 0
    for k, (op, a, b) in enumerate(want.instrs[at:], start=at):
        two = op in (tir.OP_ADD, tir.OP_SUB, tir.OP_MUL)
        expect = (op, shift(a) if op != tir.OP_CONST else a, shift(b) if two else b)
        if op == tir.OP_MUL and sp_first in (a, b) and not replaced:
            other = shift(b if a == sp_first else a)
            expect = (op, *sorted((n_in + at, other)))
            replaced += 1
        assert got.instrs[k + 1] == expect, k
    assert replaced == 1
    assert got.outputs == [shift(o) for o in want.outputs]


def _random_inputs(program, m, seed):
    rng = np.random.default_rng(seed)
    n_head = sum(1 for k in program.input_keys if k[0] in HEAD_KEYS)
    n_scal = sum(1 for k in program.input_keys if len(k) == 2 and k[0] not in HEAD_KEYS)
    return (rng.integers(0, P, size=(n_head, m), dtype=np.uint64),
            rng.integers(0, P, size=(n_scal,), dtype=np.uint64),
            rng.integers(0, P, size=(3, m), dtype=np.uint64))


def _run_port(program, head, scal, tail):
    ex = tir.SweepExecutor(program)
    rows = tgf.from_u64(head, "cpu")
    out = ex.run(lambda lo, hi: rows[:, lo:hi], tgf.from_u64(scal, "cpu"),
                 tgf.from_u64(tail, "cpu"))
    return tgf.to_u64(out), ex.last_run[0]


@pytest.mark.parametrize("budget", [None, 1 << 12])
def test_level_executor_equals_reference_executor(monkeypatch, budget):
    """Memory's program with its CTL and lookups, on 64 seeded domain
    columns; the small budget forces the port's executor into chunks."""
    if budget is not None:
        monkeypatch.setenv("ETHPROOF_SWEEP_BUDGET", str(budget))
    j_stark, t_stark, j_specs, t_specs = _pair("memory")
    want_prog = jir.record_sweep(j_stark, j_specs, NUM_CHALLENGES, NUM_CHALLENGES, True)
    head, scal, tail = _random_inputs(want_prog, 64, seed=1)
    jx = jir.SweepExecutor(want_prog)
    lo, hi = jx.run(jgf.from_u64(head), jgf.from_u64(scal), jgf.from_u64(tail), jit=False)
    want = (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)
    got, chunks = _run_port(
        tir.record_sweep(t_stark, t_specs, NUM_CHALLENGES, NUM_CHALLENGES, True), head, scal, tail)
    assert (chunks > 1) == (budget is not None)
    np.testing.assert_array_equal(got, want)


def _sweep_args(t_stark, t_inst, log_n, seed):
    rng = np.random.default_rng(seed)
    m = 1 << (log_n + RATE_BITS)

    def rand(*shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    def dev(x):  # one domain block: the prover's layout without a mesh
        return None if x is None else [tgf.from_u64(x, "cpu")]

    lookup_alphas = [int(v) for v in rand(NUM_CHALLENGES)] if t_stark.lookups else []
    n_aux = len(t_inst) + sum(
        (len(s.looking_cols) + 2) * len(lookup_alphas) for s in t_stark.lookups)
    trace = dev(rand(t_stark.num_columns, m))
    fixed = dev(rand(t_stark.num_fixed_columns, m)) if t_stark.num_fixed_columns else None
    aux = dev(rand(n_aux, m)) if n_aux else None
    totals = [int(v) for v in rand(len(t_inst))]
    pis = [int(v) for v in rand(t_stark.num_public_inputs)]
    alphas = [int(v) for v in rand(NUM_CHALLENGES)]
    return (t_stark, trace, fixed, aux, t_inst, totals, lookup_alphas, pis, alphas, log_n,
            RATE_BITS, 7)


@pytest.mark.parametrize("name,budget", [
    ("memory", None), ("cpu", None), ("arithmetic", None), ("keccak", None), ("evm", None),
    ("evm", 1 << 16),
])
def test_ir_sweep_equals_direct_sweep(monkeypatch, name, budget):
    """The prover's IR sweep (`_ir_sweep`: rows built one chunk at a time,
    next rows shifted by the rate) equals its direct evaluation of `eval`
    on seeded LDE columns, CTL and lookup constraints included."""
    if budget is not None:
        monkeypatch.setenv("ETHPROOF_SWEEP_BUDGET", str(budget))
    if name == "evm":
        t_stark = tevm.EvmStark(_erc20_shapes()[1])
        t_inst = tmulti._instances_for_table(0, _evm_ctls(t_stark), [(3, 5), (7, 11)])[0]
    else:
        t_stark, t_inst = _pair(name)[1], None
        t = 4 if name == "memory" else TABLES[name]
        ctls = _ctls7()[1] if name in SEVEN else _ctls()[1]
        t_inst = tmulti._instances_for_table(t, ctls, [(3, 5), (7, 11)])[0]
    args = _sweep_args(t_stark, t_inst, 5 if name == "cpu" else 4, seed=30)
    want = tprove._sweep(*args)
    got = tprove._ir_sweep(*args)
    ex = tprove.ir_executor(t_stark, tuple(i.spec for i in t_inst), NUM_CHALLENGES,
                            len(args[6]), args[3] is not None)
    assert (ex.last_run[0] > 1) == (budget is not None)
    np.testing.assert_array_equal(tgf.to_u64(got[0]), tgf.to_u64(want[0]))


def _evm_ctls(machine):
    from ethproof_tpu_torch.tables import all as tall

    return tall.build_ctls_evm(machine)


def _memory_proof():
    trace = tmem.generate_trace([tmem.MemoryOp(*op) for op in OPS], 64)
    return T_CFG, stark_prove(tmem.MemoryStark(), trace, [], T_CFG, device="cpu")


@pytest.mark.parametrize("mode", ["ir", "eager"])
def test_verifier_accepts_honest_and_rejects_tampered(monkeypatch, mode):
    """A 2^6-row Memory proof made under each sweep mode is the same proof;
    the verifier accepts it and rejects it with one opening of the trace
    at zeta changed, with its constraint identity evaluated by IR replay
    ("ir": the verifier as it is) or by `eval` run directly ("eager":
    `_direct_accs` in place of `_replay_accs`)."""
    from ethproof_tpu_torch.stark import verify as tverify

    monkeypatch.setenv("ETHPROOF_SWEEP", mode)
    if mode == "eager":
        monkeypatch.setattr(tverify, "_replay_accs", tverify._direct_accs)
    config, proof = _memory_proof()
    assert stark_verify(tmem.MemoryStark(), proof, config, device="cpu")
    proof.openings.trace_at_zeta[3, 0] = (int(proof.openings.trace_at_zeta[3, 0]) + 1) % P
    assert not stark_verify(tmem.MemoryStark(), proof, config, device="cpu")


def test_sweep_modes_make_the_same_proof(monkeypatch):
    from ethproof_tpu_torch.interop import proof_to_numpy

    monkeypatch.setenv("ETHPROOF_SWEEP", "eager")
    _, eager = _memory_proof()
    monkeypatch.setenv("ETHPROOF_SWEEP", "ir")
    _, ir = _memory_proof()
    assert_same(proof_to_numpy(ir), proof_to_numpy(eager))


def test_sweep_mode_refuses_an_unknown_value(monkeypatch):
    monkeypatch.setenv("ETHPROOF_SWEEP", "jit")
    with pytest.raises(ValueError):
        tprove._sweep_mode()

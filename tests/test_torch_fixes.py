"""The port's two fixes to the reference, held against the reference with
the same two fixes patched in for one test (in-process: no file of the JAX
package changes).

1. KECCAK256 declares its sponge request at its KDIG row: the timestamp
   `hash_ts` in `execute_evm`, the declare constraint of `EvmStark.eval`
   gated by `F_CHD + S_KDIG` (SP_FIRST before), and the sponge first-row
   CTL sending `H_TS` (the row's own slot before).
2. `fri_verify` accepts a table with no folding round: the final
   polynomial's value at each query is the round-0 opening.

So fixed, the reference is a witness of the port's machine that is not the
port: its run of each ERC-20 case equals the port's field for field, its
own row-by-row constraint check and its CTL multiset check accept that run,
its recorded machine program and CTL graph equal the port's, its FRI
verifier accepts the port's proof of a table with no folding round, its
`verify_evm_tables` alone accepts the port's machine multi-proof of
tests/test_evm_e2e.py's program, and it proves that program to the port's
multi-proof, bit for bit, and verifies it. Exact u64 equality throughout.
"""

import dataclasses
import inspect
import textwrap

import numpy as np
import pytest
import torch

from ethproof_tpu.fri import verify as jfri
from ethproof_tpu.gf import field as jgf
from ethproof_tpu.stark import ir as jir
from ethproof_tpu.stark import verify as jsverify
from ethproof_tpu.stark.multi import MultiProof as JMultiProof
from ethproof_tpu.tables import all as jall
from ethproof_tpu.tables import evm as jevm
from ethproof_tpu.tables import memory as jmem
from ethproof_tpu_torch.interop import multi_proof_to_numpy, proof_to_numpy
from ethproof_tpu_torch.stark import ir as tir
from ethproof_tpu_torch.tables import all as tall
from ethproof_tpu_torch.tables import evm as tevm
from test_evm_e2e import CALLDATA, CODE, ctl_multisets_ok, make_traces
from test_evm_machine import check_constraints, pi_limbs
from test_torch_evm import CASES, E2E_SIZES, _ops, _packs
from test_torch_stark import J_CFG, OPS, T_CFG, assert_same, to_reference

torch.set_num_threads(1)

NUM_CHALLENGES = 2


def _kpack_rows(ln: int) -> int:
    """KPACK rows that stage a KECCAK256 message of `ln` bytes: five per
    136-byte block (32, 32, 32, 32 and 8 bytes), the last block's partial."""
    blocks, rest = divmod(ln, 136)
    rows = 5 * blocks
    for width in (32, 32, 32, 32, 8):
        if rest <= 0:
            break
        rest -= width
        rows += 1
    return rows


def _edited(fn, old: str, new: str):
    """`fn` compiled again from its source with `old` (found once) replaced
    by `new`, in its own module's namespace."""
    src = textwrap.dedent(inspect.getsource(fn))
    assert src.count(old) == 1, old
    scope: dict = {}
    exec(compile(src.replace(old, new), inspect.getsourcefile(fn), "exec"), fn.__globals__,
         scope)
    return scope[fn.__name__]


@pytest.fixture
def fixed_reference(monkeypatch):
    """The reference with the port's two fixes, for the test's duration."""
    monkeypatch.setattr(jevm, "_kpack_rows", _kpack_rows, raising=False)
    monkeypatch.setattr(jevm, "execute_evm", _edited(
        jevm.execute_evm,
        "hash_ts = TS_SLOTS * r + 6\n            tr[HS_SEG, r] = SEG_HASH",
        "hash_ts = TS_SLOTS * (r + 1 + _kpack_rows(ln)) + 6\n            tr[HS_SEG, r] = SEG_HASH"))
    monkeypatch.setattr(jevm.EvmStark, "eval", _edited(
        jevm.EvmStark.eval,
        "c.constraint(o.mul(L(SP_FIRST), o.sub(L(H_TS), decl_ts)))",
        "c.constraint(o.mul(o.add(f_chd, kdig), o.sub(L(H_TS), decl_ts)))"))
    sponge_specs = jevm.EvmStark.sponge_ctl_specs

    def sponge_ctl_specs(self):
        first, digest = sponge_specs(self)
        return [dataclasses.replace(first, columns=first.columns[:4] + (jevm.H_TS,)), digest]

    monkeypatch.setattr(jevm.EvmStark, "sponge_ctl_specs", sponge_ctl_specs)
    fri_verify = _edited(
        jfri.fri_verify,
        "        if acc != prev_fold:\n",
        "        if not arities:\n            first_openings.append((i0, acc))\n"
        "        elif acc != prev_fold:\n")
    monkeypatch.setattr(jfri, "fri_verify", fri_verify)
    monkeypatch.setattr(jsverify, "fri_verify", fri_verify)


def _e2e(evm):
    """tests/test_evm_e2e.py's program (storage update, KECCAK256 of a
    scratch pair, RETURN), run by `evm`."""
    return evm.discover_and_execute(CODE, CALLDATA, 0xC0FFEE, 0, {0xBEEF: 35}, 9)


RUNS = dict(CASES, e2e=lambda p: _e2e(jevm if p == "j" else tevm))


@pytest.mark.parametrize("case", list(RUNS))
def test_fixed_reference_runs_as_the_port(fixed_reference, case):
    """`execute_evm` of the fixed reference equals the port's in every field."""
    j_shape, _, want = RUNS[case]("j")
    t_shape, _, got = RUNS[case]("t")
    assert dataclasses.asdict(t_shape) == dataclasses.asdict(j_shape)
    np.testing.assert_array_equal(got.trace, want.trace)
    assert any(w.seg == jevm.SEG_HASH for w in want.hash_requests) or case != "success"
    assert [(g.ctx, g.seg, g.virt, g.ts, g.message, g.staged) for g in got.hash_requests] == [
        (w.ctx, w.seg, w.virt, w.ts, w.message, w.staged) for w in want.hash_requests]
    assert got.pi_words == want.pi_words
    assert _ops(got.mem_ops) == _ops(want.mem_ops)
    assert got.arith_requests == want.arith_requests
    assert got.logic_requests == want.logic_requests
    assert _packs(got.pack_requests) == _packs(want.pack_requests)
    for name in ("storage_post", "success", "logs", "return_data", "gas_used", "gas_refund",
                 "warm_addrs_post"):
        assert getattr(got, name) == getattr(want, name), name


def test_fixed_reference_accepts_the_run(fixed_reference):
    """tests/test_evm_e2e.py's program at its sizes: the fixed reference's
    own checks accept the run it now makes (the port's run, above): its
    row-by-row constraint check of the machine and Memory tables (the
    sponge's constraints are stacked, beyond that scalar harness) and its
    CTL multiset check of all seven."""
    shape, _, res = _e2e(jevm)
    machine = jevm.EvmStark(shape)
    traces = make_traces(shape, res, jall.TableSizes(**E2E_SIZES))
    starks = jall.all_starks(machine, with_keccak=True)
    assert check_constraints(machine, traces[0], pi_limbs(res.pi_words)) == []
    assert check_constraints(jmem.MemoryStark(), traces[4], []) == []
    assert ctl_multisets_ok(starks, traces, jall.build_ctls_evm(machine)) == []


def test_fixed_reference_records_the_port_machine_program(fixed_reference):
    """The machine's recorded sweep program, instruction for instruction,
    and its CTL graph, spec for spec, are the fixed reference's."""
    j_shape, _, _ = CASES["success"]("j")
    t_shape = tevm.EvmShape(**dataclasses.asdict(j_shape))
    j_machine, t_machine = jevm.EvmStark(j_shape), tevm.EvmStark(t_shape)
    want = jir.record_sweep(j_machine, (), NUM_CHALLENGES, NUM_CHALLENGES, False)
    got = tir.record_sweep(t_machine, (), NUM_CHALLENGES, NUM_CHALLENGES, False)
    assert got.input_keys == want.input_keys
    assert got.instrs == want.instrs
    assert got.outputs == want.outputs
    assert got.meta == want.meta
    j_ctls, t_ctls = jall.build_ctls_evm(j_machine), tall.build_ctls_evm(t_machine)
    assert len(t_ctls) == len(j_ctls) == 8
    for g, w in zip(t_ctls, j_ctls):
        assert repr(g) == repr(w)


def test_fixed_reference_verifies_a_proof_without_folding_rounds(fixed_reference):
    """The port's 2^5-row Memory proof under a configuration whose final
    polynomial has 2^5 coefficients, as `standard_fast_config`'s has (no
    FRI folding round; few queries and grinding bits keep it quick), passes
    the fixed reference's `stark_verify`, which rejects it with a final
    coefficient changed."""
    from ethproof_tpu.fri.config import FriConfig as JFriConfig
    from ethproof_tpu.fri.config import StarkConfig as JStarkConfig
    from ethproof_tpu_torch.fri.config import FriConfig, StarkConfig
    from ethproof_tpu_torch.stark.prove import stark_prove
    from ethproof_tpu_torch.tables import memory as tmem

    kw = dict(rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
              arity_bits=2, final_poly_bits=5)
    config = StarkConfig(num_challenges=2, fri_config=FriConfig(**kw))
    j_config = JStarkConfig(num_challenges=2, fri_config=JFriConfig(**kw))
    trace = tmem.generate_trace([tmem.MemoryOp(*op) for op in OPS], 32)
    proof = stark_prove(tmem.MemoryStark(), trace, [], config, device="cpu")
    assert config.fri_config.reduction_arity_bits(5) == []
    j_stark = jmem.MemoryStark()
    assert jsverify.stark_verify(j_stark, to_reference(proof_to_numpy(proof)), j_config)
    proof.fri_proof.final_poly[3, 0] ^= 1
    assert not jsverify.stark_verify(j_stark, to_reference(proof_to_numpy(proof)), j_config)


@pytest.mark.slow
def test_fixed_reference_verifies_the_port_machine_proof(fixed_reference, monkeypatch):
    """tests/test_evm_e2e.py's program at its sizes: the port's machine
    multi-proof, with no reference proof beside it, passes the fixed
    reference's `verify_evm_tables`, which rejects it under a forged
    post-storage PI word."""
    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    torch.set_num_threads(4)
    j_shape, _, _ = _e2e(jevm)
    t_shape, _, got_res = _e2e(tevm)
    got = tall.prove_evm_tables(tevm.EvmStark(t_shape), got_res, tall.TableSizes(**E2E_SIZES),
                                T_CFG, device="cpu")
    torch.set_num_threads(1)
    j_machine = jevm.EvmStark(j_shape)
    as_reference = JMultiProof(proofs=[to_reference(p) for p in multi_proof_to_numpy(got)])
    assert jall.verify_evm_tables(j_machine, got_res.pi_words, as_reference, J_CFG)
    bad = list(got_res.pi_words)
    bad[j_shape.pi_layout["storage"] + 3] += 1
    assert not jall.verify_evm_tables(j_machine, bad, as_reference, J_CFG)


@pytest.mark.slow
def test_fixed_reference_proves_the_port_machine_proof(fixed_reference, monkeypatch):
    """tests/test_evm_e2e.py's program at its sizes: the port's machine
    multi-proof equals the fixed reference's, table by table and field for
    field, and the fixed reference's `verify_evm_tables` accepts it and
    rejects a forged post-storage PI word."""
    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    torch.set_num_threads(4)
    j_shape, _, want_res = _e2e(jevm)
    t_shape, _, got_res = _e2e(tevm)
    j_machine, t_machine = jevm.EvmStark(j_shape), tevm.EvmStark(t_shape)
    want = jall.prove_evm_tables(j_machine, want_res, jall.TableSizes(**E2E_SIZES), J_CFG)
    got = tall.prove_evm_tables(t_machine, got_res, tall.TableSizes(**E2E_SIZES), T_CFG,
                                device="cpu")
    torch.set_num_threads(1)
    assert_same(multi_proof_to_numpy(got), multi_proof_to_numpy(want))
    as_reference = JMultiProof(proofs=[to_reference(p) for p in multi_proof_to_numpy(got)])
    assert jall.verify_evm_tables(j_machine, got_res.pi_words, as_reference, J_CFG)
    bad = list(got_res.pi_words)
    bad[j_shape.pi_layout["storage"] + 3] += 1
    assert not jall.verify_evm_tables(j_machine, bad, as_reference, J_CFG)

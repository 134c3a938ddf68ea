"""Contract calls: the port's binding kernel, sizes and runtime vs the JAX package.

- The contract binding kernel (`evm/cbinding.py`) equals the reference's
  instruction for instruction, with its PI words, witness stream and hash
  requests, at `PRODUCTION_SHAPE` and at `KernelShape(3, 20)`;
  `check_contract_binding` accepts the honest witness and rejects the
  tampered ones in both packages.
- The sizes `prove_contract_call` fits (the machine's and the binding
  proof's) equal the reference's, for the CPU tier's witness and for
  `seeded_erc20_transfer`.
- `runtime.ops.tx_proof` dispatches a transfer and a contract call as the
  reference does, and with a recursion state proves each one's root in
  place of its multi-proof; `agg_combine` and `block_proof` chain and refuse a
  broken seam as the reference's do.
- Slow tier: the port's whole `prove_contract_call` on the CPU tier's
  witness verifies under `verify_contract_call`, and a forged storage PI
  word fails it.
"""

import dataclasses
import types

import pytest
import torch

from ethproof_tpu.evm import cbinding as jcb
from ethproof_tpu.evm import contract as jcon
from ethproof_tpu.evm.binding import KernelShape as JKernelShape
from ethproof_tpu.evm.binding import PRODUCTION_SHAPE as J_PRODUCTION
from ethproof_tpu.evm.tx import decode_tx as j_decode_tx
from ethproof_tpu.runtime import ops as jops
from ethproof_tpu.tables import all as jall
from ethproof_tpu.witness.types import GenerationInputs as JGenerationInputs
from ethproof_tpu_torch.evm import cbinding as tcb
from ethproof_tpu_torch.evm import contract as tcon
from ethproof_tpu_torch.evm.binding import PRODUCTION_SHAPE as T_PRODUCTION
from ethproof_tpu_torch.evm.binding import KernelShape as TKernelShape
from ethproof_tpu_torch.evm.tx import decode_tx as t_decode_tx
from ethproof_tpu_torch.recursion import root as troot
from ethproof_tpu_torch.runtime import ops as tops
from ethproof_tpu_torch.tables import all as tall
from ethproof_tpu_torch.witness import synthetic

torch.set_num_threads(1)

SHAPES = {"production": (J_PRODUCTION, T_PRODUCTION),
          "3x20": (JKernelShape(3, 20), TKernelShape(3, 20))}


def _witnesses(**kw):
    t_gi = synthetic.small_erc20_transfer(**kw)
    return JGenerationInputs.from_json(t_gi.to_json()), t_gi


def _statement(con, decode_tx, cb, gi):
    """(machine shape, machine result, sender, to, miner, binding PI)."""
    shape, _, res = con.machine_inputs_for_tx(gi)
    tx = decode_tx(gi.signed_txn)
    miner = gi.block_metadata.block_beneficiary
    pi = cb.expected_cb_pi(gi, res.pi_words, shape, tx.sender(), tx.to, miner,
                           gi.gas_used_after)
    return shape, res, tx.sender(), tx.to, miner, pi


def _kernel(con, decode_tx, cb, gi, kshape):
    shape, res, sender, to, miner, pi = _statement(con, decode_tx, cb, gi)
    bw = cb.build_contract_binding_witness(gi, res.pi_words, shape, sender, to, miner, pi,
                                           kshape)
    return pi, bw, cb.build_contract_kernel(len(bw.slots), kshape, pi, bw)


@pytest.mark.parametrize("kw", [{}, dict(amount=101, sender_tokens=100)])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_contract_binding_kernel_equals_reference(shape, kw):
    j_gi, t_gi = _witnesses(**kw)
    j_pi, j_bw, want = _kernel(jcon, j_decode_tx, jcb, j_gi, SHAPES[shape][0])
    t_pi, t_bw, got = _kernel(tcon, t_decode_tx, tcb, t_gi, SHAPES[shape][1])
    assert t_pi == j_pi
    assert len(t_bw.slots) == len(j_bw.slots)
    assert [dataclasses.astuple(i) for i in got.prog] == [dataclasses.astuple(i) for i in want.prog]
    assert got.witness == want.witness
    assert [(r.ctx, r.seg, r.virt, r.ts, r.message, r.staged) for r in got.hash_requests()] == [
        (r.ctx, r.seg, r.virt, r.ts, r.message, r.staged) for r in want.hash_requests()]
    assert tall.kernel_counts(got.prog, got.hash_requests()) == jall.kernel_counts(
        want.prog, want.hash_requests())
    # the program alone (the verifier's rebuild) is the same program
    assert tcb.build_contract_kernel(len(t_bw.slots), SHAPES[shape][1]).prog == got.prog


def _unproved(con, decode_tx, gi, pi_edit=None):
    shape, _, res = con.machine_inputs_for_tx(gi)
    tx = decode_tx(gi.signed_txn)
    pi = list(res.pi_words)
    if pi_edit is not None:
        pi_edit(shape.pi_layout, pi)
    return con.ContractCallProof(multi=None, shape=shape, machine_pi=pi, gen_inputs=gi,
                                 sender=tx.sender(), to=tx.to,
                                 miner=gi.block_metadata.block_beneficiary,
                                 gas_used=gi.gas_used_after)


def _forge_post(lay, pi):
    pi[lay["storage"] + 3] += 1  # extra tokens out of thin air (vpost)


def _forge_log(lay, pi):
    pi[lay["log_words"][0] + 3] += 1  # the Transfer event's amount


BINDING_CASES = {
    "honest": ({}, None, True),
    "reverted": (dict(amount=101, sender_tokens=100), None, True),
    "wrong_root": (dict(tamper_root=True), None, False),
    "forged_post_balance": ({}, _forge_post, False),
    "forged_log_amount": ({}, _forge_log, False),
}


@pytest.mark.parametrize("case", list(BINDING_CASES))
def test_check_contract_binding_agrees_with_reference(case):
    kw, edit, accept = BINDING_CASES[case]
    j_gi, t_gi = _witnesses(**kw)
    assert jcon.check_contract_binding(_unproved(jcon, j_decode_tx, j_gi, edit)) is accept
    assert tcon.check_contract_binding(_unproved(tcon, t_decode_tx, t_gi, edit)) is accept


def test_contract_call_to_numpy_carries_the_statement_to_the_reference():
    """`interop.contract_call_to_numpy` of a port ContractCallProof (here
    without its multi-proofs) rebuilds the reference's statement: its
    EvmShape, PI words and parties pass the reference's
    `check_contract_binding` on the reference's copy of the witness."""
    from ethproof_tpu.tables.evm import EvmShape as JEvmShape
    from ethproof_tpu_torch.interop import contract_call_to_numpy

    j_gi, t_gi = _witnesses()
    d = contract_call_to_numpy(_unproved(tcon, t_decode_tx, t_gi))
    assert d["multi"] is None and d["binding_multi"] is None and d["inner_frames"] == []
    shape = JEvmShape(**{k: tuple(map(tuple, v)) if k == "log_shapes" else v
                         for k, v in d["shape"].items()})
    assert shape == jcon.machine_inputs_for_tx(j_gi)[0]
    proof = jcon.ContractCallProof(multi=None, shape=shape, machine_pi=d["machine_pi"],
                                   gen_inputs=j_gi, sender=d["sender"], to=d["to"],
                                   miner=d["miner"], gas_used=d["gas_used"])
    assert jcon.check_contract_binding(proof)


class _Fitted(Exception):
    """Raised by the stubbed provers once the sizes are known."""


def _fitted_sizes(con, all_mod, gi, monkeypatch):
    """(machine sizes, binding sizes) that `prove_contract_call` fits for
    `gi` in the default "auto" mode: its provers are stubbed to record
    their sizes, and the second stops the call before any proving."""
    seen = []

    def machine(machine, res, sizes, config, *args, **kw):
        seen.append(vars(sizes))

    def binding(cpu, pi, sizes, config, *args, **kw):
        seen.append(vars(sizes))
        raise _Fitted

    monkeypatch.setattr(all_mod, "prove_evm_tables", machine)
    monkeypatch.setattr(all_mod, "prove_all_tables", binding)
    with pytest.raises(_Fitted):
        con.prove_contract_call(gi, None, **({} if con is jcon else {"device": "cpu"}))
    return seen


@pytest.mark.parametrize("witness", [
    "small", 50, pytest.param(1000, marks=pytest.mark.slow)])
def test_fitted_sizes_equal_reference(monkeypatch, witness):
    """`seeded_erc20_transfer(n, n, 5)`: n = 1,000 is the full-width
    witness of the card run (1,000 accounts and 1,000 token holders; the
    reference's binding witness alone takes about a minute of host keccak
    on the CPU, so that case is slow); both fit the binding kernel at
    PRODUCTION_SHAPE."""
    t_gi = (synthetic.small_erc20_transfer() if witness == "small"
            else synthetic.seeded_erc20_transfer(witness, witness, 5))
    j_gi = JGenerationInputs.from_json(t_gi.to_json())
    want = _fitted_sizes(jcon, jall, j_gi, monkeypatch)
    got = _fitted_sizes(tcon, tall, t_gi, monkeypatch)
    assert got == want
    assert got[0] == dict(cpu=10, arithmetic=16, logic=5, bytepacking=9, memory=13, keccak=7,
                          keccak_sponge=8)
    if witness == 1000:
        assert got[1] == dict(cpu=16, arithmetic=16, logic=10, bytepacking=9, memory=18,
                              keccak=12, keccak_sponge=8)


def test_tx_proof_dispatches_as_the_reference(monkeypatch):
    """A transfer goes to `prove_transfer` and a contract call to
    `prove_contract_call` (binding "auto"; a CircuitConfig leaves the
    machine's sizes to the fit), in both packages; a padding dummy is a
    host-checked DummyProof; with a recursion state (a stub here) the
    binding and sizes follow the state and the leaf carries its root proof;
    the provers' deterministic failures become FatalError."""
    from ethproof_tpu_torch.runtime.prover_state import CircuitConfig
    from test_transfer_e2e import make_transfer_witness

    calls = []
    monkeypatch.setattr(tops, "prove_transfer",
                        lambda gi, config, sizes, binding, **kw: calls.append(
                            ("transfer", binding, sizes)) or "transfer")
    monkeypatch.setattr(tops, "prove_contract_call",
                        lambda gi, config, sizes, binding, **kw: calls.append(
                            ("contract", binding, sizes)) or "contract")
    t_transfer, t_call = synthetic.small_transfer(), synthetic.small_erc20_transfer()
    j_call = JGenerationInputs.from_json(t_call.to_json())
    assert jops._callee_has_code(j_call) and tops._callee_has_code(t_call)
    assert not jops._callee_has_code(make_transfer_witness())
    assert not tops._callee_has_code(t_transfer)
    assert tops.tx_proof(t_transfer, None, CircuitConfig(), device="cpu") == "transfer"
    assert tops.tx_proof(t_call, None, CircuitConfig(), device="cpu") == "contract"
    sizes = tall.TableSizes(cpu=10)
    assert tops.tx_proof(t_call, None, sizes, device="cpu") == "contract"
    assert [c[:2] for c in calls] == [("transfer", "auto"), ("contract", "auto"),
                                      ("contract", "auto")]
    assert isinstance(calls[0][2], CircuitConfig) and calls[1][2] is None
    assert calls[2][2] is sizes
    dummy = tops.tx_proof(dataclasses.replace(t_call, signed_txn=None,
                                              gas_used_after=t_call.gas_used_before),
                          None, device="cpu")
    assert isinstance(dummy, tops.DummyProof) and not tops.verify_dummy(dummy)

    # with a recursion state: a transfer's binding is the state's shape, a
    # contract call runs at the state's sizes with no binding, and each
    # multi-proof is replaced by its root proof at the state's variant
    class Root:
        def prove(self, multi, seam, config, device, times):
            roots.append((multi, seam))
            return types.SimpleNamespace(variant=None)

    class State:
        root_log_n, sizes, binding_shape = 16, tall.TableSizes(cpu=5), "shape"

        def root(self, overlap):
            return Root()

        def evm_root(self, shape):
            return Root()

        def variant_of(self, overlap):
            return ("transfer", overlap)

        def variant_of_evm(self, shape):
            return ("evm", shape)

    roots = []
    monkeypatch.setattr(tops, "prove_transfer",
                        lambda gi, config, sizes, binding, **kw: calls.append(
                            ("transfer", binding, sizes)) or types.SimpleNamespace(
                                overlap="distinct", multi="transfer multi"))
    monkeypatch.setattr(tops, "prove_contract_call",
                        lambda gi, config, sizes, binding, **kw: calls.append(
                            ("contract", binding, sizes)) or types.SimpleNamespace(
                                shape="evm shape", multi="evm multi"))
    state = State()
    leaf = tops.tx_proof(t_transfer, None, CircuitConfig(), recursion=state, device="cpu")
    assert calls[-1][:2] == ("transfer", "shape")
    assert leaf.multi is None and leaf.root_proof.variant == ("transfer", "distinct")
    leaf = tops.tx_proof(t_call, None, CircuitConfig(), recursion=state, device="cpu")
    assert calls[-1] == ("contract", None, state.sizes)
    assert leaf.multi is None and leaf.root_proof.variant == ("evm", "evm shape")
    assert [m for m, _ in roots] == ["transfer multi", "evm multi"]
    assert [seam for _, seam in roots] == [troot.tx_seam(t_transfer), troot.tx_seam(t_call)]

    def fails(*args, **kw):
        raise AssertionError("witness binding failed")

    monkeypatch.setattr(tops, "prove_contract_call", fails)
    with pytest.raises(tops.FatalError):
        tops.tx_proof(t_call, None, device="cpu")


def _dummies(pkg_types, gi_cls):
    """Two chained padding dummies over the CPU-tier transfer's state, and
    one whose gas does not continue the chain."""
    base = synthetic.small_transfer()
    root = base.tries.state_trie.hash()
    d = []
    for gas in (0, 0, 5):
        t_gi = dataclasses.replace(base, signed_txn=None, gas_used_before=gas,
                                   gas_used_after=gas)
        t_gi.trie_roots_after = dataclasses.replace(t_gi.trie_roots_after, state_root=root)
        gi = t_gi if gi_cls is None else gi_cls.from_json(t_gi.to_json())
        d.append(pkg_types.DummyProof(gen_inputs=gi))
    return d


@pytest.mark.parametrize("pkg", ["j", "t"])
def test_aggregation_chains_and_refuses_a_broken_seam(pkg):
    ops, gi_cls = (jops, JGenerationInputs) if pkg == "j" else (tops, None)
    device = {} if pkg == "j" else {"device": "cpu"}
    a, b, broken = _dummies(ops, gi_cls)
    agg = ops.agg_combine(a, b)
    (tb, _, gb, _, rb, _), (_, ta, _, ga, _, ra) = ops.public_data(a), ops.public_data(b)
    assert ops.public_data(agg) == (tb, ta, gb, ga, rb, ra)
    block = ops.block_proof(agg)
    assert ops.verify_block(block, None, **device)
    child = ops.block_proof(ops.agg_combine(b, a), block)
    assert ops.verify_block(child, None, **device)
    with pytest.raises(ops.FatalError):
        ops.agg_combine(a, broken)
    bad_parent = dataclasses.replace(block, state_root_after=b"\x01" * 32)
    with pytest.raises(ops.FatalError):
        ops.block_proof(ops.agg_combine(b, a), bad_parent)


@pytest.mark.slow
def test_contract_call_proof_verifies_and_rejects_a_forged_storage_word():
    """The CPU tier's ERC-20 call through `prove_contract_call` on the CPU
    (machine proof at the fitted sizes, binding proof with its 2^16-row
    Arithmetic table): `verify_contract_call` accepts it and rejects it
    with one storage PI word changed."""
    from test_torch_stark import T_CFG

    gi = synthetic.small_erc20_transfer()
    proof = tcon.prove_contract_call(gi, T_CFG, device="cpu")
    assert proof.binding_multi is not None and proof.cb_kshape == T_PRODUCTION
    assert tcon.verify_contract_call(proof, T_CFG, device="cpu")
    proof.machine_pi[proof.shape.pi_layout["storage"] + 7] += 1
    assert not tcon.verify_contract_call(proof, T_CFG, device="cpu")


def test_router_call_frames_equal_reference():
    """tests/test_inner_frames.py's router witness (EOA -> router -> ERC-20):
    the outer and inner frames' shapes and runs equal the reference's
    (`machine_inputs_for_tx` with `frames_out`), and both packages'
    `check_contract_binding` accept the statement with its inner frame."""
    from ethproof_tpu_torch.witness.types import GenerationInputs as TGenerationInputs
    from test_inner_frames import make_router_witness
    from test_torch_evm import assert_run_equals_reference

    j_gi = make_router_witness()
    t_gi = TGenerationInputs.from_json(j_gi.to_json())
    frames = {"j": [], "t": []}
    runs = {}
    for key, con, decode_tx, gi in (("j", jcon, j_decode_tx, j_gi), ("t", tcon, t_decode_tx, t_gi)):
        shape, _, res = con.machine_inputs_for_tx(gi, frames_out=frames[key])
        tx = decode_tx(gi.signed_txn)
        inner = [con.InnerFrameProof(address=f.address, shape=f.shape,
                                     machine_pi=list(f.result.pi_words)) for f in frames[key]]
        proof = con.ContractCallProof(
            multi=None, shape=shape, machine_pi=list(res.pi_words), gen_inputs=gi,
            sender=tx.sender(), to=tx.to, miner=gi.block_metadata.block_beneficiary,
            gas_used=gi.gas_used_after, inner_frames=inner)
        assert con.check_contract_binding(proof)
        runs[key] = (shape, res)
    assert dataclasses.asdict(runs["t"][0]) == dataclasses.asdict(runs["j"][0])
    assert_run_equals_reference(runs["t"][1], runs["j"][1])
    assert len(frames["t"]) == len(frames["j"]) == 1
    for tf, jf in zip(frames["t"], frames["j"]):
        assert tf.address == jf.address
        assert dataclasses.asdict(tf.shape) == dataclasses.asdict(jf.shape)
        assert_run_equals_reference(tf.result, jf.result)

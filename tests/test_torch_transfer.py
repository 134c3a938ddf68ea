"""The transfer proof: the port vs the JAX package.

The CPU-tier transfer of tests/test_transfer_e2e.py (`make_transfer_witness()`
with its defaults, `SIZES` for five tables and `SIZES7` for seven, `CFG`) is
built with each package's own constructors (the port's:
`witness.synthetic.small_transfer`). Not slow: the port's five-table proof
passes the JAX `verify_transfer` (through `interop`) and the port's own, and
a flipped opening fails both; the binding modes raise as the reference's
do. Marked `slow`: the same for the seven-table proof (about 5 min on one
thread beside five other workers, with cold caches), and (the reference's
proof takes half an hour and more on the CPU) the port's proofs equal the
JAX `prove_transfer`'s in every field under both NTT encodings, and a proof
with the in-circuit binding passes the JAX `verify_transfer` while a
flipped post state root fails its `verify_all_tables`.

As in tests/test_torch_stark.py, the reference's base-field inverse runs
un-jitted (`_inv_jit` set to `_inv_impl`): the values are identical and
the XLA:CPU compile of the jitted chain is skipped.
"""

import copy

import pytest
import torch

from ethproof_tpu.evm import binding as jbind
from ethproof_tpu.evm import transfer as jtr
from ethproof_tpu.gf import field as jgf
from ethproof_tpu.stark.multi import MultiProof as JMultiProof
from ethproof_tpu.tables import all as jall
from ethproof_tpu.tables.all import TableSizes as JTableSizes
from ethproof_tpu_torch.evm import binding as tbind
from ethproof_tpu_torch.evm import transfer as ttr
from ethproof_tpu_torch.fri.config import FriConfig as TFriConfig
from ethproof_tpu_torch.fri.config import StarkConfig as TStarkConfig
from ethproof_tpu_torch.interop import multi_proof_to_numpy, tx_proof_to_numpy
from ethproof_tpu_torch.poly import base_dft as tbd
from ethproof_tpu_torch.tables.all import TableSizes as TTableSizes
from ethproof_tpu_torch.witness import synthetic
from test_torch_stark import assert_same, to_reference
from test_transfer_e2e import CFG, SIZES, SIZES7, make_transfer_witness

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

T_CFG = TStarkConfig(num_challenges=2, fri_config=TFriConfig(
    rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
    arity_bits=2, final_poly_bits=2))
T_SIZES = TTableSizes(cpu=5, arithmetic=6, logic=4, bytepacking=9, memory=7, keccak=None)
T_SIZES7 = TTableSizes(cpu=5, arithmetic=6, logic=4, bytepacking=9, memory=7)
# the reference's bound-proof test (tests/test_binding.py:143): one account
# (all parties equal), two trie levels
BOUND_KW = dict(miner_is_sender=True, recipient_is_sender=True, gas_price=1, sender_bal=30000)
BOUND_SIZES = dict(cpu=12, arithmetic=16, logic=6, bytepacking=9, memory=14, keccak=8,
                   keccak_sponge=8)


@pytest.fixture
def four_threads():
    """The slow tests run alone (--runslow): give the port's proofs four
    intra-op threads, then restore the suite's one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def _to_reference_tx(got, j_gi):
    d = tx_proof_to_numpy(got)
    shape = d["binding_shape"]
    return jtr.TxProof(
        multi=JMultiProof(proofs=[to_reference(p) for p in d["multi"]]),
        pi_words=d["pi_words"], gen_inputs=j_gi,
        sender=d["sender"], recipient=d["recipient"], miner=d["miner"],
        binding_shape=None if shape is None else jbind.KernelShape(**shape),
    )


@pytest.mark.parametrize("tables", [5, pytest.param(7, marks=pytest.mark.slow)])
def test_transfer_proof_verifies_under_both_verifiers(tables):
    """The port's CPU-tier proof (five tables, or seven with the Keccak pair
    and the binding dropped by the cpu < 2^11 pre-guard) passes the
    reference's host `verify_transfer` and the port's own; a flipped opening
    in the first table fails both. No reference proof is made."""
    j_gi = make_transfer_witness()
    got = ttr.prove_transfer(synthetic.small_transfer(), T_CFG,
                             T_SIZES if tables == 5 else T_SIZES7, device="cpu")
    assert len(got.multi.proofs) == tables and got.binding_shape is None
    assert jtr.verify_transfer(_to_reference_tx(got, j_gi), CFG)
    assert ttr.verify_transfer(got, T_CFG, device="cpu")
    bad = copy.deepcopy(got)
    bad.multi.proofs[0].openings.trace_at_zeta[3, 0] ^= 1
    assert not ttr.verify_transfer(bad, T_CFG, device="cpu")
    assert not jtr.verify_transfer(_to_reference_tx(bad, j_gi), CFG)


@pytest.mark.slow
def test_transfer_proof_equals_reference_and_verifies(monkeypatch, four_threads):
    """One test, so that the reference proof is made once per run."""
    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    j_gi = make_transfer_witness()
    t_gi = synthetic.small_transfer()
    want = jtr.prove_transfer(j_gi, CFG, SIZES, binding=None)
    monkeypatch.setattr(tbd, "ENCODING", "i8")
    got = ttr.prove_transfer(t_gi, T_CFG, T_SIZES, device="cpu")

    # every table proof, the PI words and the parties equal the reference's
    assert len(got.multi.proofs) == len(want.multi.proofs) == 5
    assert_same(tx_proof_to_numpy(got), tx_proof_to_numpy(want))

    # accepted by the reference verifier and by the port's own
    assert jtr.verify_transfer(_to_reference_tx(got, j_gi), CFG)
    assert ttr.verify_transfer(got, T_CFG, device="cpu")

    # a flipped opening in one table fails both
    bad = copy.deepcopy(got)
    bad.multi.proofs[1].openings.trace_at_zeta[3, 0] ^= 1
    assert not ttr.verify_transfer(bad, T_CFG, device="cpu")
    assert not jtr.verify_transfer(_to_reference_tx(bad, j_gi), CFG)

    # the bf16 encoding gives the same proof, bit for bit
    monkeypatch.setattr(tbd, "ENCODING", "bf16")
    got16 = ttr.prove_transfer(t_gi, T_CFG, T_SIZES, device="cpu")
    assert_same(multi_proof_to_numpy(got16.multi), multi_proof_to_numpy(want.multi))


def test_tampered_post_balance_is_rejected():
    """Port only, no proving: a post root that credits the recipient one
    extra wei fails the host trie binding, and PI words claiming that wei
    make the kernel's own assertion fail."""
    gi = synthetic.small_transfer(recipient_post_extra=1)
    pi, sender, recipient, miner = ttr.derive_pi_words(gi)
    stub = ttr.TxProof(multi=None, pi_words=pi, gen_inputs=gi, sender=sender,
                       recipient=recipient, miner=miner)
    assert not ttr.check_trie_binding(stub)
    assert not ttr.verify_transfer(stub, T_CFG, device="cpu")
    good = synthetic.small_transfer()
    pi, sender, recipient, miner = ttr.derive_pi_words(good)
    assert ttr.check_trie_binding(ttr.TxProof(None, pi, good, sender, recipient, miner))
    pi[ttr.PI_RECV_BAL_POST] += 1
    with pytest.raises(AssertionError):
        from ethproof_tpu_torch.tables.cpu import execute

        kasm = ttr.build_kernel(ttr.overlap_pattern(sender, recipient, miner), None, pi)
        execute(kasm.prog, pi, 1 << T_SIZES.cpu, witness=kasm.witness)


def test_pi_words_equal_reference():
    """derive_pi_words on the same transfer, built by each package."""
    want = jtr.derive_pi_words(make_transfer_witness())
    assert ttr.derive_pi_words(synthetic.small_transfer()) == want


@pytest.mark.slow
def test_seven_table_proof_equals_reference(monkeypatch, four_threads):
    """The seven-table CPU-tier proof (`SIZES7`, default binding "auto",
    which the cpu < 2^11 pre-guard drops) equals the reference's table by
    table, field for field, under both NTT encodings."""
    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    want = jtr.prove_transfer(make_transfer_witness(), CFG, SIZES7)
    assert want.binding_shape is None and len(want.multi.proofs) == 7
    for encoding in ("i8", "bf16"):
        monkeypatch.setattr(tbd, "ENCODING", encoding)
        got = ttr.prove_transfer(synthetic.small_transfer(), T_CFG, T_SIZES7, device="cpu")
        assert_same(tx_proof_to_numpy(got), tx_proof_to_numpy(want))


@pytest.mark.slow
def test_bound_transfer_passes_reference_verifier(monkeypatch, four_threads):
    """The port's proof with the in-circuit binding, at the reference
    test's shape and sizes, passes the reference's `verify_transfer`; with
    the post state root flipped the reference's `verify_all_tables`
    rejects it on its own (no host trie check)."""
    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    shape = tbind.KernelShape(levels=2, node_words=10)
    got = ttr.prove_transfer(synthetic.small_transfer(**BOUND_KW), T_CFG,
                             TTableSizes(**BOUND_SIZES), binding=shape, device="cpu")
    assert got.binding_shape == shape and len(got.multi.proofs) == 7
    ref = _to_reference_tx(got, make_transfer_witness(**BOUND_KW))
    assert jtr.verify_transfer(ref, CFG)
    cpu = jtr.transfer_cpu_stark(ref.overlap, ref.binding_shape)
    bad_pi = list(ref.pi_words)
    bad_pi[jtr.PI_STATE_ROOT_POST] ^= 1
    assert jall.verify_all_tables(cpu, ref.pi_words, ref.multi, CFG)
    assert not jall.verify_all_tables(cpu, bad_pi, ref.multi, CFG)


MODES = {
    # (binding, port sizes, reference sizes, the exception both raise)
    "bad_mode": ("exact", T_SIZES, SIZES, ValueError),
    "require_without_keccak": ("require", T_SIZES, SIZES, AssertionError),
    "tight_shape": ("tight", T_SIZES7, SIZES7, None),
}


@pytest.mark.parametrize("case", MODES)
def test_prove_transfer_refuses_what_is_not_ported(case):
    """The binding modes that cannot prove raise before any proof, as the
    reference's do: an unknown mode (ValueError), "require" without the
    Keccak pair (AssertionError), and a KernelShape the witness does not
    fit (Unsupported)."""
    binding, t_sizes, j_sizes, exc = MODES[case]
    j_binding = t_binding = binding
    j_exc = t_exc = exc
    if binding == "tight":  # depth-2 paths do not fit one level
        j_binding = jbind.KernelShape(levels=1, node_words=10)
        t_binding = tbind.KernelShape(levels=1, node_words=10)
        j_exc, t_exc = jbind.Unsupported, tbind.Unsupported
    with pytest.raises(j_exc):
        jtr.prove_transfer(make_transfer_witness(), CFG, j_sizes, binding=j_binding)
    with pytest.raises(t_exc):
        ttr.prove_transfer(synthetic.small_transfer(), T_CFG, t_sizes, binding=t_binding,
                           device="cpu")


def test_seeded_transfer_fits_the_production_floors():
    """The full-width configuration's witness (a seeded EIP-1559 transfer,
    here over 50 accounts): its PI words re-derive, its post root binds,
    and TableSizes.fit of its kernel's counts under the reference's default
    CircuitConfig ranges (ethproof_tpu/runtime/prover_state.py:26-34) gives
    the slice's sizes, as the reference's own fit does."""
    from ethproof_tpu.runtime.prover_state import CircuitConfig
    from ethproof_tpu.tables.all import TableSizes as JTableSizes

    from ethproof_tpu_torch.tables.all import kernel_counts

    gi = synthetic.seeded_transfer(50, seed=5)
    pi, s, r, m = ttr.derive_pi_words(gi)
    assert pi[ttr.PI_FEE] > pi[ttr.PI_TIP] > 0 and pi[ttr.PI_VALUE] > 10**18
    assert ttr.check_trie_binding(ttr.TxProof(None, pi, gi, s, r, m))
    kasm = ttr.build_kernel(ttr.overlap_pattern(s, r, m), None, pi)
    counts = kernel_counts(kasm.prog, kasm.hash_requests())
    fitted = TTableSizes.fit(CircuitConfig(), counts, with_keccak=False)
    assert fitted.degree_bits(with_keccak=False) == [12, 16, 12, 9, 17]
    assert fitted.keccak is None
    want = JTableSizes.fit(CircuitConfig(), counts, with_keccak=False)
    assert vars(fitted) == vars(want)

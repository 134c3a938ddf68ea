"""The five-table transfer proof: the port vs the JAX package, field for field.

The CPU-tier transfer of tests/test_transfer_e2e.py (`make_transfer_witness()`
with its defaults, `SIZES`, `CFG`) is built with each package's own
constructors (the port's: `witness.synthetic.small_transfer`). The JAX
`prove_transfer(..., binding=None)` is made once per run, inside one test:
every table proof of the port must equal it in every field, under both NTT
encodings; the port's proof must pass the JAX
`verify_transfer` (through `interop`) and the port's own, and a flipped
opening must fail both. Cheaper port-only tests follow.

As in tests/test_torch_stark.py, the reference's base-field inverse runs
un-jitted (`_inv_jit` set to `_inv_impl`): the values are identical and
the XLA:CPU compile of the jitted chain is skipped.
"""

import copy

import pytest
import torch

from ethproof_tpu.evm import transfer as jtr
from ethproof_tpu.gf import field as jgf
from ethproof_tpu.stark.multi import MultiProof as JMultiProof
from ethproof_tpu_torch.evm import transfer as ttr
from ethproof_tpu_torch.fri.config import FriConfig as TFriConfig
from ethproof_tpu_torch.fri.config import StarkConfig as TStarkConfig
from ethproof_tpu_torch.interop import multi_proof_to_numpy, tx_proof_to_numpy
from ethproof_tpu_torch.poly import base_dft as tbd
from ethproof_tpu_torch.tables.all import TableSizes as TTableSizes
from ethproof_tpu_torch.witness import synthetic
from test_torch_stark import assert_same, to_reference
from test_transfer_e2e import CFG, SIZES, make_transfer_witness

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

T_CFG = TStarkConfig(num_challenges=2, fri_config=TFriConfig(
    rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
    arity_bits=2, final_poly_bits=2))
T_SIZES = TTableSizes(cpu=5, arithmetic=6, logic=4, bytepacking=9, memory=7, keccak=None)


def _to_reference_tx(got, j_gi):
    d = tx_proof_to_numpy(got)
    return jtr.TxProof(
        multi=JMultiProof(proofs=[to_reference(p) for p in d["multi"]]),
        pi_words=d["pi_words"], gen_inputs=j_gi,
        sender=d["sender"], recipient=d["recipient"], miner=d["miner"],
    )


def test_transfer_proof_equals_reference_and_verifies(monkeypatch):
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

        kasm = ttr.build_kernel(ttr.overlap_pattern(sender, recipient, miner), pi)
        execute(kasm.prog, pi, 1 << T_SIZES.cpu, witness=kasm.witness)


def test_pi_words_equal_reference():
    """derive_pi_words on the same transfer, built by each package."""
    want = jtr.derive_pi_words(make_transfer_witness())
    assert ttr.derive_pi_words(synthetic.small_transfer()) == want


@pytest.mark.parametrize("binding", ["auto", "require", object()])
def test_prove_transfer_refuses_what_is_not_ported(binding):
    gi = synthetic.small_transfer()
    with pytest.raises(NotImplementedError):
        ttr.prove_transfer(gi, T_CFG, T_SIZES, binding=binding, device="cpu")
    with pytest.raises(NotImplementedError):
        ttr.prove_transfer(gi, T_CFG, TTableSizes(), device="cpu")  # keccak pair on


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
    kasm = ttr.build_kernel(ttr.overlap_pattern(s, r, m), pi)
    counts = kernel_counts(kasm.prog, kasm.hash_requests())
    fitted = TTableSizes.fit(CircuitConfig(), counts, with_keccak=False)
    assert fitted.degree_bits(with_keccak=False) == [12, 16, 12, 9, 17]
    assert fitted.keccak is None
    want = JTableSizes.fit(CircuitConfig(), counts, with_keccak=False)
    assert vars(fitted) == vars(want)

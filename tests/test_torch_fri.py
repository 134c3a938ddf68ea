"""Port FRI prover vs the JAX package: every FriProof field equal."""

import numpy as np
import torch

from ethproof_tpu.fri import prove as jfri
from ethproof_tpu.fri.challenger import Challenger as JChallenger
from ethproof_tpu.fri.config import FriConfig as JFriConfig
from ethproof_tpu.gf import extension as jgf2
from ethproof_tpu.gf import field as jgf
from ethproof_tpu.poly import ntt as jntt
from ethproof_tpu_torch.fri import prove as tfri
from ethproof_tpu_torch.fri.challenger import Challenger as TChallenger
from ethproof_tpu_torch.fri.config import FriConfig as TFriConfig
from ethproof_tpu_torch.fri.verify import fri_verify
from ethproof_tpu_torch.gf import extension as tgf2
from ethproof_tpu_torch.gf import field as tgf

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

P = jgf.P
# tests/test_fri.py's configuration and size, so compiled JAX programs are shared
KW = dict(rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=16,
          arity_bits=2, final_poly_bits=2)
DEGREE_BITS = 6


def _codeword():
    rng = np.random.default_rng(3)
    n = 1 << DEGREE_BITS
    ca = rng.integers(0, P, size=(n,), dtype=np.uint64)
    cb = rng.integers(0, P, size=(n,), dtype=np.uint64)
    ev_a = jgf.to_u64(jntt.coset_lde(jgf.from_u64(ca), 2, 7))
    ev_b = jgf.to_u64(jntt.coset_lde(jgf.from_u64(cb), 2, 7))
    return ev_a, ev_b


def test_fri_prove_matches_jax_field_for_field():
    ev_a, ev_b = _codeword()
    want = jfri.fri_prove(jgf2.GF2(jgf.from_u64(ev_a), jgf.from_u64(ev_b)), DEGREE_BITS,
                          JFriConfig(**KW), JChallenger())
    code = tgf2.GF2(tgf.from_u64(ev_a, "cpu"), tgf.from_u64(ev_b, "cpu"))
    got = tfri.fri_prove(code, DEGREE_BITS, TFriConfig(**KW), TChallenger())
    assert len(got.commit_caps) == len(want.commit_caps)
    for g, w in zip(got.commit_caps, want.commit_caps):
        np.testing.assert_array_equal(g, w)
    assert len(got.query_rounds) == len(want.query_rounds)
    for g, w in zip(got.query_rounds, want.query_rounds):
        np.testing.assert_array_equal(g.leaf_values, w.leaf_values)
        np.testing.assert_array_equal(g.merkle_paths, w.merkle_paths)
    np.testing.assert_array_equal(got.final_poly, w_fp := want.final_poly)
    assert got.final_poly.dtype == w_fp.dtype
    assert got.pow_witness == want.pow_witness
    assert got.degree_bits == want.degree_bits
    np.testing.assert_array_equal(got.query_indices, want.query_indices)
    ok, _ = fri_verify(got, TFriConfig(**KW), TChallenger())
    assert ok


def test_grind_pow_returns_the_same_witness():
    for challenge, bits in ((123456789, 6), (P - 5, 3)):
        assert tfri.grind_pow(challenge, bits, device="cpu") == jfri.grind_pow(challenge, bits)
        # the smallest witness, whatever the batch
        assert tfri.grind_pow(challenge, bits, batch=7, device="cpu") == jfri.grind_pow(challenge, bits)


def test_stark_without_folding_rounds_verifies_in_the_port():
    """A table of 2^5 rows under `standard_fast_config` (final_poly_bits 5):
    FRI has no folding round and its final polynomial is the composition's.
    The port's verifier checks that polynomial against the oracles'
    openings at every query, accepts the honest proof and rejects one with
    a final coefficient or a trace opening changed; the reference's
    verifier rejects even the honest proof (it compares the final
    polynomial with a fold that no round made: ROADMAP Queue 3). The
    contract path's machine proof has such a table (Logic at 2^5)."""
    from ethproof_tpu.stark.verify import stark_verify as j_stark_verify
    from ethproof_tpu.fri.config import standard_fast_config as j_standard_fast_config
    from ethproof_tpu.tables import memory as jmem
    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.interop import proof_to_numpy
    from ethproof_tpu_torch.stark.prove import stark_prove
    from ethproof_tpu_torch.stark.verify import stark_verify
    from ethproof_tpu_torch.tables import memory as tmem
    from test_torch_stark import OPS, to_reference

    config = standard_fast_config()
    trace = tmem.generate_trace([tmem.MemoryOp(*op) for op in OPS], 32)
    proof = stark_prove(tmem.MemoryStark(), trace, [], config, device="cpu")
    assert config.fri_config.reduction_arity_bits(5) == []
    assert stark_verify(tmem.MemoryStark(), proof, config, device="cpu")
    assert not j_stark_verify(jmem.MemoryStark(), to_reference(proof_to_numpy(proof)),
                              j_standard_fast_config())
    proof.fri_proof.final_poly[3, 0] ^= 1
    assert not stark_verify(tmem.MemoryStark(), proof, config, device="cpu")
    proof.fri_proof.final_poly[3, 0] ^= 1
    proof.trace_query_openings.values[0, 6] ^= 1
    assert not stark_verify(tmem.MemoryStark(), proof, config, device="cpu")

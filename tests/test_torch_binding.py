"""The in-circuit MPT binding: the port's `evm/binding` vs the JAX package.

On the witnesses of tests/test_binding.py (the CPU-tier transfer under each
of the five party-overlap patterns, `KernelShape(levels=3, node_words=10)`):
the binding witness, the bound kernel's program (instruction for
instruction), its witness stream and its hash requests, and the CPU trace
its execution gives, equal the reference's. A too-tight shape raises
`Unsupported` in both packages; a tampered node, balance or root fails the
kernel's assertions in both. Under `PRODUCTION_SHAPE` the bound kernel of a
seeded 50-account transfer has the reference's table counts and fitted
sizes. Exact equality throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ethproof_tpu.evm import binding as jbd
from ethproof_tpu.evm import transfer as jtr
from ethproof_tpu.runtime.prover_state import CircuitConfig as JCircuitConfig
from ethproof_tpu.tables import all as jall
from ethproof_tpu.tables import cpu as jcpu
from ethproof_tpu.witness.types import GenerationInputs as JGenerationInputs
from ethproof_tpu_torch.evm import binding as tbd
from ethproof_tpu_torch.evm import transfer as ttr
from ethproof_tpu_torch.runtime.prover_state import CircuitConfig
from ethproof_tpu_torch.tables import all as tall
from ethproof_tpu_torch.tables import cpu as tcpu
from ethproof_tpu_torch.witness import synthetic
from test_transfer_e2e import make_transfer_witness

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

J_SHAPE = jbd.KernelShape(levels=3, node_words=10)
T_SHAPE = tbd.KernelShape(levels=3, node_words=10)
OVERLAPS = {
    "distinct": {},
    "s_eq_m": {"miner_is_sender": True},
    "s_eq_r": {"recipient_is_sender": True},
    "r_eq_m": {"miner_is_recipient": True},
    "all_eq": {"miner_is_sender": True, "recipient_is_sender": True},
}


def _setup(kw):
    """(reference, port) x (pi words, overlap, binding witness) of one witness."""
    out = []
    for tr, bd, gi, shape in ((jtr, jbd, make_transfer_witness(**kw), J_SHAPE),
                              (ttr, tbd, synthetic.small_transfer(**kw), T_SHAPE)):
        pi, s, r, m = tr.derive_pi_words(gi)
        bw = bd.build_binding_witness(gi.tries.state_trie, tr._binding_finals(gi, pi, s, r, m),
                                      shape)
        out.append((pi, tr.overlap_pattern(s, r, m), bw))
    return out


def _requests(kasm):
    return [(h.ctx, h.seg, h.virt, h.ts, h.message, h.staged) for h in kasm.hash_requests()]


def _witness(bw):
    return [(u.pre.nodes, u.pre.is_branch, u.pre.idxs, u.post.nodes, u.post.is_branch,
             u.post.idxs, u.root_pre, u.root_post) for u in bw.updates]


@pytest.mark.parametrize("name", OVERLAPS)
def test_bound_kernel_equals_reference(name):
    (j_pi, overlap, j_bw), (t_pi, t_overlap, t_bw) = _setup(OVERLAPS[name])
    assert t_pi == j_pi and t_overlap == overlap == name
    assert _witness(t_bw) == _witness(j_bw)
    assert len(t_bw.updates) == len(ttr.pi_bindings_for_overlap(overlap))
    j_k = jtr.build_kernel(overlap, J_SHAPE, j_pi, j_bw)
    t_k = ttr.build_kernel(overlap, T_SHAPE, t_pi, t_bw)
    assert [dataclasses.astuple(i) for i in t_k.prog] == [dataclasses.astuple(i) for i in j_k.prog]
    assert t_k.witness == j_k.witness
    assert _requests(t_k) == _requests(j_k)
    # the program is a function of (overlap, shape) alone
    assert ([dataclasses.astuple(i) for i in ttr.build_kernel(overlap, T_SHAPE).prog]
            == [dataclasses.astuple(i) for i in t_k.prog])
    n = 1 << (len(j_k.prog) - 1).bit_length()
    want = jcpu.execute(j_k.prog, j_pi, n, witness=j_k.witness)
    got = tcpu.execute(t_k.prog, t_pi, n, witness=t_k.witness)
    np.testing.assert_array_equal(got.trace, want.trace)
    assert got.arith_requests == want.arith_requests
    assert got.logic_requests == want.logic_requests


def test_too_tight_shape_is_unsupported_in_both():
    tight = {"j": jbd.KernelShape(levels=1, node_words=10),
             "t": tbd.KernelShape(levels=1, node_words=10)}  # depth-2 paths don't fit
    for key, tr, bd, gi in (("j", jtr, jbd, make_transfer_witness()),
                            ("t", ttr, tbd, synthetic.small_transfer())):
        pi, s, r, m = tr.derive_pi_words(gi)
        with pytest.raises(bd.Unsupported):
            bd.build_binding_witness(gi.tries.state_trie, tr._binding_finals(gi, pi, s, r, m),
                                     tight[key])


def _tamper(what, pi, bw):
    pi = list(pi)
    if what == "node":  # a byte inside the root node of the sender's path
        node = bytearray(bw.updates[0].pre.nodes[0])
        node[len(node) // 2] ^= 1
        bw.updates[0].pre.nodes[0] = bytes(node)
    elif what == "balance":  # sender pre balance one wei up, arithmetic consistent
        pi[1] += 1
    else:  # the claimed post state root
        pi[ttr.PI_STATE_ROOT_POST] ^= 1
    return pi, bw


@pytest.mark.parametrize("what", ["node", "balance", "root"])
def test_tampered_witness_is_rejected_in_both(what):
    (j_pi, overlap, j_bw), (t_pi, _, t_bw) = _setup({})
    j_pi, j_bw = _tamper(what, j_pi, j_bw)
    t_pi, t_bw = _tamper(what, t_pi, t_bw)
    with pytest.raises(AssertionError):
        jtr.build_kernel(overlap, J_SHAPE, j_pi, j_bw)
    with pytest.raises(AssertionError):
        ttr.build_kernel(overlap, T_SHAPE, t_pi, t_bw)


def test_production_shape_counts_and_fit_equal_reference():
    """The full-width witness's shape over 50 accounts (the 1,000-account
    one's binding witness takes half a minute of host keccak): the bound kernel's
    table counts and the default CircuitConfig's fitted sizes."""
    t_gi = synthetic.seeded_transfer(50, seed=5)
    j_gi = JGenerationInputs.from_json(t_gi.to_json())
    kernels = []
    for tr, bd, gi in ((jtr, jbd, j_gi), (ttr, tbd, t_gi)):
        pi, s, r, m = tr.derive_pi_words(gi)
        bw = bd.build_binding_witness(gi.tries.state_trie, tr._binding_finals(gi, pi, s, r, m),
                                      bd.PRODUCTION_SHAPE)
        kernels.append(tr.build_kernel(tr.overlap_pattern(s, r, m), bd.PRODUCTION_SHAPE, pi, bw))
    j_k, t_k = kernels
    want = jall.kernel_counts(j_k.prog, j_k.hash_requests())
    got = tall.kernel_counts(t_k.prog, t_k.hash_requests())
    assert got == want
    assert got["keccak"] > 0 and got["cpu"] > 1 << 15
    fitted = tall.TableSizes.fit(CircuitConfig(), got)
    assert vars(fitted) == vars(jall.TableSizes.fit(JCircuitConfig(), want))
    assert fitted.degree_bits() == [16, 16, 12, 9, 17, 14, 9]
    assert dict(CircuitConfig.from_env({"KECCAK_CIRCUIT_SIZE": "15..18"}).ranges) == dict(
        JCircuitConfig.from_env({"KECCAK_CIRCUIT_SIZE": "15..18"}).ranges)

"""A single-table STARK proof: the port vs the JAX package, field for field.

MemoryStark at 2^6 rows (the trace of tests/test_logic_memory_tables.py,
under its configuration, so compiled JAX programs are shared). The port's
proof must equal `ethproof_tpu.stark.prove.stark_prove`'s in every field,
pass the reference `stark_verify` through `interop.proof_to_numpy`, pass
the port's own verifier, and a corrupted opening must fail both.

The reference's base-field inverse is `jit(pow_const(a, P - 2))`; its
XLA:CPU compile takes minutes per new shape, so these tests run the same
chain un-jitted (`_inv_jit` set to `_inv_impl`): the values are identical.
"""

import copy

import numpy as np
import torch

from ethproof_tpu.fri import prove as jfri
from ethproof_tpu.fri.config import FriConfig as JFriConfig
from ethproof_tpu.fri.config import StarkConfig as JStarkConfig
from ethproof_tpu.gf import field as jgf
from ethproof_tpu.stark import prove as jprove
from ethproof_tpu.stark.verify import stark_verify as j_stark_verify
from ethproof_tpu.tables import memory as jmem
from ethproof_tpu_torch.fri.config import FriConfig as TFriConfig
from ethproof_tpu_torch.fri.config import StarkConfig as TStarkConfig
from ethproof_tpu_torch.interop import proof_to_numpy
from ethproof_tpu_torch.stark.prove import stark_prove as t_stark_prove
from ethproof_tpu_torch.stark.verify import stark_verify as t_stark_verify
from ethproof_tpu_torch.tables import memory as tmem

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

KW = dict(rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
          arity_bits=2, final_poly_bits=2)
J_CFG = JStarkConfig(num_challenges=2, fri_config=JFriConfig(**KW))
T_CFG = TStarkConfig(num_challenges=2, fri_config=TFriConfig(**KW))
OPS = [(0, 1, 5, 1, 0, 1234), (0, 1, 5, 2, 1, 1234), (0, 1, 7, 3, 0, 999),
       (0, 2, 0, 4, 1, 0), (0, 1, 7, 9, 1, 999)]


def to_reference(d):
    """interop dict -> the JAX package's StarkProof dataclasses."""
    f = d["fri_proof"]
    fri = jfri.FriProof(
        commit_caps=list(f["commit_caps"]),
        query_rounds=[jfri.FriQueryRound(q["leaf_values"], q["merkle_paths"])
                      for q in f["query_rounds"]],
        final_poly=f["final_poly"], pow_witness=f["pow_witness"],
        degree_bits=f["degree_bits"], query_indices=f["query_indices"],
    )

    def tree(t):
        return None if t is None else jprove.TreeOpenings(t["values"], t["paths"])

    return jprove.StarkProof(
        degree_bits=d["degree_bits"], public_inputs=list(d["public_inputs"]),
        trace_cap=d["trace_cap"], aux_cap=d["aux_cap"], quotient_cap=d["quotient_cap"],
        ctl_totals=list(d["ctl_totals"]), openings=jprove.StarkOpenings(**d["openings"]),
        fri_proof=fri,
        trace_query_openings=tree(d["trace_query_openings"]),
        aux_query_openings=tree(d["aux_query_openings"]),
        quotient_query_openings=tree(d["quotient_query_openings"]),
        fixed_query_openings=tree(d["fixed_query_openings"]),
    )


def assert_same(got, want, path="proof"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def test_memory_proof_equals_reference_and_verifies(monkeypatch):
    """One test, so that the reference proof (about two minutes of eager JAX
    on the CPU) is made once per run, whichever worker gets it."""
    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    j_trace = jmem.generate_trace([jmem.MemoryOp(*op) for op in OPS], 64)
    t_trace = tmem.generate_trace([tmem.MemoryOp(*op) for op in OPS], 64)
    np.testing.assert_array_equal(t_trace, j_trace)
    want = jprove.stark_prove(jmem.MemoryStark(), j_trace, [], J_CFG, mesh=False)
    got = t_stark_prove(tmem.MemoryStark(), t_trace, [], T_CFG, device="cpu")

    # field for field equal to the reference's proof
    assert_same(proof_to_numpy(got), proof_to_numpy(want))

    # accepted by the reference verifier and by the port's own
    assert j_stark_verify(jmem.MemoryStark(), to_reference(proof_to_numpy(got)), J_CFG)
    assert t_stark_verify(tmem.MemoryStark(), got, T_CFG, device="cpu")

    # a corrupted opening or query value fails both
    bad = copy.deepcopy(got)
    bad.openings.trace_at_zeta[3, 0] ^= 1
    assert not t_stark_verify(tmem.MemoryStark(), bad, T_CFG, device="cpu")
    assert not j_stark_verify(jmem.MemoryStark(), to_reference(proof_to_numpy(bad)), J_CFG)
    bad = copy.deepcopy(got)
    bad.trace_query_openings.values[0, 0] ^= 1
    assert not t_stark_verify(tmem.MemoryStark(), bad, T_CFG, device="cpu")
    assert not j_stark_verify(jmem.MemoryStark(), to_reference(proof_to_numpy(bad)), J_CFG)


def test_invalid_trace_fails_the_port_verifier():
    """A read that returns the wrong value: the port proves it, the port's
    verifier rejects it (port only; no reference run)."""
    ops = list(OPS)
    ops[1] = (0, 1, 5, 2, 1, 4321)
    trace = tmem.generate_trace([tmem.MemoryOp(*op) for op in ops], 64)
    proof = t_stark_prove(tmem.MemoryStark(), trace, [], T_CFG, device="cpu")
    assert not t_stark_verify(tmem.MemoryStark(), proof, T_CFG, device="cpu")


def test_device_ops_vector_api_matches_host_ext_ops():
    """fold_vec / pack_weighted of the torch DeviceOps against the host
    extension ops on base-field values (the verifier's side of them)."""
    from ethproof_tpu_torch.gf import field as tgf
    from ethproof_tpu_torch.stark.stark import DeviceOps, HostExtOps

    rng = np.random.default_rng(5)
    vals = rng.integers(0, tgf.P, size=(6, 3), dtype=np.uint64)
    dev, host = DeviceOps((3,), "cpu"), HostExtOps()
    vec = tgf.from_u64(vals, "cpu")
    alpha, weights = 0xDEADBEEF12345, [3, tgf.P - 1, 1 << 40]
    folded = tgf.to_u64(dev.fold_vec(vec, alpha))
    packed = tgf.to_u64(dev.pack_weighted(vec, weights, 3))
    for j in range(3):
        col = [(int(v), 0) for v in vals[:, j]]
        assert host.fold_vec(col, alpha) == (int(folded[j]), 0)
        assert host.pack_weighted(col, weights, 3) == [(int(v), 0) for v in packed[:, j]]


def test_deep_batch_combine_is_blocking_invariant(monkeypatch):
    """`_batch_combine` over several row blocks, in blocks of two rows and
    in one piece, equals the host sum of w_j * row_j in GF(p^2)."""
    from ethproof_tpu_torch.gf import field as tgf
    from ethproof_tpu_torch.stark import prove as tprove

    rng = np.random.default_rng(8)
    m = 16
    parts = [rng.integers(0, tgf.P, size=(k, m), dtype=np.uint64) for k in (3, 1, 4)]
    weights = [tuple(int(v) for v in rng.integers(0, tgf.P, size=2, dtype=np.uint64))
               for _ in range(8)]
    rows = np.concatenate(parts)
    want = [(sum(w[0] * int(r[x]) for w, r in zip(weights, rows)) % tgf.P,
             sum(w[1] * int(r[x]) for w, r in zip(weights, rows)) % tgf.P) for x in range(m)]
    for block in (1 << 25, 2 * m):
        monkeypatch.setattr(tprove, "COMBINE_BLOCK_ELEMS", block)
        got = tprove._batch_combine([tgf.from_u64(p, "cpu") for p in parts], weights)
        assert list(zip(tgf.to_u64(got.a).tolist(), tgf.to_u64(got.b).tolist())) == want

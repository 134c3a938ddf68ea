"""Multi-device proving: the port's mesh vs one device and the JAX package.

The port's mesh is single-controller, as the JAX package's is, and a
device may repeat, so the CPU tier's 8-device mesh is `["cpu"] * 8` (the
JAX package's is XLA's 8 virtual host devices, tests/conftest.py). Every
sharded cap, tree, commit and proof must equal the one-device result and
the JAX package's, bit for bit: sharding is placement only.
"""

import numpy as np
import pytest
import torch

from ethproof_tpu.fri.config import FriConfig as JFriConfig
from ethproof_tpu.fri.config import StarkConfig as JStarkConfig
from ethproof_tpu.gf import field as jgf
from ethproof_tpu.hash import poseidon as jps
from ethproof_tpu.parallel import mesh as jmesh
from ethproof_tpu.recursion import circuit as jc
from ethproof_tpu.recursion import machine as jm
from ethproof_tpu.stark import prove as jprove
from ethproof_tpu.stark.verify import stark_verify as j_stark_verify
from ethproof_tpu_torch.fri.config import FriConfig as TFriConfig
from ethproof_tpu_torch.fri.config import StarkConfig as TStarkConfig
from ethproof_tpu_torch.gf import field as tgf
from ethproof_tpu_torch.hash import merkle as tmerkle
from ethproof_tpu_torch.hash import poseidon as tps
from ethproof_tpu_torch.interop import multi_proof_to_numpy, proof_to_numpy
from ethproof_tpu_torch.parallel import mesh as tmesh
from ethproof_tpu_torch.poly import four_step
from ethproof_tpu_torch.recursion import circuit as tc
from ethproof_tpu_torch.recursion import machine as tm
from ethproof_tpu_torch.stark import multi as tmulti
from ethproof_tpu_torch.stark import prove as tprove
from ethproof_tpu_torch.stark.stark import CtlInstance
from ethproof_tpu_torch.stark.verify import stark_verify as t_stark_verify
from ethproof_tpu_torch.tables import memory as tmem
from test_torch_ir import _pair, _sweep_args
from test_torch_stark import OPS, T_CFG, assert_same, to_reference

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

P = jgf.P
CPU8 = ["cpu"] * 8


def _vals(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _t(x):
    return tgf.from_u64(x, "cpu")


def test_mesh_axes_and_devices():
    m = tmesh.make_mesh(8, tx=2, devices=CPU8)
    assert m.devices.shape == (2, 4)
    assert m.axis_names == ("tx", "col") == jmesh.make_mesh(8, tx=2).axis_names
    assert m.shape == {"tx": 2, "col": 4}
    assert tmesh.mesh_width(m) == 4
    assert m.leader == torch.device("cpu")
    assert tmesh.make_mesh(4, devices=CPU8).shape == {"tx": 1, "col": 4}
    # an unindexed card is normalised to an index (torch.device("cuda") != "cuda:0")
    assert tmesh.Mesh([["cuda", "cuda:0"]]).col_devices() == [torch.device("cuda", 0)] * 2


def test_mesh_refuses_mixed_devices_and_a_width_of_three():
    with pytest.raises(ValueError, match="one device type"):
        tmesh.make_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="power of two"):
        tmesh.make_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="power of two"):
        tmesh.make_mesh(6, tx=2, devices=CPU8)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_mesh(8, tx=3, devices=CPU8)
    with pytest.raises(ValueError, match="leader"):
        tmesh.resolve_mesh(tmesh.make_mesh(devices=["cuda:0"] * 2), torch.device("cpu"))


@pytest.mark.parametrize("mode", ["off", "auto", "4"])
def test_default_mesh_is_none_on_a_cpu_host(monkeypatch, mode):
    """ETHPROOF_MESH off, auto and a cap: without CUDA cards there is no
    default mesh, and a CPU proof never takes one."""
    monkeypatch.setenv("ETHPROOF_MESH", mode)
    tmesh.reset_default_mesh()
    try:
        assert tmesh.default_mesh() is None
        assert tmesh.resolve_mesh(None, torch.device("cpu")) is None
        assert tmesh.resolve_mesh(False, torch.device("cpu")) is None
    finally:
        tmesh.reset_default_mesh()


def test_default_mesh_spans_the_cards_and_is_read_once(monkeypatch):
    """With four cards (counted, none touched): auto spans them, a cap of
    2 gives width 2, off gives None; the first answer holds until reset."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    try:
        for mode, width in (("auto", 4), ("2", 2), ("3", 2), ("1", None), ("off", None)):
            monkeypatch.setenv("ETHPROOF_MESH", mode)
            tmesh.reset_default_mesh()
            m = tmesh.default_mesh()
            assert (m and tmesh.mesh_width(m)) == width, mode
        monkeypatch.setenv("ETHPROOF_MESH", "auto")
        assert tmesh.default_mesh() is None  # cached until reset
        tmesh.reset_default_mesh()
        m = tmesh.default_mesh()
        assert m.col_devices() == [torch.device("cuda", i) for i in range(4)]
        assert tmesh.resolve_mesh(None, torch.device("cuda")) is m
        assert tmesh.resolve_mesh(None, torch.device("cuda", 1)) is None
        assert tmesh.resolve_mesh(None, torch.device("cpu")) is None
        assert tmesh.resolve_mesh(False, torch.device("cuda")) is None
    finally:
        tmesh.reset_default_mesh()


def test_sharded_commit_matches_single_device_and_reference():
    """tests/test_parallel.py's shapes: tx 2, 8 columns, 64 rows, on a
    (2, 4) mesh; caps equal the port's one-device commit and JAX's sharded
    commit on its 8-device mesh."""
    tx, cols, n = 2, 8, 64
    trace = _vals((tx, cols, n), 0)
    mesh = tmesh.make_mesh(8, tx=2, devices=CPU8)
    commit, shard_fn = tmesh.trace_commit_sharded(mesh, cols, n)
    placed = shard_fn(trace)
    assert [[b.shape for b in row] for row in placed] == [[(2, n)] * 4] * 2
    got = tgf.to_u64(commit(placed))
    assert got.shape == (tx, 4, 4)

    jg = jgf.from_u64(trace)
    jcommit, jshard = jmesh.trace_commit_sharded(jmesh.make_mesh(8, tx=2), cols, n)
    want = jgf.to_u64(jgf.GF(*jcommit(*jshard(np.asarray(jg.lo), np.asarray(jg.hi)))))
    np.testing.assert_array_equal(got, want)
    for t in range(tx):
        lde = four_step.best_coset_lde(four_step.best_intt(_t(trace[t])), 2, 7)
        np.testing.assert_array_equal(got[t], tgf.to_u64(tmerkle.build(lde, 2).cap))


def test_sharded_sweep_matches_host_and_reference():
    cols, n = 8, 32
    lde, w = _vals((cols, n), 1), _vals((cols,), 2)
    got = tgf.to_u64(tmesh.constraint_sweep_sharded(tmesh.make_mesh(devices=CPU8))(_t(lde), _t(w)))
    want = [sum(int(w[c]) * int(lde[c, j]) for c in range(cols)) % P for j in range(n)]
    assert [int(v) for v in got] == want
    g, wg = jgf.from_u64(lde), jgf.from_u64(w)
    lo, hi = jmesh.constraint_sweep_sharded(jmesh.make_mesh(8, tx=1))(g.lo, g.hi, wg.lo, wg.hi)
    np.testing.assert_array_equal(got, jgf.to_u64(jgf.GF(lo, hi)))
    # a column count the width does not divide: zero-padded columns and weights
    got5 = tmesh.constraint_sweep_sharded(tmesh.make_mesh(devices=CPU8))(_t(lde[:5]), _t(w[:5]))
    assert [int(v) for v in tgf.to_u64(got5)] == [
        sum(int(w[c]) * int(lde[c, j]) for c in range(5)) % P for j in range(n)]


@pytest.mark.parametrize("width", [1, 2, 8])
@pytest.mark.parametrize("cap_height", [0, 1, 4])
def test_merkle_blocks_equal_one_device(width, cap_height):
    """The tree over `width` domain blocks: its levels, cap and every leaf's
    path equal the one-device tree's (the blocks' share of the cap when
    2^cap_height >= width, the upper levels on the leader below it)."""
    rows = _vals((5, 32), 10 + width + cap_height)
    want = tmerkle.build(_t(rows), cap_height)
    blocks = tmesh.shard(_t(rows), tmesh.make_mesh(devices=["cpu"] * width), 1)
    got = tmerkle.build_blocks(blocks, cap_height)
    assert len(got.blocks) == width and got.num_leaves == 32
    assert (len(got.top) > 0) == (1 << cap_height < width)
    assert len(got.levels) == len(want.levels)
    for g, w in zip(got.levels, want.levels):
        np.testing.assert_array_equal(tgf.to_u64(g), tgf.to_u64(w))
    np.testing.assert_array_equal(tgf.to_u64(got.cap), tgf.to_u64(want.cap))
    idx = torch.arange(32)
    np.testing.assert_array_equal(tgf.to_u64(tmerkle.open_path(got, idx)),
                                  tgf.to_u64(tmerkle.open_path(want, idx)))
    np.testing.assert_array_equal(tgf.to_u64(tmerkle.open_path(got, torch.tensor(31))),
                                  tgf.to_u64(tmerkle.open_path(want, torch.tensor(31))))
    assert bool(tmerkle.verify_path(want.levels[0][:, idx], idx,
                                    tmerkle.open_path(got, idx), want.cap).all())


def test_commit_gf_pads_fewer_columns_than_the_width():
    """Three columns on an 8-wide mesh: zero-padded to eight for the column
    blocks, the padding dropped from the coefficients and the domain
    blocks; everything equals the one-device commit."""
    a = _t(_vals((3, 64), 3))
    assert tmesh.pad_cols(a, 8).shape == (8, 64)
    assert int(tmesh.pad_cols(a, 8)[3:].abs().sum()) == 0
    assert tmesh.pad_cols(a, 3) is a
    coeffs, lde, tree = tprove._commit_gf(a, T_CFG, tmesh.make_mesh(devices=CPU8))
    [c1], [l1], t1 = tprove._commit_gf(a, T_CFG)
    assert [c.shape[0] for c in coeffs] == [1, 1, 1, 0, 0, 0, 0, 0]
    assert [b.shape for b in lde] == [(3, 32)] * 8
    np.testing.assert_array_equal(tgf.to_u64(torch.cat(coeffs)), tgf.to_u64(c1))
    np.testing.assert_array_equal(tgf.to_u64(torch.cat(lde, dim=1)), tgf.to_u64(l1))
    np.testing.assert_array_equal(tgf.to_u64(tree.cap), tgf.to_u64(t1.cap))
    for g, w in zip(tree.levels, t1.levels):
        np.testing.assert_array_equal(tgf.to_u64(g), tgf.to_u64(w))


@pytest.mark.parametrize("width,budget", [(2, None), (8, None), (8, 1 << 10)])
def test_ir_sweep_over_domain_blocks_equals_direct_sweep(monkeypatch, width, budget):
    """Memory's sweep with its CTL and lookups on seeded LDE columns held as
    domain blocks: each block's next rows come from a halo of the next
    block (the last block's from the first), also when the budget cuts
    each block into chunks; equal to the direct sweep over the joined
    domain."""
    if budget is not None:
        monkeypatch.setenv("ETHPROOF_SWEEP_BUDGET", str(budget))
    _, t_stark, _, specs = _pair("memory")
    inst = [CtlInstance(s, 3 + i, 5 + i) for i, s in enumerate(specs)]
    args = list(_sweep_args(t_stark, inst, 4, seed=40))
    want = tprove._sweep(*args)[0]
    mesh = tmesh.make_mesh(devices=["cpu"] * width)
    for k in (1, 2, 3):  # trace, fixed, aux: one domain block each -> `width` blocks
        if args[k] is not None:
            args[k] = tmesh.shard(args[k][0], mesh, 1)
    got = tprove._ir_sweep(*args)
    assert len(got) == width
    np.testing.assert_array_equal(tgf.to_u64(torch.cat(got, dim=1)), tgf.to_u64(want))
    assert (tprove.ir_executor(t_stark, specs, 2, len(args[6]), True).last_run[0]
            > width) == (budget is not None)


def _hash_machine(mod, ps):
    """tests/test_parallel.py's machine: PI = poseidon(x^2), x = 31337."""
    b = mod.CBuilder()
    x = b.wit("x")
    y = b.mul(x, x)
    out = b.poseidon([y] + [b.const(0)] * 11)
    for k in range(4):
        b.expose(out[k], k)
    xv = 31337
    return b.build(), [xv], ps.permute_host([xv * xv % P] + [0] * 11)[:4]


def test_machine_proof_on_a_mesh_equals_reference(monkeypatch):
    """tests/test_parallel.py:69-120's recursion-machine proof (fixed
    columns, the wire bus's custom aux columns), 64 rows, cap height 1 on
    an 8-wide mesh (the upper tree levels on the leader): the port's proof
    under both sweeps on the mesh equals its one-device proof and the JAX
    package's `stark_prove(..., mesh=False)` field for field, and passes
    the JAX package's `stark_verify`. One test: the reference's proof and
    vkey commit are made once."""
    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    kw = dict(rate_bits=2, cap_height=1, proof_of_work_bits=2, num_query_rounds=2,
              arity_bits=2, final_poly_bits=2)
    j_cfg = JStarkConfig(num_challenges=1, fri_config=JFriConfig(**kw))
    t_cfg = TStarkConfig(num_challenges=1, fri_config=TFriConfig(**kw))
    circuit, wit, digest = _hash_machine(jc, jps)
    js = jm.RecursionStark(circuit)
    j_trace = jm.generate_trace(js, jc.interpret(circuit, wit, digest), 64)
    t_circuit, t_wit, t_digest = _hash_machine(tc, tps)
    assert t_digest == digest
    ts = tm.RecursionStark(t_circuit)
    t_trace = tm.generate_trace(ts, tc.interpret(t_circuit, t_wit, digest), 64)
    np.testing.assert_array_equal(t_trace, j_trace)

    want = proof_to_numpy(jprove.stark_prove(js, j_trace, digest, j_cfg, mesh=False))
    one = proof_to_numpy(tprove.stark_prove(ts, t_trace, digest, t_cfg, device="cpu"))
    assert_same(one, want)
    mesh = tmesh.make_mesh(devices=CPU8)
    for mode in ("ir", "eager"):
        monkeypatch.setenv("ETHPROOF_SWEEP", mode)
        got = tprove.stark_prove(tm.RecursionStark(t_circuit), t_trace, digest, t_cfg,
                                 device="cpu", mesh=mesh)
        assert_same(proof_to_numpy(got), want, f"proof[{mode}]")
    assert t_stark_verify(ts, got, t_cfg, device="cpu")
    assert j_stark_verify(js, to_reference(proof_to_numpy(got)), j_cfg)


def test_prove_multi_with_ctls_on_a_mesh():
    """Two Memory tables (fixed column, logUp lookup) joined by a CTL over
    Memory's CTL tuple, proved on a 4-wide mesh: the same proofs as on
    one device, accepted by the port's `verify_multi`."""
    trace = tmem.generate_trace([tmem.MemoryOp(*op) for op in OPS], 64)
    spec = tmem.MemoryStark.ctl_spec
    ctls = [tmulti.CrossTableLookup(looking=((0, spec),), looked=(1, spec))]

    def prove(mesh):
        return tmulti.prove_multi([tmem.MemoryStark(), tmem.MemoryStark()], [trace, trace],
                                  [[], []], ctls, T_CFG, device="cpu", mesh=mesh)

    on_mesh = prove(tmesh.make_mesh(devices=["cpu"] * 4))
    assert_same(multi_proof_to_numpy(on_mesh), multi_proof_to_numpy(prove(False)))
    assert len(on_mesh.proofs[0].ctl_totals) == T_CFG.num_challenges
    assert tmulti.verify_multi([tmem.MemoryStark(), tmem.MemoryStark()], on_mesh, ctls, T_CFG,
                               device="cpu")

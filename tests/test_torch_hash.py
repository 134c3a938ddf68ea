"""Port Poseidon, Merkle trees and Keccak-256 vs the JAX package (exact equality)."""

import numpy as np
import pytest
import torch

from ethproof_tpu.gf import field as jgf
from ethproof_tpu.hash import keccak as jkeccak
from ethproof_tpu.hash import merkle as jmerkle
from ethproof_tpu.hash import poseidon as jps
from ethproof_tpu_torch.gf import field as tgf
from ethproof_tpu_torch.hash import keccak as tkeccak
from ethproof_tpu_torch.hash import merkle as tmerkle
from ethproof_tpu_torch.hash import poseidon as tps

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

P = jgf.P


def _vals(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _t(x):
    return tgf.from_u64(x, "cpu")


def test_permute_matches_jax():
    x = _vals((12, 8), 1)
    x[:, 0] = 0
    x[:, 1] = P - 1
    want = jgf.to_u64(jps.permute(jgf.from_u64(x)))
    np.testing.assert_array_equal(tgf.to_u64(tps.permute(_t(x))), want)
    assert [int(v) for v in want[:, 2]] == tps.permute_host([int(v) for v in x[:, 2]])


@pytest.mark.parametrize("length", [2, 8, 9])
def test_hash_n_to_m_no_pad_matches_jax(length):
    x = _vals((length, 4), 10 + length)
    want = jgf.to_u64(jps.hash_n_to_m_no_pad(jgf.from_u64(x), 4))
    np.testing.assert_array_equal(tgf.to_u64(tps.hash_n_to_m_no_pad(_t(x), 4)), want)


def test_two_to_one_and_tree_digest_match_jax():
    left, right = _vals((4, 4), 20), _vals((4, 4), 21)
    want = jgf.to_u64(jps.two_to_one(jgf.from_u64(left), jgf.from_u64(right)))
    np.testing.assert_array_equal(tgf.to_u64(tps.two_to_one(_t(left), _t(right))), want)
    rows = _vals((11, 3), 22)
    got = tgf.to_u64(tps.tree_digest(_t(rows)))
    for j in range(3):
        assert [int(v) for v in got[:, j]] == jps.tree_digest_host([int(v) for v in rows[:, j]])


def test_merkle_cap_and_paths_match_jax():
    rows = _vals((7, 64), 30)
    jtree = jmerkle.build(jgf.from_u64(rows), 2)
    ttree = tmerkle.build(_t(rows), 2)
    assert len(ttree.levels) == len(jtree.levels)
    for tl, jl in zip(ttree.levels, jtree.levels):
        np.testing.assert_array_equal(tgf.to_u64(tl), jgf.to_u64(jl))
    idx = np.array([0, 5, 33, 63])
    want = jgf.to_u64(jmerkle.open_path(jtree, idx))
    path = tmerkle.open_path(ttree, torch.from_numpy(idx))
    np.testing.assert_array_equal(tgf.to_u64(path), want)
    ok = tmerkle.verify_path(ttree.levels[0][:, idx], torch.from_numpy(idx), path, ttree.cap)
    assert bool(ok.all())
    bad = ttree.levels[0][:, idx].clone()
    bad[0, 1] ^= 1
    assert not bool(tmerkle.verify_path(bad, torch.from_numpy(idx), path, ttree.cap)[1])


@pytest.mark.parametrize("leaf_block_elems", [7 * 8, 7 * 3, 1])
def test_blocked_merkle_leaves_match_jax(monkeypatch, leaf_block_elems):
    """Leaves digested in domain blocks (8 leaves, a ragged 3, one) give the
    reference's tree."""
    monkeypatch.setattr(tmerkle, "LEAF_BLOCK_ELEMS", leaf_block_elems)
    rows = _vals((7, 64), 31)
    jtree = jmerkle.build(jgf.from_u64(rows), 2)
    ttree = tmerkle.build(_t(rows), 2)
    for tl, jl in zip(ttree.levels, jtree.levels, strict=True):
        np.testing.assert_array_equal(tgf.to_u64(tl), jgf.to_u64(jl))


@pytest.mark.parametrize("length", [0, 1, 135, 136, 137, 300])
def test_keccak256_matches_jax(length):
    """Across the 136-byte rate boundary (one- and two-byte padding)."""
    data = np.random.default_rng(length).bytes(length)
    assert tkeccak.keccak256(data) == jkeccak.keccak256(data)

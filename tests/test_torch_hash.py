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


# leaf lengths: the padded copy (L <= 4), ragged and whole groups of four,
# an odd and an even group count, and the main path's 430-, 708- and 5,644-
# element leaves as groups (1411 = 5644 / 4)
LEAF_LENGTHS = [1, 3, 4, 5, 8, 9, 11, 12, 430, 708, 1411]


@pytest.mark.parametrize("length", LEAF_LENGTHS)
def test_two_to_one_and_tree_digest_match_jax(length):
    """two_to_one, and tree_digest as its level walk (leaf_level, then
    node_level to one digest, each level ceil(k/2) digests of the k below
    it), against the JAX package on every column of an odd count."""
    left, right = _vals((4, 4), 20), _vals((4, 4), 21)
    want = jgf.to_u64(jps.two_to_one(jgf.from_u64(left), jgf.from_u64(right)))
    np.testing.assert_array_equal(tgf.to_u64(tps.two_to_one(_t(left), _t(right))), want)
    rows = _vals((length, 5), 100 + length)
    got = tgf.to_u64(tps.tree_digest(_t(rows)))
    for j in range(5):
        assert [int(v) for v in got[:, j]] == jps.tree_digest_host([int(v) for v in rows[:, j]])
    if length <= 4:
        return
    k = (length + 3) // 4
    d = tps.leaf_level(_t(rows))
    sizes = [d.shape[1]]
    while d.shape[1] > 1:
        d = tps.node_level(d)
        sizes.append(d.shape[1])
    expect = [(k + 1) // 2]
    while expect[-1] > 1:
        expect.append((expect[-1] + 1) // 2)
    assert sizes == expect
    assert tuple(d.shape) == (4, 1, 5)
    np.testing.assert_array_equal(tgf.to_u64(d[:, 0]), got)


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


# -- the level walk of tree_digest (the kernel's levels, here on the plain path) ----


def _host_groups(col, length):
    """The k = ceil(L/4) zero-padded groups of one leaf, python ints."""
    xs = [int(v) % P for v in col] + [0] * (-length % 4)
    return [xs[4 * g : 4 * g + 4] for g in range(len(xs) // 4)]


@pytest.mark.parametrize("length", [n for n in LEAF_LENGTHS if n > 4])
def test_leaf_level_pairs_group_i_with_half_plus_i(length):
    """The first level reads the rows as zero-padded groups of four: digest
    i is two_to_one(group i, group half + i), half = k // 2, and an odd k
    carries group k - 1 (its padding included) up as it is."""
    rows = _vals((length, 3), 200 + length)
    k = (length + 3) // 4
    half = k // 2
    got = tgf.to_u64(tps.leaf_level(_t(rows)))
    assert got.shape == (4, half + (k & 1), 3)
    for j in range(3):
        groups = _host_groups(rows[:, j], length)
        for i in range(half):
            assert [int(v) for v in got[:, i, j]] == jps.two_to_one_host(groups[i],
                                                                        groups[half + i])
        if k & 1:
            assert [int(v) for v in got[:, half, j]] == groups[k - 1]


@pytest.mark.parametrize("k", [2, 3, 7, 8])
def test_node_level_pairs_and_carries(k):
    """A level above the leaves: (4, k, N) -> (4, ceil(k/2), N), digest i the
    two_to_one of digests i and half + i, an odd k's last digest carried."""
    d = _vals((4, k, 3), 300 + k)
    got = tgf.to_u64(tps.node_level(_t(d)))
    half = k // 2
    assert got.shape == (4, half + (k & 1), 3)
    for j in range(3):
        for i in range(half):
            want = jps.two_to_one_host([int(v) for v in d[:, i, j]],
                                       [int(v) for v in d[:, half + i, j]])
            assert [int(v) for v in got[:, i, j]] == want
        if k & 1:
            np.testing.assert_array_equal(got[:, half, j], d[:, k - 1, j])


def test_merkle_level_compresses_siblings():
    """A Merkle level: digest j of (4, M) -> (4, M/2) is two_to_one of
    siblings 2j and 2j + 1."""
    d = _vals((4, 8), 400)
    got = tgf.to_u64(tps.merkle_level(_t(d)))
    assert got.shape == (4, 4)
    for j in range(4):
        want = jps.two_to_one_host([int(v) for v in d[:, 2 * j]], [int(v) for v in d[:, 2 * j + 1]])
        assert [int(v) for v in got[:, j]] == want


def test_tree_digest_reduces_inputs_at_or_above_p():
    """Lanes >= p (each below 2^32 - 1 plus p, and 2^64 - 1) hash as their
    residues, the first round's add reducing them, read through a strided
    column view, as the JAX package's host digest of the residues."""
    rows = _vals((9, 6), 500)
    rows[:, ::2] = np.random.default_rng(501).integers(0, (1 << 64) - P, size=(9, 3),
                                                       dtype=np.uint64)
    rows[0, 1] = np.uint64((1 << 64) - 1 - P)
    big = np.where(rows < np.uint64((1 << 64) - P), rows + np.uint64(P), rows)
    assert (big[:, ::2] >= np.uint64(P)).all() and big[0, 1] == np.uint64((1 << 64) - 1)
    wide = np.zeros((9, 12), dtype=np.uint64)
    wide[:, ::2] = big
    got = tgf.to_u64(tps.tree_digest(torch.from_numpy(wide.view(np.int64))[:, ::2]))
    for j in range(6):
        assert [int(v) for v in got[:, j]] == jps.tree_digest_host([int(v) for v in rows[:, j]])


def test_kernel_source_holds_the_constants():
    """csrc/poseidon.cu's round-constant table and MDS rows are the JAX
    package's (ethproof_tpu/hash/constants.py)."""
    import re
    from pathlib import Path

    from ethproof_tpu.hash import constants as C

    src = (Path(tps.__file__).resolve().parent.parent / "csrc" / "poseidon.cu").read_text()
    table = src[src.index("kRoundConstants[kRounds][kWidth] = {"):]
    table = table[: table.index("};")]
    values = [int(v, 16) for v in re.findall(r"0x([0-9A-F]{16})ull", table)]
    assert values == [int(v) for v in C.ALL_ROUND_CONSTANTS]
    circ = re.search(r"kCirc\[kWidth\] = \{([^}]*)\}", src).group(1)
    assert [int(v) for v in circ.split(",")] == C.MDS_MATRIX_CIRC
    assert f"kDiag0 = {C.MDS_MATRIX_DIAG[0]};" in src
    assert C.MDS_MATRIX_DIAG[1:] == [0] * 11


def test_census_counts_plain_permutations_by_device():
    """A CPU permutation is counted under ("plain", "cpu") by its batch and
    launches no kernel."""
    before = dict(tps.CENSUS)
    tps.permute(_t(_vals((12, 7), 600)))
    tps.tree_digest(_t(_vals((9, 2), 601)))
    after = dict(tps.CENSUS)
    assert after[("plain", "cpu")] - before.get(("plain", "cpu"), 0) == 7 + 2 * 2
    assert {k: v for k, v in after.items() if k[0] != "plain"} == \
        {k: v for k, v in before.items() if k[0] != "plain"}

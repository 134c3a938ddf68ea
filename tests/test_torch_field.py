"""Port field arithmetic vs the JAX package: exact u64 equality.

The same seeded numpy inputs go through `ethproof_tpu.gf` (JAX on the CPU)
and `ethproof_tpu_torch.gf` (torch on the CPU)."""

import numpy as np
import pytest
import torch

from ethproof_tpu.gf import extension as jgf2
from ethproof_tpu.gf import field as jgf
from ethproof_tpu.poly import ntt as jntt
from ethproof_tpu_torch.gf import extension as tgf2
from ethproof_tpu_torch.gf import field as tgf
from ethproof_tpu_torch.poly import ntt as tntt

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

P = jgf.P
EDGE = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63, P - 2, (1 << 63) + 1, (1 << 32) + 1]


def _vals(n, seed, edge=True):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, P, size=n, dtype=np.uint64)
    if edge:
        r = np.concatenate([np.asarray(EDGE, dtype=np.uint64), r])
    return r


def _pair():
    x = _vals(55, 1)
    y = np.concatenate([np.asarray(EDGE[::-1], dtype=np.uint64), _vals(55, 2, edge=False)])
    return x, y


def _t(x):
    return tgf.from_u64(x, "cpu")


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(op):
    x, y = _pair()
    want = jgf.to_u64(getattr(jgf, op)(jgf.from_u64(x), jgf.from_u64(y)))
    got = tgf.to_u64(getattr(tgf, op)(_t(x), _t(y)))
    np.testing.assert_array_equal(got, want)


def test_edge_value_grid_matches_jax():
    e = np.asarray(EDGE, dtype=np.uint64)
    x = np.repeat(e, len(e))
    y = np.tile(e, len(e))
    for op in ("add", "sub", "mul"):
        want = jgf.to_u64(getattr(jgf, op)(jgf.from_u64(x), jgf.from_u64(y)))
        got = tgf.to_u64(getattr(tgf, op)(_t(x), _t(y)))
        np.testing.assert_array_equal(got, want, err_msg=op)


def test_neg_and_inv_match_jax_and_inv_zero_is_zero():
    # `jgf.inv` is `pow_const(a, P - 2)` under jit; the eager chain gives
    # the same values without a multi-minute XLA:CPU compile per shape
    x = _vals(55, 3)
    np.testing.assert_array_equal(tgf.to_u64(tgf.neg(_t(x))), jgf.to_u64(jgf.neg(jgf.from_u64(x))))
    got = tgf.to_u64(tgf.inv(_t(x)))
    np.testing.assert_array_equal(got, jgf.to_u64(jgf.pow_const(jgf.from_u64(x), P - 2)))
    assert got[0] == 0  # EDGE[0] == 0
    assert all(int(v) * int(w) % P == 1 for v, w in zip(x[1:], got[1:]))


@pytest.mark.parametrize("e", [0, 1, 7, 1 << 20, P - 2])
def test_pow_const_matches_jax(e):
    x = _vals(16, 4, edge=False)
    np.testing.assert_array_equal(
        tgf.to_u64(tgf.pow_const(_t(x), e)), jgf.to_u64(jgf.pow_const(jgf.from_u64(x), e))
    )


@pytest.mark.parametrize("n", [1, 8, 64])
def test_powers_match_jax(n):
    base = 0x123456789ABCDEF0 % P
    want = jgf.to_u64(jntt.powers(jgf.gf(base), n))
    np.testing.assert_array_equal(tgf.to_u64(tntt.powers(base, n, "cpu")), want)


def test_extension_ops_match_jax():
    a0, b0, a1, b1 = (_vals(24, 10 + i, edge=False) for i in range(4))
    jx = jgf2.GF2(jgf.from_u64(a0), jgf.from_u64(b0))
    jy = jgf2.GF2(jgf.from_u64(a1), jgf.from_u64(b1))
    tx = tgf2.GF2(_t(a0), _t(b0))
    ty = tgf2.GF2(_t(a1), _t(b1))
    for op in ("add", "sub", "mul"):
        want = getattr(jgf2, op)(jx, jy)
        got = getattr(tgf2, op)(tx, ty)
        np.testing.assert_array_equal(tgf.to_u64(got.a), jgf.to_u64(want.a), err_msg=op)
        np.testing.assert_array_equal(tgf.to_u64(got.b), jgf.to_u64(want.b), err_msg=op)
    # GF(p^2) inverse: the counterpart's formula with the eager base inverse
    norm = jgf.sub(jgf.sqr(jx.a), jgf.mul_const(jgf.sqr(jx.b), jgf2.W_EXT))
    ninv = jgf.pow_const(norm, P - 2)
    got = tgf2.inv(tx)
    np.testing.assert_array_equal(tgf.to_u64(got.a), jgf.to_u64(jgf.mul(jx.a, ninv)))
    np.testing.assert_array_equal(tgf.to_u64(got.b), jgf.to_u64(jgf.mul(jgf.neg(jx.b), ninv)))
    one = tgf2.mul(tx, got)
    assert (tgf.to_u64(one.a) == 1).all() and (tgf.to_u64(one.b) == 0).all()


def test_from_u32_pairs_round_trip():
    x = _vals(40, 5)
    g = jgf.from_u64(x)
    t = tgf.from_u32_pairs(np.asarray(g.lo), np.asarray(g.hi), "cpu")
    np.testing.assert_array_equal(tgf.to_u64(t), x)
    np.testing.assert_array_equal(tgf.to_u64(t), jgf.to_u64(g))


def test_sum_dim_is_the_modular_sum():
    x = _vals(200, 6, edge=False).reshape(2, 100)
    got = tgf.to_u64(tgf.sum_dim(_t(x), -1))
    want = [sum(int(v) for v in row) % P for row in x]
    assert [int(v) for v in got] == want

"""Port base DFT, radix-2 NTT and four-step NTT vs the JAX package (exact).

`base_dft_plain` is held against the JAX package's XLA int8-digit base DFT
(`mxu_ntt._field_matmul_dft_i8`) and against its Pallas kernel
(`pallas_ntt.dft_last_axis`) run under the Pallas interpreter, as
tests/test_pallas_ntt.py runs it on the CPU. On a CPU tensor the wrapper
`base_dft` takes the plain version, so the four-step path tested here is
the one the card runs with the CUDA kernel at its base."""

import numpy as np
import pytest
import torch

from ethproof_tpu.gf import field as jgf
from ethproof_tpu.poly import mxu_ntt as jmx
from ethproof_tpu.poly import ntt as jntt
from ethproof_tpu.poly import pallas_ntt
from ethproof_tpu_torch.gf import field as tgf
from ethproof_tpu_torch.poly import base_dft as tbd
from ethproof_tpu_torch.poly import four_step as tfs
from ethproof_tpu_torch.poly import ntt as tntt

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

P = jgf.P
SHIFT = 7


def _vals(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _t(x):
    return tgf.from_u64(x, "cpu")


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 9))
def test_base_dft_plain_matches_xla_i8(log_n, inverse):
    x = _vals((3, 1 << log_n), log_n)
    want = jgf.to_u64(jmx._field_matmul_dft_i8(jgf.from_u64(x), log_n, inverse))
    got = tgf.to_u64(tbd.base_dft(_t(x), log_n, inverse))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft_plain(_t(x), log_n, inverse)), want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 9))
def test_base_dft_plain_matches_interpreted_pallas_kernel(monkeypatch, log_n, inverse):
    monkeypatch.setattr(pallas_ntt, "_INTERPRET", True)
    monkeypatch.setattr(jmx, "_ENCODING", "i8")
    n = 1 << log_n
    x = _vals((max(8 * max(n, 128), 1024) // n, n), 100 + log_n)
    a = jgf.from_u64(x)
    assert pallas_ntt.supported(a.lo.size, log_n)
    want = jgf.to_u64(pallas_ntt.dft_last_axis(a, log_n, inverse))
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft_plain(_t(x), log_n, inverse)), want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 9))
def test_base_dft_bf16_plain_matches_xla_bf16(monkeypatch, log_n, inverse):
    """The bf16 encoding's plain version against the JAX package's XLA bf16
    path (`_field_matmul_dft` with `_ENCODING="bf16"`), on seeded values
    and on the all-0xFF-chunk value that drives every dot to its largest
    sum; the wrapper on a CPU tensor takes it under encoding="bf16"."""
    monkeypatch.setattr(jmx, "_ENCODING", "bf16")
    x = _vals((3, 1 << log_n), 500 + log_n)
    x[0] = 0xFFFFFFFEFFFFFFFF
    want = jgf.to_u64(jmx._field_matmul_dft(jgf.from_u64(x), log_n, inverse))
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft_bf16_plain(_t(x), log_n, inverse)), want)
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft(_t(x), log_n, inverse, "bf16")), want)
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft_plain(_t(x), log_n, inverse)), want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 9))
def test_base_dft_bf16_plain_matches_interpreted_pallas_kernel(monkeypatch, log_n, inverse):
    """... and against the Pallas `_dft_kernel` under the interpreter."""
    monkeypatch.setattr(pallas_ntt, "_INTERPRET", True)
    monkeypatch.setattr(jmx, "_ENCODING", "bf16")
    n = 1 << log_n
    x = _vals((max(8 * max(n, 128), 1024) // n, n), 600 + log_n)
    a = jgf.from_u64(x)
    assert pallas_ntt.supported(a.lo.size, log_n)
    want = jgf.to_u64(pallas_ntt.dft_last_axis(a, log_n, inverse))
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft_bf16_plain(_t(x), log_n, inverse)), want)


def test_encoding_switch_mirrors_the_jax_package():
    """ENCODING defaults to the JAX package's default and names the
    kernel each encoding launches; an unknown encoding raises."""
    assert tbd.ENCODINGS == ("i8", "bf16")
    assert tbd.KERNELS == {"i8": "base_dft", "bf16": "base_dft_bf16"}
    assert set(tbd.LAUNCHES) == set(tbd.KERNELS.values())
    x = _t(_vals((2, 8), 700))
    with pytest.raises(ValueError, match="encoding"):
        tbd.base_dft(x, 3, False, "fp8")


@pytest.mark.parametrize("log_n", [3, 9])
def test_ntt_and_intt_match_jax(log_n):
    x = _vals((2, 1 << log_n), 200 + log_n)
    a = jgf.from_u64(x)
    fwd = jgf.to_u64(jmx.best_ntt(a))
    np.testing.assert_array_equal(tgf.to_u64(tfs.best_ntt(_t(x))), fwd)
    np.testing.assert_array_equal(tgf.to_u64(tfs.best_intt(_t(x))), jgf.to_u64(jmx.best_intt(a)))
    if log_n < 9:  # the radix-2 path itself
        np.testing.assert_array_equal(tgf.to_u64(tntt.ntt(_t(x))), jgf.to_u64(jntt.ntt(a)))
        np.testing.assert_array_equal(tgf.to_u64(tntt.intt(_t(x))), jgf.to_u64(jntt.intt(a)))


@pytest.mark.parametrize("log_n", [3, 7])
def test_coset_lde_and_coset_intt_match_jax(log_n):
    x = _vals((2, 1 << log_n), 300 + log_n)
    a = jgf.from_u64(x)
    lde = tfs.best_coset_lde(_t(x), 2, SHIFT)
    np.testing.assert_array_equal(tgf.to_u64(lde), jgf.to_u64(jmx.best_coset_lde(a, 2, SHIFT)))
    back = tfs.best_coset_intt(lde, SHIFT)
    np.testing.assert_array_equal(tgf.to_u64(back)[:, : 1 << log_n], x)
    if log_n == 3:  # the radix-2 path itself
        np.testing.assert_array_equal(tgf.to_u64(tntt.coset_lde(_t(x), 2, SHIFT)), tgf.to_u64(lde))
        np.testing.assert_array_equal(
            tgf.to_u64(tntt.coset_intt(lde, SHIFT)),
            jgf.to_u64(jntt.coset_intt(jgf.from_u64(tgf.to_u64(lde)), SHIFT)))
    np.testing.assert_array_equal(
        tgf.to_u64(back), jgf.to_u64(jmx.best_coset_intt(jgf.from_u64(tgf.to_u64(lde)), SHIFT))
    )


def test_four_step_levels_agree_with_radix2():
    """Any exact partition gives the same transform: the port's levels
    (2^11 = 2^4 * 2^4 * 2^3 here) against the radix-2 NTT."""
    x = _vals((1, 1 << 11), 400)
    np.testing.assert_array_equal(
        tgf.to_u64(tfs._four_step(_t(x), 11, False)), tgf.to_u64(tntt.ntt(_t(x)))
    )

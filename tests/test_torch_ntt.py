"""Port base DFT, radix-2 NTT and four-step NTT vs the JAX package (exact).

`base_dft_plain` and `base_dft_i8_plain` are held against the JAX
package's XLA int8-digit base DFT (`mxu_ntt._field_matmul_dft_i8`) and
against its Pallas kernel (`pallas_ntt.dft_last_axis`) run under the Pallas
interpreter, as tests/test_pallas_ntt.py runs it on the CPU; the port's
digit tables against `mxu_ntt._dft_matrix_i8`. On a CPU tensor the wrapper
`base_dft` takes the encoding's plain version, so the four-step path tested
here is the one the card runs with the CUDA kernel at its base. The
kernels' own tables (fragment order, rows) are checked against the layout
and the bucket fold they document."""

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


# every i8 data digit -128; seven of eight bytes 0xFF (i8 digits +127, the
# largest bf16 chunk dots); p - 1
ADVERSARIAL = (0, 0xFFFFFFFEFFFFFFFF, P - 1)


def _vals_adv(shape, seed):
    x = _vals(shape, seed)
    x[: len(ADVERSARIAL)] = np.asarray(ADVERSARIAL, dtype=np.uint64)[:, None]
    return x


def _t(x):
    return tgf.from_u64(x, "cpu")


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 9))
def test_base_dft_plain_matches_xla_i8(log_n, inverse):
    """base_dft (on the CPU: base_dft_i8_plain), base_dft_plain and the
    port's copy of `_dft_matrix_i8` (weight digits and correction row, u64
    here, a u32 pair there) against the JAX package, base_dft_i8_plain with
    float32 matmuls set to reduced precision; the i8 kernel's tables
    against the layout and fold it documents."""
    digits, corr = tbd.dft_matrix_i8(log_n, inverse)
    want_digits, want_corr = jmx._dft_matrix_i8(log_n, inverse)
    np.testing.assert_array_equal(digits, want_digits)
    assert digits.dtype == np.int8
    np.testing.assert_array_equal(
        corr, (want_corr[1].astype(np.uint64) << np.uint64(32)) | want_corr[0])
    x = _vals_adv((6, 1 << log_n), log_n)
    want = jgf.to_u64(jmx._field_matmul_dft_i8(jgf.from_u64(x), log_n, inverse))
    got = tgf.to_u64(tbd.base_dft(_t(x), log_n, inverse))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft_plain(_t(x), log_n, inverse)), want)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")  # the digit matmuls run in float64
    try:
        np.testing.assert_array_equal(
            tgf.to_u64(tbd.base_dft_i8_plain(_t(x), log_n, inverse)), want)
    finally:
        torch.set_float32_matmul_precision(precision)
    _check_kernel_tables("i8", x, log_n, inverse, want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 9))
def test_base_dft_plain_matches_interpreted_pallas_kernel(monkeypatch, log_n, inverse):
    monkeypatch.setattr(pallas_ntt, "_INTERPRET", True)
    monkeypatch.setattr(jmx, "_ENCODING", "i8")
    n = 1 << log_n
    x = _vals_adv((max(8 * max(n, 128), 1024) // n, n), 100 + log_n)
    a = jgf.from_u64(x)
    assert pallas_ntt.supported(a.lo.size, log_n)
    want = jgf.to_u64(pallas_ntt.dft_last_axis(a, log_n, inverse))
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft_plain(_t(x), log_n, inverse)), want)
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft_i8_plain(_t(x), log_n, inverse)), want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 9))
def test_base_dft_bf16_plain_matches_xla_bf16(monkeypatch, log_n, inverse):
    """The bf16 encoding's plain version against the JAX package's XLA bf16
    path (`_field_matmul_dft` with `_ENCODING="bf16"`), on seeded values
    and on the all-0xFF-chunk value that drives every dot to its largest
    sum (and on 0 and p - 1); the wrapper on a CPU tensor takes it under
    encoding="bf16"; the bf16 kernel's tables against the layout and fold
    it documents."""
    monkeypatch.setattr(jmx, "_ENCODING", "bf16")
    x = _vals_adv((5, 1 << log_n), 500 + log_n)
    want = jgf.to_u64(jmx._field_matmul_dft(jgf.from_u64(x), log_n, inverse))
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft_bf16_plain(_t(x), log_n, inverse)), want)
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft(_t(x), log_n, inverse, "bf16")), want)
    np.testing.assert_array_equal(tgf.to_u64(tbd.base_dft_plain(_t(x), log_n, inverse)), want)
    _check_kernel_tables("bf16", x, log_n, inverse, want)


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


def _unpack_fragment_order(table, n, kstep, dtype):
    """The kernels' B operand back to [plane, term, column] by the mma.sync
    fragment layout (csrc/goldilocks.cuh, FragmentOrder): lane 4g + t holds
    words t and t + 4 of column g, a word kstep / 8 consecutive terms."""
    npad, kpad, per = max(n, 8), max(n, kstep), kstep // 8
    words = table.view(dtype).reshape(npad // 8, kpad // kstep, 4, 8, 4, 2, 2, per)
    out = np.zeros((8, kpad, npad), dtype=np.int64)
    tile, step, q, g, t, wl, h, j = np.indices(words.shape).reshape(8, -1)
    out[2 * q + wl, step * kstep + (t + 4 * h) * per + j, tile * 8 + g] = words.ravel()
    return out


def _fold(buckets):
    """The kernels' fold (csrc/goldilocks.cuh, `fold_buckets`) in Python
    ints: buckets 12..14 into 0..2 by 2^96 = -1, the twelve biased by
    FOLD_BIAS into (0, 2^28), then sum_b u_b 2^(8b) mod p."""
    u = [buckets[b] - (buckets[b + 12] if b < 3 else 0) + tbd.FOLD_BIAS for b in range(12)]
    assert all(0 < x < 1 << 28 for x in u)
    return sum(x << (8 * b) for b, x in enumerate(u)) % P


def _check_kernel_tables(encoding, x, log_n, inverse, want):
    """What the CUDA kernels are given: the weight table, unpacked by the
    fragment layout, is the encoding's digits zero-padded; and the digit
    buckets of the rows x, folded as the kernels fold them, plus the
    kernel's row, give `want`."""
    n = 1 << log_n
    table, row = tbd.kernel_tables(encoding, log_n, inverse)
    if encoding == "i8":
        kstep, dtype = 32, np.int8
        digits = tbd.dft_matrix_i8(log_n, inverse)[0].astype(np.int64)
        offset = 128
    else:
        kstep, dtype = 16, np.uint16
        digits = tbd.dft_matrix_chunks(log_n, inverse).astype(np.int64)
        offset = 0
    bits = _unpack_fragment_order(table, n, kstep, dtype)
    if encoding == "bf16":  # bf16 bits -> the chunk value (exact below 256)
        bits = (bits.astype(np.uint32) << np.uint32(16)).view(np.float32).astype(np.int64)
    padded = np.zeros_like(bits)
    padded[:, :n, :n] = digits.transpose(0, 2, 1)
    np.testing.assert_array_equal(bits, padded)
    planes = [((x >> np.uint64(8 * c)) & np.uint64(0xFF)).astype(np.int64) - offset
              for c in range(8)]
    buckets = [sum(planes[dc] @ digits[b - dc].T for dc in range(max(0, b - 7), min(b, 7) + 1))
               for b in range(15)]
    got = np.zeros(x.shape, dtype=np.uint64)
    for r, k in np.ndindex(*x.shape):
        got[r, k] = (_fold([int(bk[r, k]) for bk in buckets]) + int(row[k])) % P
    np.testing.assert_array_equal(got, want)


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

"""The four-step NTT's base level: an exact n-point DFT along the last axis.

Counterparts, one per NTT encoding (ethproof_tpu/poly/mxu_ntt.py:175,
`ETHPROOF_NTT_ENCODING`, default "i8"):
- "i8": ethproof_tpu/poly/pallas_ntt.py:141-185 (`_dft_kernel_i8`, reached
  through `dft_last_axis`, :256-278) and its XLA twin
  `mxu_ntt._field_matmul_dft_i8` (mxu_ntt.py:243);
- "bf16": ethproof_tpu/poly/pallas_ntt.py:95-138 (`_dft_kernel`, reached
  through `_pallas_call`, :192-213) and its XLA twin
  `mxu_ntt._field_matmul_dft` (mxu_ntt.py:204).

out[..., k] = sum_i a[..., i] * W[k, i] mod p with W[k, i] = w^(k*i),
n = 2^log_n <= 256, w the order-n root (inverse: its inverse; the 1/n
scale is the caller's). Both encodings give the same canonical bits.

`base_dft` launches the encoding's hand-written CUDA kernel on a CUDA
tensor (csrc/base_dft.cu on the int8 tensor cores, csrc/base_dft_bf16.cu
on the bf16 ones) and takes the encoding's plain version only for a tensor
on the CPU. The plain versions, valid on either device:
`base_dft_i8_plain`, the int8 digit formulation as eight float64 matmuls
(offset data digits times balanced weight digits), int64 buckets, a field
recombination and the correction row; `base_dft_bf16_plain`, the chunked
bf16 formulation likewise; and `base_dft_plain`, a loop over the n
contraction terms in the field arithmetic of gf/field.py, the independent
oracle both kernels are held against.
"""

from __future__ import annotations

import ctypes
import os
from collections import Counter
from functools import lru_cache

import numpy as np
import torch

from ..gf import field as gfp
from ..gf import field_host as fh

MAX_BASE_LOG = 8
ENCODINGS = ("i8", "bf16")
KERNELS = {"i8": "base_dft", "bf16": "base_dft_bf16"}


def _check_encoding(encoding: str) -> str:
    if encoding not in ENCODINGS:
        raise ValueError(f"NTT encoding must be one of {ENCODINGS}, got {encoding!r}")
    return encoding


# The encoding `base_dft` uses when the caller names none (the JAX package's
# switch, read from the same variable with the same default).
ENCODING = _check_encoding(os.environ.get("ETHPROOF_NTT_ENCODING", "i8"))

# Launches per kernel; a wrapper adds one per launch of its kernel and
# nowhere else. CENSUS counts the same launches by (kernel, rows, n, inverse).
LAUNCHES = {name: 0 for name in KERNELS.values()}
CENSUS: Counter = Counter()

# -- the int8 digit encoding (copied from ethproof_tpu/poly/mxu_ntt.py:116-169)
#
# Weights use balanced signed digits of a representative W' = W (mod p);
# data uses offset digits ((v >> 8c) & 255) - 128, which encode v - K. The
# digit matmul then gives C_k = sum_i (v_i - K) W'_ki, and out_k = C_k + K R_k
# with R_k = sum_i W'_ki: one per-k constant. Buckets are biased by _I8_BIAS
# to be nonnegative; the bias total folds into the same constant.
_K_OFF = 128 * ((1 << 64) - 1) // 255  # the value the offset digits drop
_I8_BIAS = 1 << 26  # makes biased buckets nonnegative (|bucket| <= 2^25)
_BIAS_TOTAL = _I8_BIAS * sum(1 << (8 * b) for b in range(15))

# The kernels fold buckets 12..14 into 0..2 (2^96 = -1 mod p) and bias the
# twelve sums by FOLD_BIAS (csrc/goldilocks.cuh, `fold_buckets`, `fold12`);
# their rows take FOLD_BIAS * _S12 off again.
FOLD_BIAS = 1 << 27
_S12 = sum(1 << (8 * b) for b in range(12))


def _balanced_digits_u64(rows: np.ndarray) -> np.ndarray:
    """(...) u64 canonical mod p -> (8, ...) int8 balanced digits of a
    representative = rows (mod p). Entries above 0x7f7f... use w - p (two's-
    complement wrap); the digit window [-0x8080.., 0x7f7f..] then covers
    every representative, so the greedy mod-2^64 digit loop is exact."""
    thr = np.uint64(0x7F7F7F7F7F7F7F7F)
    wrap = np.uint64((1 << 64) - fh.P)
    u = np.where(rows > thr, rows + wrap, rows)  # u64 wraparound = w - p
    digits = np.zeros((8,) + rows.shape, dtype=np.int8)
    rem = u.copy()
    for c in range(8):
        d = (rem & np.uint64(255)).astype(np.int64)
        db = np.where(d >= 128, d - 256, d)
        digits[c] = db.astype(np.int8)
        rem = (rem - db.astype(np.uint64)) >> np.uint64(8)
    return digits


@lru_cache(maxsize=32)
def dft_matrix_u64(log_n: int, inverse: bool) -> np.ndarray:
    """(n, n) u64: W[k, i] = w^(k*i), canonical (symmetric in k and i)."""
    n = 1 << log_n
    w = fh.primitive_root_of_unity(log_n)
    if inverse:
        w = fh.inv(w)
    pw = [1] * n
    for j in range(1, n):
        pw[j] = pw[j - 1] * w % fh.P
    idx = (np.arange(n)[:, None] * np.arange(n)[None, :]) % n
    return np.asarray(pw, dtype=np.uint64)[idx]


@lru_cache(maxsize=32)
def dft_matrix_chunks(log_n: int, inverse: bool) -> np.ndarray:
    """(8, n, n) float32 [wc, k, i]: the DFT matrix's unsigned 8-bit chunks
    (mxu_ntt._dft_matrix_chunks)."""
    rows = dft_matrix_u64(log_n, inverse)
    return np.stack(
        [((rows >> np.uint64(8 * c)) & np.uint64(0xFF)).astype(np.float32) for c in range(8)]
    )


@lru_cache(maxsize=32)
def dft_matrix_i8(log_n: int, inverse: bool):
    """((8, n, n) int8 balanced weight digits [wc, k, i], (n,) u64
    correction row): out_k = recombine(biased buckets) + corr_k (mod p)
    (mxu_ntt._dft_matrix_i8, whose row is a (2, n) u32 pair)."""
    rows = dft_matrix_u64(log_n, inverse)
    corr = [(_K_OFF * (sum(int(x) for x in row) % fh.P) - _BIAS_TOTAL) % fh.P for row in rows]
    return _balanced_digits_u64(rows), np.asarray(corr, dtype=np.uint64)


def _digit_buckets(planes: torch.Tensor, w: torch.Tensor) -> list:
    """The 15 int64 buckets sum_{dc + wc = b} planes[dc] @ w[wc].T of float64
    digit planes (8, ..., n) and weight digits (8, n, n) [wc, k, i]. Every
    dot is an integer below 2^24 in magnitude, so float64 gives it exactly,
    whatever precision PyTorch is set to use for float32 matmuls (TF32 on
    the card, reduced precision on the CPU)."""
    buckets = [None] * 15
    for wc in range(8):
        dots = torch.matmul(planes, w[wc].T).to(torch.int64)  # (8, ..., k)
        for dc in range(8):
            b = dc + wc
            buckets[b] = dots[dc] if buckets[b] is None else buckets[b] + dots[dc]
    return buckets


def _recombine(buckets: list, bias: int = 0) -> torch.Tensor:
    """sum_b (buckets[b] + bias) * 2^(8b) mod p, for buckets + bias in [0, 2^28)."""
    out = buckets[0] + bias  # below 2^28: already canonical
    for b in range(1, 15):
        out = gfp.add(out, gfp.mul_const(buckets[b] + bias, 1 << (8 * b)))
    return out


def base_dft_plain(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Plain PyTorch base DFT (CPU or CUDA): n multiply-adds per output."""
    n = 1 << log_n
    assert a.shape[-1] == n
    w = torch.from_numpy(dft_matrix_u64(log_n, inverse).view(np.int64)).to(a.device)  # [k, i]
    out = gfp.mul(a[..., 0:1], w[:, 0])
    for i in range(1, n):
        out = gfp.add(out, gfp.mul(a[..., i : i + 1], w[:, i]))
    return out


def base_dft_i8_plain(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Plain PyTorch base DFT in the int8 encoding (CPU or CUDA), the kernel's
    formulation: offset data digits ((a >> 8c) & 0xFF) - 128 times the
    balanced weight digits as eight exact matmuls (|dot| <= 128 * 128 * 256
    = 2^22), 15 int64 buckets plus _I8_BIAS, the field recombination, then
    the correction row."""
    n = 1 << log_n
    assert a.shape[-1] == n
    digits, corr = dft_matrix_i8(log_n, inverse)
    w = torch.from_numpy(digits).to(device=a.device, dtype=torch.float64)
    planes = torch.stack([((a >> (8 * c)) & 0xFF) - 128 for c in range(8)]).to(torch.float64)
    out = _recombine(_digit_buckets(planes, w), _I8_BIAS)
    return gfp.add(out, torch.from_numpy(corr.view(np.int64)).to(a.device))


def base_dft_bf16_plain(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Plain PyTorch base DFT in the bf16 encoding (CPU or CUDA).

    Eight unsigned 8-bit chunk planes of the data times the eight chunk
    planes of W: every dot is an integer < 255^2 * 256 < 2^24, which the
    matmuls give exactly (`_digit_buckets`). The 64 dots go into 15 int64
    buckets by chunk weight 2^(8 (dc + wc)), recombined in the field."""
    n = 1 << log_n
    assert a.shape[-1] == n
    w = torch.from_numpy(dft_matrix_chunks(log_n, inverse)).to(a.device, torch.float64)
    planes = torch.stack([(a >> (8 * c)) & 0xFF for c in range(8)]).to(torch.float64)
    return _recombine(_digit_buckets(planes, w))


# -- the kernels' tables -----------------------------------------------------


def _fragment_order(planes: np.ndarray, kstep: int) -> np.ndarray:
    """(8, n, n) [plane, k, i] weight digits (int8) or bf16 bits (uint16) ->
    the kernels' B operand, u8 [8-column tile][kstep-term step][plane pair
    q][lane][4 words]: lane 4g + t holds {reg0, reg1} of planes 2q and 2q + 1
    for column g, reg0 = the word of terms t, reg1 = of terms t + 4 (a word
    holds kstep / 8 consecutive terms, the lower term in the lower bits;
    csrc/goldilocks.cuh, FragmentOrder). Zero past n in either index."""
    _, n, _ = planes.shape
    npad, kpad = max(n, 8), max(n, kstep)
    p = np.zeros((8, npad, kpad), dtype=planes.dtype)
    p[:, :n, :n] = planes
    # [q, plane in pair, tile, g, step, word half, t, term in word]
    x = p.reshape(4, 2, npad // 8, 8, kpad // kstep, 2, 4, kstep // 8)
    return np.ascontiguousarray(x.transpose(2, 4, 0, 3, 6, 1, 5, 7)).view(np.uint8).ravel()


def kernel_row_i8(log_n: int, inverse: bool) -> np.ndarray:
    """(n,) u64 the i8 kernel adds to column k: the correction row plus the
    JAX package's bias total, less the fold's bias (csrc/base_dft.cu)."""
    _, corr = dft_matrix_i8(log_n, inverse)
    fix = (_BIAS_TOTAL - FOLD_BIAS * _S12) % fh.P
    return np.asarray([(int(c) + fix) % fh.P for c in corr], dtype=np.uint64)


def kernel_row_bf16(log_n: int) -> np.ndarray:
    """(n,) u64 the bf16 kernel adds to column k: less the fold's bias."""
    return np.full(1 << log_n, (-FOLD_BIAS * _S12) % fh.P, dtype=np.uint64)


@lru_cache(maxsize=64)
def kernel_tables(encoding: str, log_n: int, inverse: bool):
    """(B operand bytes, (n,) u64 row) of the encoding's kernel (host)."""
    if encoding == "i8":
        digits, _ = dft_matrix_i8(log_n, inverse)
        return _fragment_order(digits, 32), kernel_row_i8(log_n, inverse)
    bits = (dft_matrix_chunks(log_n, inverse).view(np.uint32) >> 16).astype(np.uint16)
    return _fragment_order(bits, 16), kernel_row_bf16(log_n)


_DEVICE_TABLES: dict = {}


def _device_tables(encoding: str, log_n: int, inverse: bool, device):
    key = (encoding, log_n, inverse, str(device))
    tables = _DEVICE_TABLES.get(key)
    if tables is None:
        wfrag, row = kernel_tables(encoding, log_n, inverse)
        tables = (torch.from_numpy(wfrag).to(device), torch.from_numpy(row.view(np.int64)).to(device))
        _DEVICE_TABLES[key] = tables
    return tables


@lru_cache(maxsize=None)
def _kernel(name: str):
    """The kernel's C entry point, built and loaded at its first use."""
    from .. import kernels

    fn = getattr(kernels.load(name), f"ethproof_{name}")
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(a: torch.Tensor, log_n: int, inverse: bool, encoding: str) -> torch.Tensor:
    if not a.is_contiguous():
        raise ValueError("base_dft: the kernel takes a contiguous tensor")
    if a.data_ptr() % 16:
        raise ValueError("base_dft: the kernel's 16-byte loads take a 16-byte aligned tensor")
    name = KERNELS[encoding]
    fn = _kernel(name)
    wfrag, row = _device_tables(encoding, log_n, inverse, a.device)
    out = torch.empty_like(a)
    rows = a.numel() >> log_n
    # the C entry point sets the kernel's shared-memory attribute and
    # launches on the CURRENT device: make it the tensor's (a mesh shard
    # may lie on another card than the current one)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), wfrag.data_ptr(), row.data_ptr(), out.data_ptr(), rows, log_n,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    CENSUS[(name, rows, 1 << log_n, inverse)] += 1
    return out


def base_dft(a: torch.Tensor, log_n: int, inverse: bool, encoding: str | None = None) -> torch.Tensor:
    """Base DFT over the last axis in `encoding` (None: `ENCODING`): the
    encoding's CUDA kernel for a CUDA tensor, its plain version for a CPU
    tensor. Raises on what the kernel does not take."""
    encoding = _check_encoding(ENCODING if encoding is None else encoding)
    if not 1 <= log_n <= MAX_BASE_LOG:
        raise ValueError(f"base_dft takes 1 <= log_n <= {MAX_BASE_LOG}, got {log_n}")
    if a.dtype != torch.int64:
        raise TypeError(f"base_dft takes int64 field tensors, got {a.dtype}")
    if a.dim() == 0 or a.shape[-1] != 1 << log_n:
        raise ValueError(f"base_dft: last axis {tuple(a.shape)} is not 2^{log_n}")
    if a.device.type == "cpu":
        plain = base_dft_i8_plain if encoding == "i8" else base_dft_bf16_plain
        return plain(a, log_n, inverse)
    if a.device.type != "cuda":
        raise ValueError(f"base_dft: unsupported device {a.device}")
    if a.numel() == 0:
        return torch.empty_like(a)
    return _launch(a, log_n, inverse, encoding)

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
tensor (csrc/base_dft.cu, csrc/base_dft_bf16.cu) and takes the encoding's
plain version only for a tensor on the CPU. The plain versions, valid on
either device: `base_dft_plain`, a loop over the n contraction terms in
the field arithmetic of gf/field.py; `base_dft_bf16_plain`, the chunked
bf16 formulation as eight float32 matmuls, int64 buckets and a field
recombination.
"""

from __future__ import annotations

import ctypes
import os
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
# nowhere else.
LAUNCHES = {name: 0 for name in KERNELS.values()}


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


def _weights(log_n: int, inverse: bool, device) -> torch.Tensor:
    return torch.from_numpy(dft_matrix_u64(log_n, inverse).view(np.int64)).to(device)


def _chunk_weights(log_n: int, inverse: bool, device, dtype) -> torch.Tensor:
    return torch.from_numpy(dft_matrix_chunks(log_n, inverse)).to(device=device, dtype=dtype)


def base_dft_plain(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Plain PyTorch base DFT (CPU or CUDA): n multiply-adds per output."""
    n = 1 << log_n
    assert a.shape[-1] == n
    w = _weights(log_n, inverse, a.device)  # [k, i]
    out = gfp.mul(a[..., 0:1], w[:, 0])
    for i in range(1, n):
        out = gfp.add(out, gfp.mul(a[..., i : i + 1], w[:, i]))
    return out


def base_dft_bf16_plain(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Plain PyTorch base DFT in the bf16 encoding (CPU or CUDA).

    Eight unsigned 8-bit chunk planes of the data, as float32, times the
    eight chunk planes of W: every dot is an integer < 255^2 * 256 < 2^24,
    so float32 matmuls give it exactly. The 64 dots go into 15 int64
    buckets by chunk weight 2^(8 (dc + wc)), recombined in the field."""
    n = 1 << log_n
    assert a.shape[-1] == n
    w = _chunk_weights(log_n, inverse, a.device, torch.float32)  # [wc, k, i]
    planes = torch.stack([(a >> (8 * c)) & 0xFF for c in range(8)]).to(torch.float32)
    buckets = [None] * 15
    for wc in range(8):
        dots = torch.matmul(planes, w[wc].T).to(torch.int64)  # (8, ..., k)
        for dc in range(8):
            b = dc + wc
            buckets[b] = dots[dc] if buckets[b] is None else buckets[b] + dots[dc]
    out = buckets[0]  # every bucket < 2^27: already canonical
    for b in range(1, 15):
        out = gfp.add(out, gfp.mul_const(buckets[b], 1 << (8 * b)))
    return out


def _launch(a: torch.Tensor, log_n: int, inverse: bool, encoding: str) -> torch.Tensor:
    from .. import kernels

    name = KERNELS[encoding]
    lib = kernels.load(name)
    fn = getattr(lib, f"ethproof_{name}")
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    if encoding == "i8":
        w = _weights(log_n, inverse, a.device)
    else:
        w = _chunk_weights(log_n, inverse, a.device, torch.bfloat16)  # exact: < 256
    out = torch.empty_like(a)
    rows = a.numel() >> log_n
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), rows, log_n, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
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
        plain = base_dft_plain if encoding == "i8" else base_dft_bf16_plain
        return plain(a, log_n, inverse)
    if a.device.type != "cuda":
        raise ValueError(f"base_dft: unsupported device {a.device}")
    if not a.is_contiguous():
        raise ValueError("base_dft: the kernel takes a contiguous tensor")
    if a.numel() == 0:
        return torch.empty_like(a)
    return _launch(a, log_n, inverse, encoding)

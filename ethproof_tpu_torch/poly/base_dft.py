"""The four-step NTT's base level: an exact n-point DFT along the last axis.

Counterpart: ethproof_tpu/poly/pallas_ntt.py:141-185 (`_dft_kernel_i8`,
reached through `dft_last_axis`, :256-278) and its XLA twin
`mxu_ntt._field_matmul_dft_i8` (ethproof_tpu/poly/mxu_ntt.py:243).

out[..., k] = sum_i a[..., i] * W[k, i] mod p with W[k, i] = w^(k*i),
n = 2^log_n <= 256, w the order-n root (inverse: its inverse; the 1/n
scale is the caller's).

`base_dft` launches the hand-written CUDA kernel (csrc/base_dft.cu) on a
CUDA tensor and takes the plain version only for a tensor on the CPU.
`base_dft_plain` is that plain version: a loop over the n contraction
terms in the field arithmetic of gf/field.py, valid on either device.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..gf import field as gfp
from ..gf import field_host as fh

MAX_BASE_LOG = 8

# Launches of the CUDA kernel; `base_dft` adds one per launch and nowhere else.
LAUNCHES = 0


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


def _weights(log_n: int, inverse: bool, device) -> torch.Tensor:
    return torch.from_numpy(dft_matrix_u64(log_n, inverse).view(np.int64)).to(device)


def base_dft_plain(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Plain PyTorch base DFT (CPU or CUDA): n multiply-adds per output."""
    n = 1 << log_n
    assert a.shape[-1] == n
    w = _weights(log_n, inverse, a.device)  # [k, i]
    out = gfp.mul(a[..., 0:1], w[:, 0])
    for i in range(1, n):
        out = gfp.add(out, gfp.mul(a[..., i : i + 1], w[:, i]))
    return out


def _launch(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    from .. import kernels

    lib = kernels.load("base_dft")
    fn = lib.ethproof_base_dft
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    w = _weights(log_n, inverse, a.device)
    out = torch.empty_like(a)
    rows = a.numel() >> log_n
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), rows, log_n, stream)
    if err != 0:
        raise RuntimeError(f"base_dft kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def base_dft(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Base DFT over the last axis: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Raises on what the kernel does not take."""
    if not 1 <= log_n <= MAX_BASE_LOG:
        raise ValueError(f"base_dft takes 1 <= log_n <= {MAX_BASE_LOG}, got {log_n}")
    if a.dtype != torch.int64:
        raise TypeError(f"base_dft takes int64 field tensors, got {a.dtype}")
    if a.dim() == 0 or a.shape[-1] != 1 << log_n:
        raise ValueError(f"base_dft: last axis {tuple(a.shape)} is not 2^{log_n}")
    if a.device.type == "cpu":
        return base_dft_plain(a, log_n, inverse)
    if a.device.type != "cuda":
        raise ValueError(f"base_dft: unsupported device {a.device}")
    if not a.is_contiguous():
        raise ValueError("base_dft: the kernel takes a contiguous tensor")
    if a.numel() == 0:
        return torch.empty_like(a)
    return _launch(a, log_n, inverse)

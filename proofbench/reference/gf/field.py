"""[The benchmark's frozen copy of ethproof_tpu_torch/gf/field.py.]

Goldilocks GF(p) arithmetic on int64 tensors (plain PyTorch).

Counterpart: ethproof_tpu/gf/field.py:1 (uint32-pair lanes for the TPU VPU).

p = 2^64 - 2^32 + 1. A field element is one `torch.int64` holding the
canonical u64 bit pattern (values >= 2^63 read as negative int64). A CUDA
kernel reads the same bytes as `uint64_t`. `torch.uint64` is not used: it
cannot add, shift or compare on the CPU.

Arithmetic wraps mod 2^64 in int64, which gives the u64 result's bit
pattern. Unsigned order is signed order after flipping the sign bit
(`_ult`). A 64x64 -> 128 product is built from four 32x32 products of
32-bit limbs held in int64; each such product wraps to its exact u64 bit
pattern, and `(x >> 32) & 0xFFFFFFFF` still gives its high word. The
128-bit product folds with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), as
`_reduce128` in the counterpart does. Every function keeps results
canonical in [0, p); `inv(0) == 0`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import field_host

P = field_host.P
EPSILON = field_host.EPSILON  # 2^32 - 1 == 2^64 mod p
MULT_GROUP_GEN = field_host.MULT_GROUP_GEN
TWO_ADICITY = field_host.TWO_ADICITY

_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)  # xor with this maps unsigned order onto signed order
_P_FLIP = P - (1 << 63)  # p with its sign bit flipped, as a signed value


def to_i64(x: int) -> int:
    """u64 python int -> the int64 python int with the same bit pattern."""
    x %= 1 << 64
    return x - (1 << 64) if x >= 1 << 63 else x


# -- host <-> tensor ------------------------------------------------------------


def from_u64(arr, device=None) -> torch.Tensor:
    """numpy u64 array (or int sequence) -> canonical int64 tensor."""
    a = np.asarray(arr)
    if a.dtype != np.uint64:
        a = np.asarray([int(v) % P for v in np.ravel(a)], dtype=np.uint64).reshape(a.shape)
    a = np.ascontiguousarray(a % np.uint64(P))
    return torch.from_numpy(a.view(np.int64)).to(resolve_device(device))


def to_u64(a: torch.Tensor) -> np.ndarray:
    """-> numpy uint64 array (host transfer)."""
    return a.detach().to("cpu").contiguous().numpy().view(np.uint64).copy()


def full(shape, value: int, device) -> torch.Tensor:
    return torch.full(tuple(shape), to_i64(value % P), dtype=torch.int64, device=device)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.int64, device=device)


def ones(shape, device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=torch.int64, device=device)


# -- comparisons in unsigned order ------------------------------------------------


def _ult(a, b):
    """a < b as unsigned 64-bit values."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _uge_p(a):
    """a >= p as an unsigned 64-bit value."""
    return (a ^ _SIGN) >= _P_FLIP


# -- arithmetic -----------------------------------------------------------------


def add(a, b):
    """a + b mod p. The wrapped sum s either carried out of 64 bits or is
    >= p; both cases add EPSILON (2^64 = EPSILON, and s - p wraps to
    s + EPSILON). With a carry, s < 2^64 - 2^33, so no second carry."""
    s = a + b
    return torch.where(_ult(s, a) | _uge_p(s), s + EPSILON, s)


def sub(a, b):
    """a - b mod p. On borrow the wrapped difference is 2^64 too big:
    subtract EPSILON (it is >= EPSILON, so no second borrow)."""
    d = a - b
    return torch.where(_ult(a, b), d - EPSILON, d)


def neg(a):
    return sub(torch.zeros_like(a), a)


def _mul_wide(a, b):
    """Exact 128-bit product -> (x_lo u64 pattern, r2, r3) with
    product = x_lo + r2 * 2^64 + r3 * 2^96, r2 and r3 in [0, 2^32)."""
    a0 = a & _M32
    a1 = (a >> 32) & _M32
    b0 = b & _M32
    b1 = (b >> 32) & _M32
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = ((p00 >> 32) & _M32) + (p01 & _M32) + (p10 & _M32)
    top = ((p01 >> 32) & _M32) + ((p10 >> 32) & _M32) + (p11 & _M32) + (mid >> 32)
    x_lo = (mid << 32) | (p00 & _M32)
    r3 = ((p11 >> 32) & _M32) + (top >> 32)
    return x_lo, top & _M32, r3


def _reduce128(x_lo, r2, r3):
    """x_lo + r2 * 2^64 + r3 * 2^96 mod p, canonical (plonky2's reduce128)."""
    t0 = x_lo - r3
    t0 = torch.where(_ult(x_lo, r3), t0 - EPSILON, t0)
    t1 = (r2 << 32) - r2  # r2 * EPSILON < 2^64
    t2 = t0 + t1
    return torch.where(_ult(t2, t1) | _uge_p(t2), t2 + EPSILON, t2)


def reduce_wide(h, l):
    """h * 2^32 + l mod p for nonnegative int64 h, l < 2^62 (canonical).

    Folds the limb sums of `sum_dim` and of Poseidon's MDS layer."""
    h = h + (l >> 32)
    w = ((h & _M32) << 32) | (l & _M32)
    t = (h >> 32) * EPSILON  # h >> 32 < 2^31: exact, positive
    r = w + t
    return torch.where(_ult(r, t) | _uge_p(r), r + EPSILON, r)


def mul(a, b):
    return _reduce128(*_mul_wide(a, b))


def sqr(a):
    return mul(a, a)


def mul_const(a, c: int):
    """Multiply by a python-int constant (broadcast)."""
    return mul(a, torch.tensor(to_i64(c % P), dtype=torch.int64, device=a.device))


def pow_const(a, e: int):
    """a^e for a python-int exponent (square-and-multiply)."""
    e %= P - 1
    if e == 0:
        return torch.ones_like(a)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = sqr(base)
    return result


def inv(a):
    """a^(p-2); zero maps to zero (callers guard where that matters)."""
    return pow_const(a, P - 2)


def sum_dim(a, dim: int = -1):
    """Modular sum along `dim` (at most 2^30 terms): exact int64 sums of
    the 32-bit limbs, one fold at the end."""
    assert a.shape[dim] < 1 << 30
    lo = (a & _M32).sum(dim)
    hi = ((a >> 32) & _M32).sum(dim)
    return reduce_wide(hi, lo)

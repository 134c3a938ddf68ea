"""[The benchmark's frozen copy of ethproof_tpu_torch/poly/ntt.py.]

Radix-2 NTT / iNTT / coset-LDE over Goldilocks (plain PyTorch).

Counterpart: ethproof_tpu/poly/ntt.py:60-174. The transform runs over the
LAST axis; leading axes are batch. `ntt` maps natural-order coefficients
to natural-order evaluations over H = <w_n>; `intt` is its exact inverse;
`coset_lde` evaluates on shift * H' with |H'| = n * 2^rate_bits.

Used for n < 2^9, as the counterpart's size dispatch does
(ethproof_tpu/poly/mxu_ntt.py:368); larger transforms go through the
four-step NTT of four_step.py.
"""

from __future__ import annotations

import torch

from ..gf import field as gfp
from ..gf import field_host


def powers(base: int, n: int, device) -> torch.Tensor:
    """[1, base, ..., base^(n-1)] by log-doubling (log2 n batched muls)."""
    assert n & (n - 1) == 0 and n >= 1
    p = gfp.ones((1,), device)
    acc = gfp.full((), base, device)
    length = 1
    while length < n:
        p = torch.cat([p, gfp.mul(p, acc)])
        acc = gfp.mul(acc, acc)
        length *= 2
    return p


def _bitrev_indices(log_n: int, device) -> torch.Tensor:
    idx = torch.arange(1 << log_n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev = (rev << 1) | ((idx >> b) & 1)
    return rev


def _ntt_impl(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    n = a.shape[-1]
    assert n & (n - 1) == 0, "length must be a power of two"
    log_n = n.bit_length() - 1
    if n == 1:
        return a
    x = a.index_select(-1, _bitrev_indices(log_n, a.device))
    batch = x.shape[:-1]
    for s in range(log_n):
        half = 1 << s
        root = field_host.primitive_root_of_unity(s + 1)
        if inverse:
            root = field_host.inv(root)
        w = powers(root, half, a.device)
        xr = x.reshape(batch + (n >> (s + 1), 2, half))
        t = gfp.mul(xr[..., 1, :], w)
        x0 = xr[..., 0, :]
        x = torch.stack([gfp.add(x0, t), gfp.sub(x0, t)], dim=-2).reshape(batch + (n,))
    if inverse:
        x = gfp.mul_const(x, field_host.inv(n))
    return x


def ntt(a: torch.Tensor) -> torch.Tensor:
    """Forward NTT over the last axis (natural -> natural order)."""
    return _ntt_impl(a, inverse=False)


def intt(a: torch.Tensor) -> torch.Tensor:
    """Inverse NTT over the last axis (exact inverse of ntt)."""
    return _ntt_impl(a, inverse=True)


def coset_scale_pad(coeffs: torch.Tensor, rate_bits: int, shift: int) -> torch.Tensor:
    """c_i * shift^i, zero-padded to n << rate_bits: p(shift * x) ready
    for a forward NTT over the larger domain."""
    n = coeffs.shape[-1]
    scaled = gfp.mul(coeffs, powers(shift, n, coeffs.device))
    return torch.nn.functional.pad(scaled, (0, (n << rate_bits) - n))


def coset_lde(coeffs: torch.Tensor, rate_bits: int, shift: int) -> torch.Tensor:
    """Evaluate polys (coeffs over the last axis) on shift * H'."""
    return _ntt_impl(coset_scale_pad(coeffs, rate_bits, shift), inverse=False)


def coset_intt(evals: torch.Tensor, shift: int) -> torch.Tensor:
    """Inverse of evaluation on shift * H: evaluations -> coefficients."""
    coeffs = _ntt_impl(evals, inverse=True)
    inv_sp = powers(field_host.inv(shift), evals.shape[-1], evals.device)
    return gfp.mul(coeffs, inv_sp)

"""Four-step NTT over the last axis, with the CUDA base-DFT at the bottom.

Counterpart: ethproof_tpu/poly/mxu_ntt.py:272-337 (`_twiddle_table`,
`_mxu_ntt_rec`) and the prover-facing `best_ntt` / `best_intt` /
`best_coset_lde` / `best_coset_intt` (:464-487), under the same names.

Bailey's four-step with n = n1 * n2 and x[i1*n2 + i2]:
  1. n1-point DFTs along i1, 2. twiddle by w_n^(i2*k1),
  3. n2-point DFTs along i2, 4. out[k2*n1 + k1] (a transpose).
Levels recurse until they reach the base (<= 2^8 points), where
`base_dft` runs. Any exact partition gives the same output, so the
counterpart's MXU cost model (`_partition`) is not copied: the port splits
a transform into ceil(log_n / 8) near-equal levels (2^19 = 2^7 * 2^6 * 2^6),
which keeps the base kernel's n multiply-adds per element small. The
HBM row-blocking of the counterpart (`_BLOCK_ELEMS`, `_map_rows`,
`_mxu_ntt_big`, :370-461) is not needed on an 80 GB card at this slice's
sizes. Transforms below 2^9 points take the radix-2 path of ntt.py, as
the counterpart's `_MXU_MIN` (:368) dispatch does.
"""

from __future__ import annotations

import torch

from ..gf import field as gfp
from ..gf import field_host as fh
from . import ntt as nttm
from .base_dft import MAX_BASE_LOG, base_dft

FOUR_STEP_MIN = 1 << 9


def _split(log_n: int) -> int:
    """log2 of the last (base) level for a 2^log_n transform."""
    levels = -(-log_n // MAX_BASE_LOG)
    return log_n // levels


def _twiddle_table(log_n1: int, log_n2: int, inverse: bool, device) -> torch.Tensor:
    """(n1, n2) tensor [k1, i2] of w_n^(i2*k1)."""
    log_n = log_n1 + log_n2
    w = fh.primitive_root_of_unity(log_n)
    if inverse:
        w = fh.inv(w)
    n1, n2 = 1 << log_n1, 1 << log_n2
    pw = nttm.powers(w, 1 << log_n, device)
    k1 = torch.arange(n1, device=device)[:, None]
    i2 = torch.arange(n2, device=device)[None, :]
    return pw[(k1 * i2) & ((1 << log_n) - 1)]


def _four_step(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Natural-order four-step DFT over the last axis (no 1/n scale)."""
    if log_n <= MAX_BASE_LOG:
        return base_dft(a.contiguous(), log_n, inverse)
    log_n2 = _split(log_n)
    log_n1 = log_n - log_n2
    n1, n2 = 1 << log_n1, 1 << log_n2
    batch = a.shape[:-1]
    x = a.reshape(batch + (n1, n2))
    s1 = _four_step(x.transpose(-1, -2).contiguous(), log_n1, inverse)  # [.., i2, k1]
    tw = _twiddle_table(log_n1, log_n2, inverse, a.device).transpose(0, 1)  # [i2, k1]
    s2 = gfp.mul(s1, tw)
    s3 = _four_step(s2.transpose(-1, -2).contiguous(), log_n2, inverse)  # [.., k1, k2]
    return s3.transpose(-1, -2).reshape(batch + (1 << log_n,))


def _ntt_auto(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    n = a.shape[-1]
    if n < FOUR_STEP_MIN:
        return nttm._ntt_impl(a, inverse)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "length must be a power of two"
    out = _four_step(a, log_n, inverse)
    if inverse:
        out = gfp.mul_const(out, fh.inv(n))
    return out


def best_ntt(a: torch.Tensor) -> torch.Tensor:
    """NTT over the last axis (natural order), size-dispatched."""
    return _ntt_auto(a, inverse=False)


def best_intt(a: torch.Tensor) -> torch.Tensor:
    """Inverse NTT over the last axis (natural order), size-dispatched."""
    return _ntt_auto(a, inverse=True)


def best_coset_lde(coeffs: torch.Tensor, rate_bits: int, shift: int) -> torch.Tensor:
    """Evaluations on shift * H' (|H'| = n << rate_bits), natural order."""
    if (coeffs.shape[-1] << rate_bits) >= FOUR_STEP_MIN:
        return _ntt_auto(nttm.coset_scale_pad(coeffs, rate_bits, shift), inverse=False)
    return nttm.coset_lde(coeffs, rate_bits, shift)


def best_coset_intt(evals: torch.Tensor, shift: int) -> torch.Tensor:
    """Coefficients of the polys whose evaluations on shift * H are given."""
    coeffs = _ntt_auto(evals, inverse=True)
    inv_sp = nttm.powers(fh.inv(shift), evals.shape[-1], evals.device)
    return gfp.mul(coeffs, inv_sp)

"""The reference's NTTs: the radix-2 transforms of `ntt.py` at every size.

The program dispatches transforms of 2^9 points and more to its four-step
NTT over the base-DFT kernel; the reference never does, so the four-step
layer and the kernel are held against an independent route to the same
exact values. The names are the program's `poly/four_step` entry points.
"""

from __future__ import annotations

import torch

from . import ntt as nttm


def best_ntt(a: torch.Tensor) -> torch.Tensor:
    return nttm.ntt(a)


def best_intt(a: torch.Tensor) -> torch.Tensor:
    return nttm.intt(a)


def best_coset_lde(coeffs: torch.Tensor, rate_bits: int, shift: int) -> torch.Tensor:
    return nttm.coset_lde(coeffs, rate_bits, shift)


def best_coset_intt(evals: torch.Tensor, shift: int) -> torch.Tensor:
    return nttm.coset_intt(evals, shift)

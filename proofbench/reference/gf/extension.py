"""[The benchmark's frozen copy of ethproof_tpu_torch/gf/extension.py.]

Quadratic extension GF(p^2) = GF(p)[X] / (X^2 - W), W = 7.

Counterpart: ethproof_tpu/gf/extension.py:1. An element is a pair of
int64 field tensors (a + b X).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import field as gfp

W_EXT = 7


class GF2(NamedTuple):
    """a + b*X with X^2 = 7."""

    a: torch.Tensor
    b: torch.Tensor

    def __getitem__(self, idx):
        return GF2(self.a[idx], self.b[idx])


def full(shape, value, device) -> GF2:
    """Broadcast constant from a host pair (a, b)."""
    return GF2(gfp.full(shape, value[0], device), gfp.full(shape, value[1], device))


def add(x: GF2, y: GF2) -> GF2:
    return GF2(gfp.add(x.a, y.a), gfp.add(x.b, y.b))


def sub(x: GF2, y: GF2) -> GF2:
    return GF2(gfp.sub(x.a, y.a), gfp.sub(x.b, y.b))


def mul(x: GF2, y: GF2) -> GF2:
    """(a0 + b0 X)(a1 + b1 X) = a0 a1 + 7 b0 b1 + (a0 b1 + b0 a1) X."""
    a0a1 = gfp.mul(x.a, y.a)
    b0b1 = gfp.mul(x.b, y.b)
    a = gfp.add(a0a1, gfp.mul_const(b0b1, W_EXT))
    b = gfp.add(gfp.mul(x.a, y.b), gfp.mul(x.b, y.a))
    return GF2(a, b)


def mul_base(x: GF2, s) -> GF2:
    return GF2(gfp.mul(x.a, s), gfp.mul(x.b, s))


def inv(x: GF2) -> GF2:
    """1 / (a + bX) = (a - bX) / (a^2 - 7 b^2) (norm in the base field)."""
    norm = gfp.sub(gfp.sqr(x.a), gfp.mul_const(gfp.sqr(x.b), W_EXT))
    ninv = gfp.inv(norm)
    return GF2(gfp.mul(x.a, ninv), gfp.mul(gfp.neg(x.b), ninv))

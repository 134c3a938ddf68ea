"""FieldOps backend that COMPILES constraint evaluation into circuit gates.

Counterpart: ethproof_tpu/recursion/ops_circuit.py:1 (a copy).

The third interpretation of a table's `eval` (after DeviceOps — whole-LDE
device sweep — and HostExtOps — python ints at zeta): values are GF(p^2)
wire pairs in a `CBuilder`, so running the SAME `Stark.eval` emits the
gates that re-check the constraint identity inside the verifier machine.
This is the TPU-native replacement for plonky2's hand-built in-circuit
`eval_vanishing_poly` (reference dep pin Cargo.lock:3441):
instead of maintaining a parallel "recursive" copy of every table's
constraint code, the one shared evaluator is traced symbolically.

Transcript values (challenges, CTL totals) arrive as wire pairs through
`ops.challenge`, which passes them through — see FieldOps.challenge.
"""

from __future__ import annotations

from typing import List, Sequence

from ..gf import field_host as fh
from .circuit import CBuilder, Ext

P = fh.P


class CircuitExtOps:
    """GF(p^2) arithmetic over wire pairs; vectors are python lists.

    Mirrors HostExtOps' broadcast semantics so table code written against
    the vector constraint API compiles unchanged.
    """

    def __init__(self, b: CBuilder):
        self.b = b

    # -- scalar ---------------------------------------------------------------

    def _bin(self, a, b, f):
        if isinstance(a, list) or isinstance(b, list):
            if not isinstance(a, list):
                a = [a] * len(b)
            if not isinstance(b, list):
                b = [b] * len(a)
            return [f(x, y) for x, y in zip(a, b)]
        return f(a, b)

    def add(self, a, b):
        return self._bin(a, b, self.b.ext_add)

    def sub(self, a, b):
        return self._bin(a, b, self.b.ext_sub)

    def mul(self, a, b):
        return self._bin(a, b, self.b.ext_mul)

    def constant(self, c: int) -> Ext:
        return self.b.ext_const((c % P, 0))

    def zero(self) -> Ext:
        return self.constant(0)

    def one(self) -> Ext:
        return self.constant(1)

    def challenge(self, c) -> Ext:
        """Transcript values are already wire pairs under compilation."""
        assert isinstance(c, tuple) and len(c) == 2, (
            "circuit compilation requires transcript values as wire pairs; "
            f"got {c!r}"
        )
        return c

    def alpha_pow(self, alpha, k: int) -> Ext:
        """alpha^k by square-and-multiply on wires (k is compile-static)."""
        alpha = self.challenge(alpha)
        acc = self.one()
        base = alpha
        e = k
        while e:
            if e & 1:
                acc = self.b.ext_mul(acc, base)
            e >>= 1
            if e:
                base = self.b.ext_mul(base, base)
        return acc

    # -- vector API -----------------------------------------------------------

    def stack(self, vals) -> List[Ext]:
        return list(vals)

    def vec_len(self, vec) -> int:
        return len(vec)

    def fold_vec(self, vec: Sequence[Ext], alpha) -> Ext:
        """sum_j alpha^(k-1-j) vec_j, Horner. alpha: wire pair or int."""
        if alpha == 1:  # plain sum (logUp h-sums): skip the unit muls
            acc = vec[0]
            for c in vec[1:]:
                acc = self.b.ext_add(acc, c)
            return acc
        if not isinstance(alpha, tuple):
            alpha = self.constant(alpha)
        acc = self.zero()
        for c in vec:
            acc = self.b.ext_add(self.b.ext_mul(acc, alpha), c)
        return acc

    def pack_weighted(self, vec: Sequence[Ext], weights, group: int) -> List[Ext]:
        out = []
        for i in range(len(vec) // group):
            acc = self.zero()
            for j, w in enumerate(weights):
                acc = self.b.ext_add(
                    acc, self.b.ext_mulc(int(w) % P, vec[i * group + j])
                )
            out.append(acc)
        return out

"""[The benchmark's frozen copy of ethproof_tpu_torch/stark/stark.py, without the
verifier's `HostExtOps`.]

Stark table interface + constraint consumer.

Counterpart: ethproof_tpu/stark/stark.py:1. `FieldOps`, `HostExtOps`,
`ConstraintConsumer`, `EvalContext`, `Stark`, the lookup and CTL specs and
their shared constraint emitters are copies; `DeviceOps` is the torch
version (int challenges only: the port's sweep is the direct evaluation of
`eval`, not a trace under jit).

Reference equivalent: starky's `Stark` trait and `ConstraintConsumer`:

- `constraint(c)`: c must vanish on ALL of H.
- `constraint_transition(c)`: all rows but the last — implemented by
  multiplying c with z_last(x) = x - g^(n-1) before the Z_H division.
- `constraint_first_row(c)` / `constraint_last_row(c)`: multiplied by the
  (unnormalized-consistent) Lagrange selectors L_first = Z_H/(n*(x-1)),
  L_last = Z_H/(n*g^(n-1)... ) — both provided by the evaluation context so
  prover (device arrays over the LDE coset) and verifier (host extension
  scalars at zeta) use identical algebra.
- Accumulation is Horner in alpha per soundness challenge:
  acc = acc * alpha + term.

A table is a `Stark` subclass defining column/public-input counts, the
constraint degree bound (<= 3: quotient fits in the rate-4 LDE), and
`eval(ctx)` written against ctx's field ops — the SAME code path runs over
whole-domain tensors in the prover sweep and on python ints at zeta in the
verifier, which is what guarantees the two agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..gf import field as gfp


class FieldOps:
    """Abstract field arithmetic used by constraint evaluators."""

    def add(self, a, b):  # pragma: no cover - interface
        raise NotImplementedError

    def sub(self, a, b):
        raise NotImplementedError

    def mul(self, a, b):
        raise NotImplementedError

    def constant(self, c: int):
        raise NotImplementedError

    def challenge(self, c):
        """A transcript value (challenge or prover message) as a field
        value. On prover/verifier paths these are python ints
        (-> constant); the recursion compiler overrides this to pass
        compiled wire values through."""
        return self.constant(c)

    def alpha_pow(self, alpha, k: int):
        """alpha^k for a transcript challenge (int on prover/verifier
        paths; wire value under the recursion compiler, which overrides
        this with square-and-multiply gates)."""
        return self.constant(pow(alpha, k, 0xFFFFFFFF00000001))

    def zero(self):
        return self.constant(0)

    def one(self):
        return self.constant(1)


class DeviceOps(FieldOps):
    """Base-field int64 tensors over the LDE domain (prover sweep).

    Challenges are python ints and become broadcast constants. "Vectors"
    are tensors with a leading stack axis (k, m): the same elementwise ops
    apply, and `fold_vec`/`pack_weighted` turn k structurally identical
    constraints into one weighted modular sum.
    """

    def __init__(self, shape, device):
        self._shape = tuple(shape)
        self._device = device

    def add(self, a, b):
        return gfp.add(a, b)

    def sub(self, a, b):
        return gfp.sub(a, b)

    def mul(self, a, b):
        return gfp.mul(a, b)

    def constant(self, c: int):
        return gfp.full(self._shape, c, self._device)

    # -- vector API ----------------------------------------------------------

    def stack(self, vals):
        return torch.stack(list(vals))

    def vec_len(self, vec) -> int:
        return vec.shape[0]

    def _weights(self, ws, ndim_rest: int):
        w = gfp.from_u64(np.asarray([int(x) % gfp.P for x in ws], dtype=np.uint64), self._device)
        return w.reshape((len(ws),) + (1,) * ndim_rest)

    def fold_vec(self, vec, alpha: int):
        """sum_j alpha^(k-1-j) * vec_j — the Horner-equivalent batch fold."""
        k = self.vec_len(vec)
        w = [pow(alpha, k - 1 - j, gfp.P) for j in range(k)]
        return gfp.sum_dim(gfp.mul(vec, self._weights(w, vec.dim() - 1)), 0)

    def pack_weighted(self, vec, weights, group: int):
        """out_i = sum_j weights[j] * vec[i*group + j]; vec (k*group, m)."""
        kg = self.vec_len(vec)
        assert kg % group == 0
        r = vec.reshape((kg // group, group) + tuple(vec.shape[1:]))
        wb = self._weights(list(weights), vec.dim() - 1).unsqueeze(0)
        return gfp.sum_dim(gfp.mul(r, wb), 1)


class ConstraintConsumer:
    """Accumulates weighted constraints, Horner-style per alpha.

    `constraint_vec*` absorbs a whole stack of k constraints in one step:
    acc = acc * alpha^k + fold_vec(stack, alpha) — algebraically identical
    to k scalar constraint() calls in stack order, but log-depth on
    device. Selector weights (z_last / Lagrange) distribute over the fold.
    """

    def __init__(self, ops: FieldOps, alphas_int: List[int], z_last, l_first, l_last):
        self.ops = ops
        self.alphas_int = list(alphas_int)
        self.alphas = [ops.challenge(a) for a in alphas_int]
        self.accs = [ops.zero() for _ in alphas_int]
        self.z_last = z_last
        self.l_first = l_first
        self.l_last = l_last

    def _accumulate(self, term) -> None:
        o = self.ops
        self.accs = [o.add(o.mul(acc, a), term) for acc, a in zip(self.accs, self.alphas)]

    def constraint(self, c) -> None:
        self._accumulate(c)

    def constraint_transition(self, c) -> None:
        self._accumulate(self.ops.mul(c, self.z_last))

    def constraint_first_row(self, c) -> None:
        self._accumulate(self.ops.mul(c, self.l_first))

    def constraint_last_row(self, c) -> None:
        self._accumulate(self.ops.mul(c, self.l_last))

    def _accumulate_vec(self, vec, weight) -> None:
        o = self.ops
        k = o.vec_len(vec)
        new_accs = []
        for acc, a_int, a_val in zip(self.accs, self.alphas_int, self.alphas):
            folded = o.fold_vec(vec, a_int)
            if weight is not None:
                folded = o.mul(folded, weight)
            a_k = o.alpha_pow(a_int, k)
            new_accs.append(o.add(o.mul(acc, a_k), folded))
        self.accs = new_accs

    def constraint_vec(self, vec) -> None:
        self._accumulate_vec(vec, None)

    def constraint_vec_transition(self, vec) -> None:
        self._accumulate_vec(vec, self.z_last)

    def constraint_vec_first_row(self, vec) -> None:
        self._accumulate_vec(vec, self.l_first)

    def constraint_vec_last_row(self, vec) -> None:
        self._accumulate_vec(vec, self.l_last)


class EvalContext:
    """What a table's `eval` sees: rows, public inputs, consumer, ops."""

    def __init__(
        self, ops, local_values, next_values, public_inputs, consumer,
        fixed_local=None, fixed_next=None,
    ):
        self.ops = ops
        self._local = local_values
        self._next = next_values
        self._public = public_inputs
        self.consumer = consumer
        self._fixed_local = fixed_local or []
        self._fixed_next = fixed_next or []

    def local(self, i: int):
        return self._local[i]

    def next(self, i: int):
        return self._next[i]

    def fixed(self, i: int):
        return self._fixed_local[i]

    def fixed_next(self, i: int):
        return self._fixed_next[i]

    def public_input(self, i: int):
        return self._public[i]

    # stacked accessors for the vector constraint API
    def local_stack(self, idxs):
        return self.ops.stack([self._local[i] for i in idxs])

    def next_stack(self, idxs):
        return self.ops.stack([self._next[i] for i in idxs])

    def fixed_stack(self, idxs):
        return self.ops.stack([self._fixed_local[i] for i in idxs])

    def public_stack(self, idxs):
        return self.ops.stack([self._public[i] for i in idxs])


class Stark:
    """Base class for a provable table."""

    num_columns: int = 0
    num_public_inputs: int = 0
    constraint_degree: int = 3  # max total degree of any accumulated term
    lookups: "List[LookupSpec]" = []  # in-table logUp range/set checks
    num_fixed_columns: int = 0  # preprocessed columns (program ROM etc.)

    def fixed_columns(self, n: int):
        """(num_fixed_columns, n) uint64 — deterministic per (table, n).

        Fixed columns are part of the circuit DEFINITION, not the witness:
        they are committed once per (table, n) as the verification key and
        opened like trace columns. This is the preprocessed-column
        mechanism that encodes the CPU kernel's program ROM.
        """
        return np.zeros((0, n), dtype=np.uint64)

    def eval(self, ctx: EvalContext) -> None:  # pragma: no cover - interface
        """Emit constraints via ctx.consumer.* using ctx.ops arithmetic."""
        raise NotImplementedError

    # -- custom aux columns (challenge-parameterized, committed) -------------
    # Tables may commit extra columns computed AFTER the trace commitment
    # from post-commit challenges (beyond the engine's CTL/logUp shapes).
    # Used by the recursion machine's wire bus (recursion/machine.py).

    def num_aux_challenges(self, num_challenges: int) -> int:
        return 0

    def num_custom_aux(self, num_challenges: int) -> int:
        return 0

    def custom_aux_columns(self, trace_gf, fixed_gf, challenges: List[int]):
        """-> (num_custom_aux, n) columns on the trace's device."""
        raise NotImplementedError

    def eval_custom(self, ctx: EvalContext, aux_local, aux_next, challenges) -> None:
        """Constraints over the custom aux slice; ops-generic like eval.
        `challenges` entries must only be consumed via ctx.ops.challenge."""
        raise NotImplementedError

    def effective_degree(self, has_ctls: bool) -> int:
        # CTL transition constraints are degree 3 (Z * filter * combine)
        return max(self.constraint_degree, 3) if has_ctls else self.constraint_degree

    def quotient_chunks(self, has_ctls: bool = False) -> int:
        # deg(sum w*c) <= d*(n-1)+1; after /Z_H the quotient has degree
        # < (d-1)*n -> that many size-n chunks.
        return max(self.effective_degree(has_ctls) - 1, 1)


# -- in-table lookups (logUp) ------------------------------------------------


@dataclass(frozen=True)
class LookupSpec:
    """logUp range/set check: every value in `looking_cols` must appear in
    the in-table column `table_col`; `multiplicity_col` counts occurrences.

    Argument (starky's logUp lookups): for a challenge alpha, the identity
      sum_rows sum_j 1/(alpha - v_j)  ==  sum_rows m/(alpha - t)
    is proved with committed inverse-witness columns h_j (h_j*(alpha-v_j)=1)
    and g (g*(alpha-t)=m) plus a running-sum column S with
      S_first = sum_j h_j - g,  S_next = S_local + sum_j h_j(next) - g(next),
      S_last = 0.
    All constraints are degree <= 2, fitting the standard envelope.
    """

    looking_cols: Tuple[int, ...]
    table_col: int
    multiplicity_col: int


def lookup_aux_count(spec: LookupSpec) -> int:
    """h columns + g + S."""
    return len(spec.looking_cols) + 2


def eval_lookup_constraints(ops, consumer, local, nxt, local_aux, next_aux, spec, alpha):
    """Shared (device sweep / host-at-zeta) logUp constraint emission.

    local_aux/next_aux: the aux slice for this (spec, challenge): first
    len(looking_cols) entries are h_j, then g, then S. The k inverse-
    witness constraints are emitted as ONE vector constraint (log-depth
    on device).
    """
    k = len(spec.looking_cols)
    a = ops.challenge(alpha)
    one = ops.one()
    hs_l = ops.stack(local_aux[:k])
    g_l = local_aux[k]
    s_l = local_aux[k + 1]
    hs_n = ops.stack(next_aux[:k])
    g_n = next_aux[k]
    s_n = next_aux[k + 1]
    v_l = ops.stack([local[c] for c in spec.looking_cols])
    consumer.constraint_vec(ops.sub(ops.mul(hs_l, ops.sub(a, v_l)), one))
    consumer.constraint(
        ops.sub(
            ops.mul(g_l, ops.sub(a, local[spec.table_col])),
            local[spec.multiplicity_col],
        )
    )

    def h_sum(hs, g):
        return ops.sub(ops.fold_vec(hs, 1), g)  # alpha=1 fold == plain sum

    consumer.constraint_first_row(ops.sub(s_l, h_sum(hs_l, g_l)))
    consumer.constraint_transition(ops.sub(s_n, ops.add(s_l, h_sum(hs_n, g_n))))
    consumer.constraint_last_row(s_l)


# -- cross-table lookups -----------------------------------------------------


@dataclass(frozen=True)
class LC:
    """Affine combination of trace columns: sum(coeff * col) + const.

    CTL tuple elements may be virtual columns (e.g. `virt + i` for a
    byte-packing lookup at offset i) — still degree 1, so Z-column
    transition constraints stay within the degree envelope. Mirrors
    starky's `Column` linear-combination type.
    """

    terms: Tuple[Tuple[int, int], ...]  # (column, coeff)
    const: int = 0


CtlColumn = "int | LC"


def eval_ctl_column(ops, vals, col) -> object:
    """Evaluate a plain or virtual CTL column against row values."""
    if isinstance(col, int):
        return vals[col]
    acc = ops.constant(col.const)
    for c, coeff in col.terms:
        acc = ops.add(acc, ops.mul(ops.constant(coeff), vals[c]))
    return acc


@dataclass(frozen=True)
class CtlSpec:
    """One side of a lookup: which columns (plain indices or LC virtual
    columns) form the tuple, which column (0/1-valued) filters
    participating rows (None = all rows)."""

    columns: Tuple["int | LC", ...]
    filter_col: Optional[int] = None


@dataclass(frozen=True)
class CtlInstance:
    """A table-local Z-column instance: spec + bound challenges.

    The grand-product argument (starky CTL semantics): with challenges (beta, gamma),
    combine(row) = gamma + sum_j beta^j * col_j, and
    factor(row) = filter * (combine - 1) + 1. The committed Z column is the
    running product of factor over the subgroup rows; the final value
    (`total`) is a prover message checked across tables by the multi-table
    verifier: prod(looking totals) == looked total.
    """

    spec: CtlSpec
    beta: int
    gamma: int


def eval_ctl_constraints(ops, consumer, local, nxt, local_zs, next_zs, instances, totals):
    """Shared (device sweep / host-at-zeta) CTL constraint emission.

    local/nxt: trace column values; local_zs/next_zs: Z column values
    (one per instance); totals: claimed final products (field constants).
    """

    def combine(vals, inst):
        # gamma + sum_j beta^j * col_j, Horner from the highest power so
        # beta may be a compiled wire (recursion) or an int (prover /
        # verifier — identical algebra to _ctl_z_columns' power loop).
        beta = ops.challenge(inst.beta)
        cols = [eval_ctl_column(ops, vals, j) for j in inst.spec.columns]
        acc = cols[-1]
        for v in reversed(cols[:-1]):
            acc = ops.add(ops.mul(acc, beta), v)
        return ops.add(ops.challenge(inst.gamma), acc)

    def factor(vals, inst):
        c = combine(vals, inst)
        if inst.spec.filter_col is None:
            return c
        f = vals[inst.spec.filter_col]
        one = ops.one()
        return ops.add(ops.mul(f, ops.sub(c, one)), one)

    for k, inst in enumerate(instances):
        f_local = factor(local, inst)
        f_next = factor(nxt, inst)
        z_l, z_n = local_zs[k], next_zs[k]
        consumer.constraint_first_row(ops.sub(z_l, f_local))
        consumer.constraint_transition(ops.sub(z_n, ops.mul(z_l, f_next)))
        consumer.constraint_last_row(ops.sub(z_l, ops.challenge(totals[k])))

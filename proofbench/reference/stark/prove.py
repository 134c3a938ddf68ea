"""The reference's single-table STARK prover.

A frozen copy of `ethproof_tpu_torch/stark/prove.py` (`_commit_gf`,
`_ctl_z_columns`, `_lookup_aux_columns`, `stark_prove`, `_sweep`,
`_compute_quotient`, `_compute_openings`, `_deep_composition` and their
helpers) cut down to one device and the direct sweep: every commit is
iNTT -> coset LDE -> Merkle tree on the radix-2 NTT, the constraint sweep
evaluates `stark.eval` (plus the CTL and logUp constraints) over the whole
LDE domain at once, and the DEEP codeword is one block. Its proof is the
program's field for field.

Transcript: observe(public_inputs, degree_bits) -> [observe(fixed cap)] ->
observe(trace cap) -> [lookup alphas] -> [observe(aux cap) -> observe(ctl
totals)] -> alphas -> observe(quotient cap) -> zeta -> observe(openings)
-> fri_alpha -> FRI transcript.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..fri.challenger import Challenger
from ..fri.config import StarkConfig
from ..fri.prove import FriProof, fri_prove
from ..gf import extension as gf2x
from ..gf import field as gfp
from ..gf import field_host as fh
from ..gf.extension import GF2
from ..hash import merkle
from ..poly import ntt as nttm
from ..poly import transform
from .stark import (
    LC,
    ConstraintConsumer,
    CtlInstance,
    DeviceOps,
    EvalContext,
    Stark,
    eval_ctl_constraints,
    eval_lookup_constraints,
    lookup_aux_count,
)

P = fh.P
# Rows of a DEEP batch are combined in blocks of at most this many elements.
COMBINE_BLOCK_ELEMS = 1 << 25


@dataclass
class Commitment:
    values: torch.Tensor  # (cols, n) values (coefficients for the quotient)
    coeffs: torch.Tensor  # (cols, n)
    lde: torch.Tensor  # (cols, n << rate_bits)
    tree: merkle.MerkleTree
    cap: np.ndarray  # (4, 2^cap_height) u64


def commit(a: torch.Tensor, config: StarkConfig, from_coeffs: bool = False) -> Commitment:
    fri = config.fri_config
    coeffs = a if from_coeffs else transform.best_intt(a)
    lde = transform.best_coset_lde(coeffs, fri.rate_bits, fri.coset_shift)
    tree = merkle.build(lde, fri.cap_height)
    return Commitment(a, coeffs, lde, tree, gfp.to_u64(tree.cap))


@dataclass
class TreeOpenings:
    values: np.ndarray  # (num_q, num_rows) u64
    paths: np.ndarray  # (num_q, path_len, 4) u64


def _empty_ext() -> np.ndarray:
    return np.zeros((0, 2), dtype=np.uint64)


@dataclass
class StarkOpenings:
    trace_at_zeta: np.ndarray
    trace_at_gzeta: np.ndarray
    aux_at_zeta: np.ndarray
    aux_at_gzeta: np.ndarray
    quotient_at_zeta: np.ndarray
    fixed_at_zeta: np.ndarray = field(default_factory=_empty_ext)
    fixed_at_gzeta: np.ndarray = field(default_factory=_empty_ext)

    def transcript_elements(self) -> List[int]:
        out: List[int] = []
        for arr in (self.trace_at_zeta, self.trace_at_gzeta, self.fixed_at_zeta,
                    self.fixed_at_gzeta, self.aux_at_zeta, self.aux_at_gzeta,
                    self.quotient_at_zeta):
            out.extend(int(v) for v in np.asarray(arr, dtype=np.uint64).ravel())
        return out


@dataclass
class StarkProof:
    degree_bits: int
    public_inputs: List[int]
    trace_cap: np.ndarray
    aux_cap: Optional[np.ndarray]
    quotient_cap: np.ndarray
    ctl_totals: List[int]
    openings: StarkOpenings
    fri_proof: FriProof
    trace_query_openings: TreeOpenings
    aux_query_openings: Optional[TreeOpenings]
    quotient_query_openings: TreeOpenings
    fixed_query_openings: Optional[TreeOpenings] = None


def _scan(x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive prefix scan along the last axis (log2 n steps)."""
    n = x.shape[-1]
    d = 1
    while d < n:
        x = torch.cat([x[..., :d], op(x[..., d:], x[..., :-d])], dim=-1)
        d *= 2
    return x


def ext_powers(point: Tuple[int, int], n: int, device) -> GF2:
    p = GF2(gfp.ones((1,), device), gfp.zeros((1,), device))
    acc = gf2x.full((), point, device)
    length = 1
    while length < n:
        nxt = gf2x.mul(p, acc)
        p = GF2(torch.cat([p.a, nxt.a]), torch.cat([p.b, nxt.b]))
        acc = gf2x.mul(acc, acc)
        length *= 2
    return p


def eval_at_ext_point(coeffs: torch.Tensor, pws: GF2) -> np.ndarray:
    if coeffs.shape[0] == 0:
        return _empty_ext()
    ra = gfp.sum_dim(gfp.mul(coeffs, pws.a), -1)
    rb = gfp.sum_dim(gfp.mul(coeffs, pws.b), -1)
    return np.stack([gfp.to_u64(ra), gfp.to_u64(rb)], axis=-1)


def _domain_points(log_m: int, shift: int, device) -> torch.Tensor:
    w = fh.primitive_root_of_unity(log_m)
    return gfp.mul_const(nttm.powers(w, 1 << log_m, device), shift)


def _zh_short(log_n: int, rate_bits: int, shift: int, device) -> torch.Tensor:
    u = fh.exp(fh.primitive_root_of_unity(log_n + rate_bits), 1 << log_n)
    base = nttm.powers(u, 1 << rate_bits, device)
    return gfp.sub(gfp.mul_const(base, fh.exp(shift, 1 << log_n)), gfp.ones(base.shape, device))


def _open_tree(cm: Commitment, idx: torch.Tensor) -> TreeOpenings:
    vals = gfp.to_u64(cm.lde[:, idx])
    paths = np.transpose(gfp.to_u64(merkle.open_path(cm.tree, idx)), (2, 0, 1))
    return TreeOpenings(values=np.ascontiguousarray(vals.T), paths=np.ascontiguousarray(paths))


def _column_values(trace_gf: torch.Tensor, fixed_gf: Optional[torch.Tensor]):
    cols = list(trace_gf)
    if fixed_gf is not None:
        cols += list(fixed_gf)
    return cols


def ctl_z_columns(trace_gf, instances: List[CtlInstance], fixed_gf=None) -> torch.Tensor:
    """Z columns (num_instances, n): running products of the CTL factors."""
    cols = _column_values(trace_gf, fixed_gf)
    n = trace_gf.shape[-1]
    dev = trace_gf.device

    def col_val(j):
        if not isinstance(j, LC):
            return cols[j]
        acc = gfp.full((n,), j.const, dev)
        for c, coeff in j.terms:
            acc = gfp.add(acc, gfp.mul_const(cols[c], coeff))
        return acc

    factors = []
    for inst in instances:
        acc = gfp.full((n,), inst.gamma, dev)
        b = 1
        for j in inst.spec.columns:
            acc = gfp.add(acc, gfp.mul_const(col_val(j), b))
            b = b * inst.beta % P
        if inst.spec.filter_col is not None:
            one = gfp.ones((n,), dev)
            acc = gfp.add(gfp.mul(cols[inst.spec.filter_col], gfp.sub(acc, one)), one)
        factors.append(acc)
    return _scan(torch.stack(factors), gfp.mul)


def lookup_aux_columns(trace_gf, stark: Stark, alphas: List[int], fixed_gf=None):
    """logUp witness columns, per spec, per alpha: h_0..h_k-1, g, S."""
    if not stark.lookups:
        return None
    cols = _column_values(trace_gf, fixed_gf)
    n = trace_gf.shape[-1]
    dev = trace_gf.device
    rows = []
    for spec in stark.lookups:
        k = len(spec.looking_cols)
        v = torch.stack([cols[j] for j in spec.looking_cols])
        t = cols[spec.table_col]
        m_col = cols[spec.multiplicity_col]
        for alpha in alphas:
            hs = gfp.inv(gfp.sub(gfp.full((k, n), alpha, dev), v))
            g = gfp.mul(m_col, gfp.inv(gfp.sub(gfp.full((n,), alpha, dev), t)))
            delta = gfp.sub(gfp.sum_dim(hs, 0), g)
            rows.extend(list(hs) + [g, _scan(delta, gfp.add)])
    return torch.stack(rows)


def stark_prove(stark: Stark, trace: np.ndarray, public_inputs: List[int], config: StarkConfig,
                ctl_instances: Optional[List[CtlInstance]] = None, device=None) -> StarkProof:
    """Prove `trace` (num_columns, n) u64 satisfies `stark` on `device`."""
    dev = torch.device("cuda" if device is None else device)
    fri_cfg = config.fri_config
    cols, n = trace.shape
    if cols != stark.num_columns or len(public_inputs) != stark.num_public_inputs:
        raise ValueError("trace or public inputs do not fit the stark")
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"{n} rows is not a power of two")
    if stark.num_custom_aux(config.num_challenges):
        raise NotImplementedError("the reference proves no custom aux columns")
    rate_bits = fri_cfg.rate_bits
    shift = fri_cfg.coset_shift
    instances = ctl_instances or []

    challenger = Challenger()
    challenger.observe_elements([x % P for x in public_inputs])
    challenger.observe_element(log_n)

    fixed_cm = None
    if stark.num_fixed_columns:
        fixed_cm = commit(gfp.from_u64(stark.fixed_columns(n), dev), config)
        challenger.observe_cap(fixed_cm.cap)
    trace_cm = commit(gfp.from_u64(trace, dev), config)
    challenger.observe_cap(trace_cm.cap)

    lookup_alphas: List[int] = []
    if stark.lookups:
        lookup_alphas = [challenger.get_challenge() for _ in range(config.num_challenges)]
    aux_cm = None
    ctl_totals: List[int] = []
    fixed_gf = fixed_cm.values if fixed_cm is not None else None
    aux_parts: List[torch.Tensor] = []
    if instances:
        z_cols = ctl_z_columns(trace_cm.values, instances, fixed_gf)
        ctl_totals = [int(v) for v in gfp.to_u64(z_cols[:, -1])]
        aux_parts.append(z_cols)
    lk_cols = lookup_aux_columns(trace_cm.values, stark, lookup_alphas, fixed_gf)
    if lk_cols is not None:
        aux_parts.append(lk_cols)
    if aux_parts:
        aux_cm = commit(torch.cat(aux_parts), config)
        challenger.observe_cap(aux_cm.cap)
        if instances:
            challenger.observe_elements(ctl_totals)

    alphas = [challenger.get_challenge() for _ in range(config.num_challenges)]
    quot_cm = _compute_quotient(stark, trace_cm, fixed_cm, aux_cm, instances, ctl_totals,
                                lookup_alphas, public_inputs, alphas, log_n, config)
    challenger.observe_cap(quot_cm.cap)

    zeta = challenger.get_extension_challenge()
    g_h = fh.primitive_root_of_unity(log_n)
    gzeta = (zeta[0] * g_h % P, zeta[1] * g_h % P)
    pw = {zeta: ext_powers(zeta, n, dev), gzeta: ext_powers(gzeta, n, dev)}

    def at(cm, point):
        return _empty_ext() if cm is None else eval_at_ext_point(cm.coeffs, pw[point])

    openings = StarkOpenings(
        trace_at_zeta=at(trace_cm, zeta), trace_at_gzeta=at(trace_cm, gzeta),
        fixed_at_zeta=at(fixed_cm, zeta), fixed_at_gzeta=at(fixed_cm, gzeta),
        aux_at_zeta=at(aux_cm, zeta), aux_at_gzeta=at(aux_cm, gzeta),
        quotient_at_zeta=at(quot_cm, zeta),
    )
    challenger.observe_elements(openings.transcript_elements())

    fri_alpha = challenger.get_extension_challenge()
    comp = _deep_composition(trace_cm, fixed_cm, aux_cm, quot_cm, openings, zeta, gzeta,
                             fri_alpha, log_n, rate_bits, shift)
    fri_proof = fri_prove(comp, log_n, fri_cfg, challenger)
    idx = torch.from_numpy(fri_proof.query_indices).to(dev)
    return StarkProof(
        degree_bits=log_n,
        public_inputs=list(public_inputs),
        trace_cap=trace_cm.cap,
        aux_cap=aux_cm.cap if aux_cm is not None else None,
        quotient_cap=quot_cm.cap,
        ctl_totals=ctl_totals,
        openings=openings,
        fri_proof=fri_proof,
        trace_query_openings=_open_tree(trace_cm, idx),
        aux_query_openings=_open_tree(aux_cm, idx) if aux_cm is not None else None,
        quotient_query_openings=_open_tree(quot_cm, idx),
        fixed_query_openings=_open_tree(fixed_cm, idx) if fixed_cm is not None else None,
    )


def _selectors(log_n, rate_bits, shift, dev):
    """(z_last, l_first, l_last) over the whole LDE domain."""
    n = 1 << log_n
    xs = _domain_points(log_n + rate_bits, shift, dev)
    zh = _zh_short(log_n, rate_bits, shift, dev).repeat(n)
    g_last = fh.inv(fh.primitive_root_of_unity(log_n))
    n_inv = fh.inv(n)
    z_last = gfp.sub(xs, gfp.full((), g_last, dev))
    l_first = gfp.mul_const(gfp.mul(zh, gfp.inv(gfp.sub(xs, gfp.ones((), dev)))), n_inv)
    l_last = gfp.mul_const(gfp.mul(zh, gfp.inv(z_last)), g_last * n_inv % P)
    return z_last, l_first, l_last


def _sweep(stark, trace_lde, fixed_lde, aux_lde, instances, ctl_totals, lookup_alphas,
           public_inputs, alphas, log_n, rate_bits, shift) -> torch.Tensor:
    """Direct evaluation of every constraint over the LDE domain ->
    (num_challenges, m) accumulators."""
    dev = trace_lde.device
    m = trace_lde.shape[-1]
    rate = 1 << rate_bits
    z_last, l_first, l_last = _selectors(log_n, rate_bits, shift, dev)

    def roll(a):
        return torch.roll(a, -rate, dims=-1)

    ops = DeviceOps((m,), dev)
    local, nxt = list(trace_lde), list(roll(trace_lde))
    fixed_local: List[torch.Tensor] = []
    fixed_next: List[torch.Tensor] = []
    if fixed_lde is not None:
        fixed_local, fixed_next = list(fixed_lde), list(roll(fixed_lde))
    pis = [ops.constant(int(x)) for x in public_inputs]
    consumer = ConstraintConsumer(ops, alphas, z_last, l_first, l_last)
    ctx = EvalContext(ops, local, nxt, pis, consumer, fixed_local, fixed_next)
    stark.eval(ctx)
    if aux_lde is not None:
        aux_local, aux_next = list(aux_lde), list(roll(aux_lde))
        k = len(instances)
        if k:
            eval_ctl_constraints(ops, consumer, local + fixed_local, nxt + fixed_next,
                                 aux_local[:k], aux_next[:k], instances, ctl_totals)
        off = k
        for spec in stark.lookups:
            for alpha in lookup_alphas:
                w = lookup_aux_count(spec)
                eval_lookup_constraints(ops, consumer, local + fixed_local, nxt + fixed_next,
                                        aux_local[off : off + w], aux_next[off : off + w],
                                        spec, alpha)
                off += w
    return torch.stack(consumer.accs)


def _compute_quotient(stark, trace_cm, fixed_cm, aux_cm, instances, ctl_totals, lookup_alphas,
                      public_inputs, alphas, log_n, config) -> Commitment:
    """Accumulators / Z_H -> coefficients (coset iNTT) -> degree-n chunks,
    committed from their coefficients."""
    fri = config.fri_config
    rate_bits, shift = fri.rate_bits, fri.coset_shift
    n = 1 << log_n
    dev = trace_cm.lde.device
    accs = _sweep(stark, trace_cm.lde, fixed_cm.lde if fixed_cm is not None else None,
                  aux_cm.lde if aux_cm is not None else None, instances, ctl_totals,
                  lookup_alphas, public_inputs, alphas, log_n, rate_bits, shift)
    m = n << rate_bits
    zh_inv = gfp.inv(_zh_short(log_n, rate_bits, shift, dev)).repeat(m >> rate_bits)
    q_coeffs = transform.best_coset_intt(gfp.mul(accs, zh_inv), shift)
    chunks = stark.quotient_chunks(bool(instances))
    q_chunks = q_coeffs[:, : chunks * n].reshape(len(accs) * chunks, n)
    return commit(q_chunks, config, from_coeffs=True)


def _ext_host_mul(x, y):
    return ((x[0] * y[0] + 7 * x[1] * y[1]) % P, (x[0] * y[1] + x[1] * y[0]) % P)


def _weighted_ext_sum(weights, ys):
    acc = (0, 0)
    for w, y in zip(weights, ys):
        t = _ext_host_mul(w, y)
        acc = ((acc[0] + t[0]) % P, (acc[1] + t[1]) % P)
    return acc


def _batch_combine(parts: List[torch.Tensor], weights: List[Tuple[int, int]]) -> GF2:
    """sum_j w_j * row_j over the rows of `parts`, in order, ext weights."""
    dev = parts[0].device
    wa = gfp.from_u64(np.asarray([w[0] for w in weights], dtype=np.uint64), dev)[:, None]
    wb = gfp.from_u64(np.asarray([w[1] for w in weights], dtype=np.uint64), dev)[:, None]
    step = max(1, COMBINE_BLOCK_ELEMS // parts[0].shape[-1])
    acc, j = None, 0
    for part in parts:
        for s in range(0, part.shape[0], step):
            blk = part[s : s + step]
            k = blk.shape[0]
            t = GF2(gfp.sum_dim(gfp.mul(blk, wa[j : j + k]), 0),
                    gfp.sum_dim(gfp.mul(blk, wb[j : j + k]), 0))
            acc = t if acc is None else gf2x.add(acc, t)
            j += k
    if j != len(weights):
        raise ValueError("DEEP weights do not match the batch")
    return acc


def _deep_composition(trace_cm, fixed_cm, aux_cm, quot_cm, openings: StarkOpenings, zeta,
                      gzeta, fri_alpha, log_n, rate_bits, shift) -> GF2:
    """comp(x) = (B0(x)-y0)/(x-zeta) + (B1(x)-y1)/(x-g*zeta); batch0 = trace
    + fixed + aux + quotient rows (weights a^0..), batch1 = trace + fixed +
    aux rows (weights continue a^K..)."""
    dev = trace_cm.lde.device
    oracles = [trace_cm.lde]
    open0 = list(openings.trace_at_zeta)
    open1 = list(openings.trace_at_gzeta)
    if fixed_cm is not None:
        oracles.append(fixed_cm.lde)
        open0 += list(openings.fixed_at_zeta)
        open1 += list(openings.fixed_at_gzeta)
    if aux_cm is not None:
        oracles.append(aux_cm.lde)
        open0 += list(openings.aux_at_zeta)
        open1 += list(openings.aux_at_gzeta)
    open0 += list(openings.quotient_at_zeta)
    open0 = [(int(v[0]), int(v[1])) for v in open0]
    open1 = [(int(v[0]), int(v[1])) for v in open1]

    L = sum(o.shape[0] for o in oracles)
    K = L + quot_cm.lde.shape[0]
    a_pows = [(1, 0)]
    for _ in range(K + L - 1):
        a_pows.append(_ext_host_mul(a_pows[-1], fri_alpha))
    y0 = _weighted_ext_sum(a_pows[:K], open0)
    y1 = _weighted_ext_sum(a_pows[K:], open1)

    b0 = _batch_combine(oracles + [quot_cm.lde], a_pows[:K])
    b1 = _batch_combine(oracles, a_pows[K:])
    xs = _domain_points(log_n + rate_bits, shift, dev)
    x_ext = GF2(xs, torch.zeros_like(xs))
    num0 = gf2x.sub(b0, gf2x.full((), y0, dev))
    num1 = gf2x.sub(b1, gf2x.full((), y1, dev))
    den0 = gf2x.sub(x_ext, gf2x.full((), zeta, dev))
    den1 = gf2x.sub(x_ext, gf2x.full((), gzeta, dev))
    return gf2x.add(gf2x.mul(num0, gf2x.inv(den0)), gf2x.mul(num1, gf2x.inv(den1)))

"""STARK verifier — host-side, exact python-int arithmetic.

Counterpart: ethproof_tpu/stark/verify.py:1. A copy: the constraint
identity at zeta replays the recorded IR program on host extension pairs,
as the counterpart does (:154-159), whatever sweep the prover ran
(`_direct_accs` runs the table's `eval` directly, the same expression; the
tests hold the two against each other); the fixed-column cap comes from the
port's own commitment on `device`, and the opened leaves of each oracle
tree are digested in one batch on `device` (the same `tree_digest` as the
host's, one call for all queries: a wide table's leaves are thousands of
permutations each).

Reference equivalent: starky's `verify_stark_proof` + CTL verification. Checks:

1. transcript replay (identical observation order to stark_prove)
2. the constraint identity at zeta — running the SAME `Stark.eval` (and
   the same engine-injected CTL/lookup constraints, and a table's custom
   aux constraints over the aux challenges drawn after the trace cap) the
   prover swept on the device, but on host extension scalars
3. FRI verification of the DEEP composition codeword
4. per-query: Merkle paths of the trace/aux/quotient oracles and
   recomputation of the composition value from the opened leaves

Cross-table total consistency (prod looking == looked) belongs to the
multi-table orchestrator (ethproof_tpu/stark/multi.py; not ported yet).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .. import resolve_device
from ..gf import field as gfp
from ..gf import field_host as fh
from ..hash import poseidon
from ..fri.challenger import Challenger
from ..fri.config import StarkConfig
from ..fri.verify import _verify_merkle, ext_add, ext_mul, ext_sub, fri_verify
from .ir import replay_accs
from .prove import StarkProof
from .stark import (
    ConstraintConsumer,
    CtlInstance,
    EvalContext,
    HostExtOps,
    Stark,
    eval_ctl_constraints,
    eval_lookup_constraints,
    lookup_aux_count,
)

P = fh.P
Ext = Tuple[int, int]


def ext_inv(x: Ext) -> Ext:
    norm = (x[0] * x[0] - 7 * x[1] * x[1]) % P
    ni = fh.inv(norm)
    return (x[0] * ni % P, (-x[1]) * ni % P)


def _ext_pow(x: Ext, e: int) -> Ext:
    r: Ext = (1, 0)
    b = x
    while e:
        if e & 1:
            r = ext_mul(r, b)
        e >>= 1
        if e:
            b = ext_mul(b, b)
    return r


def _pairs(arr: np.ndarray) -> List[Ext]:
    return [(int(v[0]), int(v[1])) for v in arr]


def _leaf_digests(values: np.ndarray, device) -> List[List[int]]:
    """tree_digest of every opened row of `values` (num_q, width), hashed
    in one batch on `device`."""
    d = gfp.to_u64(poseidon.tree_digest(gfp.from_u64(np.ascontiguousarray(values.T), device)))
    return [[int(v) for v in d[:, q]] for q in range(values.shape[0])]


def _replay_accs(stark, ops, instances, ctl_totals, lookup_alphas, aux_challenges, alphas,
                 local, nxt, fixed_l, fixed_n, aux_l, aux_n, pis, z_last, l_first,
                 l_last) -> List[Ext]:
    """The constraint accumulators at zeta by replaying the SAME recorded
    constraint program the prover swept."""
    return replay_accs(
        stark, tuple(inst.spec for inst in instances), ops, len(alphas),
        local=local, nxt=nxt, fixed_l=fixed_l, fixed_n=fixed_n,
        aux_l=aux_l, aux_n=aux_n, pis=pis,
        alphas=[ops.challenge(a) for a in alphas],
        lookup_alphas=[ops.challenge(a) for a in lookup_alphas],
        aux_challenges=[ops.challenge(c) for c in aux_challenges],
        betas=[ops.challenge(inst.beta) for inst in instances],
        gammas=[ops.challenge(inst.gamma) for inst in instances],
        totals=[ops.challenge(t) for t in ctl_totals],
        z_last=z_last, l_first=l_first, l_last=l_last,
    )


def _direct_accs(stark, ops, instances, ctl_totals, lookup_alphas, aux_challenges, alphas,
                 local, nxt, fixed_l, fixed_n, aux_l, aux_n, pis, z_last, l_first,
                 l_last) -> List[Ext]:
    """The constraint accumulators at zeta by running `eval` (+ the CTL,
    lookup and custom aux constraints) directly on host extension pairs."""
    consumer = ConstraintConsumer(ops, alphas, z_last, l_first, l_last)
    ctx = EvalContext(ops, local, nxt, pis, consumer, fixed_l, fixed_n)
    stark.eval(ctx)
    k_ctl = len(instances)
    if instances:
        eval_ctl_constraints(
            ops, consumer, local + fixed_l, nxt + fixed_n,
            aux_l[:k_ctl], aux_n[:k_ctl], instances, list(ctl_totals),
        )
    off = k_ctl
    for spec in stark.lookups:
        for alpha in lookup_alphas:
            w = lookup_aux_count(spec)
            eval_lookup_constraints(
                ops, consumer, local + fixed_l, nxt + fixed_n,
                aux_l[off : off + w], aux_n[off : off + w], spec, alpha,
            )
            off += w
    k_custom = stark.num_custom_aux(len(alphas))
    if k_custom:
        stark.eval_custom(ctx, aux_l[off : off + k_custom], aux_n[off : off + k_custom],
                          list(aux_challenges))
    return consumer.accs


def stark_verify(
    stark: Stark,
    proof: StarkProof,
    config: StarkConfig,
    challenger: Optional[Challenger] = None,
    ctl_instances: Optional[List[CtlInstance]] = None,
    device=None,
) -> bool:
    """Check `proof` against `stark`. `device` (None: the CUDA card) is
    where the fixed-column cap is committed, for tables that have one."""
    fri_cfg = config.fri_config
    log_n = proof.degree_bits
    n = 1 << log_n
    rate_bits = fri_cfg.rate_bits
    shift = fri_cfg.coset_shift
    cols = stark.num_columns
    instances = ctl_instances or []
    k_ctl = len(instances)
    chunks = stark.quotient_chunks(bool(instances))

    if challenger is None:
        challenger = Challenger()

    # --- transcript replay ---
    if len(proof.public_inputs) != stark.num_public_inputs:
        return False
    challenger.observe_elements([x % P for x in proof.public_inputs])
    challenger.observe_element(log_n)
    fixed_cap = None
    if stark.num_fixed_columns:
        # the vkey: deterministic commitment to the preprocessed columns,
        # recomputed (and cached) by the verifier itself — trusted setup
        # data, not part of the proof
        from .prove import fixed_cap as _fixed_cap

        fixed_cap = _fixed_cap(stark, n, config, device)
        challenger.observe_cap(fixed_cap)
    challenger.observe_cap(proof.trace_cap)
    lookup_alphas: List[int] = []
    if stark.lookups:
        lookup_alphas = [challenger.get_challenge() for _ in range(config.num_challenges)]
    aux_challenges = [
        challenger.get_challenge()
        for _ in range(stark.num_aux_challenges(config.num_challenges))
    ]
    k_lookup = sum(lookup_aux_count(s) for s in stark.lookups) * config.num_challenges
    k_custom = stark.num_custom_aux(config.num_challenges)
    k_aux = k_ctl + k_lookup + k_custom
    if k_aux:
        if proof.aux_cap is None:
            return False
        challenger.observe_cap(proof.aux_cap)
        if instances:
            if len(proof.ctl_totals) != k_ctl:
                return False
            challenger.observe_elements(proof.ctl_totals)
        elif proof.ctl_totals:
            return False
    elif proof.aux_cap is not None or proof.ctl_totals:
        return False
    alphas = [challenger.get_challenge() for _ in range(config.num_challenges)]
    challenger.observe_cap(proof.quotient_cap)
    zeta = challenger.get_extension_challenge()
    g_h = fh.primitive_root_of_unity(log_n)
    challenger.observe_elements(proof.openings.transcript_elements())
    fri_alpha = challenger.get_extension_challenge()

    o = proof.openings
    k_fixed = stark.num_fixed_columns
    if o.trace_at_zeta.shape != (cols, 2) or o.trace_at_gzeta.shape != (cols, 2):
        return False
    if o.fixed_at_zeta.shape != (k_fixed, 2) or o.fixed_at_gzeta.shape != (k_fixed, 2):
        return False
    if o.aux_at_zeta.shape != (k_aux, 2) or o.aux_at_gzeta.shape != (k_aux, 2):
        return False
    if o.quotient_at_zeta.shape != (config.num_challenges * chunks, 2):
        return False

    # --- 2. constraint identity at zeta ---
    ops = HostExtOps()
    zeta_n = _ext_pow(zeta, n)
    zh = ext_sub(zeta_n, (1, 0))
    g_last = fh.inv(g_h)
    n_inv = fh.inv(n)
    z_last = ext_sub(zeta, (g_last, 0))
    l_first = ext_mul(ext_mul(zh, ext_inv(ext_sub(zeta, (1, 0)))), (n_inv, 0))
    l_last = ext_mul(ext_mul(zh, ext_inv(z_last)), (g_last * n_inv % P, 0))
    local = _pairs(o.trace_at_zeta)
    nxt = _pairs(o.trace_at_gzeta)
    # fixed values at zeta come from the proof's FRI-bound openings of the
    # vkey oracle (checked per-query in step 4 below)
    fixed_l: List[Ext] = _pairs(o.fixed_at_zeta)
    fixed_nx: List[Ext] = _pairs(o.fixed_at_gzeta)
    pis = [ops.constant(int(x)) for x in proof.public_inputs]
    aux_l, aux_n = _pairs(o.aux_at_zeta), _pairs(o.aux_at_gzeta)
    accs = _replay_accs(stark, ops, instances, proof.ctl_totals, lookup_alphas, aux_challenges,
                        alphas, local, nxt, fixed_l, fixed_nx, aux_l, aux_n, pis,
                        z_last, l_first, l_last)
    for ai in range(config.num_challenges):
        q: Ext = (0, 0)
        zpow: Ext = (1, 0)
        for c in range(chunks):
            y = o.quotient_at_zeta[ai * chunks + c]
            q = ext_add(q, ext_mul(zpow, (int(y[0]), int(y[1]))))
            zpow = ext_mul(zpow, zeta_n)
        if accs[ai] != ext_mul(zh, q):
            return False

    # --- 3. FRI on the composition ---
    ok, round0 = fri_verify(proof.fri_proof, fri_cfg, challenger)
    if not ok or proof.fri_proof.degree_bits != log_n:
        return False

    # --- 4. bind FRI round-0 to the oracle trees ---
    num_q = fri_cfg.num_query_rounds
    tq, qq, aq = proof.trace_query_openings, proof.quotient_query_openings, proof.aux_query_openings
    fq = proof.fixed_query_openings
    if tq.values.shape != (num_q, cols):
        return False
    if qq.values.shape != (num_q, config.num_challenges * chunks):
        return False
    if k_aux and (aq is None or aq.values.shape != (num_q, k_aux)):
        return False
    if k_fixed and (fq is None or fq.values.shape != (num_q, k_fixed)):
        return False
    gzeta = (zeta[0] * g_h % P, zeta[1] * g_h % P)
    w = fh.primitive_root_of_unity(log_n + rate_bits)
    open0 = (
        _pairs(o.trace_at_zeta) + _pairs(o.fixed_at_zeta)
        + _pairs(o.aux_at_zeta) + _pairs(o.quotient_at_zeta)
    )
    open1 = (
        _pairs(o.trace_at_gzeta) + _pairs(o.fixed_at_gzeta)
        + _pairs(o.aux_at_gzeta)
    )
    K, L = len(open0), len(open1)
    a_pows: List[Ext] = [(1, 0)]
    for _ in range(K + L - 1):
        a_pows.append(ext_mul(a_pows[-1], fri_alpha))
    y0 = (0, 0)
    for wgt, y in zip(a_pows[:K], open0):
        y0 = ext_add(y0, ext_mul(wgt, y))
    y1 = (0, 0)
    for wgt, y in zip(a_pows[K:], open1):
        y1 = ext_add(y1, ext_mul(wgt, y))

    path_len = max(log_n + rate_bits - fri_cfg.cap_height, 0)
    if tq.paths.shape[0] != num_q or qq.paths.shape[0] != num_q:
        return False
    if k_aux and aq.paths.shape[0] != num_q:
        return False
    if k_fixed and fq.paths.shape[0] != num_q:
        return False
    dev = resolve_device(device)
    t_dig = _leaf_digests(tq.values, dev)
    q_dig = _leaf_digests(qq.values, dev)
    a_dig = _leaf_digests(aq.values, dev) if k_aux else None
    f_dig = _leaf_digests(fq.values, dev) if k_fixed else None
    for q, (idx, comp_val) in enumerate(round0):
        t_leaf = [int(v) for v in tq.values[q]]
        q_leaf = [int(v) for v in qq.values[q]]
        a_leaf = [int(v) for v in aq.values[q]] if k_aux else []
        f_leaf = [int(v) for v in fq.values[q]] if k_fixed else []
        if not _verify_merkle(t_leaf, idx, tq.paths[q], proof.trace_cap, path_len, t_dig[q]):
            return False
        if not _verify_merkle(q_leaf, idx, qq.paths[q], proof.quotient_cap, path_len,
                              q_dig[q]):
            return False
        if k_aux and not _verify_merkle(a_leaf, idx, aq.paths[q], proof.aux_cap, path_len,
                                        a_dig[q]):
            return False
        if k_fixed and not _verify_merkle(f_leaf, idx, fq.paths[q], fixed_cap, path_len,
                                          f_dig[q]):
            return False
        x = shift * pow(w, idx, P) % P
        b0: Ext = (0, 0)
        for wgt, v in zip(a_pows[:K], t_leaf + f_leaf + a_leaf + q_leaf):
            b0 = ext_add(b0, ext_mul(wgt, (v, 0)))
        b1: Ext = (0, 0)
        for wgt, v in zip(a_pows[K:], t_leaf + f_leaf + a_leaf):
            b1 = ext_add(b1, ext_mul(wgt, (v, 0)))
        c0 = ext_mul(ext_sub(b0, y0), ext_inv(ext_sub((x, 0), zeta)))
        c1 = ext_mul(ext_sub(b1, y1), ext_inv(ext_sub((x, 0), gzeta)))
        if ext_add(c0, c1) != comp_val:
            return False
    return True

"""STARK prover: trace commit -> aux commit -> quotient -> openings -> DEEP -> FRI.

Counterpart: ethproof_tpu/stark/prove.py:62-659 and :846-1052
(`commit_trace`, `_commit_gf`, `fixed_commitment`, `fixed_cap`,
`StarkOpenings`, `StarkProof`, `TreeOpenings`, `_ctl_z_columns`,
`_lookup_aux_columns`, `stark_prove`, `_compute_quotient`,
`_compute_openings`, `_deep_composition`).

Arrays that span the trace or LDE domain are int64 tensors on one device
or, with a mesh (`parallel/mesh.py`, `mesh=` of `stark_prove`), blocks on
the mesh's devices: a commitment keeps its coefficients in column blocks
and its LDE in domain blocks (one block of each without a mesh); the
sweep, the DEEP codeword and the query openings run per domain block, the
openings at zeta per column block, and only the quotient's accumulator
rows, the (cols, 2) openings and the DEEP column meet on the leader. The
transcript runs on the host. What differs from the counterpart:
- the constraint sweep (`ETHPROOF_SWEEP`, counterpart :662-733) replays
  the recorded IR program on the level executor of `stark/ir.py` ("ir",
  the default), or evaluates `stark.eval` directly on the torch
  `DeviceOps` ("eager", the counterpart's `_sweep_jit(..., use_jit=False)`
  path, :735-843, kept as the tests' oracle); the two give equal
  accumulators, since field arithmetic is exact. There is no "jit" mode;
- `lax.associative_scan` becomes a log-depth (Hillis-Steele) scan under
  field mul or add;
- `fixed_cap` has the counterpart's disk cache under the artifact
  directory, and commits on one device;
- the quotient's openings use the coefficients its commit starts from
  (the counterpart transforms its LDE back: the same values).

Tables with custom aux columns (the verifier machine's wire bus,
recursion/machine.py) draw their aux challenges after the trace cap (and
the lookup alphas), and their `custom_aux_columns` follow the CTL and
logUp columns in the aux commit; both sweeps evaluate `eval_custom` over
that slice (counterpart :561-590, :829).

Transcript (the verifier mirrors it exactly):
  observe(public_inputs, degree_bits) -> [observe(fixed cap)] ->
  observe(trace cap) -> [lookup alphas] -> [aux challenges] -> [observe(aux cap) ->
  observe(ctl totals)] -> alphas -> observe(quotient cap) -> zeta ->
  observe(openings) -> fri_alpha -> FRI transcript.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..fri.challenger import Challenger
from ..fri.config import StarkConfig
from ..fri.prove import FriProof, fri_prove
from ..gf import extension as gf2x
from ..gf import field as gfp
from ..gf import field_host as fh
from ..gf.extension import GF2
from ..hash import merkle
from ..parallel import mesh as pmesh
from ..poly import four_step
from ..poly import ntt as nttm
from ..runtime.prover_state import artifact_dir
from ..runtime.tracing import phase
from .stark import (
    ConstraintConsumer,
    CtlInstance,
    DeviceOps,
    EvalContext,
    LC,
    Stark,
    eval_ctl_constraints,
    eval_lookup_constraints,
    lookup_aux_count,
)

P = fh.P


@dataclass
class TraceCommitment:
    """One commit (iNTT -> coset LDE -> Merkle tree) of a (cols, n) matrix,
    on one device (one block of each) or a mesh."""

    trace_gf: torch.Tensor  # (cols, n) values, on the leader
    coeffs: List[torch.Tensor]  # column blocks of the (cols, n) coefficient form
    lde: List[torch.Tensor]  # domain blocks of the (cols, n << rate_bits) coset LDE
    tree: merkle.MerkleTree
    cap: np.ndarray  # (4, 2^cap_height) u64


def _commit_gf(a: torch.Tensor, config: StarkConfig, mesh: Optional[pmesh.Mesh] = None,
               from_coeffs: bool = False):
    """(coefficient blocks, LDE blocks, tree) for a (cols, n) field tensor
    of values (of coefficients with `from_coeffs`). With `mesh` the
    columns are zero-padded to its width and sharded over it: each device
    transforms its own columns, then the LDE is resharded to the domain
    axis for the Merkle tree (`pmesh.commit_blocks`)."""
    fri = config.fri_config
    blocks = [a] if mesh is None else pmesh.shard(pmesh.pad_cols(a, pmesh.mesh_width(mesh)),
                                                  mesh, 0)
    return pmesh.commit_blocks(blocks, a.shape[0], fri.rate_bits, fri.coset_shift,
                               fri.cap_height, from_coeffs)


def commit_trace(trace: np.ndarray, config: StarkConfig, device=None,
                 mesh: Optional[pmesh.Mesh] = None) -> TraceCommitment:
    """Commit a (cols, n) u64 trace on `device` (None: the CUDA card), or
    sharded over `mesh` (then `device` is its leader)."""
    dev = mesh.leader if mesh is not None else resolve_device(device)
    trace_gf = gfp.from_u64(trace, dev)
    coeffs, lde, tree = _commit_gf(trace_gf, config, mesh)
    return TraceCommitment(trace_gf, coeffs, lde, tree, gfp.to_u64(tree.cap))


def fixed_commitment(stark: Stark, n: int, config: StarkConfig, device=None,
                     mesh: Optional[pmesh.Mesh] = None) -> TraceCommitment:
    """Commitment to the preprocessed (fixed) columns — the table's
    verification key. Cached on the stark instance (latest size only),
    keyed by the mesh too."""
    dev = resolve_device(device)
    cache = stark.__dict__.setdefault("_torch_fixed_cm_cache", {})
    fri = config.fri_config
    key = (n, fri.rate_bits, fri.cap_height, fri.coset_shift, str(dev),
           mesh.key() if mesh is not None else None)
    if key not in cache:
        cache.clear()  # hold at most one size: the LDE is the big object
        cache[key] = commit_trace(stark.fixed_columns(n), config, dev, mesh)
    return cache[key]


def fixed_cap(stark: Stark, n: int, config: StarkConfig, device=None) -> np.ndarray:
    """The vkey cap only, as the verifier and the recursion compiler consume
    it. Its bits are the same on every device. Looked up in order: the
    in-memory cache; an already-committed full oracle of the same size (on
    any device); the disk cache under `runtime.prover_state.artifact_dir()`,
    a `vkcap_<digest>.npy` keyed by the fixed columns' bytes and (n,
    rate_bits, cap_height, coset_shift), so new columns give a new file and
    a corrupt one is rebuilt; else committed on `device` (None: the CUDA
    card) and written to the disk cache atomically."""
    mem = stark.__dict__.setdefault("_torch_fixed_cap_cache", {})
    fri = config.fri_config
    key = (n, fri.rate_bits, fri.cap_height, fri.coset_shift)
    hit = mem.get(key)
    if hit is not None:
        return hit
    for cm_key, cm in stark.__dict__.get("_torch_fixed_cm_cache", {}).items():
        if cm_key[:4] == key:
            mem[key] = cm.cap
            return cm.cap
    path = None
    d = artifact_dir()
    if d is not None:
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(stark.fixed_columns(n)).tobytes())
        h.update(repr(key).encode())
        path = os.path.join(d, f"vkcap_{h.hexdigest()[:24]}.npy")
        if os.path.exists(path):
            try:
                cap = np.load(path)
                mem[key] = cap
                return cap
            except (OSError, ValueError, EOFError):
                pass  # a corrupt file is rebuilt
    cap = fixed_commitment(stark, n, config, device).cap
    if path is not None:
        tmp = f"{path}.{os.getpid()}.tmp.npy"  # np.save keeps the .npy suffix
        np.save(tmp, cap)
        os.replace(tmp, path)
    mem[key] = cap
    return cap


@dataclass
class TreeOpenings:
    """Openings of one oracle tree at the FRI query indices."""

    values: np.ndarray  # (num_q, num_rows) u64 — leaf rows at each index
    paths: np.ndarray  # (num_q, path_len, 4) u64


def _empty_ext() -> np.ndarray:
    return np.zeros((0, 2), dtype=np.uint64)


@dataclass
class StarkOpenings:
    trace_at_zeta: np.ndarray  # (cols, 2) u64 ext
    trace_at_gzeta: np.ndarray  # (cols, 2)
    aux_at_zeta: np.ndarray  # (num_aux, 2)
    aux_at_gzeta: np.ndarray  # (num_aux, 2)
    quotient_at_zeta: np.ndarray  # (num_challenges * chunks, 2)
    fixed_at_zeta: np.ndarray = field(default_factory=_empty_ext)  # (num_fixed, 2)
    fixed_at_gzeta: np.ndarray = field(default_factory=_empty_ext)  # (num_fixed, 2)

    def transcript_elements(self) -> List[int]:
        out: List[int] = []
        for arr in (
            self.trace_at_zeta, self.trace_at_gzeta,
            self.fixed_at_zeta, self.fixed_at_gzeta,
            self.aux_at_zeta, self.aux_at_gzeta,
            self.quotient_at_zeta,
        ):
            out.extend(int(v) for v in np.asarray(arr, dtype=np.uint64).ravel())
        return out


@dataclass
class StarkProof:
    degree_bits: int
    public_inputs: List[int]
    trace_cap: np.ndarray  # (4, 2^cap_height) u64
    aux_cap: Optional[np.ndarray]
    quotient_cap: np.ndarray
    ctl_totals: List[int]  # one per CtlInstance (base field)
    openings: StarkOpenings
    fri_proof: FriProof
    trace_query_openings: TreeOpenings
    aux_query_openings: Optional[TreeOpenings]
    quotient_query_openings: TreeOpenings
    fixed_query_openings: Optional[TreeOpenings] = None


# -- device helpers ----------------------------------------------------------------


def _scan(x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive prefix scan along the last axis under an associative,
    commutative field op (log2 n steps)."""
    n = x.shape[-1]
    d = 1
    while d < n:
        x = torch.cat([x[..., :d], op(x[..., d:], x[..., :-d])], dim=-1)
        d *= 2
    return x


def ext_powers(point: Tuple[int, int], n: int, device) -> GF2:
    """[1, z, ..., z^(n-1)] by log-doubling in GF(p^2)."""
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
    """Polys (cols, n) at the point whose powers are `pws` -> (cols, 2) u64."""
    if coeffs.shape[0] == 0:
        return _empty_ext()
    ra = gfp.sum_dim(gfp.mul(coeffs, pws.a), -1)
    rb = gfp.sum_dim(gfp.mul(coeffs, pws.b), -1)
    return np.stack([gfp.to_u64(ra), gfp.to_u64(rb)], axis=-1)


def _compute_openings(trace_c, fixed_c, aux_c, quot_c, zeta, gzeta) -> StarkOpenings:
    """Each argument a list of column blocks (the first on the leader):
    the per-column sums run where each block lies, and only their (cols, 2)
    results are joined."""
    n = trace_c[0].shape[-1]
    dev = trace_c[0].device
    base = {zeta: ext_powers(zeta, n, dev), gzeta: ext_powers(gzeta, n, dev)}
    moved: Dict = {}

    def at(blocks, point):
        out = []
        for b in blocks:
            key = (point, str(b.device))
            if key not in moved:
                moved[key] = GF2(base[point].a.to(b.device), base[point].b.to(b.device))
            out.append(eval_at_ext_point(b, moved[key]))
        return np.concatenate(out) if out else _empty_ext()

    return StarkOpenings(
        trace_at_zeta=at(trace_c, zeta),
        trace_at_gzeta=at(trace_c, gzeta),
        fixed_at_zeta=at(fixed_c, zeta),
        fixed_at_gzeta=at(fixed_c, gzeta),
        aux_at_zeta=at(aux_c, zeta),
        aux_at_gzeta=at(aux_c, gzeta),
        quotient_at_zeta=at(quot_c, zeta),
    )


def _domain_points(log_m: int, shift: int, device, lo: int = 0,
                   count: Optional[int] = None) -> torch.Tensor:
    """shift * w^i for i in [lo, lo + count) (default: the whole domain)."""
    w = fh.primitive_root_of_unity(log_m)
    count = 1 << log_m if count is None else count
    return gfp.mul_const(nttm.powers(w, count, device), shift * fh.exp(w, lo) % P)


def _zh_short(log_n: int, rate_bits: int, shift: int, device) -> torch.Tensor:
    """Z_H(x) = x^n - 1 over the LDE coset repeats with period 2^rate_bits:
    its first period."""
    u = fh.exp(fh.primitive_root_of_unity(log_n + rate_bits), 1 << log_n)
    base = nttm.powers(u, 1 << rate_bits, device)
    return gfp.sub(gfp.mul_const(base, fh.exp(shift, 1 << log_n)), gfp.ones(base.shape, device))


def _roll_cols(a: torch.Tensor, k: int) -> torch.Tensor:
    """Next-row view: rotate the domain axis left by k (g_H step = rate)."""
    return torch.roll(a, -k, dims=-1)


def _open_tree(tree: merkle.MerkleTree, rows: List[torch.Tensor],
               idx: torch.Tensor) -> TreeOpenings:
    """Leaf rows and paths at `idx`, read from the domain blocks that hold them."""
    vals = gfp.to_u64(merkle.take(rows, idx, idx.device))  # (rows, q)
    paths = np.transpose(gfp.to_u64(merkle.open_path(tree, idx)), (2, 0, 1))
    return TreeOpenings(values=np.ascontiguousarray(vals.T), paths=np.ascontiguousarray(paths))


# -- aux columns ----------------------------------------------------------------


def _column_values(trace_gf: torch.Tensor, fixed_gf: Optional[torch.Tensor]):
    """Row list; indices >= the trace's column count address fixed columns."""
    cols = list(trace_gf)
    if fixed_gf is not None:
        cols += list(fixed_gf)
    return cols


def _ctl_z_columns(trace_gf: torch.Tensor, instances: List[CtlInstance],
                   fixed_gf: Optional[torch.Tensor] = None) -> torch.Tensor:
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


def _lookup_aux_columns(trace_gf: torch.Tensor, stark: Stark, alphas: List[int],
                        fixed_gf: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """logUp witness columns, layout per spec, per alpha: h_0..h_k-1, g, S."""
    if not stark.lookups:
        return None
    cols = _column_values(trace_gf, fixed_gf)
    n = trace_gf.shape[-1]
    dev = trace_gf.device
    rows = []
    for spec in stark.lookups:
        k = len(spec.looking_cols)
        v = torch.stack([cols[j] for j in spec.looking_cols])  # (k, n)
        t = cols[spec.table_col]
        m_col = cols[spec.multiplicity_col]
        for alpha in alphas:
            hs = gfp.inv(gfp.sub(gfp.full((k, n), alpha, dev), v))
            g = gfp.mul(m_col, gfp.inv(gfp.sub(gfp.full((n,), alpha, dev), t)))
            delta = gfp.sub(gfp.sum_dim(hs, 0), g)
            rows.extend(list(hs) + [g, _scan(delta, gfp.add)])
    return torch.stack(rows)


# -- prover ------------------------------------------------------------------------


def stark_prove(
    stark: Stark,
    trace: np.ndarray,  # (num_columns, n) u64
    public_inputs: List[int],
    config: StarkConfig,
    challenger: Optional[Challenger] = None,
    ctl_instances: Optional[List[CtlInstance]] = None,
    commitment: Optional[TraceCommitment] = None,
    device=None,
    phase_times: Optional[Dict[str, float]] = None,
    mesh=None,
) -> StarkProof:
    """Prove `trace` satisfies `stark` on `device` (None: the CUDA card).

    `mesh`: None takes `parallel.mesh.default_mesh()` (a CUDA proof on a
    multi-card host, led by `device`), False forces one device, a `Mesh`
    (led by `device`) shards every commit, the sweep and the DEEP codeword
    over it; the proof is the same bits on every mesh. A `commitment`
    passed in must come from the same mesh. `phase_times`, when given,
    receives the seconds of the commit, aux, quotient, openings and
    deep_fri phases, and under the IR sweep the level executor's plan as
    "ir_plan" (`SweepExecutor.plan`)."""
    dev = resolve_device(device)
    mesh = pmesh.resolve_mesh(mesh, dev)
    if mesh is not None:
        dev = mesh.leader
    fri_cfg = config.fri_config
    cols, n = trace.shape
    assert cols == stark.num_columns
    assert len(public_inputs) == stark.num_public_inputs
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    rate_bits = fri_cfg.rate_bits
    shift = fri_cfg.coset_shift
    instances = ctl_instances or []

    if challenger is None:
        challenger = Challenger()
    challenger.observe_elements([x % P for x in public_inputs])
    challenger.observe_element(log_n)

    # 0. fixed-column (vkey) commitment, observed before the trace cap;
    # 1. the trace commitment
    with phase("commit", phase_times, dev):
        fixed_cm: Optional[TraceCommitment] = None
        if stark.num_fixed_columns:
            fixed_cm = fixed_commitment(stark, n, config, dev, mesh)
            challenger.observe_cap(fixed_cm.cap)
        if commitment is None:
            commitment = commit_trace(trace, config, dev, mesh)
    trace_lde = commitment.lde
    challenger.observe_cap(commitment.cap)

    # 2. aux commit: CTL Z columns + logUp witness columns + custom aux
    lookup_alphas: List[int] = []
    if stark.lookups:
        lookup_alphas = [challenger.get_challenge() for _ in range(config.num_challenges)]
    aux_challenges = [challenger.get_challenge()
                      for _ in range(stark.num_aux_challenges(config.num_challenges))]
    aux_tree = aux_lde = aux_coeffs = None
    aux_cap = None
    ctl_totals: List[int] = []
    with phase("aux", phase_times, dev):
        aux_parts: List[torch.Tensor] = []
        fixed_gf = fixed_cm.trace_gf if fixed_cm is not None else None
        if instances:
            z_cols = _ctl_z_columns(commitment.trace_gf, instances, fixed_gf)
            ctl_totals = [int(v) for v in gfp.to_u64(z_cols[:, -1])]
            aux_parts.append(z_cols)
        lk_cols = _lookup_aux_columns(commitment.trace_gf, stark, lookup_alphas, fixed_gf)
        if lk_cols is not None:
            aux_parts.append(lk_cols)
        if stark.num_custom_aux(config.num_challenges):
            aux_parts.append(
                stark.custom_aux_columns(commitment.trace_gf, fixed_gf, aux_challenges))
        if aux_parts:
            aux_coeffs, aux_lde, aux_tree = _commit_gf(torch.cat(aux_parts), config, mesh)
            aux_cap = gfp.to_u64(aux_tree.cap)
            challenger.observe_cap(aux_cap)
            if instances:
                challenger.observe_elements(ctl_totals)

    # 3. constraint sweep -> quotient
    alphas = [challenger.get_challenge() for _ in range(config.num_challenges)]
    with phase("quotient", phase_times, dev):
        quotient_coeffs, quotient_lde, quotient_tree = _compute_quotient(
            stark, trace_lde, aux_lde, instances, ctl_totals, lookup_alphas,
            public_inputs, alphas, log_n, rate_bits, shift, config,
            fixed_lde=fixed_cm.lde if fixed_cm is not None else None,
            plan=phase_times, aux_challenges=aux_challenges, mesh=mesh,
        )
        quotient_cap = gfp.to_u64(quotient_tree.cap)
    challenger.observe_cap(quotient_cap)

    # 4. openings at zeta / g*zeta
    zeta = challenger.get_extension_challenge()
    g_h = fh.primitive_root_of_unity(log_n)
    gzeta = (zeta[0] * g_h % P, zeta[1] * g_h % P)
    with phase("openings", phase_times, dev):
        openings = _compute_openings(
            commitment.coeffs,
            fixed_cm.coeffs if fixed_cm is not None else [],
            aux_coeffs if aux_coeffs is not None else [],
            quotient_coeffs, zeta, gzeta,
        )
    challenger.observe_elements(openings.transcript_elements())

    # 5. DEEP composition codeword; 6. FRI + oracle query openings
    fri_alpha = challenger.get_extension_challenge()
    with phase("deep_fri", phase_times, dev):
        comp = _deep_composition(
            trace_lde, aux_lde, quotient_lde, openings, zeta, gzeta, fri_alpha,
            log_n, rate_bits, shift,
            fixed_lde=fixed_cm.lde if fixed_cm is not None else None,
        )
        fri_proof = fri_prove(comp, log_n, fri_cfg, challenger)
        idx = torch.from_numpy(fri_proof.query_indices).to(dev)
        proof = StarkProof(
            degree_bits=log_n,
            public_inputs=list(public_inputs),
            trace_cap=commitment.cap,
            aux_cap=aux_cap,
            quotient_cap=quotient_cap,
            ctl_totals=ctl_totals,
            openings=openings,
            fri_proof=fri_proof,
            trace_query_openings=_open_tree(commitment.tree, trace_lde, idx),
            aux_query_openings=(
                _open_tree(aux_tree, aux_lde, idx) if aux_tree is not None else None),
            quotient_query_openings=_open_tree(quotient_tree, quotient_lde, idx),
            fixed_query_openings=(
                _open_tree(fixed_cm.tree, fixed_cm.lde, idx) if fixed_cm is not None else None),
        )
    return proof


def _sweep_mode() -> str:
    """ETHPROOF_SWEEP: "ir" (default) or "eager" (see the module docstring)."""
    mode = os.environ.get("ETHPROOF_SWEEP", "ir")
    if mode not in ("ir", "eager"):
        raise ValueError(f"ETHPROOF_SWEEP={mode!r}: expected 'ir' or 'eager'")
    return mode


def _selectors(log_n, rate_bits, shift, dev, lo: int = 0,
               count: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z_last, l_first, l_last) over the LDE domain's points lo..lo+count-1
    (default: all of them; lo a multiple of the rate)."""
    n = 1 << log_n
    count = n << rate_bits if count is None else count
    xs = _domain_points(log_n + rate_bits, shift, dev, lo, count)
    zh = _zh_short(log_n, rate_bits, shift, dev).repeat(count >> rate_bits)
    g_last = fh.inv(fh.primitive_root_of_unity(log_n))
    n_inv = fh.inv(n)
    z_last = gfp.sub(xs, gfp.full((), g_last, dev))
    l_first = gfp.mul_const(gfp.mul(zh, gfp.inv(gfp.sub(xs, gfp.ones((), dev)))), n_inv)
    l_last = gfp.mul_const(gfp.mul(zh, gfp.inv(z_last)), g_last * n_inv % P)
    return z_last, l_first, l_last


def ir_executor(stark, specs, num_challenges: int, n_lookup_alphas: int, has_aux: bool):
    """The level executor of the table's recorded sweep program, cached on
    the stark instance by STRUCTURE only: one recording serves every shape
    and every proof (counterpart :691-704)."""
    from .ir import SweepExecutor, sweep_program

    cache = stark.__dict__.setdefault("_torch_ir_exec_cache", {})
    key = (hash(repr(specs)), num_challenges, n_lookup_alphas, has_aux)
    ex = cache.get(key)
    if ex is None:
        prog = sweep_program(stark, specs, num_challenges, n_lookup_alphas, has_aux)
        ex = cache[key] = SweepExecutor(prog)
    return ex


def _ir_sweep(stark, trace_lde, fixed_lde, aux_lde, instances, ctl_totals, lookup_alphas,
              public_inputs, alphas, log_n, rate_bits, shift, plan=None,
              aux_challenges=()) -> List[torch.Tensor]:
    """Constraint sweep by the recorded IR (stark/ir.py) on the level
    executor, per domain block -> each block's (num_challenges, m / w)
    accumulators. Each `*_lde` is a list of w domain blocks (one without a
    mesh). A block's executor input rows are built one chunk at a time:
    local rows, then next rows (the chunk's columns shifted by the rate,
    the last ones from a halo of the following block's first `rate`
    columns, the last block's from the first block's), per oracle. `plan`,
    when given, receives the executor's plan of this run as "ir_plan"."""
    w = len(trace_lde)
    span = trace_lde[0].shape[-1]
    rate = 1 << rate_bits
    if span < rate:
        raise ValueError(f"a domain block of {span} points is narrower than the {rate}-row halo")
    ex = ir_executor(stark, tuple(inst.spec for inst in instances), len(alphas),
                     len(lookup_alphas), aux_lde is not None)
    oracles = [p for p in (trace_lde, fixed_lde, aux_lde) if p is not None]
    scalars = (list(public_inputs) + list(alphas) + list(lookup_alphas) + list(aux_challenges)
               + [inst.beta for inst in instances] + [inst.gamma for inst in instances]
               + list(ctl_totals))
    scal = np.asarray([int(v) % P for v in scalars], dtype=np.uint64)

    def head_of(parts, halo):
        def head(lo, hi):
            rows = []
            for p, h in zip(parts, halo):
                rows.append(p[:, lo:hi])
                nxt = p[:, lo + rate:hi + rate]
                if hi + rate > span:
                    nxt = torch.cat([nxt, h[:, max(lo + rate - span, 0):hi + rate - span]], dim=1)
                rows.append(nxt)
            return torch.cat(rows)
        return head

    heads, scals, tails = [], [], []
    for d in range(w):
        dev = trace_lde[d].device
        heads.append(head_of([o[d] for o in oracles],
                             [o[(d + 1) % w][:, :rate].to(dev) for o in oracles]))
        scals.append(gfp.from_u64(scal, dev))
        tails.append(torch.stack(_selectors(log_n, rate_bits, shift, dev, d * span, span)))
    accs = ex.run_blocks(heads, scals, tails)
    if plan is not None:
        plan["ir_plan"] = ex.plan()
    return accs


def _sweep(stark, trace_lde, fixed_lde, aux_lde, instances, ctl_totals, lookup_alphas,
           public_inputs, alphas, log_n, rate_bits, shift, plan=None,
           aux_challenges=()) -> List[torch.Tensor]:
    """Direct evaluation of the table's eval (+ CTL, lookup and custom aux
    constraints) over the whole LDE domain, its domain blocks joined on
    the leader -> [(num_challenges, m) accumulators]. It has no plan to
    report: `plan` is left as it is."""
    dev = trace_lde[0].device

    def joined(blocks):
        return None if blocks is None else pmesh.gather(blocks, 1, dev)

    trace_lde, fixed_lde, aux_lde = joined(trace_lde), joined(fixed_lde), joined(aux_lde)
    m = trace_lde.shape[-1]
    rate = 1 << rate_bits
    z_last, l_first, l_last = _selectors(log_n, rate_bits, shift, dev)

    ops = DeviceOps((m,), dev)
    local = list(trace_lde)
    nxt = list(_roll_cols(trace_lde, rate))
    fixed_local: List[torch.Tensor] = []
    fixed_next: List[torch.Tensor] = []
    if fixed_lde is not None:
        fixed_local = list(fixed_lde)
        fixed_next = list(_roll_cols(fixed_lde, rate))
    pis = [ops.constant(int(x)) for x in public_inputs]
    consumer = ConstraintConsumer(ops, alphas, z_last, l_first, l_last)
    ctx = EvalContext(ops, local, nxt, pis, consumer, fixed_local, fixed_next)
    stark.eval(ctx)
    if aux_lde is not None:
        aux_local = list(aux_lde)
        aux_next = list(_roll_cols(aux_lde, rate))
        k = len(instances)
        if k:
            eval_ctl_constraints(
                ops, consumer, local + fixed_local, nxt + fixed_next,
                aux_local[:k], aux_next[:k], instances, ctl_totals,
            )
        off = k
        for spec in stark.lookups:
            for alpha in lookup_alphas:
                w = lookup_aux_count(spec)
                eval_lookup_constraints(
                    ops, consumer, local + fixed_local, nxt + fixed_next,
                    aux_local[off : off + w], aux_next[off : off + w], spec, alpha,
                )
                off += w
        k_custom = stark.num_custom_aux(len(alphas))
        if k_custom:
            stark.eval_custom(ctx, aux_local[off : off + k_custom],
                              aux_next[off : off + k_custom], list(aux_challenges))
    return [torch.stack(consumer.accs)]


def _compute_quotient(stark, trace_lde, aux_lde, instances, ctl_totals, lookup_alphas,
                      public_inputs, alphas, log_n, rate_bits, shift, config,
                      fixed_lde=None, plan=None, aux_challenges=(), mesh=None):
    """The sweep's accumulators (their num_challenges rows joined on the
    leader), divided by Z_H, to coefficients by a coset iNTT, cut into
    degree-n chunks and committed -> (chunk coefficient blocks, LDE
    blocks, tree)."""
    n = 1 << log_n
    dev = trace_lde[0].device
    if stark.num_fixed_columns:
        assert fixed_lde is not None, "fixed tables must pass the committed LDE"
    sweep = {"ir": _ir_sweep, "eager": _sweep}[_sweep_mode()]
    accs = pmesh.gather(
        sweep(stark, trace_lde, fixed_lde if stark.num_fixed_columns else None, aux_lde,
              instances, ctl_totals, lookup_alphas, public_inputs, alphas,
              log_n, rate_bits, shift, plan, aux_challenges), 1, dev)
    m = n << rate_bits
    zh_inv = gfp.inv(_zh_short(log_n, rate_bits, shift, dev)).repeat(m >> rate_bits)
    q_evals = gfp.mul(accs, zh_inv)  # (num_challenges, m)
    q_coeffs = four_step.best_coset_intt(q_evals, shift)
    chunks = stark.quotient_chunks(bool(instances))
    q_chunks = q_coeffs[:, : chunks * n].reshape(len(accs) * chunks, n)
    return _commit_gf(q_chunks, config, mesh, from_coeffs=True)


def _ext_host_mul(x, y):
    return ((x[0] * y[0] + 7 * x[1] * y[1]) % P, (x[0] * y[1] + x[1] * y[0]) % P)


def _weighted_ext_sum(weights, ys):
    acc = (0, 0)
    for w, y in zip(weights, ys):
        t = _ext_host_mul(w, y)
        acc = ((acc[0] + t[0]) % P, (acc[1] + t[1]) % P)
    return acc


# Rows of a DEEP batch are combined in blocks of at most this many elements:
# the field product's temporaries then scale with the block, not the batch.
COMBINE_BLOCK_ELEMS = 1 << 25


def _batch_combine(parts: List[torch.Tensor], weights: List[Tuple[int, int]]) -> GF2:
    """sum_j w_j * row_j over the base rows of `parts` (each (k_i, m)), in
    order, with ext weights -> (m,) ext. Modular sums are exact, so the
    blocking does not change the result."""
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
    assert j == len(weights)
    return acc


def _deep_composition(trace_lde, aux_lde, quotient_lde, openings: StarkOpenings, zeta, gzeta,
                      fri_alpha, log_n, rate_bits, shift, fixed_lde=None) -> GF2:
    """comp(x) = (B0(x)-y0)/(x-zeta) + (B1(x)-y1)/(x-g*zeta), row by row over
    the domain: each `*_lde` is a list of domain blocks, each block's part
    is computed where it lies and the blocks' one extension column is
    joined on the leader.

    batch0 (opened at zeta): trace + fixed + aux + quotient rows, weights
    a^0..; batch1 (opened at g*zeta): trace + fixed + aux rows, weights
    continue a^K..."""
    dev = trace_lde[0].device
    m = 1 << (log_n + rate_bits)
    span = trace_lde[0].shape[-1]
    oracles = [trace_lde]
    open0 = list(openings.trace_at_zeta)
    open1 = list(openings.trace_at_gzeta)
    if fixed_lde is not None:
        oracles.append(fixed_lde)
        open0 += list(openings.fixed_at_zeta)
        open1 += list(openings.fixed_at_gzeta)
    if aux_lde is not None:
        oracles.append(aux_lde)
        open0 += list(openings.aux_at_zeta)
        open1 += list(openings.aux_at_gzeta)
    open0 += list(openings.quotient_at_zeta)
    open0 = [(int(v[0]), int(v[1])) for v in open0]
    open1 = [(int(v[0]), int(v[1])) for v in open1]

    L = sum(o[0].shape[0] for o in oracles)
    K = L + quotient_lde[0].shape[0]
    a_pows = [(1, 0)]
    for _ in range(K + L - 1):
        a_pows.append(_ext_host_mul(a_pows[-1], fri_alpha))
    y0 = _weighted_ext_sum(a_pows[:K], open0)
    y1 = _weighted_ext_sum(a_pows[K:], open1)

    outs = []
    for d in range(len(trace_lde)):
        bdev = trace_lde[d].device
        parts1 = [o[d] for o in oracles]
        b0 = _batch_combine(parts1 + [quotient_lde[d]], a_pows[:K])
        b1 = _batch_combine(parts1, a_pows[K:])
        xs = _domain_points(log_n + rate_bits, shift, bdev, d * span, span)
        x_ext = GF2(xs, torch.zeros_like(xs))
        num0 = gf2x.sub(b0, gf2x.full((), y0, bdev))
        num1 = gf2x.sub(b1, gf2x.full((), y1, bdev))
        den0 = gf2x.sub(x_ext, gf2x.full((), zeta, bdev))
        den1 = gf2x.sub(x_ext, gf2x.full((), gzeta, bdev))
        t0 = gf2x.mul(num0, gf2x.inv(den0))
        t1 = gf2x.mul(num1, gf2x.inv(den1))
        outs.append(gf2x.add(t0, t1))
    comp = GF2(pmesh.gather([o.a for o in outs], 0, dev), pmesh.gather([o.b for o in outs], 0, dev))
    assert comp.a.shape == (m,)
    return comp

"""Constraint IR: record a table's `eval` ONCE, replay it anywhere.

Counterpart: ethproof_tpu/stark/ir.py:1. The recorder (`IRBuilder`,
`DeferredConsumer`, `record_sweep`, `sweep_program`, `assemble_inputs`,
`replay_accs`, `replay`) is a copy: host Python, so the port records the
same instruction list, inputs and outputs for every table. The
level-batched `SweepExecutor` (counterpart :641-878) is rewritten in
PyTorch with the same design. The counterpart's `StraightlineExecutor`
exists only to be jitted; run eagerly it would be the direct evaluation
again, so the level executor serves every program size here.

Every table's constraint system is a Python function `Stark.eval(ctx)`
written against abstract field ops. Evaluated directly over the LDE
domain, the EVM machine's eval body (thousands of constraints) would
launch ~10^5 device ops per sweep. The IR:

  record   `eval` runs ONCE per table STRUCTURE (not per shape, not per
           proof) against a recording `FieldOps`; every add/sub/mul
           becomes an instruction over virtual registers; constants fold
           and common subexpressions dedupe at record time.
  batch    instructions are topologically levelled; within a level, all
           instructions of one opcode execute as ONE gathered, stacked
           field op over (k, m) tensors — a few hundred stacked ops
           regardless of table width.
  replay   the same program evaluates over ANY field backend: the
           device sweep (base field over the LDE domain) and the host
           verifier (GF(p^2) ints at zeta), so both agree by construction.

The Horner accumulation acc = acc*alpha + c is inherently sequential
(depth = #constraints), so the recording consumer DEFERS it: terms are
collected and folded at the end as sum_i alpha^(N-1-i) * c_i with
log-depth power ladders and tree sums — algebraically identical mod p
(field ops are canonical, so results are bit-identical), but depth O(log N).

Liveness-based compaction bounds executor memory to the live frontier of
the DAG rather than the full register file.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..gf import field as gfp
from ..gf import field_host as fh
from .stark import (
    ConstraintConsumer,
    CtlSpec,
    EvalContext,
    FieldOps,
    Stark,
    eval_ctl_constraints,
    eval_lookup_constraints,
    lookup_aux_count,
)

P = fh.P

# opcodes: two-register, register+immediate, and materialized constant
OP_ADD, OP_SUB, OP_MUL = 0, 1, 2
OP_ADDC, OP_SUBC, OP_RSUBC, OP_MULC = 3, 4, 5, 6  # reg (+,-,r-,*) imm
OP_CONST = 7  # materialize an immediate as a row
_OP_NAMES = ["add", "sub", "mul", "addc", "subc", "rsubc", "mulc", "const"]


class Reg:
    """A virtual register (SSA value) in the recorded program."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


class KConst:
    """A compile-time field constant; folds through arithmetic until a
    consumer actually needs a register (then materialized via OP_CONST)."""

    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % P


class IRBuilder(FieldOps):
    """Recording FieldOps: values are Reg/KConst, ops append instructions.

    CSE: (op, operands) keyed; repeated subexpressions (e.g. the power
    ladder of a challenge requested by many folds) cost nothing.
    """

    def __init__(self):
        self.input_keys: List[Tuple] = []
        self.instrs: List[Tuple[int, int, int]] = []  # (op, a, b_or_imm)
        self._cse: Dict[Tuple, Reg] = {}

    # -- inputs ---------------------------------------------------------------

    def new_input(self, key: Tuple) -> Reg:
        r = Reg(len(self.input_keys) + len(self.instrs))
        assert not self.instrs, "declare all inputs before recording ops"
        self.input_keys.append(key)
        return r

    def _emit(self, op: int, a: int, b: int) -> Reg:
        key = (op, a, b)
        hit = self._cse.get(key)
        if hit is not None:
            return hit
        r = Reg(len(self.input_keys) + len(self.instrs))
        self.instrs.append((op, a, b))
        self._cse[key] = r
        return r

    def materialize(self, v) -> Reg:
        """KConst -> Reg (OP_CONST row); Reg passes through."""
        if isinstance(v, Reg):
            return v
        assert isinstance(v, KConst)
        return self._emit(OP_CONST, 0, v.v)

    # -- FieldOps -------------------------------------------------------------

    def add(self, a, b):
        if isinstance(a, list) or isinstance(b, list):
            return self._binvec(a, b, self.add)
        if isinstance(a, KConst) and isinstance(b, KConst):
            return KConst(a.v + b.v)
        if isinstance(a, KConst):
            a, b = b, a
        if isinstance(b, KConst):
            if b.v == 0:
                return a
            return self._emit(OP_ADDC, a.i, b.v)
        return self._emit(OP_ADD, *sorted((a.i, b.i)))

    def sub(self, a, b):
        if isinstance(a, list) or isinstance(b, list):
            return self._binvec(a, b, self.sub)
        if isinstance(a, KConst) and isinstance(b, KConst):
            return KConst(a.v - b.v)
        if isinstance(b, KConst):
            if b.v == 0:
                return a
            return self._emit(OP_SUBC, a.i, b.v)
        if isinstance(a, KConst):
            return self._emit(OP_RSUBC, b.i, a.v)
        return self._emit(OP_SUB, a.i, b.i)

    def mul(self, a, b):
        if isinstance(a, list) or isinstance(b, list):
            return self._binvec(a, b, self.mul)
        if isinstance(a, KConst) and isinstance(b, KConst):
            return KConst(a.v * b.v)
        if isinstance(a, KConst):
            a, b = b, a
        if isinstance(b, KConst):
            if b.v == 0:
                return KConst(0)
            if b.v == 1:
                return a
            return self._emit(OP_MULC, a.i, b.v)
        return self._emit(OP_MUL, *sorted((a.i, b.i)))

    def constant(self, c: int):
        return KConst(c)

    def challenge(self, c):
        if isinstance(c, (Reg, KConst)):
            return c
        return KConst(c)

    def alpha_pow(self, alpha, k: int):
        if isinstance(alpha, KConst):
            return KConst(pow(alpha.v, k, P))
        acc = None
        base = alpha
        kk = k
        while kk:
            if kk & 1:
                acc = base if acc is None else self.mul(acc, base)
            kk >>= 1
            if kk:
                base = self.mul(base, base)
        return KConst(1) if acc is None else acc

    # -- vector API (lists, like the host verifier backend) -------------------

    def _binvec(self, a, b, f):
        if not isinstance(a, list):
            a = [a] * len(b)
        if not isinstance(b, list):
            b = [b] * len(a)
        return [f(x, y) for x, y in zip(a, b)]

    def stack(self, vals):
        return list(vals)

    def vec_len(self, vec) -> int:
        return len(vec)

    def powers(self, alpha, k: int) -> List:
        """[alpha^0 .. alpha^(k-1)] in log-depth (doubling); CSE-cached."""
        if isinstance(alpha, KConst):
            return [KConst(pow(alpha.v, j, P)) for j in range(k)]
        pows = [KConst(1)]
        while len(pows) < k:
            step = self.alpha_pow(alpha, len(pows))
            pows = pows + [self.mul(p, step) for p in pows]
        return pows[:k]

    def tree_sum(self, terms: List):
        """Pairwise-halving sum — depth ceil(log2 k)."""
        terms = list(terms)
        if not terms:
            return KConst(0)
        while len(terms) > 1:
            nxt = [
                self.add(terms[2 * j], terms[2 * j + 1])
                for j in range(len(terms) // 2)
            ]
            if len(terms) & 1:
                nxt.append(terms[-1])
            terms = nxt
        return terms[0]

    def fold_vec(self, vec, alpha):
        """sum_j alpha^(k-1-j) * vec_j in log depth (== Horner mod p)."""
        k = len(vec)
        alpha = self.challenge(alpha)
        pows = self.powers(alpha, k)
        return self.tree_sum(
            [self.mul(vec[j], pows[k - 1 - j]) for j in range(k)]
        )

    def pack_weighted(self, vec, weights, group: int):
        out = []
        for i in range(len(vec) // group):
            out.append(
                self.tree_sum(
                    [
                        self.mul(KConst(w), vec[i * group + j])
                        for j, w in enumerate(weights)
                    ]
                )
            )
        return out


class DeferredConsumer(ConstraintConsumer):
    """Collects constraint terms; the alpha-Horner is emitted at finalize
    as a log-depth weighted fold (identical value mod p, bounded depth)."""

    def __init__(self, ops: IRBuilder, alphas: List, z_last, l_first, l_last):
        self.ops = ops
        self._alphas = list(alphas)
        self.alphas_int = list(alphas)  # consumer API compat (symbolic)
        self.z_last = z_last
        self.l_first = l_first
        self.l_last = l_last
        self.terms: List = []

    def _accumulate(self, term) -> None:
        self.terms.append(term)

    def _accumulate_vec(self, vec, weight) -> None:
        o = self.ops
        if weight is not None:
            vec = [o.mul(v, weight) for v in vec]
        self.terms.extend(vec)

    def finalize(self) -> List[Reg]:
        o = self.ops
        return [o.materialize(o.fold_vec(self.terms, a)) for a in self._alphas]


# -- recorded program ----------------------------------------------------------


@dataclass
class IRProgram:
    """A recorded constraint system + the input layout it expects."""

    input_keys: List[Tuple]
    instrs: List[Tuple[int, int, int]]
    outputs: List[int]  # register ids of the per-challenge accumulators
    meta: Dict

    @property
    def n_inputs(self) -> int:
        return len(self.input_keys)

    def stats(self) -> Dict:
        from collections import Counter

        c = Counter(_OP_NAMES[op] for op, _, _ in self.instrs)
        return {"inputs": self.n_inputs, "instrs": len(self.instrs), **c}


def record_sweep(
    stark: Stark,
    specs: Tuple[CtlSpec, ...],
    num_challenges: int,
    n_lookup_alphas: int,
    has_aux: bool,
) -> IRProgram:
    """Record the FULL sweep (table eval + CTL + lookups + custom aux) once.

    Shape-independent: every op is elementwise over the domain, so one
    program serves all trace lengths of this table structure.
    """
    b = IRBuilder()
    nc = stark.num_columns
    nf = stark.num_fixed_columns
    n_instances = len(specs)
    n_auxch = stark.num_aux_challenges(num_challenges)
    k_custom = stark.num_custom_aux(num_challenges)
    n_aux = (
        n_instances
        + sum(lookup_aux_count(s) for s in stark.lookups) * n_lookup_alphas
        + k_custom
    )

    local = [b.new_input(("tl", i)) for i in range(nc)]
    nxt = [b.new_input(("tn", i)) for i in range(nc)]
    fixed_l = [b.new_input(("fl", i)) for i in range(nf)]
    fixed_n = [b.new_input(("fn", i)) for i in range(nf)]
    aux_l = [b.new_input(("al", i)) for i in range(n_aux)] if has_aux else []
    aux_n = [b.new_input(("an", i)) for i in range(n_aux)] if has_aux else []
    pis = [b.new_input(("pi", i)) for i in range(stark.num_public_inputs)]
    alphas = [b.new_input(("alpha", i)) for i in range(num_challenges)]
    lk_alphas = [b.new_input(("lookup", i)) for i in range(n_lookup_alphas)]
    auxch = [b.new_input(("auxch", i)) for i in range(n_auxch)]
    betas = [b.new_input(("beta", i)) for i in range(n_instances)]
    gammas = [b.new_input(("gamma", i)) for i in range(n_instances)]
    totals = [b.new_input(("total", i)) for i in range(n_instances)]
    z_last = b.new_input(("zlast",))
    l_first = b.new_input(("lfirst",))
    l_last = b.new_input(("llast",))

    consumer = DeferredConsumer(b, alphas, z_last, l_first, l_last)
    ctx = EvalContext(b, local, nxt, pis, consumer, fixed_l, fixed_n)
    stark.eval(ctx)

    if has_aux:
        from .stark import CtlInstance

        if n_instances:
            bound = [
                CtlInstance(spec=specs[k], beta=betas[k], gamma=gammas[k])
                for k in range(n_instances)
            ]
            eval_ctl_constraints(
                b, consumer, local + fixed_l, nxt + fixed_n,
                aux_l[:n_instances], aux_n[:n_instances],
                bound, totals,
            )
        off = n_instances
        for spec in stark.lookups:
            for ai in range(n_lookup_alphas):
                w = lookup_aux_count(spec)
                eval_lookup_constraints(
                    b, consumer, local + fixed_l, nxt + fixed_n,
                    aux_l[off : off + w], aux_n[off : off + w],
                    spec, lk_alphas[ai],
                )
                off += w
        if k_custom:
            stark.eval_custom(
                ctx, aux_l[off : off + k_custom], aux_n[off : off + k_custom],
                auxch,
            )

    outs = consumer.finalize()
    return IRProgram(
        input_keys=b.input_keys,
        instrs=b.instrs,
        outputs=[r.i for r in outs],
        meta={
            "num_columns": nc, "num_fixed": nf, "n_aux": n_aux,
            "num_challenges": num_challenges, "n_instances": n_instances,
            "n_lookup_alphas": n_lookup_alphas, "n_auxch": n_auxch,
            "num_pis": stark.num_public_inputs, "has_aux": has_aux,
        },
    )


def sweep_program(
    stark: Stark,
    specs: Tuple[CtlSpec, ...],
    num_challenges: int,
    n_lookup_alphas: int,
    has_aux: bool,
) -> IRProgram:
    """Cached per-structure program, shared by prover sweep, host
    verifier, and recursion compiler (one recording, three backends)."""
    cache = stark.__dict__.setdefault("_ir_prog_cache", {})
    key = (hash(repr(specs)), num_challenges, n_lookup_alphas, has_aux)
    prog = cache.get(key)
    if prog is None:
        prog = record_sweep(stark, specs, num_challenges, n_lookup_alphas, has_aux)
        cache[key] = prog
    return prog


def assemble_inputs(
    program: IRProgram, *, local, nxt, fixed_l, fixed_n, aux_l, aux_n,
    pis, alphas, lookup_alphas, aux_challenges, betas, gammas, totals,
    z_last, l_first, l_last,
) -> List:
    """Map backend values onto the program's input registers by key."""
    table = {
        "tl": local, "tn": nxt, "fl": fixed_l, "fn": fixed_n,
        "al": aux_l, "an": aux_n, "pi": pis, "alpha": alphas,
        "lookup": lookup_alphas, "auxch": aux_challenges,
        "beta": betas, "gamma": gammas, "total": totals,
    }
    single = {"zlast": z_last, "lfirst": l_first, "llast": l_last}
    out = []
    for key in program.input_keys:
        if len(key) == 1:
            out.append(single[key[0]])
        else:
            out.append(table[key[0]][key[1]])
    return out


def replay_accs(stark: Stark, specs: Tuple[CtlSpec, ...], ops: FieldOps,
                num_challenges: int, **inputs) -> List:
    """One-call constraint-identity evaluation over any backend: the
    verifier (HostExtOps at zeta) and the recursion compiler
    (CircuitExtOps wires) replay the SAME recorded program the prover
    swept — multi-backend agreement by construction, at list-iteration
    speed instead of a Python re-trace of `eval`."""
    prog = sweep_program(
        stark, specs, num_challenges, len(inputs["lookup_alphas"]),
        has_aux=bool(inputs["aux_l"]),
    )
    return replay(prog, ops, assemble_inputs(prog, **inputs))


# -- generic replay (host verifier / recursion compiler backends) --------------


def replay(program: IRProgram, ops: FieldOps, inputs: List) -> List:
    """Evaluate the program over ANY FieldOps backend.

    `inputs`: one backend value per input_keys entry (same order). Used by
    the host verifier (GF(p^2) pairs at zeta) and the recursion compiler
    (circuit wires) so all backends evaluate the IDENTICAL expression the
    prover swept — the multi-backend agreement the engine's soundness
    rests on.
    """
    vals: List = list(inputs)
    const_cache: Dict[int, object] = {}

    def konst(v):
        r = const_cache.get(v)
        if r is None:
            r = ops.constant(v)
            const_cache[v] = r
        return r

    for op, a, bimm in program.instrs:
        if op == OP_ADD:
            vals.append(ops.add(vals[a], vals[bimm]))
        elif op == OP_SUB:
            vals.append(ops.sub(vals[a], vals[bimm]))
        elif op == OP_MUL:
            vals.append(ops.mul(vals[a], vals[bimm]))
        elif op == OP_ADDC:
            vals.append(ops.add(vals[a], konst(bimm)))
        elif op == OP_SUBC:
            vals.append(ops.sub(vals[a], konst(bimm)))
        elif op == OP_RSUBC:
            vals.append(ops.sub(konst(bimm), vals[a]))
        elif op == OP_MULC:
            vals.append(ops.mul(vals[a], konst(bimm)))
        elif op == OP_CONST:
            vals.append(konst(bimm))
        else:  # pragma: no cover
            raise ValueError(f"bad opcode {op}")
    return [vals[i] for i in program.outputs]


# -- level-batched device executor ---------------------------------------------


@dataclass
class _Group:
    op: int
    a_pos: np.ndarray  # positions in the current live buffer
    b_pos: Optional[np.ndarray]  # OP_ADD/SUB/MUL only
    imm: Optional[np.ndarray]  # uint64 immediates for *C / CONST


@dataclass
class _Level:
    groups: List[_Group]
    keep: np.ndarray  # gather into concat(buf, new rows) -> next live buffer


def sweep_budget() -> int:
    """The chunking threshold: peak live rows x the chunk's domain columns,
    ETHPROOF_SWEEP_BUDGET, default 2^27. It counts live register rows, not
    bytes: a level also holds its new rows, the concatenated buffer and its
    compacted copy, and the field ops' int64 temporaries, so a pass's
    device memory is several times 8 bytes x this count."""
    import os

    return int(os.environ.get("ETHPROOF_SWEEP_BUDGET", str(1 << 27)))


class SweepExecutor:
    """Level-batched evaluator of an IRProgram over int64 field tensors.

    Executes the whole constraint sweep as (#levels x #opcodes) stacked
    field ops with liveness-compacted buffers: tens of thousands of
    recorded instructions become a few hundred gathered tensor ops per
    domain chunk. `last_run` holds the (chunks, stacked ops) of the last
    `run`.
    """

    def __init__(self, program: IRProgram):
        self.program = program
        self._plan()
        self._device_plans: Dict[str, list] = {}
        self.last_run: Tuple[int, int] = (0, 0)

    def _plan(self) -> None:
        pr = self.program
        n_in = pr.n_inputs
        n_regs = n_in + len(pr.instrs)
        level = np.zeros(n_regs, dtype=np.int64)
        last_use = np.zeros(n_regs, dtype=np.int64)
        for k, (op, a, bimm) in enumerate(pr.instrs):
            i = n_in + k
            if op in (OP_ADD, OP_SUB, OP_MUL):
                level[i] = max(level[a], level[bimm]) + 1
            elif op == OP_CONST:
                level[i] = 1
            else:
                level[i] = level[a] + 1
        n_levels = int(level.max(initial=0))
        for k, (op, a, bimm) in enumerate(pr.instrs):
            i = n_in + k
            if op != OP_CONST:
                last_use[a] = max(last_use[a], level[i])
            if op in (OP_ADD, OP_SUB, OP_MUL):
                last_use[bimm] = max(last_use[bimm], level[i])
        for i in pr.outputs:
            last_use[i] = n_levels + 1

        # bucket instructions by (level, op), stable order
        by_level: List[Dict[int, List[int]]] = [dict() for _ in range(n_levels + 1)]
        for k, (op, _a, _b) in enumerate(pr.instrs):
            by_level[level[n_in + k]].setdefault(op, []).append(k)

        pos = {i: i for i in range(n_in)}  # reg -> live-buffer position
        live = list(range(n_in))
        self.levels: List[_Level] = []
        for lv in range(1, n_levels + 1):
            groups: List[_Group] = []
            created: List[int] = []
            for op in sorted(by_level[lv].keys()):
                ks = by_level[lv][op]
                a_pos = np.array(
                    [pos[pr.instrs[k][1]] if op != OP_CONST else 0 for k in ks],
                    dtype=np.int64,
                )
                b_pos = imm = None
                if op in (OP_ADD, OP_SUB, OP_MUL):
                    b_pos = np.array([pos[pr.instrs[k][2]] for k in ks], dtype=np.int64)
                else:
                    imm = np.array([pr.instrs[k][2] for k in ks], dtype=np.uint64)
                groups.append(_Group(op=op, a_pos=a_pos, b_pos=b_pos, imm=imm))
                created.extend(n_in + k for k in ks)
            # liveness compaction: new buffer = [still-live old, new live]
            ext = live + created
            new_live = [r for r in ext if last_use[r] > lv]
            ext_pos = {r: j for j, r in enumerate(ext)}
            keep = np.array([ext_pos[r] for r in new_live], dtype=np.int64)
            self.levels.append(_Level(groups=groups, keep=keep))
            live = new_live
            pos = {r: j for j, r in enumerate(live)}
        self.out_pos = np.array([pos[i] for i in pr.outputs], dtype=np.int64)
        # peak live rows (inputs + widest level frontier): with the domain
        # length this bounds the executor's working set
        self.peak_rows = n_in + max(
            (
                len(lvl.keep) + sum(len(g.a_pos) for g in lvl.groups)
                for lvl in self.levels
            ),
            default=0,
        )

    def _tensors(self, device: torch.device) -> list:
        """The plan's index and immediate arrays as tensors on `device`
        (immediates as (k, 1) int64 bit patterns), built once per device."""
        plan = self._device_plans.get(str(device))
        if plan is None:

            def idx(a):
                return None if a is None else torch.from_numpy(a).to(device)

            def imm(a):
                return None if a is None else (
                    torch.from_numpy(a.view(np.int64).copy()).to(device)[:, None])

            plan = [
                ([(g.op, idx(g.a_pos), idx(g.b_pos), imm(g.imm)) for g in lvl.groups],
                 idx(lvl.keep))
                for lvl in self.levels
            ]
            plan.append(idx(self.out_pos))
            self._device_plans[str(device)] = plan
        return plan

    def _run(self, head: torch.Tensor, scal: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
        """`head` (n_vec, c) trace/fixed/aux rows (local then next blocks),
        `scal` (n_scal,) transcript scalars (broadcast here), `tail` (3, c)
        domain vectors (z_last, l_first, l_last) -> (n_outputs, c)."""
        *levels, out_pos = self._tensors(head.device)
        c = head.shape[-1]
        buf = torch.cat([head, scal[:, None].expand(-1, c), tail])
        for groups, keep in levels:
            parts = [buf]
            for op, a_pos, b_pos, imm in groups:
                if op == OP_CONST:
                    parts.append(imm.expand(-1, c))
                    continue
                a = buf.index_select(0, a_pos)
                if op in (OP_ADD, OP_SUB, OP_MUL):
                    b = buf.index_select(0, b_pos)
                    out = (gfp.add, gfp.sub, gfp.mul)[op](a, b)
                elif op == OP_ADDC:
                    out = gfp.add(a, imm)
                elif op == OP_SUBC:
                    out = gfp.sub(a, imm)
                elif op == OP_RSUBC:
                    out = gfp.sub(imm, a)
                else:  # OP_MULC
                    out = gfp.mul(a, imm)
                parts.append(out)
            buf = torch.cat(parts).index_select(0, keep)
        return buf.index_select(0, out_pos)

    def chunks(self, m: int) -> int:
        """Power-of-two chunks of an m-column domain: every op is POINTWISE
        in the domain, so when the working set (peak_rows x m) exceeds
        `sweep_budget()` elements the domain runs in equal chunks."""
        budget = sweep_budget()
        nchunks = 1
        while self.peak_rows * (m // nchunks) > budget and (m // nchunks) > 1:
            nchunks *= 2
        return nchunks

    def stacked_ops(self) -> int:
        """Stacked field ops (gathers and constants aside) of one pass."""
        return sum(sum(g.op != OP_CONST for g in lvl.groups) for lvl in self.levels)

    def plan(self) -> Dict[str, int]:
        """The plan of the last `run`: recorded instructions, levels,
        stacked ops per pass, peak live rows, domain chunks and the stacked
        ops run over all chunks."""
        return dict(instrs=len(self.program.instrs), levels=len(self.levels),
                    stacked_ops=self.stacked_ops(), peak_rows=self.peak_rows,
                    chunks=self.last_run[0], stacked_ops_run=self.last_run[1])

    def run(self, head, scal: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
        """Evaluate the program over the domain -> (n_outputs, m) int64.

        `head(lo, hi)` gives columns lo..hi-1 of the (n_vec, m) input rows
        in input_keys order (so a caller builds the rows of one chunk at a
        time); `scal` (n_scal,) and `tail` (3, m) as in `_run`."""
        m = tail.shape[-1]
        nchunks = self.chunks(m)
        c = m // nchunks
        outs = [self._run(head(i * c, (i + 1) * c), scal, tail[:, i * c:(i + 1) * c])
                for i in range(nchunks)]
        self.last_run = (nchunks, nchunks * self.stacked_ops())
        return outs[0] if nchunks == 1 else torch.cat(outs, dim=-1)

    def run_blocks(self, heads, scals, tails) -> List[torch.Tensor]:
        """`run` over a domain held in blocks (a mesh's domain blocks, one
        without a mesh): heads[d], scals[d] and tails[d] as in `run`, on
        block d's device -> each block's outputs there. `last_run` counts
        the chunks and stacked ops of all blocks."""
        outs, chunks = [], 0
        for head, scal, tail in zip(heads, scals, tails):
            outs.append(self.run(head, scal, tail))
            chunks += self.last_run[0]
        self.last_run = (chunks, chunks * self.stacked_ops())
        return outs

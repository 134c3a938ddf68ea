"""The verifier machine: a STARK whose trace executes a `Circuit`.

Counterpart: ethproof_tpu/recursion/machine.py:1. The layout (`_Row`,
`_gate_lane`, `_layout`) and `RecursionStark`'s `eval` and `eval_custom`
are copies. `fixed_columns` and `generate_trace` fill the same bits as the
counterpart's per-row loops from the layout's arrays (`_plan`), with every
Poseidon block's rounds run at once on the host. `custom_aux_columns`, the
counterpart's one JAX function, is PyTorch on `gf/field.py` with the
prover's log-depth `_scan` in place of `lax.associative_scan`, and
returns the same canonical values on the trace's device.

Reference equivalent: plonky2's recursion circuits — `CircuitData` built
once per shape, then proved per witness (pin
Cargo.lock:3441; used via AllRecursiveCircuits at
common/src/prover_state/circuit.rs:200-206). The TPU
re-design is a UNIFORM-ROW machine instead of a gate-typed Plonk circuit:

- FOUR independent gate LANES per row, lane i constrained Plonk-style
  over value slots (V[3i], V[3i+1], V[3i+2]):
    qm_i*Va*Vb + ql_i*Va + qr_i*Vb + qc_i + qo_i*Vo = 0
  (add/sub/mul/mulc/const/bool/assert0 are coefficient choices);
- Poseidon permutations as 30-row blocks (one round per row, same
  arithmetization as tables/poseidon_table.py). The 28 MIDDLE rows of a
  block leave all 12 value slots free, so generic lanes PACK INTO them:
  the logUp bus routes by (tag, value) multisets — a wire's producing
  and consuming slots may sit on any rows in any order — so lane
  placement is pure scheduling, invisible to soundness. Machine rows ~=
  max(poseidon rows, ceil(gates/4)) instead of their SUM of gates.
- dataflow routed by a logUp BUS: every row has 12 value slots; fixed
  columns give each slot a wire TAG and a SIGNED MULTIPLICITY (+k for the
  producing slot of a wire consumed k times, -1 per consuming slot, 0 for
  dead slots). For challenges (beta, gamma) drawn after the trace commit,
    sum_rows sum_slots M / (gamma - (T + beta*V)) == 0
  forces signed multiset equality of (tag, value) pairs — i.e. every
  consumer slot carries exactly the producer's value. Tags and
  multiplicities are PREPROCESSED (fixed columns): the prover has zero
  freedom over routing.
- public inputs bound by one-hot QPI selectors on lane 0 (the circuit
  exposes a 4-element Poseidon digest of its logical public values, so
  QPI stays 4 columns regardless of how many values are exposed).

The program (fixed columns) is part of the circuit definition; the
verifier evaluates fixed columns analytically (stark/verify.py), so a
machine proof commits only the 36 witness columns + bus aux.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..gf import field as gfp
from ..gf import field_host as fh
from ..hash import constants as C
from ..hash.poseidon import _mds_layer
from ..stark.prove import _scan
from ..stark.stark import Stark
from .circuit import (
    Circuit,
    G_ADD,
    G_ASSERT0,
    G_BOOL,
    G_CONST,
    G_MUL,
    G_MULC,
    G_PI,
    G_POSEIDON,
    G_SUB,
    G_WIT,
)

P = fh.P
WIDTH = C.WIDTH  # 12
N_ROUNDS = C.N_ROUNDS  # 30
NUM_SLOTS = WIDTH
NUM_LANES = 4  # generic gate lanes per row (3 slots each)
NUM_PI = 4  # machine-level public inputs: a Poseidon digest
_MDS = C.mds_matrix()

# witness columns
V = list(range(0, NUM_SLOTS))
S = list(range(NUM_SLOTS, NUM_SLOTS + WIDTH))
X3 = list(range(NUM_SLOTS + WIDTH, NUM_SLOTS + 2 * WIDTH))
NUM_COLUMNS = NUM_SLOTS + 2 * WIDTH  # 36

# fixed columns: 5 plonk coefficients per lane, then the rest
_NQ = 5 * NUM_LANES
F_Q = [list(range(5 * i, 5 * i + 5)) for i in range(NUM_LANES)]  # per lane
F_QPOSE, F_QPOSE_FIRST, F_QPOSE_LAST = _NQ, _NQ + 1, _NQ + 2
F_RC = list(range(_NQ + 3, _NQ + 3 + WIDTH))
F_T = list(range(_NQ + 15, _NQ + 15 + NUM_SLOTS))
F_M = list(range(_NQ + 27, _NQ + 27 + NUM_SLOTS))
F_DEAD = list(range(_NQ + 39, _NQ + 39 + NUM_SLOTS))
F_QPI = list(range(_NQ + 51, _NQ + 51 + NUM_PI))
NUM_FIXED = _NQ + 51 + NUM_PI  # 75

_MINUS_ONE = P - 1

# per-gate-type Plonk coefficients (qm, ql, qr, qc, qo); None entries are
# gate-value-dependent
_GATE_COEFFS = {
    G_ADD: (0, 1, 1, 0, _MINUS_ONE),
    G_SUB: (0, 1, _MINUS_ONE, 0, _MINUS_ONE),
    G_MUL: (1, 0, 0, 0, _MINUS_ONE),
    G_WIT: (0, 0, 0, 0, 0),
    G_BOOL: (1, _MINUS_ONE, 0, 0, 0),
    G_ASSERT0: (0, 1, 0, 0, 0),
}


class _Row:
    """Layout of one machine row (shared by fixed-column and trace gen)."""

    __slots__ = ("coeffs", "rc", "pose", "pose_first", "pose_last", "slots", "qpi")

    def __init__(self):
        # one (qm, ql, qr, qc, qo) tuple per lane
        self.coeffs: List[Tuple[int, int, int, int, int]] = [
            (0, 0, 0, 0, 0)
        ] * NUM_LANES
        self.rc: Optional[np.ndarray] = None
        self.pose = self.pose_first = self.pose_last = False
        # slot j -> (tag, signed_mult, wire) ; absent = dead
        self.slots: Dict[int, Tuple[int, int, int]] = {}
        self.qpi: Optional[int] = None


def _gate_lane(g, counts) -> Tuple[Tuple[int, int, int, int, int], List]:
    """(coeffs, [(slot_offset, tag, mult, wire), ...]) for one generic
    gate placed in a lane (offsets 0..2 relative to the lane base)."""
    if g.op == G_CONST:
        coeffs = (0, 0, 0, g.c, _MINUS_ONE)
    elif g.op == G_MULC:
        coeffs = (0, g.c, 0, 0, _MINUS_ONE)
    elif g.op == G_PI:
        coeffs = (0, 0, 0, 0, 0)
    else:
        coeffs = _GATE_COEFFS[g.op]
    slots: List[Tuple[int, int, int, int]] = []
    if g.op in (G_ADD, G_SUB, G_MUL):
        slots = [
            (0, g.a, -1, g.a),
            (1, g.b, -1, g.b),
            (2, g.out, counts.get(g.out, 0), g.out),
        ]
    elif g.op == G_BOOL:
        # qm*Va*Vb - Va with both slots reading the same wire
        slots = [(0, g.a, -1, g.a), (1, g.a, -1, g.a)]
    elif g.op in (G_MULC, G_ASSERT0, G_PI):
        slots = [(0, g.a, -1, g.a)]
        if g.op == G_MULC:
            slots.append((2, g.out, counts.get(g.out, 0), g.out))
    elif g.op in (G_CONST, G_WIT):
        slots = [(2, g.out, counts.get(g.out, 0), g.out)]
    else:
        raise ValueError(f"unknown gate {g.op}")
    return coeffs, slots


def _layout(circuit: Circuit) -> List[_Row]:
    """Pack gates into rows: poseidon blocks are 30 consecutive rows whose
    28 middle rows donate their 4 lanes to generic gates; leftover generic
    gates get dedicated rows, 4 lanes each. PI gates are pinned to lane 0
    (the QPI selector binds V0). Placement is pure scheduling — the bus
    multiset argument is order-free — so any gate may land on any row."""
    counts = circuit.consumption_counts()
    rows: List[_Row] = []
    # open (row, lane) slots; consumed from `head`. Lane assignment is
    # order-free (the bus is a multiset argument), so a PI gate needing
    # lane 0 just swaps a lane-0 slot to the head and takes it.
    free: List[Tuple[int, int]] = []
    head = 0

    def place(g, lane0_only: bool) -> None:
        nonlocal head
        if head == len(free):
            base = len(rows)
            rows.append(_Row())
            free.extend((base, ln) for ln in range(NUM_LANES))
        if lane0_only and free[head][1] != 0:
            j = head
            while j < len(free) and free[j][1] != 0:
                j += 1
            if j == len(free):  # no lane-0 slot open: new generic row
                base = len(rows)
                rows.append(_Row())
                free.extend((base, ln) for ln in range(NUM_LANES))
            free[head], free[j] = free[j], free[head]
        r_i, lane = free[head]
        head += 1
        row = rows[r_i]
        coeffs, slots = _gate_lane(g, counts)
        cc = list(row.coeffs)
        cc[lane] = coeffs
        row.coeffs = cc
        for off, tag, mult, wire in slots:
            row.slots[3 * lane + off] = (tag, mult, wire)
        if g.op == G_PI:
            row.qpi = g.c

    for g in circuit.gates:
        if g.op == G_POSEIDON:
            base = len(rows)
            for rnd in range(N_ROUNDS):
                r = _Row()
                r.pose = True
                r.pose_first = rnd == 0
                r.pose_last = rnd == N_ROUNDS - 1
                if rnd == 0:
                    for j, w in enumerate(g.ins):
                        r.slots[j] = (w, -1, w)
                elif rnd == N_ROUNDS - 1:
                    for j, w in enumerate(g.outs):
                        r.slots[j] = (w, counts.get(w, 0), w)
                else:
                    # middle rows: all 4 lanes open for generic packing
                    free.extend(
                        (base + rnd, ln) for ln in range(NUM_LANES)
                    )
                rows.append(r)
            continue
        place(g, lane0_only=g.op == G_PI)
    return rows


class RecursionStark(Stark):
    """One instance per circuit (the circuit defines the fixed columns)."""

    num_columns = NUM_COLUMNS
    num_public_inputs = NUM_PI
    num_fixed_columns = NUM_FIXED
    constraint_degree = 4
    lookups = []

    def __init__(self, circuit: Circuit):
        assert circuit.num_public_inputs <= NUM_PI
        self.circuit = circuit
        self._rows = _layout(circuit)
        self._fixed_cache: Dict[int, np.ndarray] = {}

    @property
    def num_rows(self) -> int:
        """Machine rows after lane packing (NOT circuit.num_rows)."""
        return len(self._rows)

    # -- custom aux: the wire bus -------------------------------------------

    def num_aux_challenges(self, num_challenges: int) -> int:
        return 2 * num_challenges  # (beta, gamma) per repetition

    def num_custom_aux(self, num_challenges: int) -> int:
        return num_challenges * (NUM_SLOTS + 1)  # H[12] + running sum

    def custom_aux_columns(self, trace_gf, fixed_gf, challenges):
        """Per (beta, gamma): the 12 bus terms h_j = M_j / (gamma - (T_j +
        beta * V_j)) and the running sum of sum_j h_j -> (num_custom_aux, n)
        on the trace's device."""
        v = trace_gf[V[0] : V[0] + NUM_SLOTS]
        t = fixed_gf[F_T[0] : F_T[0] + NUM_SLOTS]
        m = fixed_gf[F_M[0] : F_M[0] + NUM_SLOTS]
        n = trace_gf.shape[-1]
        out = []
        for i in range(len(challenges) // 2):
            beta, gamma = challenges[2 * i], challenges[2 * i + 1]
            z = gfp.add(t, gfp.mul_const(v, beta))  # (12, n)
            denom = gfp.sub(gfp.full((NUM_SLOTS, n), gamma, trace_gf.device), z)
            h = gfp.mul(m, gfp.inv(denom))
            # delta = sum_j h_j over the 12 slots
            delta = gfp.sum_dim(h, 0)
            out.extend(list(h) + [_scan(delta, gfp.add)])
        return torch.stack(out)

    def eval_custom(self, ctx, aux_local, aux_next, challenges):
        c, o = ctx.consumer, ctx.ops
        v_l = ctx.local_stack(V)
        v_n = ctx.next_stack(V)
        t_l = ctx.fixed_stack(F_T)
        m_l = ctx.fixed_stack(F_M)
        for i in range(len(challenges) // 2):
            beta = o.challenge(challenges[2 * i])
            gamma = o.challenge(challenges[2 * i + 1])
            base = i * (NUM_SLOTS + 1)
            hs_l = o.stack(aux_local[base : base + NUM_SLOTS])
            rs_l = aux_local[base + NUM_SLOTS]
            hs_n = o.stack(aux_next[base : base + NUM_SLOTS])
            rs_n = aux_next[base + NUM_SLOTS]
            # h * (gamma - T - beta*V) == M   (degree 2)
            def denom(t, v):
                return o.sub(gamma, o.add(t, o.mul(beta, v)))

            c.constraint_vec(o.sub(o.mul(hs_l, denom(t_l, v_l)), m_l))

            def h_sum(hs):
                return o.fold_vec(hs, 1)  # alpha=1 fold == plain sum

            c.constraint_first_row(o.sub(rs_l, h_sum(hs_l)))
            c.constraint_transition(o.sub(rs_n, o.add(rs_l, h_sum(hs_n))))
            c.constraint_last_row(rs_l)

    # -- fixed columns (the program) ----------------------------------------

    def fixed_columns(self, n: int) -> np.ndarray:
        """The counterpart's per-row fill, vectorised over the layout's
        arrays (`_plan`); the same bits."""
        if n in self._fixed_cache:
            return self._fixed_cache[n]
        rows = self._rows
        assert len(rows) <= n, f"circuit needs {len(rows)} rows > {n}"
        plan = _plan(self)
        fx = np.zeros((NUM_FIXED, n), dtype=np.uint64)
        fx[F_DEAD[0] : F_DEAD[0] + NUM_SLOTS, :] = 1  # dead by default
        R = len(rows)
        fx[F_Q[0][0] : F_Q[0][0] + 5 * NUM_LANES, :R] = plan["coeffs"].reshape(R, -1).T
        fx[F_QPOSE, :R] = plan["pose"]
        fx[F_QPOSE_FIRST, :R] = plan["pose_first"]
        fx[F_QPOSE_LAST, :R] = plan["pose_last"]
        rc = C.ALL_ROUND_CONSTANTS.reshape(N_ROUNDS, WIDTH)
        for rnd in range(N_ROUNDS):  # Poseidon blocks are 30 consecutive rows
            fx[F_RC[0] : F_RC[0] + WIDTH, plan["bases"] + rnd] = rc[rnd][:, None]
        fx[np.asarray(F_QPI)[plan["qpi"]], plan["qpi_rows"]] = 1
        r, j = plan["slot_rows"], plan["slots"]
        fx[np.asarray(F_T)[j], r] = plan["tags"]
        fx[np.asarray(F_M)[j], r] = plan["mults"]
        fx[np.asarray(F_DEAD)[j], r] = 0
        self._fixed_cache[n] = fx
        return fx

    # -- constraints ---------------------------------------------------------

    def eval(self, ctx):
        c, o = ctx.consumer, ctx.ops
        # one plonk gate constraint per lane
        for ln in range(NUM_LANES):
            va = ctx.local(V[3 * ln])
            vb = ctx.local(V[3 * ln + 1])
            vo = ctx.local(V[3 * ln + 2])
            q = F_Q[ln]
            qm, ql, qr = ctx.fixed(q[0]), ctx.fixed(q[1]), ctx.fixed(q[2])
            qc, qo = ctx.fixed(q[3]), ctx.fixed(q[4])
            gate = o.add(
                o.add(o.mul(qm, o.mul(va, vb)), o.mul(ql, va)),
                o.add(o.add(o.mul(qr, vb), qc), o.mul(qo, vo)),
            )
            c.constraint(gate)

        # public-input binding (PI gates are laid out in lane 0)
        for k in range(NUM_PI):
            c.constraint(
                o.mul(ctx.fixed(F_QPI[k]), o.sub(ctx.local(V[0]), ctx.public_input(k)))
            )

        # dead slots pinned to zero (the bus ignores them ONLY because the
        # value is pinned; see module docstring)
        c.constraint_vec(o.mul(ctx.fixed_stack(F_DEAD), ctx.local_stack(V)))

        # poseidon rounds (tables/poseidon_table.py arithmetization)
        qpose = ctx.fixed(F_QPOSE)
        qfirst = ctx.fixed(F_QPOSE_FIRST)
        qlast = ctx.fixed(F_QPOSE_LAST)
        s = ctx.local_stack(S)
        rcv = ctx.fixed_stack(F_RC)
        sp = o.add(s, rcv)
        x3 = ctx.local_stack(X3)
        c.constraint_vec(o.mul(qpose, o.sub(x3, o.mul(sp, o.mul(sp, sp)))))
        sbox = o.mul(o.mul(x3, x3), sp)

        def _slice1(vec, i):
            # row i of a (k, m) tensor on the prover, of a list elsewhere
            return vec[i]

        mds_rows = []
        for i in range(WIDTH):
            acc = None
            for j in range(WIDTH):
                term = o.mul(o.constant(int(_MDS[i, j])), _slice1(sbox, j))
                acc = term if acc is None else o.add(acc, term)
            mds_rows.append(acc)
        mds_out = o.stack(mds_rows)
        not_last = o.sub(qpose, qlast)
        c.constraint_vec_transition(
            o.mul(not_last, o.sub(ctx.next_stack(S), mds_out))
        )
        # first round reads the block inputs from the V slots; last round
        # writes the outputs back. Middle rows' V slots belong to packed
        # generic lanes, so only first/last touch V.
        c.constraint_vec(o.mul(qfirst, o.sub(s, ctx.local_stack(V))))
        c.constraint_vec(o.mul(qlast, o.sub(ctx.local_stack(V), mds_out)))


def _plan(stark: RecursionStark) -> Dict[str, np.ndarray]:
    """The layout as arrays, cached on the stark: per row its lane
    coefficients and Poseidon flags; the first row of every Poseidon block;
    the rows and PI indices of the QPI selectors; and per live value slot
    its row, slot, tag, multiplicity (mod p) and wire, in layout order."""
    plan = stark.__dict__.get("_layout_plan")
    if plan is not None:
        return plan
    rows = stark._rows
    slot_rows: List[int] = []
    slots: List[int] = []
    tags: List[int] = []
    mults: List[int] = []
    wires: List[int] = []
    for r, row in enumerate(rows):
        for j, (tag, mult, w) in row.slots.items():
            slot_rows.append(r)
            slots.append(j)
            tags.append(tag)
            mults.append(mult % P)
            wires.append(w)
    qpi_rows = [r for r, row in enumerate(rows) if row.qpi is not None]
    plan = {
        "coeffs": np.asarray([row.coeffs for row in rows], dtype=np.uint64).reshape(
            len(rows), NUM_LANES, 5),
        "pose": np.asarray([row.pose for row in rows], dtype=np.uint64),
        "pose_first": np.asarray([row.pose_first for row in rows], dtype=np.uint64),
        "pose_last": np.asarray([row.pose_last for row in rows], dtype=np.uint64),
        "bases": np.asarray([r for r, row in enumerate(rows) if row.pose_first],
                            dtype=np.int64),
        "qpi_rows": np.asarray(qpi_rows, dtype=np.int64),
        "qpi": np.asarray([rows[r].qpi for r in qpi_rows], dtype=np.int64),
        "slot_rows": np.asarray(slot_rows, dtype=np.int64),
        "slots": np.asarray(slots, dtype=np.int64),
        "tags": np.asarray(tags, dtype=np.uint64),
        "mults": np.asarray(mults, dtype=np.uint64),
        "wires": np.asarray(wires, dtype=np.int64),
    }
    stark.__dict__["_layout_plan"] = plan
    return plan


def generate_trace(
    stark: RecursionStark, wire_values: List[int], n_rows: int
) -> np.ndarray:
    """Machine trace from interpreted wire values (circuit.interpret).

    The counterpart's per-row loop, vectorised: every value slot is one
    gather from the wire values, and every Poseidon block's rounds run at
    once on the host (torch field ops over (12, blocks)); the same bits."""
    rows = stark._rows
    assert len(rows) <= n_rows
    tr = np.zeros((NUM_COLUMNS, n_rows), dtype=np.uint64)
    plan = _plan(stark)
    bases = plan["bases"]
    vals = np.asarray(wire_values, dtype=np.uint64)
    tr[np.asarray(V)[plan["slots"]], plan["slot_rows"]] = vals[plan["wires"]]
    if len(bases):
        rc = gfp.from_u64(C.ALL_ROUND_CONSTANTS.reshape(N_ROUNDS, WIDTH), "cpu")
        mds = torch.from_numpy(_MDS.astype(np.float64))
        state = gfp.from_u64(tr[V[0] : V[0] + WIDTH][:, bases], "cpu")  # (12, blocks)
        for rnd in range(N_ROUNDS):
            tr[S[0] : S[0] + WIDTH, bases + rnd] = gfp.to_u64(state)
            sp = gfp.add(state, rc[rnd][:, None])
            x3 = gfp.mul(gfp.sqr(sp), sp)
            tr[X3[0] : X3[0] + WIDTH, bases + rnd] = gfp.to_u64(x3)
            state = _mds_layer(gfp.mul(gfp.sqr(x3), sp), mds)
    return tr

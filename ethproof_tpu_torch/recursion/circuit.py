"""Straight-line wire/gate circuit IR for the verifier machine.

Counterpart: ethproof_tpu/recursion/circuit.py:1 (a copy: `Gate`,
`Circuit`, `CBuilder`, `eval_hint`, `circuit_to_arrays`,
`circuit_from_arrays`, `interpret`), on the port's host field and
`hash/poseidon.permute_host`.

Reference equivalent: plonky2's `CircuitBuilder` + generator-filled
witness (pin Cargo.lock:3441), re-designed for a STARK
machine: a circuit here is a LIST of gates executed one per machine row
(Poseidon: one 30-row block), with dataflow carried by wire ids that the
machine routes via a logUp bus over preprocessed tags. There is no gate
graph scheduling — emission order IS execution order, which keeps witness
generation a single forward interpretation pass.

Wires hold Goldilocks elements. GF(p^2) values are wire PAIRS handled by
the `Ext` helpers on `CBuilder` (x^2 = 7 tower, matching gf/extension.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..gf import field_host as fh
from ..hash import constants as C
from ..hash import poseidon

P = fh.P

# gate opcodes
G_WIT = 0  # out = prover-supplied value (bound by later hashing/asserts)
G_CONST = 1  # out = C
G_ADD = 2  # out = a + b
G_SUB = 3  # out = a - b
G_MUL = 4  # out = a * b
G_MULC = 5  # out = C * a
G_BOOL = 6  # a * (a - 1) == 0   (consumer only)
G_ASSERT0 = 7  # a == 0            (consumer only)
G_PI = 8  # a == public_input[C]  (consumer only; C is the PI index)
G_POSEIDON = 9  # outs[12] = permute(ins[12])   (30-row block)

GATE_NAMES = {
    G_WIT: "wit", G_CONST: "const", G_ADD: "add", G_SUB: "sub",
    G_MUL: "mul", G_MULC: "mulc", G_BOOL: "bool", G_ASSERT0: "assert0",
    G_PI: "pi", G_POSEIDON: "poseidon",
}

Wire = int
Ext = Tuple[Wire, Wire]


@dataclass(frozen=True)
class Gate:
    op: int
    a: Wire = 0
    b: Wire = 0
    out: Wire = 0
    c: int = 0  # constant (G_CONST/G_MULC) or PI index (G_PI)
    ins: Tuple[Wire, ...] = ()  # G_POSEIDON inputs (12)
    outs: Tuple[Wire, ...] = ()  # G_POSEIDON outputs (12)
    label: str = ""
    # G_WIT only: derive the value from earlier wires instead of consuming
    # the external witness stream (plonky2-generator analogue: gadget
    # hints like inverses / bit decompositions fill themselves).
    # DECLARATIVE tuples — ("inv", a) | ("bit", x, i) | ("extinv", a, b,
    # comp) — evaluated by interpret(); declarative (not closures) so
    # whole circuits serialize to the prover-state artifact dir
    # (reference persistence.rs:40-88 parity).
    hint: Optional[Tuple] = None


def eval_hint(h: Tuple, vals: List[int]) -> int:
    tag = h[0]
    if tag == "inv":
        return pow(vals[h[1]], P - 2, P)
    if tag == "bit":
        return (vals[h[1]] >> h[2]) & 1
    if tag == "extinv":
        a, b = vals[h[1]], vals[h[2]]
        ni = pow((a * a - 7 * b * b) % P, P - 2, P)
        return a * ni % P if h[3] == 0 else (-b) * ni % P
    raise ValueError(f"unknown hint {h!r}")


@dataclass
class Circuit:
    gates: List[Gate]
    num_wires: int
    num_public_inputs: int
    num_witness: int  # count of G_WIT gates (the prover-input stream length)

    @property
    def num_rows(self) -> int:
        """Machine rows: 1 per gate, 30 per poseidon."""
        n = 0
        for g in self.gates:
            n += C.N_ROUNDS if g.op == G_POSEIDON else 1
        return n

    def consumption_counts(self) -> Dict[Wire, int]:
        """wire -> number of times consumed (operand / poseidon input / PI)."""
        counts: Dict[Wire, int] = {}

        def use(w: Wire) -> None:
            counts[w] = counts.get(w, 0) + 1

        for g in self.gates:
            if g.op in (G_ADD, G_SUB, G_MUL):
                use(g.a)
                use(g.b)
            elif g.op == G_BOOL:
                use(g.a)
                use(g.a)  # the machine reads it through two bus slots
            elif g.op in (G_MULC, G_ASSERT0, G_PI):
                use(g.a)
            elif g.op == G_POSEIDON:
                for w in g.ins:
                    use(w)
        return counts


class CBuilder:
    """Emission-order circuit builder with base- and extension-field helpers."""

    def __init__(self) -> None:
        self.gates: List[Gate] = []
        self._next_wire = 1  # wire 0 is the reserved null wire
        self.num_public_inputs = 0
        self.num_witness = 0
        self._const_cache: Dict[int, Wire] = {}

    def _wire(self) -> Wire:
        w = self._next_wire
        self._next_wire += 1
        return w

    def build(self) -> Circuit:
        return Circuit(
            gates=list(self.gates),
            num_wires=self._next_wire,
            num_public_inputs=self.num_public_inputs,
            num_witness=self.num_witness,
        )

    # -- base field ----------------------------------------------------------

    def wit(self, label: str = "", hint=None) -> Wire:
        """Prover-supplied wire. `hint(vals) -> int` (vals: wire-id-indexed
        values list) makes it self-filling during interpretation; unhinted
        wits consume the external witness stream in emission order."""
        out = self._wire()
        self.gates.append(Gate(G_WIT, out=out, label=label, hint=hint))
        if hint is None:
            self.num_witness += 1
        return out

    def const(self, c: int, label: str = "") -> Wire:
        c = c % P
        if c in self._const_cache:
            return self._const_cache[c]
        out = self._wire()
        self.gates.append(Gate(G_CONST, out=out, c=c, label=label))
        self._const_cache[c] = out
        return out

    def add(self, a: Wire, b: Wire) -> Wire:
        out = self._wire()
        self.gates.append(Gate(G_ADD, a=a, b=b, out=out))
        return out

    def sub(self, a: Wire, b: Wire) -> Wire:
        out = self._wire()
        self.gates.append(Gate(G_SUB, a=a, b=b, out=out))
        return out

    def mul(self, a: Wire, b: Wire) -> Wire:
        out = self._wire()
        self.gates.append(Gate(G_MUL, a=a, b=b, out=out))
        return out

    def mulc(self, c: int, a: Wire) -> Wire:
        c = c % P
        if c == 1:
            return a
        out = self._wire()
        self.gates.append(Gate(G_MULC, a=a, c=c, out=out))
        return out

    def bool_check(self, a: Wire) -> Wire:
        self.gates.append(Gate(G_BOOL, a=a))
        return a

    def assert_zero(self, a: Wire, label: str = "") -> None:
        self.gates.append(Gate(G_ASSERT0, a=a, label=label))

    def assert_eq(self, a: Wire, b: Wire, label: str = "") -> None:
        self.assert_zero(self.sub(a, b), label=label)

    def expose(self, a: Wire, pi_index: int, label: str = "") -> None:
        """Constrain wire == public_input[pi_index]."""
        self.gates.append(Gate(G_PI, a=a, c=pi_index, label=label))
        self.num_public_inputs = max(self.num_public_inputs, pi_index + 1)

    def poseidon(self, state: Sequence[Wire], label: str = "") -> List[Wire]:
        assert len(state) == C.WIDTH
        outs = tuple(self._wire() for _ in range(C.WIDTH))
        self.gates.append(
            Gate(G_POSEIDON, ins=tuple(state), outs=outs, label=label)
        )
        return list(outs)

    def select(self, bit: Wire, x: Wire, y: Wire) -> Wire:
        """bit ? x : y  — bit must already be bool-checked."""
        return self.add(y, self.mul(bit, self.sub(x, y)))

    def inverse(self, a: Wire, label: str = "inv") -> Wire:
        """Witnessed inverse: w * a == 1 (fails for a == 0). Self-filling."""
        w = self.wit(label, hint=("inv", a))
        self.assert_eq(self.mul(w, a), self.const(1), label=label)
        return w

    def decompose_bits(self, x: Wire, n_bits: int = 64) -> List[Wire]:
        """Canonical n-bit decomposition of x (little-endian bit wires).

        Soundness: bits are bool-checked, their weighted sum equals x in
        the field, and for the full 64-bit case the value is constrained
        canonical (< p = 2^64 - 2^32 + 1): NOT(high 32 bits all ones AND
        low 32 bits nonzero) via prod(high) * sum_low_weighted == 0.
        Bit wires are hint-filled from x's value.
        """
        bits = [
            self.bool_check(self.wit(f"bit{i}", hint=("bit", x, i)))
            for i in range(n_bits)
        ]
        acc = bits[0]
        for i in range(1, n_bits):
            acc = self.add(acc, self.mulc(1 << i, bits[i]))
        self.assert_eq(acc, x, label="bit-recompose")
        if n_bits == 64:
            high = bits[32]
            for i in range(33, 64):
                high = self.mul(high, bits[i])
            low = bits[0]
            for i in range(1, 32):
                low = self.add(low, self.mulc(1 << i, bits[i]))
            self.assert_zero(self.mul(high, low), label="canonical-u64")
        return bits

    # -- GF(p^2) helpers (x^2 = 7 tower, gf/extension.py) --------------------

    def ext_const(self, v: Tuple[int, int]) -> Ext:
        return (self.const(v[0]), self.const(v[1]))

    def ext_wit(self, label: str = "") -> Ext:
        return (self.wit(label + ".a"), self.wit(label + ".b"))

    def ext_from_base(self, a: Wire) -> Ext:
        return (a, self.const(0))

    def ext_add(self, x: Ext, y: Ext) -> Ext:
        return (self.add(x[0], y[0]), self.add(x[1], y[1]))

    def ext_sub(self, x: Ext, y: Ext) -> Ext:
        return (self.sub(x[0], y[0]), self.sub(x[1], y[1]))

    def ext_mul(self, x: Ext, y: Ext) -> Ext:
        a = self.mul(x[0], y[0])
        b = self.mul(x[1], y[1])
        c0 = self.add(a, self.mulc(7, b))
        c1 = self.add(self.mul(x[0], y[1]), self.mul(x[1], y[0]))
        return (c0, c1)

    def ext_mulc(self, c: int, x: Ext) -> Ext:
        return (self.mulc(c, x[0]), self.mulc(c, x[1]))

    def ext_scale(self, x: Ext, s: Wire) -> Ext:
        return (self.mul(x[0], s), self.mul(x[1], s))

    def ext_assert_eq(self, x: Ext, y: Ext, label: str = "") -> None:
        self.assert_eq(x[0], y[0], label=label + ".a")
        self.assert_eq(x[1], y[1], label=label + ".b")

    def ext_inverse(self, x: Ext, label: str = "ext-inv") -> Ext:
        # (a + b*s)^-1 = (a - b*s) / (a^2 - 7 b^2) in GF(p^2), x^2 = 7
        w = (
            self.wit(label + ".a", hint=("extinv", x[0], x[1], 0)),
            self.wit(label + ".b", hint=("extinv", x[0], x[1], 1)),
        )
        prod = self.ext_mul(w, x)
        self.assert_eq(prod[0], self.const(1), label=label + ".a")
        self.assert_zero(prod[1], label=label + ".b")
        return w

    def ext_select(self, bit: Wire, x: Ext, y: Ext) -> Ext:
        return (self.select(bit, x[0], y[0]), self.select(bit, x[1], y[1]))


_HINT_TAGS = {"inv": 0, "bit": 1, "extinv": 2}
_HINT_NAMES = {v: k for k, v in _HINT_TAGS.items()}
_HINT_ARITY = {"inv": 1, "bit": 2, "extinv": 3}


def circuit_to_arrays(c: Circuit) -> Dict:
    """Compact numpy encoding for disk persistence (labels dropped —
    they only decorate assertion messages). The prover-state artifact
    dir stores circuits this way (reference persistence.rs:40-88)."""
    import numpy as np

    n = len(c.gates)
    op = np.zeros(n, np.uint8)
    a = np.zeros(n, np.uint32)
    b = np.zeros(n, np.uint32)
    out = np.zeros(n, np.uint32)
    cval = np.zeros(n, np.uint64)
    htag = np.full(n, -1, np.int8)
    hargs = np.zeros((n, 3), np.uint32)
    pos: List[List[int]] = []
    pidx = np.zeros(n, np.uint32)
    for i, g in enumerate(c.gates):
        op[i], a[i], b[i], out[i], cval[i] = g.op, g.a, g.b, g.out, g.c
        if g.op == G_POSEIDON:
            pidx[i] = len(pos)
            pos.append(list(g.ins) + list(g.outs))
        if g.hint is not None:
            htag[i] = _HINT_TAGS[g.hint[0]]
            for j, v in enumerate(g.hint[1:]):
                hargs[i, j] = v
    return dict(
        op=op, a=a, b=b, out=out, c=cval, htag=htag, hargs=hargs,
        pos=(
            np.asarray(pos, np.uint32)
            if pos
            else np.zeros((0, 24), np.uint32)
        ),
        pidx=pidx,
        meta=np.asarray(
            [c.num_wires, c.num_public_inputs, c.num_witness], np.int64
        ),
    )


def circuit_from_arrays(d: Dict) -> Circuit:
    op, a, b, out, cval = d["op"], d["a"], d["b"], d["out"], d["c"]
    htag, hargs, pos, pidx = d["htag"], d["hargs"], d["pos"], d["pidx"]
    gates: List[Gate] = []
    for i in range(op.shape[0]):
        o = int(op[i])
        hint = None
        if htag[i] >= 0:
            name = _HINT_NAMES[int(htag[i])]
            hint = (name,) + tuple(
                int(hargs[i, j]) for j in range(_HINT_ARITY[name])
            )
        if o == G_POSEIDON:
            row = pos[int(pidx[i])]
            gates.append(
                Gate(
                    o,
                    ins=tuple(int(x) for x in row[:12]),
                    outs=tuple(int(x) for x in row[12:]),
                )
            )
        else:
            gates.append(
                Gate(
                    o, a=int(a[i]), b=int(b[i]), out=int(out[i]),
                    c=int(cval[i]), hint=hint,
                )
            )
    meta = d["meta"]
    return Circuit(
        gates=gates,
        num_wires=int(meta[0]),
        num_public_inputs=int(meta[1]),
        num_witness=int(meta[2]),
    )


def interpret(
    circuit: Circuit,
    witness: Sequence[int],
    public_inputs: Sequence[int],
    check: bool = True,
) -> List[int]:
    """Forward-evaluate: -> wire values (index = wire id).

    `witness` feeds G_WIT gates in emission order. With check=True the
    consumer gates (BOOL/ASSERT0/PI) raise on violation — this is the
    prover-side sanity run; the STARK constraints enforce the same
    relations against a malicious prover.
    """
    vals = [0] * circuit.num_wires
    it: Iterator[int] = iter(witness)
    n_wit = 0
    for g in circuit.gates:
        if g.op == G_WIT:
            if g.hint is not None:
                vals[g.out] = eval_hint(g.hint, vals) % P
            else:
                vals[g.out] = next(it) % P
                n_wit += 1
        elif g.op == G_CONST:
            vals[g.out] = g.c
        elif g.op == G_ADD:
            vals[g.out] = (vals[g.a] + vals[g.b]) % P
        elif g.op == G_SUB:
            vals[g.out] = (vals[g.a] - vals[g.b]) % P
        elif g.op == G_MUL:
            vals[g.out] = vals[g.a] * vals[g.b] % P
        elif g.op == G_MULC:
            vals[g.out] = g.c * vals[g.a] % P
        elif g.op == G_BOOL:
            if check and vals[g.a] not in (0, 1):
                raise AssertionError(f"bool violation at {g.label or g}")
        elif g.op == G_ASSERT0:
            if check and vals[g.a] != 0:
                raise AssertionError(
                    f"assert0 violation ({g.label}): {vals[g.a]:#x}"
                )
        elif g.op == G_PI:
            if check and vals[g.a] != public_inputs[g.c] % P:
                raise AssertionError(
                    f"public input {g.c} mismatch ({g.label}): "
                    f"{vals[g.a]:#x} != {public_inputs[g.c] % P:#x}"
                )
        elif g.op == G_POSEIDON:
            out = poseidon.permute_host([vals[w] for w in g.ins])
            for w, v in zip(g.outs, out):
                vals[w] = v
        else:
            raise ValueError(f"unknown gate op {g.op}")
    assert n_wit == circuit.num_witness
    return vals

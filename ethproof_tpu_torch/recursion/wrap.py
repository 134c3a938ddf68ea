"""Prove / verify machine circuits; the wrap (shrink) step.

Counterpart: ethproof_tpu/recursion/wrap.py:1 (`machine_degree`,
`MachineProof`, `prove_circuit`, `verify_machine`, `WrapCircuit`,
`build_wrap`), on the port's `stark_prove`/`stark_verify`. Every entry
point takes `device` (None: the CUDA card), and `phase_times`, when given,
receives host seconds per step apart from the machine proof's phases.

Reference equivalent: proof_gen's per-table shrink ladder — each STARK
proof is recursively wrapped until it reaches a fixed size
(common/src/prover_state/circuit.rs:200-206 [dep: from
knowledge of proof_gen 0.1.3]). Here a "wrap" is one machine proof whose
circuit verifies the child proof and re-exposes its public inputs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..fri.config import StarkConfig
from ..gf import field_host as fh
from ..stark.prove import StarkProof, stark_prove
from ..stark.verify import stark_verify
from .circuit import interpret
from .machine import NUM_PI, RecursionStark, generate_trace
from .verifier_circuit import CompiledVerifier, compile_stark_verifier

P = fh.P


def machine_degree(target, floor_bits: int = 6) -> int:
    """log2 rows for a machine proof (next pow2, floored).

    Accepts the RecursionStark (whose layout knows the PACKED row count
    after 4-lane scheduling) or a bare Circuit (pre-packing upper bound
    — only for sizing before a stark exists)."""
    rows = target.num_rows  # RecursionStark.num_rows or Circuit.num_rows
    need = max(rows, 1 << floor_bits)
    return (need - 1).bit_length()


@dataclass
class MachineProof:
    """A machine STARK proof plus the (static) identity of its circuit.

    `variant`, `seam` and `digest` are the aggregation ladder's prover-side
    plumbing (recursion/aggregate.py and root.py); a wrap leaves them at
    their defaults."""

    proof: StarkProof
    log_n: int
    variant: int = 0
    seam: Optional[List[int]] = None
    digest: Optional[List[int]] = None


def _elapsed(host: Dict[str, float], name: str, t0: float) -> None:
    host[name] = host.get(name, 0.0) + time.perf_counter() - t0


def prove_circuit(
    stark: RecursionStark,
    witness: Sequence[int],
    public_inputs: List[int],
    config: StarkConfig,
    log_n: Optional[int] = None,
    device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> MachineProof:
    """Interpret the circuit (checking every assertion — the prover-side
    sanity run), generate the machine trace, and STARK-prove it on `device`.

    `phase_times`, when given, receives the host seconds of "interpret" and
    "generate_trace" under "host", and the machine proof's phases
    (`stark_prove`'s) under "machine"."""
    host: Dict[str, float] = {}
    t0 = time.perf_counter()
    vals = interpret(stark.circuit, witness, public_inputs, check=True)
    _elapsed(host, "interpret", t0)
    bits = log_n or machine_degree(stark)
    t0 = time.perf_counter()
    tr = generate_trace(stark, vals, 1 << bits)
    _elapsed(host, "generate_trace", t0)
    machine: Optional[Dict[str, float]] = {} if phase_times is not None else None
    proof = stark_prove(stark, tr, public_inputs, config, device=device, phase_times=machine)
    if phase_times is not None:
        phase_times.setdefault("host", {}).update(host)
        phase_times["machine"] = machine
    return MachineProof(proof=proof, log_n=bits)


def verify_machine(
    stark: RecursionStark, mp: MachineProof, config: StarkConfig, device=None
) -> bool:
    if mp.proof.degree_bits != mp.log_n:
        return False
    return stark_verify(stark, mp.proof, config, device=device)


@dataclass
class WrapCircuit:
    """Compiled wrap step: machine circuit + its prover-side machinery."""

    compiled: CompiledVerifier
    stark: RecursionStark
    log_n: int  # machine degree of the WRAP proof
    device: object = None  # where the wrap proves (None: the CUDA card)

    def prove(
        self,
        child_proof: StarkProof,
        config: StarkConfig,
        phase_times: Optional[Dict[str, Dict[str, float]]] = None,
    ) -> MachineProof:
        """The wrap proof of `child_proof`: its public inputs are the
        child's, padded with zeros to the machine's NUM_PI. `phase_times`
        as in `prove_circuit`; the host seconds of the witness stream go to
        "witness" under "host"."""
        t0 = time.perf_counter()
        witness = self.compiled.witness(child_proof)
        pis = [int(x) % P for x in child_proof.public_inputs]
        # the machine always has NUM_PI public inputs; a child with fewer
        # (MemoryStark has none) leaves the rest zero, which no QPI
        # selector reads (the counterpart passes the child's list as it is,
        # and its stark_prove refuses any other length than NUM_PI)
        pis += [0] * (NUM_PI - len(pis))
        if phase_times is not None:
            _elapsed(phase_times.setdefault("host", {}), "witness", t0)
        return prove_circuit(self.stark, witness, pis, config, self.log_n, self.device,
                             phase_times)


def build_wrap(
    child_stark,
    child_log_n: int,
    config: StarkConfig,
    device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> WrapCircuit:
    """Compile the circuit verifying `child_stark` proofs at degree
    2^child_log_n, and set up its machine STARK. `device` (None: the CUDA
    card) commits the child's vkey and proves the wrap. `phase_times`, when
    given, receives under "host" the seconds of "compile" (the verifier
    circuit, the child's vkey included), "layout" (the machine's row
    layout) and "fixed_columns" (the machine's program at the wrap's
    degree, cached on the stark for its proofs)."""
    host: Dict[str, float] = {}
    t0 = time.perf_counter()
    compiled = compile_stark_verifier(child_stark, child_log_n, config, device)
    _elapsed(host, "compile", t0)
    t0 = time.perf_counter()
    stark = RecursionStark(compiled.circuit)
    _elapsed(host, "layout", t0)
    log_n = machine_degree(stark)
    t0 = time.perf_counter()
    stark.fixed_columns(1 << log_n)
    _elapsed(host, "fixed_columns", t0)
    if phase_times is not None:
        phase_times.setdefault("host", {}).update(host)
    return WrapCircuit(compiled=compiled, stark=stark, log_n=log_n, device=device)

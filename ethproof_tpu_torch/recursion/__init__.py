"""Recursion: the verifier machine and the wrap.

Counterpart: ethproof_tpu/recursion/__init__.py:1. Ported: the circuit IR
(`circuit`), its compiling FieldOps (`ops_circuit`), the verifier machine
(`machine`), the verifier compiler (`verifier_circuit`) and the wrap
(`wrap`). The aggregation ladder (`aggregate`, `root`, `block`, `state`,
`persist`) is not ported yet.
"""

from .circuit import CBuilder, Circuit, Gate, interpret
from .machine import RecursionStark, generate_trace
from .verifier_circuit import CompiledVerifier, compile_stark_verifier
from .wrap import MachineProof, WrapCircuit, build_wrap, machine_degree, prove_circuit, verify_machine

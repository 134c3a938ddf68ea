"""All-tables wiring: the five-table multi-table proof of one transaction.

Counterpart: ethproof_tpu/tables/all.py:1-255 (`build_ctls`, `TableSizes`,
`kernel_counts`, `all_starks`, `prove_all_tables`, `verify_all_tables`),
the part without the Keccak/KeccakSponge pair: tables CPU, Arithmetic,
Logic, BytePacking and Memory with three CTLs (cpu<->arithmetic,
cpu<->logic, cpu/bytepacking<->memory). `with_keccak=True` raises
NotImplementedError: the pair comes with the seven-table transfer. The EVM
machine's wiring (`build_ctls_evm`, `prove_evm_tables`) is not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..fri.config import StarkConfig
from ..stark.multi import CrossTableLookup, MultiProof, prove_multi, verify_multi
from . import arithmetic, bytepacking, logic, memory
from .cpu import ARITH_OPS, LOGIC_OPS, OP_NOP, CpuStark, CpuTraceResult, execute, pi_limbs
from .keccak_sponge import RATE_BYTES

# table indices (stable order)
T_CPU, T_ARITH, T_LOGIC, T_BYTEPACK, T_MEM = range(5)
TABLE_NAMES = ("cpu", "arithmetic", "logic", "bytepacking", "memory")

_SEVEN_TABLES = (
    "the Keccak/KeccakSponge tables are not ported yet: they come with the "
    "seven-table transfer (in-circuit trie binding)"
)


class CircuitSizeError(ValueError):
    """A trace demands a degree above the configured range (deterministic)."""


def _ceil_log2(x: int) -> int:
    return max(int(x) - 1, 0).bit_length()


def build_ctls(cpu: CpuStark, with_keccak: bool = False) -> List[CrossTableLookup]:
    if with_keccak:
        raise NotImplementedError(_SEVEN_TABLES)
    mem_looking = [(T_CPU, spec) for spec in cpu.memory_ctl_specs()]
    mem_looking += [(T_BYTEPACK, s) for s in bytepacking.memory_ctl_specs()]
    return [
        CrossTableLookup(
            looking=((T_CPU, cpu.arith_ctl_spec()),),
            looked=(T_ARITH, arithmetic.ArithmeticStark.ctl_spec),
        ),
        CrossTableLookup(
            looking=((T_CPU, cpu.logic_ctl_spec()),),
            looked=(T_LOGIC, logic.LogicStark.ctl_spec),
        ),
        CrossTableLookup(
            looking=tuple(mem_looking),
            looked=(T_MEM, memory.MemoryStark.ctl_spec),
        ),
    ]


@dataclass
class TableSizes:
    """log2 trace lengths per table (the reference's *_CIRCUIT_SIZE
    ranges). keccak=None drops the Keccak/KeccakSponge pair, which is the
    only form the port proves."""

    cpu: int = 5
    arithmetic: int = 6
    logic: int = 4
    bytepacking: int = 9
    memory: int = 7
    keccak: "int | None" = 5
    keccak_sponge: int = 8

    def degree_bits(self, with_keccak: bool = True) -> List[int]:
        """Per-table log2 sizes in prove_all_tables trace order."""
        out = [self.cpu, self.arithmetic, self.logic, self.bytepacking, self.memory]
        if with_keccak:
            assert self.keccak is not None
            out += [self.keccak, self.keccak_sponge]
        return out

    # TableSizes field -> CircuitConfig range key
    RANGE_KEYS = {
        "cpu": "cpu",
        "arithmetic": "arithmetic",
        "logic": "logic",
        "bytepacking": "byte_packing",
        "memory": "memory",
        "keccak": "keccak",
        "keccak_sponge": "keccak_sponge",
    }

    @classmethod
    def fit(cls, config, counts: Dict[str, int], with_keccak: bool = True) -> "TableSizes":
        """Per-proof degree = next pow2 of the actual trace demand, clamped
        into `config.ranges` (a mapping of range keys to `range`s). Above
        the range maximum raises CircuitSizeError; below the minimum proves
        at the floor."""
        vals: Dict[str, "int | None"] = {}
        for field_name, key in cls.RANGE_KEYS.items():
            r = config.ranges[key]
            need = _ceil_log2(counts.get(field_name, 1))
            log = max(r.start, need)
            if log >= r.stop:
                raise CircuitSizeError(
                    f"{key} trace needs degree 2^{need}, above configured "
                    f"range {r.start}..{r.stop}"
                )
            vals[field_name] = log
        if not with_keccak:
            vals["keccak"] = None
        return cls(**vals)


def kernel_counts(program, hash_requests=()) -> Dict[str, int]:
    """Analytic per-table row demand for one kernel run — computable before
    any trace is generated."""
    active = [i for i in program if i.op != OP_NOP]
    blocks = sum(len(r.message) // RATE_BYTES + 1 for r in hash_requests)
    # memory: 3 ops/instr + 10/block (5 word reads + up to 5 staging
    # writes); diffs are range-checked against the table size, and
    # timestamps run past 3*len(program) by one serial per request, so
    # the table must also cover that bound.
    mem = 3 * len(active) + 10 * blocks
    max_ts = 3 * len(program) + 3 + len(hash_requests)
    return {
        "cpu": len(program),
        "arithmetic": sum(1 for i in active if i.op in ARITH_OPS),
        "logic": sum(1 for i in active if i.op in LOGIC_OPS) + 5 * blocks,
        "bytepacking": 256,  # byte range table floor
        "memory": max(mem + 1, max_ts),
        "keccak": 24 * blocks,
        "keccak_sponge": max(blocks, 256),  # byte range table floor
    }


def all_starks(cpu: CpuStark, with_keccak: bool = False):
    if with_keccak:
        raise NotImplementedError(_SEVEN_TABLES)
    return [
        cpu,
        arithmetic.ArithmeticStark(),
        logic.LogicStark(),
        bytepacking.BytePackingStark(),
        memory.MemoryStark(),
    ]


def generate_traces(
    cpu: CpuStark,
    pi_words: List[int],
    sizes: TableSizes,
    kernel_witness: Optional[List[int]] = None,
) -> Tuple[List[np.ndarray], CpuTraceResult]:
    """Execute the kernel on the host and fill the five tables' traces."""
    if sizes.keccak is not None:
        raise NotImplementedError(_SEVEN_TABLES)
    res = execute(cpu.program, pi_words, 1 << sizes.cpu, witness=kernel_witness)
    arith_tr, _ = arithmetic.generate_trace(res.arith_requests, 1 << sizes.arithmetic)
    bp_tr, bp_mem_ops = bytepacking.generate_trace([], 1 << sizes.bytepacking)
    logic_tr, _ = logic.generate_trace(res.logic_requests, 1 << sizes.logic)
    mem_tr = memory.generate_trace(res.mem_ops + bp_mem_ops, 1 << sizes.memory)
    return [res.trace, arith_tr, logic_tr, bp_tr, mem_tr], res


def prove_all_tables(
    cpu: CpuStark,
    pi_words: List[int],
    sizes: TableSizes,
    config: StarkConfig,
    hash_requests=(),
    kernel_witness: Optional[List[int]] = None,
    device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> Tuple[MultiProof, CpuTraceResult]:
    """Execute the kernel and prove the five tables under one transcript on
    `device` (None: the CUDA card). `phase_times`, when given, receives
    the host's trace generation seconds (`["host"]["tracegen"]`) and each
    table's phase seconds under its name in TABLE_NAMES."""
    if hash_requests:
        raise NotImplementedError(_SEVEN_TABLES)
    t0 = time.perf_counter()
    traces, res = generate_traces(cpu, pi_words, sizes, kernel_witness)
    tracegen_s = time.perf_counter() - t0
    starks = all_starks(cpu)
    pis: List[List[int]] = [pi_limbs(pi_words)] + [[]] * (len(starks) - 1)
    table_times: Optional[List[Dict[str, float]]] = [] if phase_times is not None else None
    proof = prove_multi(starks, traces, pis, build_ctls(cpu), config, device, table_times)
    if phase_times is not None:
        phase_times["host"] = {"tracegen": tracegen_s}
        phase_times.update(zip(TABLE_NAMES, table_times))
    return proof, res


def verify_all_tables(
    cpu: CpuStark,
    pi_words: List[int],
    proof: MultiProof,
    config: StarkConfig,
    device=None,
) -> bool:
    starks = all_starks(cpu)
    if len(proof.proofs) != len(starks):
        return False
    # the CPU proof must carry exactly the claimed public inputs
    if proof.proofs[T_CPU].public_inputs != pi_limbs(pi_words):
        return False
    return verify_multi(starks, proof, build_ctls(cpu), config, device)

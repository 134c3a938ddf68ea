"""All-tables wiring: the multi-table proof of one transaction.

Counterpart: ethproof_tpu/tables/all.py:1 (`build_ctls`, `TableSizes`,
`kernel_counts`, `all_starks`, `prove_all_tables`, `verify_all_tables`).
Seven tables: CPU, Arithmetic, Logic, BytePacking, Memory, Keccak and
KeccakSponge, with the CTLs cpu<->arithmetic, cpu/sponge<->logic,
cpu/bytepacking/sponge<->memory, sponge<->keccak (input and output) and,
when the kernel hashes, cpu<->sponge (first and final rows).
`with_keccak=False` (`TableSizes.keccak is None`) drops the Keccak pair
and its CTLs: the five-table proof of a kernel that issues no hash
request. The EVM machine's wiring (counterpart :258-385: `build_ctls_evm`,
`evm_table_counts`, `prove_evm_tables`, `verify_evm_tables`) puts
`tables/evm.EvmStark` in the CPU role, with the machine<->BytePacking CTL.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..fri.config import StarkConfig
from ..stark.multi import CrossTableLookup, MultiProof, prove_multi, verify_multi
from . import arithmetic, bytepacking, keccak, keccak_sponge, logic, memory
from .cpu import ARITH_OPS, LOGIC_OPS, OP_NOP, CpuStark, CpuTraceResult, execute, pi_limbs
from .keccak_sponge import RATE_BYTES

# table indices (stable order)
T_CPU, T_ARITH, T_LOGIC, T_BYTEPACK, T_MEM, T_KECCAK, T_SPONGE = range(7)
TABLE_NAMES = (
    "cpu", "arithmetic", "logic", "bytepacking", "memory", "keccak", "keccak_sponge",
)


class CircuitSizeError(ValueError):
    """A trace demands a degree above the configured range (deterministic)."""


def _ceil_log2(x: int) -> int:
    return max(int(x) - 1, 0).bit_length()


def build_ctls(cpu: CpuStark, with_keccak: bool = True) -> List[CrossTableLookup]:
    mem_looking = [(T_CPU, spec) for spec in cpu.memory_ctl_specs()]
    mem_looking += [(T_BYTEPACK, s) for s in bytepacking.memory_ctl_specs()]
    logic_looking = [(T_CPU, cpu.logic_ctl_spec())]
    if with_keccak:
        mem_looking += [(T_SPONGE, s) for s in keccak_sponge.memory_ctl_specs()]
        logic_looking += [(T_SPONGE, s) for s in keccak_sponge.logic_ctl_specs()]
    ctls = [
        CrossTableLookup(
            looking=((T_CPU, cpu.arith_ctl_spec()),),
            looked=(T_ARITH, arithmetic.ArithmeticStark.ctl_spec),
        ),
        CrossTableLookup(
            looking=tuple(logic_looking),
            looked=(T_LOGIC, logic.LogicStark.ctl_spec),
        ),
        CrossTableLookup(
            looking=tuple(mem_looking),
            looked=(T_MEM, memory.MemoryStark.ctl_spec),
        ),
    ]
    if with_keccak:
        kc = keccak.KeccakStark()
        ctls += [
            CrossTableLookup(
                looking=((T_SPONGE, keccak_sponge.keccak_input_ctl_spec()),),
                looked=(T_KECCAK, kc.input_ctl_spec()),
            ),
            CrossTableLookup(
                looking=((T_SPONGE, keccak_sponge.keccak_output_ctl_spec()),),
                looked=(T_KECCAK, kc.output_ctl_spec()),
            ),
        ]
        if cpu.uses_sponge:
            # kernel <-> sponge request binding (first + final rows)
            cpu_first, cpu_digest = cpu.sponge_ctl_specs()
            ctls += [
                CrossTableLookup(
                    looking=((T_CPU, cpu_first),),
                    looked=(T_SPONGE, keccak_sponge.first_ctl_spec()),
                ),
                CrossTableLookup(
                    looking=((T_CPU, cpu_digest),),
                    looked=(T_SPONGE, keccak_sponge.digest_ctl_spec()),
                ),
            ]
    return ctls


@dataclass
class TableSizes:
    """log2 trace lengths per table (the reference's *_CIRCUIT_SIZE
    ranges). keccak=None drops the Keccak/KeccakSponge pair (and their
    CTLs) from the proof — valid whenever the kernel issues no hash
    request; the verifier requires the same configuration."""

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


def all_starks(cpu: CpuStark, with_keccak: bool = True):
    out = [
        cpu,
        arithmetic.ArithmeticStark(),
        logic.LogicStark(),
        bytepacking.BytePackingStark(),
        memory.MemoryStark(),
    ]
    if with_keccak:
        out += [keccak.KeccakStark(), keccak_sponge.KeccakSpongeStark()]
    return out


def generate_traces(
    cpu: CpuStark,
    pi_words: List[int],
    sizes: TableSizes,
    hash_requests: List["keccak_sponge.HashRequest"] = (),
    kernel_witness: Optional[List[int]] = None,
    host_times: Optional[Dict[str, float]] = None,
) -> Tuple[List[np.ndarray], CpuTraceResult]:
    """Execute the kernel on the host and fill the tables' traces (seven,
    or five when sizes.keccak is None). `host_times`, when given, receives
    the seconds of the kernel's execution and of each table's generator."""
    with_keccak = sizes.keccak is not None
    assert with_keccak or not hash_requests, "hash requests need the keccak pair"
    times = host_times if host_times is not None else {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        times[name] = time.perf_counter() - t0
        return out

    res = timed("execute", execute, cpu.program, pi_words, 1 << sizes.cpu, kernel_witness)
    traces = _fill_tables(res, [], list(hash_requests), sizes, timed)
    return [res.trace] + traces, res


def _fill_tables(res, pack_requests, hash_requests, sizes: TableSizes, timed) -> List[np.ndarray]:
    """The traces of the tables after the CPU role's (Arithmetic, Logic,
    BytePacking, Memory and, when sizes.keccak is set, Keccak and
    KeccakSponge) from its requests; `timed(name, fn, *args)` runs each
    generator."""
    arith_tr, _ = timed("arithmetic", arithmetic.generate_trace, res.arith_requests,
                        1 << sizes.arithmetic)
    bp_tr, bp_mem_ops = timed("bytepacking", bytepacking.generate_trace, pack_requests,
                              1 << sizes.bytepacking)
    logic_reqs, mem_ops = res.logic_requests, res.mem_ops + bp_mem_ops
    with_keccak = sizes.keccak is not None
    if with_keccak:
        sponge = timed("keccak_sponge", keccak_sponge.generate_trace, hash_requests,
                       1 << sizes.keccak_sponge)
        logic_reqs, mem_ops = logic_reqs + sponge.logic_requests, mem_ops + sponge.mem_ops
    logic_tr, _ = timed("logic", logic.generate_trace, logic_reqs, 1 << sizes.logic)
    mem_tr = timed("memory", memory.generate_trace, mem_ops, 1 << sizes.memory)
    traces = [arith_tr, logic_tr, bp_tr, mem_tr]
    if with_keccak:
        traces += [timed("keccak", keccak.generate_trace, sponge.perm_inputs, 1 << sizes.keccak),
                   sponge.trace]
    return traces


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
    """Execute the kernel and prove all tables (seven, or five when
    sizes.keccak is None) under one transcript on `device` (None: the CUDA
    card). `phase_times`, when given, receives the host's seconds
    (`["host"]`: the kernel's `execute` and each table's trace generator)
    and each table's phase seconds under its name in TABLE_NAMES."""
    with_keccak = sizes.keccak is not None
    host: Dict[str, float] = {}
    traces, res = generate_traces(cpu, pi_words, sizes, list(hash_requests), kernel_witness,
                                  host)
    starks = all_starks(cpu, with_keccak)
    pis: List[List[int]] = [pi_limbs(pi_words)] + [[]] * (len(starks) - 1)
    table_times: Optional[List[Dict[str, float]]] = [] if phase_times is not None else None
    proof = prove_multi(starks, traces, pis, build_ctls(cpu, with_keccak), config, device,
                        table_times)
    if phase_times is not None:
        phase_times.setdefault("host", {}).update(host)
        phase_times.update(zip(TABLE_NAMES, table_times))
    return proof, res


def verify_all_tables(
    cpu: CpuStark,
    pi_words: List[int],
    proof: MultiProof,
    config: StarkConfig,
    device=None,
) -> bool:
    with_keccak = len(proof.proofs) == 7
    starks = all_starks(cpu, with_keccak)
    if len(proof.proofs) != len(starks):
        return False
    # the CPU proof must carry exactly the claimed public inputs
    if proof.proofs[T_CPU].public_inputs != pi_limbs(pi_words):
        return False
    return verify_multi(starks, proof, build_ctls(cpu, with_keccak), config, device)


# -- EVM machine wiring (bytecode-interpreting CPU, tables/evm.py) ------------


def build_ctls_evm(machine) -> List[CrossTableLookup]:
    """CTL graph with the EVM machine in the CPU role. Adds the
    machine<->BytePacking group (PUSH/MLOAD/MSTORE/CALLDATALOAD windows),
    which the kasm kernel never uses."""
    mem_looking = [(T_CPU, s) for s in machine.memory_ctl_specs()]
    mem_looking += [(T_BYTEPACK, s) for s in bytepacking.memory_ctl_specs()]
    mem_looking += [(T_SPONGE, s) for s in keccak_sponge.memory_ctl_specs()]
    logic_looking = [(T_CPU, s) for s in machine.logic_ctl_specs()]
    logic_looking += [(T_SPONGE, s) for s in keccak_sponge.logic_ctl_specs()]
    kc = keccak.KeccakStark()
    cpu_first, cpu_digest = machine.sponge_ctl_specs()
    return [
        CrossTableLookup(
            looking=tuple((T_CPU, s) for s in machine.arith_ctl_specs()),
            looked=(T_ARITH, arithmetic.ArithmeticStark.ctl_spec),
        ),
        CrossTableLookup(
            looking=tuple(logic_looking),
            looked=(T_LOGIC, logic.LogicStark.ctl_spec),
        ),
        CrossTableLookup(
            looking=((T_CPU, machine.bytepack_ctl_spec()),),
            looked=(T_BYTEPACK, bytepacking.BytePackingStark.ctl_spec),
        ),
        CrossTableLookup(
            looking=tuple(mem_looking),
            looked=(T_MEM, memory.MemoryStark.ctl_spec),
        ),
        CrossTableLookup(
            looking=((T_SPONGE, keccak_sponge.keccak_input_ctl_spec()),),
            looked=(T_KECCAK, kc.input_ctl_spec()),
        ),
        CrossTableLookup(
            looking=((T_SPONGE, keccak_sponge.keccak_output_ctl_spec()),),
            looked=(T_KECCAK, kc.output_ctl_spec()),
        ),
        CrossTableLookup(
            looking=((T_CPU, cpu_first),),
            looked=(T_SPONGE, keccak_sponge.first_ctl_spec()),
        ),
        CrossTableLookup(
            looking=((T_CPU, cpu_digest),),
            looked=(T_SPONGE, keccak_sponge.digest_ctl_spec()),
        ),
    ]


def evm_table_counts(shape, res) -> Dict[str, int]:
    """Per-table row demand for one machine run (for TableSizes.fit)."""
    blocks = sum(len(r.message) // RATE_BYTES + 1 for r in res.hash_requests)
    max_ts = 8 * (1 << shape.log_rows)
    return {
        "cpu": 1 << shape.log_rows,
        "arithmetic": len(res.arith_requests),
        "logic": len(res.logic_requests) + 5 * blocks,
        "bytepacking": max(len(res.pack_requests), 256),
        "memory": max(
            len(res.mem_ops) + 32 * len(res.pack_requests) + 10 * blocks + 1,
            max_ts,
        ),
        "keccak": 24 * blocks,
        "keccak_sponge": max(blocks, 256),
    }


def prove_evm_tables(
    machine,
    res,
    sizes: TableSizes,
    config: StarkConfig,
    device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> MultiProof:
    """Prove all seven tables for one EVM machine run (`res` from
    evm.execute_evm) on `device` (None: the CUDA card). The keccak pair is
    always present (the code hash). `phase_times` as in
    `prove_all_tables` (its "host" entry: each table's trace generator)."""
    assert sizes.keccak is not None
    host: Dict[str, float] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        host[name] = time.perf_counter() - t0
        return out

    traces = [res.trace] + _fill_tables(res, res.pack_requests, list(res.hash_requests),
                                        sizes, timed)
    starks = all_starks(machine, with_keccak=True)
    pis: List[List[int]] = [pi_limbs(res.pi_words)] + [[]] * 6
    table_times: Optional[List[Dict[str, float]]] = [] if phase_times is not None else None
    proof = prove_multi(starks, traces, pis, build_ctls_evm(machine), config, device,
                        table_times)
    if phase_times is not None:
        phase_times.setdefault("host", {}).update(host)
        phase_times.update(zip(TABLE_NAMES, table_times))
    return proof


def verify_evm_tables(
    machine,
    pi_words: List[int],
    proof: MultiProof,
    config: StarkConfig,
    device=None,
) -> bool:
    """Verification of an EVM machine multi-proof. Beyond the STARK
    check, the machine's statement contract requires the VERIFIER to
    check the public inputs themselves: storage keys strictly increasing
    (distinctness of the journal directory) and the caller/calldata/
    codehash words matching the claimed transaction."""
    lay = machine.shape.pi_layout
    keys = [
        pi_words[lay["storage"] + 4 * i] for i in range(machine.shape.n_skeys)
    ]
    if any(b <= a for a, b in zip(keys, keys[1:])):
        return False  # directory keys must be strictly increasing
    starks = all_starks(machine, with_keccak=True)
    if len(proof.proofs) != len(starks):
        return False
    if proof.proofs[T_CPU].public_inputs != pi_limbs(pi_words):
        return False
    return verify_multi(starks, proof, build_ctls_evm(machine), config, device)

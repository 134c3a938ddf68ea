#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ethproof_tpu_torch`) on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It imports
nothing of JAX and nothing of the JAX package. Phases (any failure raises
and the script exits non-zero; no phase's failure is caught):

1. build   — compile every CUDA kernel from csrc/ (one nvcc per source,
             started together) and print the build seconds and ptxas report;
2. kernels — hold each kernel against its plain PyTorch version on the card,
             bit for bit (the field is exact: the tolerance is zero), at the
             main paths' sizes, and time both: `base_dft` (i8 encoding),
             `base_dft_bf16` (bf16 encoding, also against `base_dft_plain`,
             and on the adversarial all-0xFF-chunk input) and Poseidon
             (csrc/poseidon.cu: `permute` against `permute_plain`,
             `tree_digest` and every level of `merkle.build` against the
             plain level walk, at Keccak's and Arithmetic's trace and aux
             trees, inputs over the whole 64-bit range), each beside its
             bound;
3. four-step — `best_intt` and `best_coset_lde` of a (28, 2^17) array with
             the kernel against the same with the plain base, on the card;
4. memory  — a 2^9-row Memory proof made on the card must equal, field for
             field, the one made by the plain path on the CPU (in a worker
             process), once with the IR sweep (the default) and once with
             `ETHPROOF_SWEEP=eager`;
             then a 2^17-row MemoryStark proof under `standard_fast_config`
             (launch counts reset just before it, read just after),
             verified by the port's host verifier, and the same trace
             proved again under bf16 on a fresh MemoryStark (counts reset
             again), which must give the same digest and launch only
             base_dft_bf16;
   mesh    — multi-device proving on a virtual mesh of the one card (every
             shard on cuda:0): the same 2^17-row trace proved under i8 on
             `make_mesh(devices=["cuda:0"] * 4)` (columns sharded through
             the NTTs, domain blocks through the Merkle trees, the sweep and
             the DEEP codeword; counts reset just before, read just after)
             must give the i8 proof's digest; seconds, peak and launches are
             printed; then `trace_commit_sharded` of a seeded (2, 28, 2^14)
             batch on a (tx 2, col 2) mesh against the one-device caps;
   wrap    — the recursion core: `build_wrap(MemoryStark(), 17,
             standard_fast_config(), device="cuda")` compiles the verifier
             of that 2^17-row proof into a verifier-machine circuit, and
             `WrapCircuit.prove` proves it (i8, counts reset just before):
             gates, machine rows and degree, host seconds per step, phase
             seconds, peak, the digest WRAP_DIGEST, the port's
             `verify_machine`; a child with one opened value changed is
             refused by `interpret`, a wrap proof with one trace-cap word
             or one opening changed by `verify_machine`;
5. small transfer — the seven-table transfer proof (`SIZES7` of
             tests/test_transfer_e2e.py: the Keccak pair on, the binding
             dropped by the cpu < 2^11 pre-guard) at the CPU tier's sizes,
             made on the card under i8, must equal the CPU plain path's
             proof field for field, table by table (its bf16 re-proof made
             room for the mesh phase: the bf16 kernel is driven at full
             width by the Memory proof's bf16 run and held bit for bit at
             every census shape);
   succinct — the recursion ladder at the JAX package's succinct fixture
             (tests/test_succinct_block.py:42-53: one query, the CPU tier's
             five-table sizes): `transfer_chain(2)` and the no-op dummy at
             its post state through `runtime.scheduler.prove_block(...,
             TINY, sizes=SIZES, runtime=Runtime(max_retries=0),
             recursion=True, block_wrap=True, device="cuda")` (`tx_proof`
             tasks: the roots built are the distinct overlap's, the one
             kernel that fits the 2^5-row CPU table, and the dummy's; two
             five-table transfer proofs, equal to the CPU plain path's, and
             three root machine proofs; `agg_combine`/`block_proof`; the
             fold to level 2 as `agg_machine` tasks; the block base wrap),
             i8, launch counts reset just before, read just after: gates,
             rows and degree of every circuit, host seconds per step and
             machine-proof phases of every rung, peak, the digest
             SUCCINCT_DIGEST; the block goes through serde (bytes, seconds)
             and `verify_block(recursion=state)`, with a state built anew
             (the prover's cached state dropped: circuits compiled and vkeys
             committed again) from the decoded proof's declared identity,
             accepts the decoded block and rejects a changed leaf statement,
             a flipped opening of the top proof and a changed top statement;
6. cli     — the transfer path as a user runs it, through the default mesh
             (set to a 2-wide mesh over cuda:0 for this phase, as
             `default_mesh()` gives a multi-card host, and reset after it:
             `prove_multi(mesh=None)` shards every commit; the number of
             sharded commits is printed): an EIP-1559 transfer over
             a seeded 1,000-account state trie, padded with a no-op dummy in
             front as `rpc` pads a one-transaction block, written as
             witness.json; `ethproof_tpu_torch.cli.main(["prove", "-i",
             witness.json, "--persistence", "none"])` in this process with
             stdout into proof.json (`prove_block` with the CircuitConfig()
             ranges, through a Runtime that does not retry, one `tx_proof`
             task per payload, `prove_transfer(binding="auto")`: the
             seven-table transfer with the in-circuit state-root binding at
             the sizes the reference fits for it; `agg_combine`,
             `block_proof`, serde), i8 (launch counts reset just before,
             read just after): the witness's and the proof's bytes, the
             prove and serde seconds, each task's seconds, the transfer's
             host steps and each table's phase seconds (commit, aux,
             quotient, ...); the decoded transfer proof has seven
             tables, the production binding shape, the fitted sizes and the
             recorded digest TRANSFER7_WIRE_DIGEST (every sweep through the
             IR executor); `cli verify` exits 0 on proof.json and 1 on a
             copy whose top aggregate claims another post state root; a
             flipped post state root of the decoded proof is rejected by
             `verify_all_tables` alone;
7. contract — on one device, the contract-call path: `seeded_erc20_transfer(1000, 1000,
             5)` (an EIP-1559 ERC-20 `transfer` over a 1,000-account state
             trie and a 1,000-holder token storage trie) through
             `runtime.ops.tx_proof(gi, config, CircuitConfig())` (binding
             "auto"), i8, launch counts reset just before, read just after:
             the machine's and the binding's multi-proofs at the sizes the
             reference fits, the production binding shape, the recorded
             digest CONTRACT_DIGEST, the port's `verify_contract_call`, a
             forged storage PI word rejected, and a witness with a wrong post
             state root refused by `check_contract_binding`, the host check
             that ends `prove_contract_call` (`tx_proof` raises its refusal
             as FatalError; the CPU tests drive that path);
8. census  — both kernels timed at every base-DFT shape the cli,
             contract, wrap and succinct proofs launched, beside their
             bounds, the launch floor and a one-tile call;
9. result  — one JSON line listing every kernel (launches: base_dft's and
             the two Poseidon kernels' of the contract path's proof, which
             must run no plain permutation on the card, base_dft_bf16's of
             the 2^17-row Memory proof's bf16 run), the card's name and power limit, and
             the last line {"ok": true, "device": {...}}.

The full-width five-table transfer of slice 2 is no longer run: the
five-table path stays driven at the CPU tier's sizes under i8 (the succinct
phase's two transfers), and the kernels' bits are pinned by
TRANSFER7_WIRE_DIGEST and the census. Nor is the full-width seven-table
transfer's bf16 re-proof: the wrap took its time, and the bf16 kernel is
driven at full width by the Memory proof.

`python3 chip_smoke.py --profile` instead builds the kernels and profiles
one 2^17-row Memory proof (device kernels by name, idle share, layer
times); `python3 chip_smoke.py --memory` proves the 2^17-row Memory table
under each sweep (IR and direct), runs the cli phase and proves the
contract path once, and prints each phase's seconds and peak device memory;
`python3 chip_smoke.py --succinct`, `--cli`, `--mesh` and `--poseidon` build the kernels
and run that phase alone (`--mesh` proves the 2^17-row Memory trace on one
device first, for the digest); `python3 chip_smoke.py --root-size` compiles the full-width
transfer root (the seven-table transfer path's verifier, at
`standard_fast_config`) and prints its size. None prints a result line.

Without a CUDA card, or run outside the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
# H100 SXM instruction rates: 132 SMs at the 1,980 MHz boost clock (NVIDIA
# H100 whitepaper); an SM issues 4 x 32 thread-instructions a clock and runs
# 64 32-bit integer operations a clock on its ALU pipe (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0); IMAD
# issues to the FMA pipe instead (Nsight Compute's pipe definitions)
ISSUE_PER_S = 132 * 128 * 1.98e9
ALU_PER_S = 132 * 64 * 1.98e9
# SASS instructions of one permutation of csrc/poseidon.cu's level kernel:
# 30 times the round loop's body, counted from `cuobjdump -sass` of the sm_90a
# build (CUDA 12.8), the few hundred around the loop left out. The body is
# 2,161 instructions: 758 IMADs, 41 of the uniform datapath, a branch and
# 1,361 for the ALU pipe (VIADD counted there). The permute kernel's differ
# by under 1%.
POSEIDON_INSTRUCTIONS = 30 * 2161
POSEIDON_ALU_INSTRUCTIONS = 30 * 1361

LOG_ROWS = 17  # MemoryStark floor: DEFAULT_RANGES["memory"] starts at 2^17
MESH_WIDTH = 4  # the mesh phase's virtual mesh on the one card
CLI_MESH_WIDTH = 2  # the default mesh of the cli phase
TRACE_COLS = 28
ARITH_COLS = 430  # the arithmetic table: the largest trace of the transfer
CENSUS_PLAIN_MAX = 1 << 27  # elements up to which the census times the plain versions
CENSUS_CHECK_ELEMS = 1 << 24  # elements per shape the census checks against the plain versions
N_ACCOUNTS = 1000
# History: the full-width five-table transfer (TableSizes(12, 16, 12, 9, 17,
# keccak=None), the transfer7 witness, i8) had the proof digest
# ad37af5e6b2f2e55dbed414bc56488a97e838d6f3459cb91e8ec56b28e775f03 under the
# kernels of commit 5308af5 and their tensor-core redesign alike; that run was
# dropped when the contract path came, and TRANSFER7_DIGEST pins the bits.
# the seven-table transfer's sizes as the reference's TableSizes.fit gives
# them for `phase_cli`'s witness under the default CircuitConfig ranges
TRANSFER7_LOGS = dict(cpu=16, arithmetic=16, logic=12, bytepacking=9, memory=17, keccak=14,
                      keccak_sponge=9)
# sha256 (`proof_digest`) of that proof as a proof file holds it: every
# `FriProof.query_indices` None (the wire format does not carry them; serde
# reads them back as None). It pins the bits for later kernel work; it is
# not a reference check. Recorded on an NVIDIA H100 80GB HBM3 (700 W) by the
# commit that added it, from the direct `prove_transfer(gi, standard_fast_
# config(), CircuitConfig(), binding="require", device="cuda")` proof of
# `phase_cli`'s transaction (i8), in the run that showed that proof's digest
# with its query indices to be the one the earlier commits recorded for it,
# 91aa11c62fc5069a4337ca142abe4a07a56b49cdbc77ff48c768af686318462f (i8 and
# bf16 alike); `phase_cli` holds the decoded proof of `cli prove` against it
TRANSFER7_WIRE_DIGEST = "63f43c02747691ad673603ca0047e9b3884c22b70453179c06a4540d9c4c0c0a"
N_HOLDERS = 1000  # the token's balance slots in the contract path's witness
# the contract path's sizes as the reference fits them for its witness
# (tests/test_torch_contract.py holds the port's fit equal to the reference's):
# the machine's multi-proof and the binding's at PRODUCTION_SHAPE
CONTRACT_LOGS = dict(cpu=10, arithmetic=16, logic=5, bytepacking=9, memory=13, keccak=7,
                     keccak_sponge=8)
CONTRACT_BINDING_LOGS = dict(cpu=16, arithmetic=16, logic=10, bytepacking=9, memory=18,
                             keccak=12, keccak_sponge=8)
# sha256 (`proof_digest`) of the contract path's proof (the machine's tables,
# then the binding's), recorded on an NVIDIA H100 80GB HBM3 (700 W) by the
# commit that added it
CONTRACT_DIGEST = "5ff06cb2356b2b46c46e913d1a5947010ae356a0970e5f1d7f0fa7e79b82dddb"
# sha256 (`proof_digest` of `machine_proof_to_numpy`) of the wrap proof of
# the 2^17-row Memory proof (`phase_wrap`), recorded on an NVIDIA H100 80GB
# HBM3 (700 W) by the commit that added it
WRAP_DIGEST = "70b2c0e7819eabc1b03b9e0c1adfa1c8f2332f655aa40f47026d5e782bb55194"
P = 0xFFFFFFFF00000001
# all-zero data (i8 digits all -128), seven of eight bytes 0xFF (i8 digits
# +127, bf16 dots at their largest sums), and p - 1
ADVERSARIAL_VALUES = (0, 0xFFFFFFFEFFFFFFFF, P - 1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of `fn()` over `iters` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, elements: int) -> float:
    """Mean device milliseconds of `fn()` replayed from a CUDA graph of
    several calls (2 to 20, fewer for larger calls), after a warm-up: the
    host's per-call launch cost, which sets the pace of a back-to-back run
    of small calls, stays out."""
    import torch

    calls = min(20, max(2, (1 << 25) // elements))
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * calls)
    del graph
    return ms


def timed(fn):
    """(result, device milliseconds) of one call of `fn`."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over u64 values; equal tensors are told apart on the
    card, without copying them to the host."""
    import torch

    from ethproof_tpu_torch.gf import field as gfp

    if torch.equal(a, b):
        return 0.0
    x, y = gfp.to_u64(a), gfp.to_u64(b)
    return float(np.max(np.abs(x.astype(np.float64) - y.astype(np.float64))))


def memory_ops(n_ops: int, seed: int):
    """A seeded synthetic memory log: reads return the last value written to
    the address (zero if none), timestamps increase, and every sorted-order
    difference stays below the table's 2^17 range."""
    from ethproof_tpu_torch.tables import memory as mem

    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, 3, n_ops)
    seg = rng.integers(0, 4, n_ops)
    virt = rng.integers(0, 2048, n_ops)
    is_read = rng.random(n_ops) < 0.6
    words = rng.integers(0, 1 << 63, size=(n_ops, 4), dtype=np.uint64)
    last = {}
    ops = []
    for t in range(n_ops):
        addr = (int(ctx[t]), int(seg[t]), int(virt[t]))
        if is_read[t]:
            value = last.get(addr, 0)
        else:
            value = sum(int(w) << (64 * i) for i, w in enumerate(words[t]))
            last[addr] = value
        ops.append(mem.MemoryOp(*addr, t + 1, int(is_read[t]), value))
    return ops


def phase_build() -> None:
    from ethproof_tpu_torch import kernels

    t0 = time.perf_counter()
    built = kernels.build_all()
    print(f"[build] {len(built)} of {len(kernels.SOURCES)} kernel sources compiled in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, secs, log in built:
        print(f"[build] {name}: {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


def bound(elements: int, n: int, weight_bytes: int, ops_per_s: float):
    """(bound ms, what binds): the bytes the call must move (16 B per element
    in and out, plus its weight table) over the HBM rate against its 2 * 64
    * n operations per element (8 x 8 chunk or digit products per term) over
    the tensor cores' peak for their type."""
    bytes_s = (16 * elements + weight_bytes) / HBM_BYTES_PER_S
    ops_s = 2 * 64 * n * elements / ops_per_s
    return 1e3 * max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"


def phase_kernels(card: str) -> dict:
    """base_dft against base_dft_plain and base_dft_i8_plain for log_n 1..8,
    both directions, at the Memory path's base-DFT call sizes (28 x 2^17 and
    28 x 2^19 elements); base_dft_bf16 against the same base_dft_plain
    outputs."""
    from ethproof_tpu_torch.gf import field as gfp
    from ethproof_tpu_torch.poly import base_dft as bd

    rng = np.random.default_rng(1)
    warm = gfp.from_u64(rng.integers(0, gfp.P, size=(8, 2), dtype=np.uint64), "cuda")
    bd.base_dft_plain(warm, 1, False)  # first-use costs stay out of the timings
    report = None
    print(f"[kernels] base_dft vs base_dft_plain and base_dft_i8_plain on {card}; the JSON "
          f"line reports the (28*2^{LOG_ROWS + 2} / 128, 128) forward call, the coset LDE's "
          "first base level")
    for total_log in (LOG_ROWS, LOG_ROWS + 2):
        total = TRACE_COLS << total_log
        vals = gfp.from_u64(rng.integers(0, gfp.P, size=total, dtype=np.uint64), "cuda")
        for log_n in range(1, 9):
            n = 1 << log_n
            a = vals.reshape(total // n, n)
            for inverse in (False, True):
                got = bd.base_dft(a, log_n, inverse, "i8")
                want, plain_ms = timed(lambda: bd.base_dft_plain(a, log_n, inverse))
                err = max(max_abs_err(got, want),
                          max_abs_err(got, bd.base_dft_i8_plain(a, log_n, inverse)))
                if err != 0.0:
                    raise AssertionError(f"base_dft log_n={log_n} inverse={inverse} "
                                         f"elements={total}: kernel != plain ({err})")
                err16 = max_abs_err(bd.base_dft(a, log_n, inverse, "bf16"), want)
                if err16 != 0.0:
                    raise AssertionError(f"base_dft_bf16 log_n={log_n} inverse={inverse} "
                                         f"elements={total}: kernel != base_dft_plain ({err16})")
                ms = cuda_ms(lambda: bd.base_dft(a, log_n, inverse, "i8"), 5)
                bound_ms, bound_by = bound(total, n, 8 * n * n, INT8_OPS_PER_S)
                print(f"[kernels] elements=28*2^{total_log} shape=({total // n}, {n}) "
                      f"inverse={inverse}: equal bits (base_dft_bf16 too); kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by})")
                if total_log == LOG_ROWS + 2 and log_n == 7 and not inverse:
                    report = {
                        "name": "base_dft",
                        "route": "cuda",
                        "source": "ethproof_tpu_torch/csrc/base_dft.cu",
                        "replaces": "ethproof_tpu/poly/pallas_ntt.py:141",
                        "launches": 0,
                        "max_abs_err": err,
                        "ms": ms,
                        "plain_ms": plain_ms,
                        "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": None,
                    }
        del vals
    return report


def phase_adversarial(card: str) -> None:
    """Both kernels against base_dft_plain and their own plain versions, bit
    for bit, for log_n 1..8 both ways, on inputs whose every element is 0
    (every i8 data digit -128), 0xFFFFFFFE_FFFFFFFF (every bf16 chunk but one
    0xFF, every dot at its largest sum; i8 digits +127) or p - 1."""
    import torch

    from ethproof_tpu_torch.gf import field as gfp
    from ethproof_tpu_torch.poly import base_dft as bd

    plains = {"i8": bd.base_dft_i8_plain, "bf16": bd.base_dft_bf16_plain}
    for value in ADVERSARIAL_VALUES:
        flat = torch.full((ARITH_COLS << 8,), gfp.to_i64(value), dtype=torch.int64,
                          device="cuda")
        for log_n in range(1, 9):
            a = flat.reshape(-1, 1 << log_n)
            for inverse in (False, True):
                want = bd.base_dft_plain(a, log_n, inverse)
                for encoding, plain in plains.items():
                    got = bd.base_dft(a, log_n, inverse, encoding)
                    err = max(max_abs_err(got, want),
                              max_abs_err(got, plain(a, log_n, inverse)))
                    if err != 0.0:
                        raise AssertionError(
                            f"{bd.KERNELS[encoding]} log_n={log_n} inverse={inverse} "
                            f"all-0x{value:X}: kernel != plain ({err})")
    print(f"[kernels] base_dft and base_dft_bf16 on {card}: the inputs all "
          + ", all ".join(f"0x{v:X}" for v in ADVERSARIAL_VALUES)
          + " (430*2^8 elements each) equal base_dft_plain and their plain versions, "
          "log_n 1..8 both ways")


def phase_kernels_bf16(card: str) -> dict:
    """base_dft_bf16 against base_dft_bf16_plain and base_dft against
    base_dft_i8_plain, bit for bit, and the two kernels against each other,
    for log_n 1..8 both ways on seeded random inputs at the transfer's
    largest base-DFT call sizes (the arithmetic table's commit: 430 x 2^16
    elements in the iNTT, 430 x 2^18 in the coset LDE)."""
    from ethproof_tpu_torch.gf import field as gfp
    from ethproof_tpu_torch.poly import base_dft as bd

    rng = np.random.default_rng(6)
    report = None
    for total_log, report_log_n in ((16, None), (18, 6)):
        total = ARITH_COLS << total_log
        vals = gfp.from_u64(rng.integers(0, gfp.P, size=total, dtype=np.uint64), "cuda")
        for log_n in range(1, 9):
            n = 1 << log_n
            a = vals.reshape(total // n, n)
            for inverse in (False, True):
                got = bd.base_dft(a, log_n, inverse, "bf16")
                want, plain_ms = timed(lambda: bd.base_dft_bf16_plain(a, log_n, inverse))
                err = max_abs_err(got, want)
                got8 = bd.base_dft(a, log_n, inverse, "i8")
                err8 = max(max_abs_err(got8, bd.base_dft_i8_plain(a, log_n, inverse)),
                           max_abs_err(got8, got))
                if max(err, err8) != 0.0:
                    raise AssertionError(
                        f"elements=430*2^{total_log} log_n={log_n} inverse={inverse}: "
                        f"base_dft_bf16 != its plain version ({err}) or base_dft != "
                        f"base_dft_i8_plain or base_dft_bf16 ({err8})")
                del got8
                ms = cuda_ms(lambda: bd.base_dft(a, log_n, inverse, "bf16"), 5)
                bound_ms, bound_by = bound(total, n, 16 * n * n, BF16_OPS_PER_S)
                print(f"[kernels] base_dft_bf16 elements=430*2^{total_log} shape=({total // n}, "
                      f"{n}) inverse={inverse}: equal bits (and base_dft); kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by})")
                if log_n == report_log_n and not inverse:
                    report = {
                        "name": "base_dft_bf16",
                        "route": "cuda",
                        "source": "ethproof_tpu_torch/csrc/base_dft_bf16.cu",
                        "replaces": "ethproof_tpu/poly/pallas_ntt.py:95",
                        "launches": 0,
                        "max_abs_err": err,
                        "ms": ms,
                        "plain_ms": plain_ms,
                        "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": None,
                    }
        del vals
    print("[kernels] the JSON line reports base_dft_bf16 at (430*2^18 / 64, 64) forward, the "
          "arithmetic table's coset-LDE base level")
    return report


@contextlib.contextmanager
def plain_permutation():
    """`poseidon.permute` as the plain PyTorch permutation, on any device."""
    from ethproof_tpu_torch.hash import poseidon

    saved = poseidon.permute
    poseidon.permute = poseidon.permute_plain
    try:
        yield
    finally:
        poseidon.permute = saved


def plain_tree(rows, cap_height: int) -> list:
    """`merkle.build(rows, cap_height).levels` by the plain path on the rows'
    device: the leaf digest as the walk of `_level_plain` over zero-padded
    groups of four (L > 4), in `LEAF_BLOCK_ELEMS` blocks, then two_to_one of
    siblings 0::2 / 1::2 up to the cap."""
    import torch

    from ethproof_tpu_torch.hash import merkle, poseidon

    length, n = rows.shape
    k = (length + 3) // 4
    block = max(1, merkle.LEAF_BLOCK_ELEMS // length)
    digests = []
    with plain_permutation():
        for s in range(0, n, block):
            r = rows[:, s : s + block]
            pad = torch.zeros((4 * k - length, r.shape[1]), dtype=torch.int64, device=r.device)
            d = torch.cat([r, pad]).reshape(k, 4, -1).movedim(1, 0)
            while d.shape[1] > 1:
                d = poseidon._level_plain(d)
            digests.append(d[:, 0])
        levels = [torch.cat(digests, dim=1)]
        while levels[-1].shape[1] > 1 << cap_height:
            d = levels[-1]
            levels.append(poseidon.two_to_one(d[:, 0::2], d[:, 1::2]))
    return levels


def tree_work(length: int, n: int, cap_height: int):
    """(permutations, bytes) of `merkle.build` of (length, n) rows: each
    level reads its input once and writes its output once (8 B an element);
    a group's odd carry is a copy."""
    k = (length + 3) // 4
    perms, moved = (k - 1) * n, 8 * length * n
    while k > 1:
        k = (k + 1) // 2
        moved += 2 * 8 * 4 * k * n if k > 1 else 8 * 4 * k * n
    m = n
    while m > 1 << cap_height:
        perms += m // 2
        moved += 8 * 4 * (m + m // 2)
        m //= 2
    return perms, moved


def poseidon_bound(permutations: int, moved: int):
    """(bound ms, what binds): the bytes over the HBM rate, the permutations'
    SASS instructions over the issue rate, and their ALU-pipe instructions
    over that pipe's rate."""
    limits = {"bytes": moved / HBM_BYTES_PER_S,
              "issue": permutations * POSEIDON_INSTRUCTIONS / ISSUE_PER_S,
              "ALU pipe": permutations * POSEIDON_ALU_INSTRUCTIONS / ALU_PER_S}
    bound_by = max(limits, key=limits.get)
    return 1e3 * limits[bound_by], bound_by


def phase_poseidon(card: str) -> list:
    """csrc/poseidon.cu against the plain PyTorch path on the card, bit for
    bit, on seeded u64 inputs over the whole 64-bit range (lanes >= p
    included), at the main path's sizes, both timed: `permute` against
    `permute_plain` at 2^15 states (the PoW grind's batch) and 2^22;
    `tree_digest` and `merkle.build` (cap height 4, every level; the Merkle
    levels through `merkle_level`) against the plain walk of `_level_plain`
    and two_to_one of siblings, at Keccak's trace tree ((5644, 2^14) rows)
    and Arithmetic's trace and aux trees ((430, 2^17), (708, 2^17))."""
    import torch

    from ethproof_tpu_torch.hash import merkle, poseidon

    rng = np.random.default_rng(13)

    def raw(shape):
        x = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
        return torch.from_numpy(x.view(np.int64)).to("cuda")

    warm = raw((12, 2))
    poseidon.permute(warm), poseidon.permute_plain(warm)  # first-use costs stay out
    reports = []
    for log_n in (15, 22):
        n = 1 << log_n
        states = raw((12, n))
        got = poseidon.permute(states)
        want, plain_ms = timed(lambda: poseidon.permute_plain(states))
        err = max_abs_err(got, want)
        if err != 0.0:
            raise AssertionError(f"poseidon permute n=2^{log_n}: kernel != plain ({err})")
        ms = cuda_ms(lambda: poseidon.permute(states), 10)
        bound_ms, bound_by = poseidon_bound(n, 2 * 8 * 12 * n)
        print(f"[poseidon] permute (12, 2^{log_n}): equal bits to permute_plain; kernel "
              f"{ms:.4f} ms ({n / ms / 1e3:.1f} M permutations/s), plain {plain_ms:.2f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it")
        if log_n == 22:
            reports.append({
                "name": "poseidon_permute",
                "route": "cuda",
                "source": "ethproof_tpu_torch/csrc/poseidon.cu",
                "replaces": "ethproof_tpu/hash/poseidon.py:123 (XLA ops, no Pallas kernel)",
                "launches": 0,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            })
        del states, got, want
    for length, log_n in ((5644, 14), (430, 17), (708, 17)):
        n = 1 << log_n
        rows = raw((length, n))
        want, plain_ms = timed(lambda: plain_tree(rows, 4))
        digests = poseidon.tree_digest(rows)
        err = max_abs_err(digests, want[0])
        tree = merkle.build(rows, 4)
        if len(tree.levels) != len(want):
            raise AssertionError(f"poseidon ({length}, 2^{log_n}): {len(tree.levels)} levels "
                                 f"!= the plain tree's {len(want)}")
        for got, w in zip(tree.levels, want):
            err = max(err, max_abs_err(got, w))
        if err != 0.0:
            raise AssertionError(f"poseidon ({length}, 2^{log_n}): tree_digest or merkle.build "
                                 f"!= the plain path ({err})")
        del tree, digests, want
        digest_ms = cuda_ms(lambda: poseidon.tree_digest(rows), 3)
        ms = cuda_ms(lambda: merkle.build(rows, 4), 3)
        perms, moved = tree_work(length, n, 4)
        bound_ms, bound_by = poseidon_bound(perms, moved)
        print(f"[poseidon] ({length}, 2^{log_n}) rows, cap height 4: tree_digest and every "
              f"level of merkle.build equal bits to the plain path; tree_digest {digest_ms:.3f} "
              f"ms, merkle.build {ms:.3f} ms ({perms} permutations, {perms / ms / 1e3:.1f} M/s), "
              f"plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
              f"{moved / 1e9:.3f} GB), {100 * bound_ms / ms:.1f}% of it")
        if length == 5644:
            reports.append({
                "name": "poseidon_level",
                "route": "cuda",
                "source": "ethproof_tpu_torch/csrc/poseidon.cu",
                "replaces": "ethproof_tpu/hash/poseidon.py:192 (XLA ops, no Pallas kernel)",
                "launches": 0,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            })
        del rows
    print("[poseidon] the JSON line reports permute at 2^22 states and merkle.build of "
          "Keccak's (5644, 2^14) trace rows (launches: the contract path's proof)")
    return reports


def phase_four_step() -> None:
    from unittest import mock

    import torch

    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.gf import field as gfp
    from ethproof_tpu_torch.poly import base_dft as bd
    from ethproof_tpu_torch.poly import four_step

    fri = standard_fast_config().fri_config
    rng = np.random.default_rng(2)
    a = gfp.from_u64(rng.integers(0, gfp.P, size=(TRACE_COLS, 1 << LOG_ROWS), dtype=np.uint64),
                     "cuda")

    def run():
        coeffs = four_step.best_intt(a)
        return coeffs, four_step.best_coset_lde(coeffs, fri.rate_bits, fri.coset_shift)

    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    with mock.patch.object(four_step, "base_dft", bd.base_dft_plain):
        t0 = time.perf_counter()
        want = run()
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    for name, g, w in zip(("best_intt", "best_coset_lde"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name} with the kernel != with the plain base")
    print(f"[four-step] best_intt + best_coset_lde of ({TRACE_COLS}, 2^{LOG_ROWS}): equal bits; "
          f"{t_kernel:.3f} s with the kernel, {t_plain:.3f} s with the plain base")


SWEEP_MODES = ("ir", "eager")


def small_proofs(device: str) -> dict:
    """The 2^9-row Memory proof of a seeded log on `device` under each sweep
    (`ETHPROOF_SWEEP`), as interop dicts by mode."""
    import os

    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.interop import proof_to_numpy
    from ethproof_tpu_torch.stark.prove import stark_prove
    from ethproof_tpu_torch.tables import memory as mem

    trace = mem.generate_trace(memory_ops(300, seed=3), 1 << 9)
    proofs = {}
    for mode in SWEEP_MODES:
        os.environ["ETHPROOF_SWEEP"] = mode
        try:
            proofs[mode] = proof_to_numpy(
                stark_prove(mem.MemoryStark(), trace, [], standard_fast_config(), device=device))
        finally:
            os.environ.pop("ETHPROOF_SWEEP")
    return proofs


def cpu_small_proofs() -> dict:
    """`small_proofs` on the CPU plain path, run in a worker process while
    the card works on the first phases."""
    import torch

    torch.set_num_threads(4)
    return small_proofs("cpu")


def phase_small_proof(on_cpu_future) -> None:
    """The card's proof of a small trace equals the CPU plain path's (from
    `cpu_small_proofs`), with the IR sweep and with the direct one
    (`ETHPROOF_SWEEP=eager`)."""
    on_card = small_proofs("cuda")
    on_cpu = on_cpu_future.result()
    for mode in SWEEP_MODES:
        if not same(on_card[mode], on_cpu[mode]):
            raise AssertionError(f"the card's 2^9-row Memory proof differs from the CPU's "
                                 f"(ETHPROOF_SWEEP={mode})")
        print(f"[slice] 2^9-row Memory proof, ETHPROOF_SWEEP={mode}: card and CPU plain path "
              "agree field for field")


def reset_launches() -> None:
    from ethproof_tpu_torch.hash import poseidon
    from ethproof_tpu_torch.poly import base_dft as bd

    for name in bd.LAUNCHES:
        bd.LAUNCHES[name] = 0
    bd.CENSUS.clear()
    poseidon.CENSUS.clear()


def poseidon_launches() -> dict:
    """The Poseidon kernels' launches since `reset_launches`, under their
    JSON names (`level_kernel` runs the leaf and node levels); raises if a
    plain permutation ran on a CUDA tensor."""
    from ethproof_tpu_torch.hash import poseidon

    census = poseidon.CENSUS
    if census[("plain", "cuda")]:
        raise AssertionError(f"{census[('plain', 'cuda')]} plain permutations ran on the card")
    return {"poseidon_permute": census[("permute", "launches")],
            "poseidon_level": census[("leaf_level", "launches")]
            + census[("node_level", "launches")]}


def same(x, y) -> bool:
    """Field-for-field equality of two interop dicts (or lists of them)."""
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
    if isinstance(x, list):
        return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
    if isinstance(x, np.ndarray):
        return np.array_equal(x, y)
    return x == y


def phase_slice(card: str):
    """The 2^17-row Memory proof under i8, verified; then the same trace
    proved again under bf16 on a fresh MemoryStark (no commitment reused),
    launch counts reset just before, which must give the same digest and
    launch only base_dft_bf16 -> (the bf16 proof's base_dft_bf16 launches,
    the i8 proof's stark and proof, for the wrap, the trace and the i8
    proof's digest, for the mesh phase)."""
    import torch

    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.interop import proof_to_numpy
    from ethproof_tpu_torch.poly import base_dft as bd
    from ethproof_tpu_torch.stark.prove import stark_prove
    from ethproof_tpu_torch.stark.verify import stark_verify
    from ethproof_tpu_torch.tables import memory as mem

    n = 1 << LOG_ROWS
    t0 = time.perf_counter()
    trace = mem.generate_trace(memory_ops(n - 1000, seed=4), n)
    print(f"[slice] MemoryStark trace ({trace.shape[0]}, 2^{LOG_ROWS}) generated in "
          f"{time.perf_counter() - t0:.2f} s")
    config = standard_fast_config()
    stark = mem.MemoryStark()
    times: dict = {}
    bd.ENCODING = "i8"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    proof = stark_prove(stark, trace, [], config, device="cuda", phase_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(bd.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches["base_dft"] <= 0:
        raise AssertionError("the Memory path launched no base_dft kernel")
    print(f"[slice] prove 2^{LOG_ROWS} rows on {card}: {wall:.3f} s, launches {launches}, "
          f"peak device memory {peak_gb:.2f} GB")
    print_phases("[slice] phase seconds:", {"memory": times})
    t0 = time.perf_counter()
    ok = stark_verify(stark, proof, config, device="cuda")
    print(f"[slice] port stark_verify: {ok} in {time.perf_counter() - t0:.2f} s")
    if not ok:
        raise AssertionError("the 2^17-row Memory proof does not verify")
    digest = proof_digest([proof_to_numpy(proof)])
    print(f"[slice] i8 proof sha256 {digest}")
    bd.ENCODING = "bf16"
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        proof16 = stark_prove(mem.MemoryStark(), trace, [], config, device="cuda")
        torch.cuda.synchronize()
    finally:
        bd.ENCODING = "i8"
    launches16 = dict(bd.LAUNCHES)
    digest16 = proof_digest([proof_to_numpy(proof16)])
    print(f"[slice] the same trace under bf16 on {card}: {time.perf_counter() - t0:.3f} s, "
          f"launches {launches16}, proof sha256 {digest16}")
    if digest16 != digest:
        raise AssertionError(f"the 2^17-row Memory proof under bf16 has digest {digest16}, not "
                             f"the i8 proof's ({digest})")
    if launches16["base_dft_bf16"] <= 0 or launches16["base_dft"] != 0:
        raise AssertionError(f"the Memory proof under bf16 launched {launches16}")
    return launches16["base_dft_bf16"], stark, proof, trace, digest


def phase_mesh(card: str, trace, digest: str) -> int:
    """Multi-device proving on a virtual mesh of the one card (every shard
    on cuda:0, so peer-to-peer copies between cards are not exercised):
    `trace` (the 2^17-row Memory trace) proved under i8 on a MESH_WIDTH-wide
    mesh, launch counts reset just before, read just after, must have the
    one-device i8 proof's `digest`; then `trace_commit_sharded` of a seeded
    (2, 28, 2^14) batch on a (tx 2, col 2) mesh must give the one-device
    caps -> the mesh proof's base_dft launches."""
    import torch

    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.gf import field as gfp
    from ethproof_tpu_torch.hash import merkle
    from ethproof_tpu_torch.interop import proof_to_numpy
    from ethproof_tpu_torch.parallel import mesh as pmesh
    from ethproof_tpu_torch.poly import base_dft as bd
    from ethproof_tpu_torch.poly import four_step
    from ethproof_tpu_torch.stark.prove import stark_prove
    from ethproof_tpu_torch.tables import memory as mem

    config = standard_fast_config()
    mesh = pmesh.make_mesh(devices=["cuda:0"] * MESH_WIDTH)
    bd.ENCODING = "i8"
    times: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    proof = stark_prove(mem.MemoryStark(), trace, [], config, device="cuda", mesh=mesh,
                        phase_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = dict(bd.LAUNCHES), len(bd.CENSUS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = proof_digest([proof_to_numpy(proof)])
    print(f"[mesh] prove 2^{LOG_ROWS} rows on a {MESH_WIDTH}-wide mesh of {card}: {wall:.3f} s, "
          f"launches {launches} over {shapes} shapes, peak device memory {peak_gb:.2f} GB, "
          f"proof sha256 {got}")
    print_phases("[mesh] phase seconds:", {"memory": times})
    if got != digest:
        raise AssertionError(f"the mesh proof's digest {got} is not the one-device proof's "
                             f"({digest})")
    if launches["base_dft"] <= 0 or launches["base_dft_bf16"] != 0:
        raise AssertionError(f"the mesh proof under i8 launched {launches}")
    fri = config.fri_config
    tx, n = 2, 1 << 14
    batch = np.random.default_rng(9).integers(0, P, size=(tx, TRACE_COLS, n), dtype=np.uint64)
    txmesh = pmesh.make_mesh(devices=["cuda:0"] * 4, tx=tx)
    commit, shard_fn = pmesh.trace_commit_sharded(txmesh, TRACE_COLS, n, fri.rate_bits,
                                                  fri.cap_height, fri.coset_shift)
    t0 = time.perf_counter()
    caps = gfp.to_u64(commit(shard_fn(batch)))
    sharded_s = time.perf_counter() - t0
    for t in range(tx):
        coeffs = four_step.best_intt(gfp.from_u64(batch[t], "cuda"))
        lde = four_step.best_coset_lde(coeffs, fri.rate_bits, fri.coset_shift)
        if not np.array_equal(caps[t], gfp.to_u64(merkle.build(lde, fri.cap_height).cap)):
            raise AssertionError(f"trace_commit_sharded's cap of tx {t} differs from one device's")
    print(f"[mesh] trace_commit_sharded of ({tx}, {TRACE_COLS}, 2^14) on a (tx {tx}, col 2) "
          f"mesh: {sharded_s:.3f} s, caps equal to one device's")
    return launches["base_dft"]


def phase_mesh_alone(card: str) -> None:
    """The 2^17-row Memory trace proved on one device under i8 (its digest),
    then the mesh phase."""
    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.interop import proof_to_numpy
    from ethproof_tpu_torch.stark.prove import stark_prove
    from ethproof_tpu_torch.tables import memory as mem

    n = 1 << LOG_ROWS
    trace = mem.generate_trace(memory_ops(n - 1000, seed=4), n)
    t0 = time.perf_counter()
    proof = stark_prove(mem.MemoryStark(), trace, [], standard_fast_config(), device="cuda")
    digest = proof_digest([proof_to_numpy(proof)])
    print(f"[mesh] one-device i8 proof: {time.perf_counter() - t0:.3f} s, sha256 {digest}")
    phase_mesh(card, trace, digest)


def phase_wrap(card: str, child_stark, child_proof) -> dict:
    """The recursion core on the card: the wrap of the 2^17-row Memory
    proof at `standard_fast_config` (its verifier compiled into a machine
    circuit, the machine proved under i8, launch counts reset just before,
    read just after), verified by the port; its digest against WRAP_DIGEST;
    one opened leaf value of the child changed fails the wrap's `interpret`;
    one trace-cap word or one opening of the wrap proof changed fails
    `verify_machine` -> the base-DFT census of the wrap proof."""
    import copy

    import torch

    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.interop import machine_proof_to_numpy
    from ethproof_tpu_torch.poly import base_dft as bd
    from ethproof_tpu_torch.recursion import build_wrap, verify_machine
    from ethproof_tpu_torch.recursion.circuit import G_POSEIDON

    config = standard_fast_config()
    bd.ENCODING = "i8"
    times: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    wrap = build_wrap(child_stark, LOG_ROWS, config, device="cuda", phase_times=times)
    build_s = time.perf_counter() - t0
    gates = wrap.compiled.circuit.gates
    n_pos = sum(1 for g in gates if g.op == G_POSEIDON)
    print(f"[wrap] verifier circuit of the 2^{LOG_ROWS}-row Memory proof: {len(gates)} gates "
          f"({n_pos} Poseidon), {wrap.compiled.circuit.num_witness} witness wires; machine "
          f"{wrap.stark.num_rows} rows, degree 2^{wrap.log_n}; built in {build_s:.3f} s")
    t0 = time.perf_counter()
    proof = wrap.prove(child_proof, config, phase_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, census = dict(bd.LAUNCHES), dict(bd.CENSUS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host = times.get("host", {})
    print(f"[wrap] prove on {card}: {wall:.3f} s, launches {launches}, peak device memory "
          f"{peak_gb:.2f} GB")
    print(f"[wrap] host seconds {sum(host.values()):.3f}: "
          + json.dumps({k: round(v, 4) for k, v in host.items()}))
    print_phases("[wrap]", {"machine": times["machine"]})
    if launches["base_dft"] <= 0 or launches["base_dft_bf16"] != 0:
        raise AssertionError(f"the wrap proof under i8 launched {launches}")
    if proof.log_n != wrap.log_n or proof.proof.degree_bits != wrap.log_n:
        raise AssertionError(f"the wrap proof has degree 2^{proof.proof.degree_bits}, "
                             f"not 2^{wrap.log_n}")
    if [int(x) for x in proof.proof.public_inputs] != [0, 0, 0, 0]:
        raise AssertionError(f"the wrap of a proof with no public inputs exposes "
                             f"{proof.proof.public_inputs}")
    digest = proof_digest(machine_proof_to_numpy(proof))
    print(f"[wrap] proof sha256 {digest}")
    if digest != WRAP_DIGEST:
        raise AssertionError(f"the wrap proof's digest {digest} differs from the recorded "
                             f"proof's ({WRAP_DIGEST})")
    t0 = time.perf_counter()
    ok = verify_machine(wrap.stark, proof, config, device="cuda")
    print(f"[wrap] port verify_machine: {ok} in {time.perf_counter() - t0:.2f} s")
    if not ok:
        raise AssertionError("the wrap proof does not verify")
    bad_child = copy.deepcopy(child_proof)
    bad_child.trace_query_openings.values[0, 0] ^= 1
    t0 = time.perf_counter()
    try:
        wrap.prove(bad_child, config)
    except AssertionError as e:
        print(f"[wrap] child with one opened trace value changed: interpret refused "
              f"({str(e)[:60]}) in {time.perf_counter() - t0:.2f} s")
    else:
        raise AssertionError("the wrap proved a child whose opened trace value was changed")
    for what in ("trace_cap", "trace_at_zeta"):
        bad = copy.deepcopy(proof)
        if what == "trace_cap":
            bad.proof.trace_cap[0, 0] ^= 1
        else:
            bad.proof.openings.trace_at_zeta[0, 0] ^= 1
        t0 = time.perf_counter()
        rejected = not verify_machine(wrap.stark, bad, config, device="cuda")
        print(f"[wrap] verify_machine with one {what} word changed: "
              f"{'rejected' if rejected else 'ACCEPTED'} in {time.perf_counter() - t0:.2f} s")
        if not rejected:
            raise AssertionError(f"a wrap proof with a changed {what} word passed verify_machine")
    return census


def small_transfer_config():
    """The CPU tier's configuration (tests/test_transfer_e2e.py:33)."""
    from ethproof_tpu_torch.fri.config import FriConfig, StarkConfig

    return StarkConfig(num_challenges=2, fri_config=FriConfig(
        rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
        arity_bits=2, final_poly_bits=2))


def small_transfer_sizes(keccak):
    from ethproof_tpu_torch.tables.all import TableSizes

    return TableSizes(cpu=5, arithmetic=6, logic=4, bytepacking=9, memory=7, keccak=keccak)


def cpu_small_transfers():
    """The CPU plain path's seven-table transfer proof at the CPU tier's
    sizes -> (interop proofs, seconds). Run in a worker process while the
    card works on the earlier phases."""
    import torch

    from ethproof_tpu_torch.evm.transfer import prove_transfer
    from ethproof_tpu_torch.interop import multi_proof_to_numpy
    from ethproof_tpu_torch.witness import synthetic

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    gi, config = synthetic.small_transfer(), small_transfer_config()
    proofs = multi_proof_to_numpy(
        prove_transfer(gi, config, small_transfer_sizes(5), device="cpu").multi)
    return proofs, time.perf_counter() - t0


def phase_small_transfer(on_cpu_future) -> None:
    """The card's seven-table transfer proof at the CPU tier's sizes, under
    i8, equals the CPU plain path's (from `cpu_small_transfers`), table by
    table. (The five-table transfer is held against the CPU by
    `phase_succinct`, whose ladder proves two.)"""
    from ethproof_tpu_torch.evm.transfer import prove_transfer
    from ethproof_tpu_torch.interop import multi_proof_to_numpy
    from ethproof_tpu_torch.poly import base_dft as bd
    from ethproof_tpu_torch.witness import synthetic

    gi, config = synthetic.small_transfer(), small_transfer_config()
    bd.ENCODING = "i8"
    t0 = time.perf_counter()
    on_card = multi_proof_to_numpy(
        prove_transfer(gi, config, small_transfer_sizes(5), device="cuda").multi)
    card_s = time.perf_counter() - t0
    on_cpu, cpu_s = on_cpu_future.result()
    for t, (x, y) in enumerate(zip(on_card, on_cpu)):
        if not same(x, y):
            raise AssertionError(f"small transfer, i8: table {t}'s proof on the card differs "
                                 "from the CPU's")
    print(f"[small transfer] {len(on_card)} tables, i8: card ({card_s:.2f} s) and CPU plain "
          f"path agree field for field in every table")
    print(f"[small transfer] the CPU plain path's proof took {cpu_s:.2f} s in a worker "
          "process, beside the card's phases")


# the recursion ladder's fixture: tests/test_succinct_block.py:42-53 of the
# JAX package (one challenge, rate 2, cap height 0, no PoW, ONE query, arity
# 2^3, final polynomial 2^3; the CPU tier's five-table sizes)
SUCCINCT_SIZES = dict(cpu=5, arithmetic=6, logic=4, bytepacking=9, memory=7, keccak=None)
# sha256 (`proof_digest`) of the succinct block's top aggregation proof and
# its block wrap (`machine_proof_to_numpy`, `block_wrap_proof_to_numpy`),
# recorded on an NVIDIA H100 80GB HBM3 (700 W) by the commit that added it
SUCCINCT_DIGEST = "a2883ba8d3c449312ec6835e528b0f9342cee742f70fda58ff8e5e051c9682f6"


def succinct_config():
    from ethproof_tpu_torch.fri.config import FriConfig, StarkConfig

    return StarkConfig(num_challenges=1, fri_config=FriConfig(
        rate_bits=2, cap_height=0, proof_of_work_bits=0, num_query_rounds=1,
        arity_bits=3, final_poly_bits=3))


def cpu_succinct_transfers():
    """The CPU plain path's five-table proofs of `transfer_chain(2)` under
    the ladder's fixture (binding None, as the recursion state's) ->
    (interop proofs per transfer, seconds). Run in the worker process."""
    import torch

    from ethproof_tpu_torch.evm.transfer import prove_transfer
    from ethproof_tpu_torch.interop import multi_proof_to_numpy
    from ethproof_tpu_torch.tables.all import TableSizes
    from ethproof_tpu_torch.witness import synthetic

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    proofs = [multi_proof_to_numpy(prove_transfer(
        gi, succinct_config(), TableSizes(**SUCCINCT_SIZES), binding=None, device="cpu").multi)
        for gi in synthetic.transfer_chain(2)]
    return proofs, time.perf_counter() - t0


def circuit_line(name: str, stark, log_n: int, times: dict) -> str:
    from ethproof_tpu_torch.recursion.circuit import G_POSEIDON

    gates = stark.circuit.gates
    n_pos = sum(1 for g in gates if g.op == G_POSEIDON)
    host = times.get("host", {})
    return (f"{name}: {len(gates)} gates ({n_pos} Poseidon), machine {stark.num_rows} rows, "
            f"degree 2^{log_n}; build host s " + json.dumps({k: round(v, 3) for k, v in host.items()}))


def rung_line(name: str, wall, times: dict) -> str:
    """One machine proof of a rung: wall (when timed apart), host steps,
    machine phases."""
    host = times.get("host", {})
    machine = {k: v for k, v in times.get("machine", {}).items() if k != "ir_plan"}
    return (f"{name}: " + ("" if wall is None else f"{wall:.3f} s; ")
            + f"host {sum(host.values()):.3f} s "
            + json.dumps({k: round(v, 3) for k, v in host.items()})
            + f"; machine proof {sum(v for k, v in machine.items() if not k.startswith('GB_')):.3f} s "
            + json.dumps({k: round(v, 3) for k, v in machine.items()}))


@contextlib.contextmanager
def timed_calls(owner, name: str, log: list):
    """Patch `owner.name` so that each call gets its own `phase_times` dict
    and is timed: log receives (wall seconds, times, result) per call."""
    import torch

    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        times = kwargs.setdefault("phase_times", {})
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, times, out))
        return out

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def phase_succinct(card: str, on_cpu_future) -> dict:
    """The recursion ladder on the card, at the JAX package's succinct
    fixture: `transfer_chain(2)` and the no-op dummy at its post state
    through `scheduler.prove_block(payloads, TINY, sizes=SIZES,
    runtime=Runtime(max_retries=0), recursion=True, block_wrap=True,
    device="cuda")`: each payload a `tx_proof` task (a five-table transfer
    proof and its tx root machine proof; the dummy's root), `agg_combine`
    and `block_proof`, the three roots folded to level 2 (padded to four,
    `agg_machine` tasks) and the block base wrap; i8, launch counts reset
    just before, read just after. The two transfer multi-proofs equal the
    CPU plain path's (`cpu_succinct_transfers`); the top proof and wrap
    have the digest SUCCINCT_DIGEST; the block goes through serde, and
    `verify_block(..., recursion=state)`, with a state built from the
    decoded proof's declared identity as `cli verify` does (the prover's
    cached state dropped first, so its circuits are compiled and their
    vkeys committed anew), accepts the decoded block and rejects a changed
    leaf statement, a flipped opening of the top proof and a changed top
    statement -> the base-DFT census of the phase."""
    import copy
    import os

    import torch

    from ethproof_tpu_torch.hash.keccak import keccak256
    from ethproof_tpu_torch.interop import (block_wrap_proof_to_numpy,
                                            machine_proof_to_numpy, multi_proof_to_numpy)
    from ethproof_tpu_torch.poly import base_dft as bd
    from ethproof_tpu_torch.recursion import aggregate, recursion_state
    from ethproof_tpu_torch.recursion import state as recursion_states
    from ethproof_tpu_torch.recursion.block import BlockWraps, build_block_wraps
    from ethproof_tpu_torch.runtime import ops, scheduler, serde
    from ethproof_tpu_torch.tables.all import TableSizes
    from ethproof_tpu_torch.witness import synthetic

    if os.environ.get("ETHPROOF_ARTIFACT_DIR"):
        raise AssertionError("the succinct phase times cold builds: unset ETHPROOF_ARTIFACT_DIR")
    config, sizes = succinct_config(), TableSizes(**SUCCINCT_SIZES)
    payloads = synthetic.transfer_chain(2) + [synthetic.noop_dummy(2)]
    bd.ENCODING = "i8"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    multis, leaves, aggs, wraps_log = [], [], [], []
    prove_transfer = ops.prove_transfer

    def recording(*args, **kwargs):  # keeps the multi-proof that the root subsumes
        proof = prove_transfer(*args, **kwargs)
        multis.append(proof.multi)
        return proof

    ops.prove_transfer = recording
    t_block = time.perf_counter()
    try:
        with timed_calls(ops, "tx_proof", leaves), \
                timed_calls(aggregate.AggCircuit, "prove", aggs), \
                timed_calls(BlockWraps, "prove_base", wraps_log):
            bp = scheduler.prove_block(
                payloads, config, sizes=sizes, runtime=scheduler.Runtime(max_retries=0),
                recursion=True, block_wrap=True, device="cuda")
        torch.cuda.synchronize()
    finally:
        ops.prove_transfer = prove_transfer
    block_s = time.perf_counter() - t_block
    launches, census = dict(bd.LAUNCHES), dict(bd.CENSUS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, (wall, times, leaf) in enumerate(leaves):
        kind = "transfer" if leaf.gen_inputs.signed_txn else "no-op dummy"
        tables = {k: round(sum(v for p, v in ph.items() if p != "ir_plan"), 3)
                  for k, ph in times.items() if k not in ("host", "root")}
        print(f"[succinct] tx_proof task {i} ({kind}) on {card}: {wall:.3f} s; variant "
              f"{leaf.root_proof.variant}; table proofs s {json.dumps(tables)}, "
              f"host s {json.dumps({k: round(v, 3) for k, v in times.get('host', {}).items()})}")
        print("[succinct]   " + rung_line("its root proof", None, times["root"]))
    state = recursion_state(sizes, config, device="cuda")
    for name, times in state.build_times.items():
        root = state.roots.get(name.split("/")[-1]) if name.startswith("txroot") \
            else state.dummy_root()
        print("[succinct] built " + circuit_line(name, root.stark, state.root_log_n, times))
    for lv in sorted(state.ladder.build_times):
        stark_lv, log_n = state.ladder.level_shape(lv)
        print("[succinct] built " + circuit_line(f"agg level {lv}", stark_lv[0], log_n,
                                                 state.ladder.build_times[lv]))
    for j, (wall, times, _) in enumerate(aggs):
        print("[succinct] " + rung_line(f"agg_machine task {j}", wall, times))
    level = bp.succinct.level
    wraps = build_block_wraps(state.ladder, level, config)
    for name, times in wraps.build_times.items():
        circ = wraps.base if name == "base" else wraps.step
        print("[succinct] built " + circuit_line(f"block {name}", circ.stark, wraps.log_n, times))
    for wall, times, _ in wraps_log:
        print("[succinct] " + rung_line("block base proof", wall, times))
    print(f"[succinct] prove_block (3 payloads, level-{level} fold, base wrap) on {card} in "
          f"{block_s:.3f} s, launches {launches}, peak device memory {peak_gb:.2f} GB")
    if len(leaves) != 3 or level != 2 or len(aggs) != 3 or len(wraps_log) != 1:
        raise AssertionError(f"{len(leaves)} tx_proof calls folded to level {level} in "
                             f"{len(aggs)} agg proofs and {len(wraps_log)} wraps, not 3 "
                             f"leaves to level 2 in 3 and 1")
    if launches["base_dft"] <= 0 or launches["base_dft_bf16"] != 0:
        raise AssertionError(f"the ladder under i8 launched {launches}")
    on_cpu, cpu_s = on_cpu_future.result()
    if len(multis) != 2 or not all(same(multi_proof_to_numpy(m), c)
                                   for m, c in zip(multis, on_cpu)):
        raise AssertionError("the ladder's five-table transfer proofs on the card differ from "
                             "the CPU plain path's")
    print(f"[succinct] its two five-table transfer proofs equal the CPU plain path's field for "
          f"field (CPU {cpu_s:.2f} s in the worker process)")
    digest = proof_digest({"top": machine_proof_to_numpy(bp.succinct.top),
                           "block_wrap": block_wrap_proof_to_numpy(bp.succinct.block_wrap)})
    print(f"[succinct] top proof and block wrap sha256 {digest}")
    if SUCCINCT_DIGEST is not None and digest != SUCCINCT_DIGEST:
        raise AssertionError(f"the succinct block's digest {digest} differs from the recorded "
                             f"one ({SUCCINCT_DIGEST})")
    t0 = time.perf_counter()
    text = json.dumps(serde.block_proof_to_json(bp))
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = serde.block_proof_from_json(json.loads(text))
    print(f"[succinct] serde: {len(text)} bytes of JSON, encoded in {encode_s:.3f} s, decoded "
          f"in {time.perf_counter() - t0:.3f} s")
    s = back.succinct
    # the verifier's own state: without the prover's cached one, its
    # circuits are compiled and their vkeys committed from what the file
    # declares (no artifact dir: nothing comes from disk either)
    recursion_states._STATES.clear()
    t0 = time.perf_counter()
    verifier_state = recursion_state(s.sizes, config, binding_shape=s.binding_shape,
                                     evm_shapes=s.evm_shapes, wd_counts=s.wd_counts,
                                     device="cuda")
    if verifier_state is state:
        raise AssertionError("the verifier reused the prover's recursion state")
    ok = ops.verify_block(back, config, recursion=verifier_state, device="cuda")
    print(f"[succinct] verify_block(recursion=state) of the decoded block, the state built "
          f"anew from its declared identity: {ok} in {time.perf_counter() - t0:.2f} s")
    if not ok:
        raise AssertionError("the decoded succinct block does not verify")

    def leaf_statement(b):
        b.agg.left.left.gen_inputs.trie_roots_after.state_root = keccak256(b"no")

    def top_opening(b):
        b.succinct.top.proof.trace_query_openings.values[0, 0] ^= 1

    def top_statement(b):
        pis = b.succinct.top.proof.public_inputs
        pis[0] = (int(pis[0]) + 1) % P

    for name, tamper in (("a changed leaf statement", leaf_statement),
                         ("one flipped opening of the top proof", top_opening),
                         ("a changed top statement", top_statement)):
        bad = copy.deepcopy(back)
        tamper(bad)
        t0 = time.perf_counter()
        rejected = not ops.verify_block(bad, config, recursion=verifier_state, device="cuda")
        print(f"[succinct] verify_block with {name}: "
              f"{'rejected' if rejected else 'ACCEPTED'} in {time.perf_counter() - t0:.2f} s")
        if not rejected:
            raise AssertionError(f"verify_block accepted {name}")
    return census


def proof_digest(proofs) -> str:
    """sha256 of a `multi_proof_to_numpy` list, field by field: dict keys in
    order, list lengths, each array's dtype, shape and bytes, each int."""
    digest = hashlib.sha256()

    def walk(v):
        if isinstance(v, dict):
            digest.update(b"{%d" % len(v))
            for k in sorted(v):
                digest.update(k.encode())
                walk(v[k])
        elif isinstance(v, list):
            digest.update(b"[%d" % len(v))
            for u in v:
                walk(u)
        elif isinstance(v, np.ndarray):
            digest.update(f"{v.dtype.str}{v.shape}".encode())
            digest.update(np.ascontiguousarray(v).tobytes())
        else:
            digest.update(repr(v).encode())

    walk(proofs)
    return digest.hexdigest()


def phase_census(card: str, census: dict) -> None:
    """Each kernel held bit for bit against its plain version (on the first
    and last rows, CENSUS_CHECK_ELEMS elements in all, or every row of a
    smaller call) and against the other kernel (every row), and timed
    (`graph_ms`: CUDA events around CUDA-graph replays) at every base-DFT
    shape the main path launched: `census` is base_dft.CENSUS of its i8
    proof, (kernel, rows, n, inverse) -> launches; a bf16 proof launches the
    same shapes (the four-step split depends on n alone). Prints per shape and per proof
    the kernel ms, the bound, what binds, launches x (ms - bound) and the
    plain version's ms (one call, up to CENSUS_PLAIN_MAX elements: above it
    its float64 digit planes and int64 buckets outgrow the card). What the
    bound leaves out is timed the same way: the launch floor (a one-element
    `add_`) and, for each n, a 16-row call (one block of one row tile, so
    its time is the latency of one tile's read, planes, MMAs and epilogue);
    each shape's time is also given against that call's."""
    import torch

    from ethproof_tpu_torch.poly import base_dft as bd

    plains = {"i8": bd.base_dft_i8_plain, "bf16": bd.base_dft_bf16_plain}
    shapes = sorted((rows, n, inverse, count)
                    for (name, rows, n, inverse), count in census.items() if name == "base_dft")
    tiny = torch.zeros(1, dtype=torch.int64, device="cuda")
    print(f"[census] launch floor on {card}: {graph_ms(lambda: tiny.add_(1), 1):.4f} ms per "
          "one-element add_")
    one_tile = {}
    for n in sorted({s[1] for s in shapes}):
        t = torch.randint(0, 1 << 62, (16, n), dtype=torch.int64, device="cuda")
        for encoding in ("i8", "bf16"):
            one_tile[encoding, n] = graph_ms(
                lambda: bd.base_dft(t, n.bit_length() - 1, False, encoding), 16 * n)
        print(f"[census] one 16-row call at n = {n}: base_dft {one_tile['i8', n]:.4f} ms, "
              f"base_dft_bf16 {one_tile['bf16', n]:.4f} ms")
    per_proof = {}
    print(f"[census] {len(shapes)} shapes, {sum(s[3] for s in shapes)} launches in the "
          f"cli, contract, wrap and succinct proofs, on {card}")
    for rows, n, inverse, count in shapes:
        log_n = n.bit_length() - 1
        a = torch.randint(0, 1 << 62, (rows, n), dtype=torch.int64, device="cuda")
        # the plain versions check the first and the last CENSUS_CHECK_ELEMS / 2
        # elements' rows (all rows of a smaller call); the kernels, each
        # other in every row
        half = max(1, CENSUS_CHECK_ELEMS // (2 * n))
        check_rows = ([slice(0, rows)] if rows <= 2 * half
                      else [slice(0, half), slice(rows - half, rows)])
        got = {}
        for encoding, ops, wbytes in (("i8", INT8_OPS_PER_S, 8), ("bf16", BF16_OPS_PER_S, 16)):
            name = bd.KERNELS[encoding]
            got[encoding] = bd.base_dft(a, log_n, inverse, encoding)
            for r in check_rows:
                if not torch.equal(got[encoding][r], plains[encoding](a[r], log_n, inverse)):
                    raise AssertionError(f"{name} ({rows}, {n}) inverse={inverse}: kernel != "
                                         f"its plain version in rows {r}")
            ms = graph_ms(lambda: bd.base_dft(a, log_n, inverse, encoding), rows * n)
            bound_ms, bound_by = bound(rows * n, n, wbytes * n * n, ops)
            tot = per_proof.setdefault(name, {"ms": 0.0, "bound_ms": 0.0})
            tot["ms"] += count * ms
            tot["bound_ms"] += count * bound_ms
            if rows * n <= CENSUS_PLAIN_MAX:
                plain_ms = f"{timed(lambda: plains[encoding](a, log_n, inverse))[1]:.2f} ms"
            else:
                plain_ms = "not measured"
            print(f"[census] {name} ({rows}, {n}) inverse={inverse} x{count}: equal bits to its "
                  f"plain version and the other kernel; kernel {ms:.4f} "
                  f"ms, bound {bound_ms:.4f} ms ({bound_by}), {ms / bound_ms:.2f}x bound, "
                  f"{ms / one_tile[encoding, n]:.2f}x one 16-row call, launches x (ms - bound) "
                  f"{count * (ms - bound_ms):.3f} ms, plain {plain_ms}")
        if not torch.equal(got["i8"], got["bf16"]):
            raise AssertionError(f"({rows}, {n}) inverse={inverse}: base_dft != base_dft_bf16")
        del a, got
    for name, tot in per_proof.items():
        print(f"[census] {name} in the cli, contract, wrap and succinct proofs: {tot['ms']:.3f} ms of kernel "
              f"time, bound "
              f"{tot['bound_ms']:.3f} ms, launches x (ms - bound) "
              f"{tot['ms'] - tot['bound_ms']:.3f} ms")


def print_phases(tag: str, times: dict) -> None:
    """Each table's phase seconds (and peak GB, where measured) and their
    sum; then each table's IR sweep plan, as the level executor that swept
    it reported it (`SweepExecutor.plan`: recorded instructions, levels,
    stacked field ops per pass, peak live rows, domain chunks under
    ETHPROOF_SWEEP_BUDGET)."""
    plans = {}
    for table, phases in times.items():
        plans[table] = phases.get("ir_plan")
        phases = {k: v for k, v in phases.items() if k != "ir_plan"}
        secs = sum(v for k, v in phases.items() if not k.startswith("GB_"))
        print(f"{tag} {table} " + json.dumps({k: round(v, 4) for k, v in phases.items()})
              + f" sum {secs:.3f} s")
    print(f"{tag} IR sweep plans " + json.dumps(plans))


def transfer7_inputs():
    """(witness, config) of the main path, and the host seconds of the witness."""
    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.witness import synthetic

    t0 = time.perf_counter()
    gi = synthetic.seeded_transfer(N_ACCOUNTS, seed=5)
    return gi, standard_fast_config(), time.perf_counter() - t0


def padded_witness(gi):
    """The one-transaction block as `rpc` writes it: a no-op dummy over the
    initial tries in front of the transaction (`gather_witness`'s padding)."""
    from ethproof_tpu_torch.witness import padding

    tries = padding.PartialTrieState(
        state=gi.tries.state_trie, txn=gi.tries.transactions_trie,
        receipt=gi.tries.receipts_trie, storage=dict(gi.tries.storage_tries))
    extra = padding.ExtraBlockData(checkpoint_state_trie_root=gi.checkpoint_state_trie_root)
    ir = [gi]
    padding.pad_gen_inputs_with_dummy_inputs_if_needed(
        ir, gi.block_metadata, gi.block_hashes, extra, extra, tries, tries, False)
    return ir


def run_cli(argv, stdout_path: str) -> int:
    """`ethproof_tpu_torch.cli.main(argv)` in this process (the launch
    counters and census stay readable), its stdout into `stdout_path`."""
    import contextlib

    from ethproof_tpu_torch import cli

    with open(stdout_path, "w") as f, contextlib.redirect_stdout(f):
        return cli.main(argv)


@contextlib.contextmanager
def no_retries():
    """Every `scheduler.Runtime` made inside runs each task once, whatever
    its caller asks (`cli prove` builds one with the default max_retries=2):
    a failed task raises at once and is not retried and hidden."""
    from ethproof_tpu_torch.runtime import scheduler

    init = scheduler.Runtime.__init__

    def once(self, num_workers=1, max_retries=0):
        init(self, num_workers, max_retries=0)

    scheduler.Runtime.__init__ = once
    try:
        yield
    finally:
        scheduler.Runtime.__init__ = init


def phase_cli(card: str):
    """The main path through the CLI, as a user runs it: the transfer7
    witness padded as `rpc` pads a one-transaction block, written with
    `witness_to_json`; `cli prove -i witness.json --persistence none` (in
    this process, stdout into proof.json: `prove_block` with the
    CircuitConfig() ranges through the in-memory Runtime, made without
    retries, one `tx_proof` task per payload, `prove_transfer(binding=
    "auto")`, `agg_combine`, `block_proof`, serde), through the default mesh
    (a CLI_MESH_WIDTH-wide mesh over cuda:0, as `default_mesh()` gives a
    multi-card host; reset after the prove: the sharded commits are counted
    and must be some), i8, launch counts reset
    just before, read just after; each task's seconds, the transfer's host
    steps and each table's phases are printed. The decoded
    transfer proof has seven tables at TRANSFER7_LOGS, the production
    binding shape and the digest TRANSFER7_WIRE_DIGEST; `cli verify` returns
    0 on the file and 1 on a copy whose top aggregate claims another post
    state root (refused by the host's seam check before any STARK is
    verified); a flipped post state root is rejected by `verify_all_tables`
    alone -> (base_dft launches, base-DFT census) of the prove."""
    import copy
    import os
    import tempfile

    import torch

    from ethproof_tpu_torch.evm import transfer as tr
    from ethproof_tpu_torch.evm.binding import PRODUCTION_SHAPE
    from ethproof_tpu_torch.interop import multi_proof_to_numpy
    from ethproof_tpu_torch.parallel import mesh as pmesh
    from ethproof_tpu_torch.poly import base_dft as bd
    from ethproof_tpu_torch.runtime import ops, serde
    from ethproof_tpu_torch.tables.all import verify_all_tables
    from ethproof_tpu_torch.tables.cpu import pi_limbs
    from ethproof_tpu_torch.witness.types import witness_to_json

    gi, config, witness_s = transfer7_inputs()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    witness, proof_path = os.path.join(tmp, "witness.json"), os.path.join(tmp, "proof.json")
    t0 = time.perf_counter()
    ir = padded_witness(gi)
    with open(witness, "w") as f:
        json.dump(witness_to_json(ir), f)
    print(f"[cli] witness: the {N_ACCOUNTS}-account transfer ({witness_s:.2f} s) after a no-op "
          f"dummy, {len(ir)} payloads, witness.json {os.path.getsize(witness)} bytes, padded "
          f"and written in {time.perf_counter() - t0:.2f} s")
    bd.ENCODING = "i8"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    leaves, commits = [], []
    commit_blocks = pmesh.commit_blocks

    def counted(col_blocks, *args, **kwargs):
        commits.append(len(col_blocks))
        return commit_blocks(col_blocks, *args, **kwargs)

    pmesh._DEFAULT_MESH = pmesh.make_mesh(devices=["cuda:0"] * CLI_MESH_WIDTH)
    pmesh.commit_blocks = counted
    t0 = time.perf_counter()
    try:
        with no_retries(), timed_calls(ops, "tx_proof", leaves):
            rc = run_cli(["prove", "-i", witness, "--persistence", "none"], proof_path)
        torch.cuda.synchronize()
    finally:
        pmesh.commit_blocks = commit_blocks
        pmesh.reset_default_mesh()
    prove_s = time.perf_counter() - t0
    sharded = sum(w == CLI_MESH_WIDTH for w in commits)
    print(f"[cli] {sharded} of {len(commits)} commits of cli prove went through the default "
          f"{CLI_MESH_WIDTH}-wide mesh")
    if sharded == 0:
        raise AssertionError(f"cli prove made {len(commits)} commits, none on the mesh")
    launches, census = dict(bd.LAUNCHES), dict(bd.CENSUS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise AssertionError(f"cli prove exited {rc}")
    print(f"[cli] cli prove -i witness.json on {card}: {prove_s:.3f} s, proof.json "
          f"{os.path.getsize(proof_path)} bytes, launches {launches}, peak device memory "
          f"{peak_gb:.2f} GB")
    if len(leaves) != len(ir):
        raise AssertionError(f"{len(leaves)} tx_proof calls for {len(ir)} payloads")
    for i, (wall, times, leaf) in enumerate(leaves):
        host = times.get("host", {})
        tables = {k: v for k, v in times.items() if k != "host"}
        print(f"[cli] tx_proof task {i} "
              f"({'transfer' if leaf.gen_inputs.signed_txn else 'no-op dummy'}): {wall:.3f} s; "
              f"host seconds {sum(host.values()):.3f}: "
              + json.dumps({k: round(v, 4) for k, v in host.items()}))
        if tables:
            print_phases(f"[cli] task {i}", tables)
    t0 = time.perf_counter()
    with open(proof_path) as f:
        text = f.read()
    bp = serde.block_proof_from_json(json.loads(text))
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = json.dumps(serde.block_proof_to_json(bp))
    encode_s = time.perf_counter() - t0
    print(f"[cli] serde: proof.json decoded in {decode_s:.3f} s, encoded again in "
          f"{encode_s:.3f} s ({'the same bytes' if again == text else 'OTHER BYTES'})")
    if again != text:
        raise AssertionError("the decoded proof does not encode to the same bytes")
    dummy, proof = bp.agg.left, bp.agg.right
    if dummy.gen_inputs.signed_txn is not None or not isinstance(proof, tr.TxProof):
        raise AssertionError("the block is not the padded dummy and the transfer")
    logs = dict(zip(TRANSFER7_LOGS, (p.degree_bits for p in proof.multi.proofs)))
    print(f"[cli] the transfer's proof: {len(proof.multi.proofs)} tables, fitted log2 sizes "
          f"{logs}, binding shape {proof.binding_shape}")
    if len(proof.multi.proofs) != 7:
        raise AssertionError(f"the main path made {len(proof.multi.proofs)} table proofs, not 7")
    if proof.binding_shape != PRODUCTION_SHAPE:
        raise AssertionError(f"binding shape {proof.binding_shape} != {PRODUCTION_SHAPE}")
    if logs != TRANSFER7_LOGS:
        raise AssertionError(f"fitted sizes {logs} != the reference's {TRANSFER7_LOGS}")
    if launches["base_dft"] <= 0 or launches["base_dft_bf16"] != 0:
        raise AssertionError(f"the main path under i8 launched {launches}")
    digest = proof_digest(multi_proof_to_numpy(proof.multi))
    print(f"[cli] decoded proof sha256 {digest}")
    if TRANSFER7_WIRE_DIGEST is not None and digest != TRANSFER7_WIRE_DIGEST:
        raise AssertionError(f"the decoded seven-table proof's digest {digest} differs from "
                             f"the recorded proof's ({TRANSFER7_WIRE_DIGEST})")
    t0 = time.perf_counter()
    rc = run_cli(["verify", "-i", proof_path], os.path.join(tmp, "verify.out"))
    print(f"[cli] cli verify -i proof.json: exit {rc} in {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        raise AssertionError(f"cli verify exited {rc} on the proof")
    tampered = json.loads(text)
    tampered["agg"]["state_root_after"] = bytes(32).hex()
    bad_path = os.path.join(tmp, "tampered.json")
    with open(bad_path, "w") as f:
        json.dump(tampered, f)
    t0 = time.perf_counter()
    rc = run_cli(["verify", "-i", bad_path], os.path.join(tmp, "verify_bad.out"))
    print(f"[cli] cli verify of the file with the top aggregate's state_root_after zeroed: exit "
          f"{rc} in {time.perf_counter() - t0:.2f} s")
    if rc != 1:
        raise AssertionError(f"cli verify exited {rc} on the tampered file, not 1")
    # the post state root flipped: the STARK alone (no host trie check)
    # rejects, whether the CPU proof keeps its public inputs (they no longer
    # match) or claims the flipped ones (its transcript and constraints fail)
    cpu = tr.transfer_cpu_stark(proof.overlap, proof.binding_shape)
    bad = list(proof.pi_words)
    bad[tr.PI_STATE_ROOT_POST] ^= 1
    relabelled = copy.copy(proof.multi)
    relabelled.proofs = list(proof.multi.proofs)
    relabelled.proofs[0] = copy.copy(proof.multi.proofs[0])
    relabelled.proofs[0].public_inputs = pi_limbs(bad)
    for name, multi in (("as proved", proof.multi), ("relabelled", relabelled)):
        t0 = time.perf_counter()
        rejected = not verify_all_tables(cpu, bad, multi, config, device="cuda")
        print(f"[cli] verify_all_tables of the decoded proof with PI_STATE_ROOT_POST flipped, "
              f"CPU proof {name}: {'rejected' if rejected else 'ACCEPTED'} in "
              f"{time.perf_counter() - t0:.2f} s")
        if not rejected:
            raise AssertionError(f"a flipped post state root passed verify_all_tables ({name})")
    return launches["base_dft"], census


def contract_inputs(tamper_root: bool = False):
    """(witness, config) of the contract path, and the host seconds of the
    witness."""
    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.witness import synthetic

    t0 = time.perf_counter()
    gi = synthetic.seeded_erc20_transfer(N_ACCOUNTS, N_HOLDERS, seed=5, tamper_root=tamper_root)
    return gi, standard_fast_config(), time.perf_counter() - t0


def prove_contract(gi, config, card: str, tag: str):
    """One contract-path proof on the card through `runtime.ops.tx_proof`,
    i8, launch counts reset just before and read just after -> (proof,
    launches, census)."""
    import torch

    from ethproof_tpu_torch.evm.binding import PRODUCTION_SHAPE
    from ethproof_tpu_torch.poly import base_dft as bd
    from ethproof_tpu_torch.runtime import ops
    from ethproof_tpu_torch.runtime.prover_state import CircuitConfig

    bd.ENCODING = "i8"
    times: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    proof = ops.tx_proof(gi, config, CircuitConfig(), device="cuda", phase_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, census = dict(bd.LAUNCHES), dict(bd.CENSUS)
    launches.update(poseidon_launches())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if proof.binding_multi is None:
        raise AssertionError("the contract path dropped its in-circuit binding")
    logs = dict(zip(CONTRACT_LOGS, (p.degree_bits for p in proof.multi.proofs)))
    binding_logs = dict(zip(CONTRACT_BINDING_LOGS,
                            (p.degree_bits for p in proof.binding_multi.proofs)))
    print(f"[{tag}] tx_proof(CircuitConfig()) of an ERC-20 transfer on {card}: {wall:.3f} s, "
          f"machine shape {proof.shape}, binding shape {proof.cb_kshape}, fitted log2 sizes: "
          f"machine {logs}, binding {binding_logs}; launches {launches}, peak device memory "
          f"{peak_gb:.2f} GB")
    host = times.get("host", {})
    machine_host = times.get("machine", {}).get("host", {})
    binding_host = times.get("binding", {}).get("host", {})
    print(f"[{tag}] host seconds {sum(host.values()) + sum(machine_host.values()) + sum(binding_host.values()):.3f}: "
          + json.dumps({k: round(v, 4) for k, v in host.items()})
          + " machine trace generators " + json.dumps({k: round(v, 4) for k, v in machine_host.items()})
          + " binding kernel and trace generators "
          + json.dumps({k: round(v, 4) for k, v in binding_host.items()}))
    for part in ("machine", "binding"):
        print_phases(f"[{tag}] {part}", {k: v for k, v in times.get(part, {}).items()
                                         if k != "host"})
    if proof.cb_kshape != PRODUCTION_SHAPE:
        raise AssertionError(f"binding shape {proof.cb_kshape} != {PRODUCTION_SHAPE}")
    if (logs, binding_logs) != (CONTRACT_LOGS, CONTRACT_BINDING_LOGS):
        raise AssertionError(f"fitted sizes {logs}, {binding_logs} != the reference's "
                             f"{CONTRACT_LOGS}, {CONTRACT_BINDING_LOGS}")
    if launches["base_dft"] <= 0:
        raise AssertionError("the contract path launched no base_dft kernel")
    return proof, launches, census


def phase_contract(card: str):
    """The contract path -> (launches, base-DFT census) of its i8 proof."""
    import dataclasses

    from ethproof_tpu_torch.evm import contract
    from ethproof_tpu_torch.interop import multi_proof_to_numpy

    gi, config, witness_s = contract_inputs()
    print(f"[contract] witness: EIP-1559 ERC-20 transfer over a {N_ACCOUNTS}-account state "
          f"trie and a {N_HOLDERS}-holder token storage trie, built in {witness_s:.2f} s")
    proof, launches, census = prove_contract(gi, config, card, "contract")
    digest = proof_digest(multi_proof_to_numpy(proof.multi)
                          + multi_proof_to_numpy(proof.binding_multi))
    print(f"[contract] proof sha256 {digest}")
    if digest != CONTRACT_DIGEST:
        raise AssertionError(f"the contract proof's digest {digest} differs from the recorded "
                             f"proof's ({CONTRACT_DIGEST})")
    t0 = time.perf_counter()
    ok = contract.verify_contract_call(proof, config, device="cuda")
    print(f"[contract] port verify_contract_call: {ok} in {time.perf_counter() - t0:.2f} s")
    if not ok:
        raise AssertionError("the contract-call proof does not verify")
    # a witness whose post state root is wrong: `prove_contract_call` ends in
    # this host binding check, whose refusal `tx_proof` raises as FatalError;
    # the machine proof before it is the one above
    bad, _, _ = contract_inputs(tamper_root=True)
    t0 = time.perf_counter()
    refused = not contract.check_contract_binding(dataclasses.replace(proof, gen_inputs=bad))
    print(f"[contract] check_contract_binding of the proof under the witness with a wrong post "
          f"state root: {'refused' if refused else 'ACCEPTED'} in "
          f"{time.perf_counter() - t0:.2f} s")
    if not refused:
        raise AssertionError("the binding check accepted a wrong post state root")
    word = proof.shape.pi_layout["storage"] + 7  # the second slot's post value
    proof.machine_pi[word] += 1
    t0 = time.perf_counter()
    rejected = not contract.verify_contract_call(proof, config, device="cuda")
    print(f"[contract] verify_contract_call with storage PI word {word} forged: "
          f"{'rejected' if rejected else 'ACCEPTED'} in {time.perf_counter() - t0:.2f} s")
    if not rejected:
        raise AssertionError("a forged storage PI word passed verify_contract_call")
    return launches, census


def phase_root_size(card: str) -> None:
    """The size of a full-width tx root: the circuit verifying the transfer
    path's seven-table proof (`transfer_cpu_stark(OVERLAP_DISTINCT,
    PRODUCTION_SHAPE)` at TRANSFER7_LOGS under `standard_fast_config`, the
    tables' vkeys committed on the card), compiled and laid out but not
    proved: gates (Poseidon gates), machine rows and degree, the gates each
    table's verifier adds, host seconds and the host's peak memory."""
    import resource

    from ethproof_tpu_torch.evm.binding import PRODUCTION_SHAPE
    from ethproof_tpu_torch.evm.transfer import OVERLAP_DISTINCT, transfer_cpu_stark
    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.recursion import root
    from ethproof_tpu_torch.recursion.circuit import G_POSEIDON
    from ethproof_tpu_torch.tables.all import TableSizes

    per_table = []
    add_stark_verify = root.add_stark_verify

    def counted(vc, stark, *args, **kwargs):
        before = len(vc.b.gates)
        out = add_stark_verify(vc, stark, *args, **kwargs)
        per_table.append((type(stark).__name__, len(vc.b.gates) - before))
        return out

    root.add_stark_verify = counted
    times: dict = {}
    try:
        rc = root.build_tx_root(transfer_cpu_stark(OVERLAP_DISTINCT, PRODUCTION_SHAPE),
                                TableSizes(**TRANSFER7_LOGS), standard_fast_config(),
                                device="cuda", phase_times=times)
    finally:
        root.add_stark_verify = add_stark_verify
    gates = rc.stark.circuit.gates
    n_pos = sum(1 for g in gates if g.op == G_POSEIDON)
    print(f"[root size] the full-width transfer root (TableSizes {TRANSFER7_LOGS}, "
          f"PRODUCTION_SHAPE, standard_fast_config) on {card}'s host: {len(gates)} gates "
          f"({n_pos} Poseidon), machine {rc.stark.num_rows} rows, degree 2^{rc.log_n}; host s "
          + json.dumps({k: round(v, 3) for k, v in times["host"].items()})
          + f"; host peak {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f} GiB")
    print("[root size] gates per table verifier " + json.dumps(dict(per_table)))


def phase_succinct_alone(card: str) -> None:
    """`phase_succinct` with its CPU worker, and nothing else."""
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        phase_succinct(card, pool.submit(cpu_succinct_transfers))


def phase_profile(card: str) -> None:
    """Where a 2^17-row proof spends its time: one warm-up proof, one under
    torch.profiler (device kernels by name, device busy share), then the
    commit's layers timed alone with the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.hash import merkle, poseidon
    from ethproof_tpu_torch.poly import four_step
    from ethproof_tpu_torch.stark.prove import stark_prove
    from ethproof_tpu_torch.tables import memory as mem

    n = 1 << LOG_ROWS
    trace = mem.generate_trace(memory_ops(n - 1000, seed=4), n)
    config = standard_fast_config()
    fri = config.fri_config
    stark_prove(mem.MemoryStark(), trace, [], config, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stark_prove(mem.MemoryStark(), trace, [], config, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] 2^{LOG_ROWS}-row proof on {card}: wall {wall:.3f} s under the profiler, "
          f"{len(kernels)} distinct device kernels, {sum(e.count for e in kernels)} launches")
    if busy_us == 0:
        print("[profile] device time not measured: the profiler saw no CUDA kernel time")
    else:
        print(f"[profile] device busy {busy_us / 1e6:.3f} s = {100 * busy_us / 1e6 / wall:.1f}% "
              f"of wall; idle share {100 - 100 * busy_us / 1e6 / wall:.1f}%")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
            print(f"[profile]   {e.self_device_time_total / 1e3:10.2f} ms  "
                  f"{100 * e.self_device_time_total / busy_us:5.1f}%  x{e.count:<7d} {e.key[:90]}")

    def host_s(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / reps

    from ethproof_tpu_torch.gf import field as gfp

    a = gfp.from_u64(trace, "cuda")
    coeffs, t_intt = host_s(lambda: four_step.best_intt(a))
    lde, t_lde = host_s(lambda: four_step.best_coset_lde(coeffs, fri.rate_bits, fri.coset_shift))
    _, t_tree = host_s(lambda: merkle.build(lde, fri.cap_height), reps=1)
    states = lde[:12].contiguous()
    _, t_perm = host_s(lambda: poseidon.permute(states))
    print(f"[profile] layers of the trace commit (28 x 2^{LOG_ROWS}): iNTT {t_intt * 1e3:.1f} ms, "
          f"coset LDE {t_lde * 1e3:.1f} ms, Merkle tree {t_tree * 1e3:.1f} ms; "
          f"one Poseidon permutation of 2^{LOG_ROWS + 2} states {t_perm * 1e3:.1f} ms")


def phase_memory(card: str) -> None:
    """Seconds and peak device memory of every phase of the 2^17-row Memory
    proof under each sweep (the IR executor, then the direct evaluation)
    and of the transfer and contract paths' proofs (each phase's peak
    counted from its own start)."""
    import contextlib
    import os

    import torch

    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.interop import multi_proof_to_numpy, proof_to_numpy
    from ethproof_tpu_torch.runtime import tracing
    from ethproof_tpu_torch.stark import multi, prove
    from ethproof_tpu_torch.tables import memory as mem

    timed_phase = tracing.phase

    @contextlib.contextmanager
    def phase_with_peak(name, times, device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with timed_phase(name, times, device):
            yield
        if times is not None:  # a table's trace and fixed commits share "commit"
            peak = round(torch.cuda.max_memory_allocated() / 1e9, 2)
            times["GB_" + name] = max(times.get("GB_" + name, 0.0), peak)

    prove.phase = multi.phase = phase_with_peak
    n = 1 << LOG_ROWS
    trace = mem.generate_trace(memory_ops(n - 1000, seed=4), n)
    for mode in ("ir", "eager"):
        os.environ["ETHPROOF_SWEEP"] = mode
        times: dict = {}
        try:
            proof = prove.stark_prove(mem.MemoryStark(), trace, [], standard_fast_config(),
                                      device="cuda", phase_times=times)
        finally:
            os.environ.pop("ETHPROOF_SWEEP")
        print_phases(f"[memory] MemoryStark 2^{LOG_ROWS}, ETHPROOF_SWEEP={mode}:",
                     {"memory": times})
        print(f"[memory] MemoryStark 2^{LOG_ROWS}, ETHPROOF_SWEEP={mode}: proof sha256 "
              f"{proof_digest([proof_to_numpy(proof)])}")
        del proof
    phase_cli(card)
    gi, config, _ = contract_inputs()
    proof, _, _ = prove_contract(gi, config, card, "memory")
    prove.phase = multi.phase = timed_phase
    print(f"[memory] contract proof sha256 "
          f"{proof_digest(multi_proof_to_numpy(proof.multi) + multi_proof_to_numpy(proof.binding_multi))}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import ethproof_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of the repository (ethproof_tpu_torch not found)",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    modes = {"--profile": phase_profile, "--memory": phase_memory,
             "--succinct": phase_succinct_alone, "--root-size": phase_root_size,
             "--cli": phase_cli, "--mesh": phase_mesh_alone, "--poseidon": phase_poseidon}
    if len(sys.argv) == 2 and sys.argv[1] in modes:
        phase_build()
        modes[sys.argv[1]](card)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (--profile, --memory, --succinct, "
              "--root-size, --cli, --mesh or --poseidon)", file=sys.stderr)
        return 2
    # the plain versions' digit matmuls run in float64, exact whatever the
    # float32 setting: every comparison below runs with TF32 allowed
    torch.backends.cuda.matmul.allow_tf32 = True
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    run("build", phase_build)
    # the CPU side of the small-proof and small-transfer comparisons runs in
    # a worker process while the card works; the pool is shut down (its
    # process ended) on exit
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_proofs = pool.submit(cpu_small_proofs)
        on_cpu = pool.submit(cpu_small_transfers)
        on_cpu_succinct = pool.submit(cpu_succinct_transfers)
        reports = [run("kernels", phase_kernels, card),
                   run("kernels_bf16", phase_kernels_bf16, card),
                   *run("poseidon", phase_poseidon, card)]
        run("adversarial", phase_adversarial, card)
        run("four_step", phase_four_step)
        run("small_proof", phase_small_proof, cpu_proofs)
        bf16_launches, memory_stark, memory_proof, memory_trace, memory_digest = run(
            "memory_2^17", phase_slice, card)
        run("mesh", phase_mesh, card, memory_trace, memory_digest)
        wrap_census = run("wrap", phase_wrap, card, memory_stark, memory_proof)
        del memory_stark, memory_proof, memory_trace
        run("small_transfer", phase_small_transfer, on_cpu)
        succinct_census = run("succinct", phase_succinct, card, on_cpu_succinct)
    _, transfer_census = run("cli", phase_cli, card)
    launches, contract_census = run("contract", phase_contract, card)
    census = dict(transfer_census)
    for shape, count in (list(contract_census.items()) + list(wrap_census.items())
                         + list(succinct_census.items())):
        census[shape] = census.get(shape, 0) + count
    run("census", phase_census, card, census)
    # base_dft: the contract path's i8 proof; base_dft_bf16: the 2^17-row
    # Memory proof's bf16 run
    launches["base_dft_bf16"] = bf16_launches
    for report in reports:
        report["launches"] = launches[report["name"]]
    print(json.dumps({"kernels": reports}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all; by phase " + json.dumps(seconds))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

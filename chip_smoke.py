#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ethproof_tpu_torch`) on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It imports
nothing of JAX and nothing of the JAX package. Phases (any failure raises
and the script exits non-zero; no phase's failure is caught):

1. build   — compile every CUDA kernel from csrc/ (one nvcc per source,
             started together) and print the build seconds and ptxas report;
2. kernels — hold each kernel against its plain PyTorch version on the card,
             bit for bit (the field is exact: the tolerance is zero), at the
             main path's sizes, and time both;
3. four-step — `best_intt` and `best_coset_lde` of a (28, 2^17) array with
             the kernel against the same with the plain base, on the card;
4. slice   — a 2^9-row Memory proof made on the card must equal, field for
             field, the one made by the plain path on the CPU; then the main
             path: a 2^17-row MemoryStark proof under `standard_fast_config`
             (launch counts reset just before it, read just after), verified
             by the port's host verifier;
5. result  — one JSON line per kernel, the card's name and power limit, and
             the last line {"ok": true, "device": {...}}.

`python3 chip_smoke.py --profile` instead builds the kernels and profiles
one 2^17-row proof (device kernels by name, idle share, layer times); it
prints no result line.

Without a CUDA card, or run outside the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

LOG_ROWS = 17  # MemoryStark floor: DEFAULT_RANGES["memory"] starts at 2^17
TRACE_COLS = 28


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
    from ethproof_tpu_torch.gf import field as gfp

    x, y = gfp.to_u64(a), gfp.to_u64(b)
    if np.array_equal(x, y):
        return 0.0
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


def phase_kernels(card: str) -> dict:
    """base_dft against base_dft_plain for log_n 1..8, both directions, at
    the main path's base-DFT call sizes (28 x 2^17 and 28 x 2^19 elements)."""
    import torch

    from ethproof_tpu_torch.gf import field as gfp
    from ethproof_tpu_torch.poly import base_dft as bd

    rng = np.random.default_rng(1)
    warm = gfp.from_u64(rng.integers(0, gfp.P, size=(8, 2), dtype=np.uint64), "cuda")
    bd.base_dft_plain(warm, 1, False)  # first-use costs stay out of the timings
    report = None
    print(f"[kernels] base_dft vs base_dft_plain on {card}; the JSON line reports the "
          f"(28*2^{LOG_ROWS + 2} / 128, 128) forward call, the coset LDE's first base level")
    for total_log in (LOG_ROWS, LOG_ROWS + 2):
        total = TRACE_COLS << total_log
        vals = gfp.from_u64(rng.integers(0, gfp.P, size=total, dtype=np.uint64), "cuda")
        for log_n in range(1, 9):
            n = 1 << log_n
            a = vals.reshape(total // n, n)
            for inverse in (False, True):
                got = bd.base_dft(a, log_n, inverse)
                want, plain_ms = timed(lambda: bd.base_dft_plain(a, log_n, inverse))
                err = max_abs_err(got, want)
                if err != 0.0:
                    raise AssertionError(f"base_dft log_n={log_n} inverse={inverse} "
                                         f"elements={total}: kernel != plain ({err})")
                ms = cuda_ms(lambda: bd.base_dft(a, log_n, inverse), 5)
                bytes_s = (16 * total + 8 * n * n) / HBM_BYTES_PER_S
                ops_s = 2 * 64 * n * total / INT8_OPS_PER_S
                bound_ms = 1e3 * max(bytes_s, ops_s)
                print(f"[kernels] elements=28*2^{total_log} shape=({total // n}, {n}) "
                      f"inverse={inverse}: equal bits; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
                      f"bound {bound_ms:.4f} ms")
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
                        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                        "library_ms": None,
                    }
        del vals
    return report


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


def phase_small_proof() -> None:
    """The card's proof of a small trace equals the CPU plain path's."""
    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.interop import proof_to_numpy
    from ethproof_tpu_torch.stark.prove import stark_prove
    from ethproof_tpu_torch.tables import memory as mem

    config = standard_fast_config()
    trace = mem.generate_trace(memory_ops(300, seed=3), 1 << 9)
    on_card = proof_to_numpy(stark_prove(mem.MemoryStark(), trace, [], config, device="cuda"))
    on_cpu = proof_to_numpy(stark_prove(mem.MemoryStark(), trace, [], config, device="cpu"))

    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, list):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        if isinstance(x, np.ndarray):
            return np.array_equal(x, y)
        return x == y

    if not same(on_card, on_cpu):
        raise AssertionError("the card's 2^9-row Memory proof differs from the CPU's")
    print("[slice] 2^9-row Memory proof: card and CPU plain path agree field for field")


def phase_slice(card: str) -> int:
    import torch

    from ethproof_tpu_torch.fri.config import standard_fast_config
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bd.LAUNCHES = 0
    t0 = time.perf_counter()
    proof = stark_prove(stark, trace, [], config, device="cuda", phase_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bd.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches <= 0:
        raise AssertionError("the main path launched no base_dft kernel")
    print(f"[slice] prove 2^{LOG_ROWS} rows on {card}: {wall:.3f} s, base_dft launches "
          f"{launches}, peak device memory {peak_gb:.2f} GB")
    print("[slice] phase seconds " + json.dumps({k: round(v, 4) for k, v in times.items()}))
    t0 = time.perf_counter()
    ok = stark_verify(stark, proof, config, device="cuda")
    print(f"[slice] port stark_verify: {ok} in {time.perf_counter() - t0:.2f} s")
    if not ok:
        raise AssertionError("the 2^17-row Memory proof does not verify")
    return launches


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
    if sys.argv[1:] == ["--profile"]:
        phase_build()
        phase_profile(card)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (only --profile)", file=sys.stderr)
        return 2
    phase_build()
    report = phase_kernels(card)
    phase_four_step()
    phase_small_proof()
    report["launches"] = phase_slice(card)
    print(json.dumps({"kernels": [report]}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

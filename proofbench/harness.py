"""One run of one cell: set-up, the window, the check, the result line.

The system under test is the program's `stark_prove` (named in the
configuration's file) on one table, with the CTL instances that the
program's CTL wiring gives that table, over `num_challenges` (beta, gamma)
pairs drawn from the seed. The run:

1. set-up: builds the program's table, one warm proof at the cell's size
   (kernels load or build, the table's sweep program is recorded), then
   the traffic's `proofs` traces for the window, each made from the seed;
2. the window: a closed loop of one prover, whole proofs back to back,
   each of its own trace; another starts only while the elapsed time plus
   the mean proof so far stays within `seconds`; at least one runs; the
   window runs from the first start to the last completion, and proves
   no more than the traffic's `proofs`;
3. the check: one proof of the window, drawn from the seed, against the
   plain reference's proof of the same trace and challenges, after the
   program's state is freed;
4. the metrics, read by the cell's metric files from the run record.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from . import check, spec


def _attr(path: str):
    mod, _, name = path.partition(":")
    return getattr(importlib.import_module(mod), name)


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float = 0.0
    window_s: float = 0.0
    proof_times: List[float] = field(default_factory=list)
    window_peak_bytes: int = 0
    phase_times: List[Dict[str, float]] = field(default_factory=list)
    census: Dict[tuple, int] = field(default_factory=dict)  # base_dft launches in the window
    trace: Optional[object] = None  # trace_reader.DeviceTrace of a --trace 1 run

    @property
    def proofs(self) -> int:
        return len(self.proof_times)


def closed_loop(step: Callable[[int], object], items: int, seconds: float,
                clock: Callable[[], float] = time.perf_counter):
    """Run step(0), step(1), ... back to back: another starts only while the
    elapsed time plus the mean step so far stays within `seconds`, and only
    while an item is left; at least one runs. -> (window seconds from the
    first start to the last completion, [seconds of each step], [results])."""
    times, out = [], []
    t0 = clock()
    while len(times) < items:
        if times and (clock() - t0) + sum(times) / len(times) > seconds:
            break
        s = clock()
        out.append(step(len(times)))
        times.append(clock() - s)
    return clock() - t0, times, out


class Program:
    """The system under test for one configuration, on `device`."""

    def __init__(self, config: dict, device: str, fri_overrides: Optional[dict] = None):
        p = config["program"]
        self.device = device
        self.prove = _attr(p["prove"])
        self.stark = _attr(p["stark"])()
        self.ctl_instance = _attr(p["ctl_instance"])
        ctls = _attr(p["ctls"])(_attr(p["cpu_stark"])([], 0))
        t = p["table"]
        # the table's sides of every CTL, ctl by ctl, looking before looked
        self.specs = [sp for ctl in ctls for (tt, sp) in (*ctl.looking, ctl.looked) if tt == t]
        cfg = _attr(p["stark_config"])()
        if fri_overrides:
            cfg = dataclasses.replace(cfg, fri_config=dataclasses.replace(cfg.fri_config,
                                                                          **fri_overrides))
        self.config = cfg
        fri = cfg.fri_config
        seen = {"security_bits": cfg.security_bits, "num_challenges": cfg.num_challenges,
                **{k: getattr(fri, k) for k in config["stark_config"] if hasattr(fri, k)}}
        want = {**config["stark_config"], **(fri_overrides or {})}
        if seen != want:
            raise ValueError(f"the program's StarkConfig {seen} is not the configuration's {want}")
        if self.stark.num_columns != config["num_columns"]:
            raise ValueError(f"the program's table has {self.stark.num_columns} columns, "
                             f"the configuration {config['num_columns']}")

    def instances(self, pairs):
        return [self.ctl_instance(s, b, g) for s in self.specs for (b, g) in pairs]

    def __call__(self, trace, pairs, phase_times=None):
        return self.prove(self.stark, trace, [], self.config, ctl_instances=self.instances(pairs),
                          device=self.device, phase_times=phase_times)


class Reference:
    """The plain reference prover of `proofbench/reference` for one configuration."""

    def __init__(self, config: dict, module, device: str, fri_overrides: Optional[dict] = None):
        from .reference.fri.config import FriConfig, StarkConfig
        from .reference.stark import prove as rprove
        from .reference.stark.stark import CtlInstance

        sc = dict(config["stark_config"])
        sc.update(fri_overrides or {})
        top = {k: sc.pop(k) for k in ("security_bits", "num_challenges")}
        self.config = StarkConfig(fri_config=FriConfig(**sc), **top)
        self.stark = module.reference_stark()
        self.specs = module.reference_ctl_specs(self.stark)
        self.device = device
        self._prove, self._instance = rprove.stark_prove, CtlInstance

    def __call__(self, trace, pairs):
        inst = [self._instance(s, b, g) for s in self.specs for (b, g) in pairs]
        return self._prove(self.stark, trace, [], self.config, ctl_instances=inst,
                           device=self.device)


class Inputs:
    """The run's inputs from its seed: traces of the traffic's size from the
    configuration's maker, and per proof `num_challenges` (beta, gamma)
    pairs; the i-th trace and pair list depend only on the seed and i."""

    def __init__(self, cell: spec.Cell, seed: int):
        tr_seed, ch_seed, self.pick_seed = np.random.SeedSequence(seed % (1 << 64)).spawn(3)
        t = cell.traffic
        self.maker = cell.module.maker(np.random.default_rng(tr_seed), t["log_rows"], t["fill"],
                                       t.get("mix"), **cell.config.get("maker", {}),
                                       **t.get("maker", {}))
        self.challenges = np.random.default_rng(ch_seed)
        self.k = cell.config["stark_config"]["num_challenges"]

    def next(self):
        pairs = [tuple(int(v) for v in self.challenges.integers(0, 0xFFFFFFFF00000001, 2,
                                                                dtype=np.uint64))
                 for _ in range(self.k)]
        return self.maker.trace(), pairs

    def pick(self, n: int) -> int:
        return int(np.random.default_rng(self.pick_seed).integers(0, n))


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _census(config: dict) -> Dict[tuple, int]:
    """The program's base-DFT launch counter, (kernel, rows, n, inverse) -> launches."""
    return dict(_attr(config["program"]["census"]))


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: Optional[float] = None, fri_overrides: Optional[dict] = None,
             program_factory: Callable = Program, log: Callable[[str], None] = print) -> dict:
    """One run -> {"correct", "attempted", "failed", "metrics", "device",
    ["breakdown"], "checks"}: the result line's keys, "checks" last."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device.startswith("cuda")
    marks = [time.perf_counter()]
    inputs = Inputs(cell, seed)
    program = program_factory(cell.config, device, fri_overrides)
    warm_trace, warm_pairs = inputs.next()
    marks.append(time.perf_counter())

    # set-up: one warm proof at the cell's size, then the window's traces
    program(warm_trace, warm_pairs)
    _sync(device)
    del warm_trace
    marks.append(time.perf_counter())
    count = int(cell.traffic["proofs"])
    items = [inputs.next() for _ in range(count)]
    marks.append(time.perf_counter())
    run = Run()
    run.setup_s = marks[-1] - t_start
    start, build, warm, traces = (b - a for a, b in zip([t_start] + marks, marks))
    log(f"set-up {run.setup_s:.3f} s: start {start:.3f} s (imports, the card), program and "
        f"warm trace {build:.3f} s, warm proof {warm:.3f} s, {count} traces {traces:.3f} s")

    # the window
    memory_peak = 0
    if on_card:
        _sync(device)
        memory_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    census0 = _census(cell.config)
    failed = []

    def step(i):
        trace, pairs = items[i]
        times = {} if traced else None
        try:
            proof = program(trace, pairs, phase_times=times)
            _sync(device)
        except Exception as exc:  # a failed proof counts against `correct`
            failed.append(repr(exc))
            raise
        if times is not None:
            run.phase_times.append({k: v for k, v in times.items() if isinstance(v, float)})
        return proof

    prof = sampler = None
    if traced and on_card:
        from torch.profiler import ProfilerActivity, profile

        from . import trace_reader

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        sampler = trace_reader.HostSampler()
        sampler.start()
    w_ns = time.time_ns()
    try:
        run.window_s, run.proof_times, proofs = closed_loop(step, len(items), seconds)
    except Exception:
        run.window_s, proofs = 0.0, []
    w_ns = (w_ns, time.time_ns())
    if prof is not None:
        sampler.stop()
        r0 = time.perf_counter()
        prof.__exit__(None, None, None)
        r1 = time.perf_counter()
        run.trace = trace_reader.read(prof, w_ns, sampler)
        del prof
        log(f"trace: {len(run.trace.dev_name)} device ops, {len(run.trace.host_labels)} host "
            f"samples, busy {run.trace.busy_s():.3f} s of {run.trace.window_s:.3f} s; profiler "
            f"stop {r1 - r0:.1f} s, read {time.perf_counter() - r1:.1f} s")
    run.census = {k: v - census0.get(k, 0) for k, v in _census(cell.config).items()
                  if v - census0.get(k, 0)}
    if on_card:
        run.window_peak_bytes = torch.cuda.max_memory_allocated()
        memory_peak = max(memory_peak, run.window_peak_bytes)
    log(f"window {run.window_s:.3f} s, {len(proofs)} proofs {[round(t, 3) for t in run.proof_times]}")

    # the check: one proof drawn from the seed against the reference's
    attempted = len(proofs) + len(failed)
    proofs_done = len(proofs)
    numbers = {g: 0 for g in check.LIMITS}
    if proofs:
        i = inputs.pick(len(proofs))
        trace, pairs = items[i]
        got = proofs[i]
        del program, proofs, items
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        c0 = time.perf_counter()
        want = Reference(cell.config, cell.module, device, fri_overrides)(trace, pairs)
        log(f"reference proof of window proof {i}: {time.perf_counter() - c0:.3f} s")
        numbers = check.compare(got, want)
    checks = check.judged(numbers)
    correct = bool(proofs_done) and not failed and check.passes(checks)

    metrics = spec.read_metrics(cell.per_layer if traced else cell.end_to_end, run)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": memory_peak}
    out = {"correct": correct, "attempted": attempted, "failed": len(failed),
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    for err in failed:
        log(f"failed proof: {err}")
    out["checks"] = checks
    return out

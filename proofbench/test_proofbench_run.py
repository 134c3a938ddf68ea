"""CPU tests that drive whole runs at a tiny size: a sound run is correct, and
the control and every fault the cells can have come out not correct.

The harness's look for a card is skipped (`device="cpu"`), the tables have
2^5-2^6 rows, and the FRI proof of work and query count are cut so that a
proof takes seconds on the CPU; everything else is a run's own path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from proofbench import check, control, harness, spec

ROOT = Path(__file__).resolve().parent.parent
LIGHT = {"proof_of_work_bits": 4, "num_query_rounds": 8}
SEED = 2**31 + 101


@pytest.fixture(scope="module", autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)


def tiny(cell_name: str, log_rows: int) -> spec.Cell:
    cell = spec.load_cell(ROOT, cell_name)
    cell.traffic = dict(cell.traffic, log_rows=log_rows)
    if cell.config.get("maker"):
        cell.config = dict(cell.config, maker={"pool_rows": 32})
    return cell


def run(cell, program_factory=harness.Program):
    return harness.run_cell(cell, SEED, 0.0, False, device="cpu", fri_overrides=LIGHT,
                            program_factory=program_factory, log=lambda m: None)


def test_sound_run_is_correct():
    out = run(tiny("arithmetic.2p15", 6))
    assert out["correct"] and out["attempted"] == 1 and out["failed"] == 0
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())
    assert list(out)[-1] == "checks" and {"proof_s", "setup_s"} <= set(out["metrics"])


def test_keccak_program_equals_reference():
    cell = tiny("keccak.2p12", 5)
    trace, pairs = harness.Inputs(cell, SEED).next()
    got = harness.Program(cell.config, "cpu", LIGHT)(trace, pairs)
    want = harness.Reference(cell.config, cell.module, "cpu", LIGHT)(trace, pairs)
    assert check.compare(got, want) == {g: 0 for g in check.LIMITS}


def test_control_is_not_correct():
    out = control.readings(tiny("arithmetic.2p15", 6), SEED, "cpu", False, LIGHT)
    assert not check.passes(check.judged(out["control"]))


class _Faulty(harness.Program):
    """The program with its timed path broken underneath."""

    fault = ""

    def __call__(self, trace, pairs, phase_times=None):
        from ethproof_tpu_torch.stark import prove as prog

        if self.fault == "half_batch":  # half of the rows left out of the trace commit
            saved = prog.commit_trace

            def commit_half(tr, *a, **k):
                tr = tr.copy()
                tr[:, tr.shape[1] // 2:] = 0
                return saved(tr, *a, **k)

            prog.commit_trace = commit_half
            try:
                return super().__call__(trace, pairs, phase_times)
            finally:
                prog.commit_trace = saved
        if self.fault == "answer_altered":  # one opened value changed where it is made
            saved = prog._open_tree

            def open_altered(*a, **k):
                out = saved(*a, **k)
                out.values[0, 0] = np.uint64((int(out.values[0, 0]) + 1) % prog.P)
                return out

            prog._open_tree = open_altered
            try:
                return super().__call__(trace, pairs, phase_times)
            finally:
                prog._open_tree = saved
        raise ValueError(self.fault)


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_fault_is_not_correct(fault):
    faulty = type("F", (_Faulty,), {"fault": fault})
    out = run(tiny("arithmetic.2p15", 6), faulty)
    assert out["attempted"] == 1 and not out["correct"]
    assert not check.passes(out["checks"])

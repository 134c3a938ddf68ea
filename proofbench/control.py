"""The control of the comparison that decides `correct`, and its readings.

    python3 proofbench/control.py --workload <cell> --seeds 1 2 3 [--program 1]

For each seed it makes the inputs of a run of the cell (the first trace
of its window and its challenges), proves them with the plain reference
and with the control, and prints the comparison's numbers of the control
against the reference, one JSON line per seed; with `--program 1` also
those of the program's proof (the lower readings). The benchmark's own
runs never run this.

The control is the reference computed one precision below: its Poseidon
MDS matmul in float32 (TF32 off) where the reference's is float64, the
step that would tempt a change to the hash. It must come out not correct.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def lower_precision():
    import torch

    from proofbench.reference.hash import poseidon

    saved = (poseidon.MATMUL_DTYPE, torch.backends.cuda.matmul.allow_tf32)
    poseidon.MATMUL_DTYPE = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        poseidon.MATMUL_DTYPE, torch.backends.cuda.matmul.allow_tf32 = saved


def readings(cell, seed: int, device: str, with_program: bool, fri_overrides=None) -> dict:
    """{"seed", "control": numbers, ["program": numbers]} for one seed."""
    from proofbench import check, harness

    inputs = harness.Inputs(cell, seed)
    inputs.next()  # the warm proof's inputs
    trace, pairs = inputs.next()
    out = {"seed": seed}
    t0 = time.perf_counter()
    reference = harness.Reference(cell.config, cell.module, device, fri_overrides)
    want = reference(trace, pairs)
    out["reference_s"] = time.perf_counter() - t0
    with lower_precision():
        out["control"] = check.compare(reference(trace, pairs), want)
    if with_program:
        program = harness.Program(cell.config, device, fri_overrides)
        t0 = time.perf_counter()
        out["program"] = check.compare(program(trace, pairs), want)
        out["program_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from proofbench import spec

    cell = spec.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.device, bool(args.program))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

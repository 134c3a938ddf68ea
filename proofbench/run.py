"""Run one cell of the benchmark once and print its result line.

    python3 proofbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (`ethproof_tpu_torch/`)
and `BENCHMARK.json`. The last line of standard output is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and last `checks`: each number compared with its limit); the
last lines of standard error give the same numbers. Exit codes: 0 a
result was printed; 2 bad arguments; 3 no CUDA card, or fewer than the
cell asks for; 4 the program is not in the checkout; 5 JAX or the JAX
package was loaded; 1 anything else. Only exit 0 prints a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "ethproof_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "ethproof_tpu")


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout; the
    program's own settings cleared, so it runs its defaults."""
    cache = ROOT / ".proofbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    for key in [k for k in os.environ if k.startswith("ETHPROOF_")]:
        del os.environ[key]


def loaded_forbidden() -> list:
    """Top-level module names in sys.modules that are JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    try:
        args = ap.parse_args(argv)
    except SystemExit:
        return 2
    _caches()
    sys.path.insert(0, str(ROOT))
    from proofbench import harness, spec

    try:
        cell = spec.load_cell(ROOT, args.workload)
    except (OSError, KeyError, ValueError) as exc:
        _err(f"cannot load workload {args.workload!r}: {exc}")
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _err(f"{args.workload} needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    import importlib.util

    found = importlib.util.find_spec(PROGRAM)
    if found is None or not Path(found.origin).resolve().is_relative_to(ROOT):
        _err(f"the program ({PROGRAM}) is not in the checkout at {ROOT}")
        return 4

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_START, log=_err)
    bad = loaded_forbidden()
    if bad:
        _err(f"loaded in this process: {', '.join(bad)}; the benchmark refuses JAX and its package")
        return 5
    for name, c in result["checks"].items():
        _err(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # the run's failure: a traceback and no result line
        import traceback

        traceback.print_exc()
        code = 1
    sys.exit(code)

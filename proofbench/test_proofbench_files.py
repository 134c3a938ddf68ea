"""CPU tests of the benchmark's files, generators, window, bound and imports."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from proofbench import check, harness, peaks, spec, trace_reader

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "ethproof_tpu"}


def test_benchmark_json_names_files_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["proofbench"]
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("proofbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for name in names + cells + [m["name"] for m in metrics]:
        assert spec.NAME.match(name), name
    assert len(set(cells)) == len(cells) and len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        assert spec.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert {m.name for m in cell.end_to_end} >= {"setup_s", "proof_s"} and cell.per_layer


def _traces(cell_name: str, seed: int, log_rows: int, pool: int = 32):
    cell = spec.load_cell(ROOT, cell_name)
    cell.traffic = dict(cell.traffic, log_rows=log_rows)
    if cell.config.get("maker"):
        cell.config = dict(cell.config, maker={"pool_rows": pool})
    inputs = harness.Inputs(cell, seed)
    return [inputs.next() for _ in range(2)]


@pytest.mark.parametrize("cell_name,log_rows", [("arithmetic.2p15", 6), ("keccak.2p12", 5)])
def test_traffic_is_seeded(cell_name, log_rows):
    a, b = _traces(cell_name, 2**31 + 7, log_rows), _traces(cell_name, 2**31 + 7, log_rows)
    c = _traces(cell_name, 2**31 + 8, log_rows)
    for (ta, pa), (tb, pb) in zip(a, b):
        assert np.array_equal(ta, tb) and pa == pb
    assert not np.array_equal(a[0][0], a[1][0])  # no proof repeats an input
    assert not np.array_equal(a[0][0], c[0][0]) and a[0][1] != c[0][1]


def test_arithmetic_rows_fit_the_program_table():
    """The benchmark's copy of the table fills the program's bits for rows of
    every op drawn as the maker draws them, and the maker's traces keep every
    range-checked cell under the table's bound."""
    from ethproof_tpu_torch.tables import arithmetic as prog

    from proofbench.configs import arithmetic as A

    rng = np.random.default_rng(3)
    col = np.zeros((A.T.NUM_COLUMNS, 1), dtype=np.uint64)
    reqs = []
    for op in A.OPS.values():
        while True:
            req = A._request(rng, op, 128)
            col[:] = 0
            A.T.fill_row(col, 0, req)
            if int(col[A._RC, 0].max()) < 128:
                reqs.append(req)
                break
    # and rows with the operand lengths of the arithmetic traffic
    traffic = json.loads((HERE / "traffic" / "2p15.json").read_text())
    lengths = {op: {side: (np.asarray([int(k) for k in c]), np.asarray(list(c.values()))
                           / sum(c.values())) for side, c in sides.items()}
               for op, sides in traffic["maker"]["operand_limbs"].items()}
    for name in traffic["mix"]:
        for _ in range(4):
            while True:
                req = A._request(rng, A.OPS[name], 128, lengths[name])
                col[:] = 0
                A.T.fill_row(col, 0, req)
                if int(col[A._RC, 0].max()) < 128:
                    reqs.append(req)
                    break
    want, want_res = prog.generate_trace(reqs, 128)
    got, got_res = A.T.generate_trace(reqs, 128)
    assert np.array_equal(got, want) and got_res == want_res
    tr = A.maker(np.random.default_rng(4), 7, 1.0, None, pool_rows=16).trace()
    cols = np.asarray(prog.RANGE_CHECKED, dtype=np.intp)
    assert int(tr[cols].max()) < 128 and int(tr[prog.RC_MULT].sum()) == cols.size * 128


def test_traffic_sources_its_counts():
    """The traffic files hold the counts of the program's own transaction
    proofs that `count_traffic.py` prints (checked against its output)."""
    t15 = json.loads((HERE / "traffic" / "2p15.json").read_text())
    t12 = json.loads((HERE / "traffic" / "2p12.json").read_text())
    assert int(t15["fill"] * 2**15) == sum(t15["mix"].values()) == 31888
    assert set(t15["maker"]["operand_limbs"]) == set(t15["mix"])
    for op, sides in t15["maker"]["operand_limbs"].items():
        assert sum(sides["a"].values()) == sum(sides["b"].values()) == t15["mix"][op]
    assert int(t12["fill"] * 2**12) // 24 == 164
    assert t15["proofs"] == 1 and t12["proofs"] == 2


def test_setup_makes_the_traffics_traces(monkeypatch):
    """Set-up makes the warm trace and the traffic's `proofs` traces, however
    long the warm proof takes."""
    cell = spec.load_cell(ROOT, "keccak.2p12")
    cell.traffic = dict(cell.traffic, log_rows=5)
    made = []
    nxt = harness.Inputs.next
    monkeypatch.setattr(harness.Inputs, "next", lambda self: made.append(1) or nxt(self))

    class Fake:  # the warm proof passes; the window's first proof fails
        def __init__(self, *args):
            self.calls = 0

        def __call__(self, trace, pairs, phase_times=None):
            self.calls += 1
            if self.calls > 1:
                raise RuntimeError("stop")

    out = harness.run_cell(cell, 2**31 + 9, 51.0, False, device="cpu", program_factory=Fake,
                           log=lambda m: None)
    assert len(made) == 1 + cell.traffic["proofs"]
    assert not out["correct"] and out["attempted"] == out["failed"] == 1


def test_window_rule_with_a_fake_step():
    now = [0.0]

    def clock():
        return now[0]

    def stepper(durations):
        def step(i):
            now[0] += durations[i]
            return i
        return step

    # whole proofs: the third would end past 51 s, so it does not start
    assert harness.closed_loop(stepper([20, 20, 20, 20]), 4, 51, clock) == (40, [20, 20], [0, 1])
    now[0] = 0.0  # one proof longer than the window still runs, alone
    assert harness.closed_loop(stepper([70, 70]), 2, 51, clock) == (70, [70], [0])
    now[0] = 0.0  # a zero-second window runs one
    assert harness.closed_loop(stepper([5, 5]), 2, 0, clock)[1] == [5]
    now[0] = 0.0  # no more than the items made
    assert harness.closed_loop(stepper([1, 1, 1]), 3, 51, clock) == (3, [1, 1, 1], [0, 1, 2])


def test_base_dft_bound():
    s, what = peaks.base_dft_bound(114688, 128, "base_dft_kernel")
    assert round(s * 1e3, 4) == 0.1215 and what == "operations"


def test_trace_reader_busy_idle_and_names():
    ns = 10**9
    tr = trace_reader.DeviceTrace(
        window=(0, 10 * ns),
        dev_start=np.asarray([1, 2, 6]) * ns, dev_end=np.asarray([3, 4, 7]) * ns,
        dev_name=["k_a", "Memcpy HtoD", "k_b"],
        host_times=np.asarray([0, 5, 8, 9]) * ns // 1 + 1,
        host_labels=["a.py:f", "fri/challenger.py:observe", "b.py:g", "b.py:g"])
    assert tr.busy_s() == 4.0 and tr.window_s == 10.0 and tr.kernel_count() == 2
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps[0] == ["b.py:g", 3.0] and ["fri/challenger.py:observe", 2.0] in gaps
    assert gaps[-1] == ["a.py:f", 1.0]


def test_host_sampler_names_program_frames():
    import threading

    sampler = trace_reader.HostSampler(interval=0.001)
    sampler.target = threading.get_ident()
    sampler.start()
    from ethproof_tpu_torch.gf import field_host

    deadline = __import__("time").perf_counter() + 0.3
    while __import__("time").perf_counter() < deadline:
        field_host.inv(12345)
    sampler.stop()
    assert any("gf/field_host.py:" in label for label in sampler.labels)


def test_comparison_counts_differences():
    from proofbench.reference.stark.prove import StarkOpenings

    o = StarkOpenings(*(np.zeros((3, 2), dtype=np.uint64) for _ in range(5)))
    o2 = StarkOpenings(*(np.zeros((3, 2), dtype=np.uint64) for _ in range(5)))
    o2.aux_at_zeta[1, 0] = 5
    assert check._diff(o2, o) == 1 and check._diff(o, o) == 0
    assert check._diff(None, o) == 32 and check._diff([1, 2], [1, 2, 3]) == 3


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import proofbench.run, proofbench.harness, proofbench.control; "
            "from proofbench import spec; import json; root = __import__('pathlib').Path(sys.argv[1]); "
            "[spec.load_cell(root, w['name']) for w in "
            "json.loads((root / 'BENCHMARK.json').read_text())['workloads']]; "
            "import ethproof_tpu_torch.stark.prove; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, check=True).stdout.split()
    assert not set(out) & FORBIDDEN and "ethproof_tpu_torch" in out


def test_cell_config_traffic_and_metric_are_added_as_files(tmp_path):
    """A new configuration, traffic mix, metric and cell: new files and a new
    BENCHMARK.json entry, no existing file edited."""
    shutil.copytree(HERE, tmp_path / "proofbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "proofbench"
    (pb / "configs" / "arith_copy.json").write_text(
        json.dumps(dict(json.loads((pb / "configs" / "arithmetic.json").read_text()),
                        name="arith_copy", maker={"pool_rows": 16})))
    (pb / "configs" / "arith_copy.py").write_text("from .arithmetic import *  # noqa: F401,F403\n"
                                                  "from .arithmetic import maker  # noqa: F401\n")
    (pb / "traffic" / "tiny.json").write_text(json.dumps({"name": "tiny", "log_rows": 15,
                                                          "fill": 0.5, "proofs": 1,
                                                          "mix": {"ADD": 1}}))
    (pb / "metrics" / "proofs_in_window.py").write_text("def read(run):\n    return run.proofs\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="arith_copy",
                                 file="proofbench/configs/arith_copy.json"))
    bench["workloads"].append({"name": "arith_copy.tiny", "config": "arith_copy",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "proofs_in_window", "unit": "proofs", "better": "higher",
                               "source": "host_clock", "layer": "Window", "moves": "proof_s",
                               "workloads": ["arith_copy.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from pathlib import Path; "
            "from proofbench import spec, harness; "
            "cell = spec.load_cell(Path(sys.argv[1]), 'arith_copy.tiny'); "
            "cell.traffic['log_rows'] = 6; "
            "tr, pairs = harness.Inputs(cell, 5).next(); "
            "run = harness.Run(proof_times=[1.0, 2.0]); "
            "print(tr.shape, spec.read_metrics(cell.per_layer, run), "
            "cell.module.__name__)")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, cwd=tmp_path, check=True).stdout
    assert "(430, 64)" in out and "'proofs_in_window': {'value': 2" in out
    assert "proofbench.configs.arith_copy" in out

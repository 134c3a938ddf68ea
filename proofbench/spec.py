"""What the benchmark runs, read from files by name.

`BENCHMARK.json` (at the checkout's root) names the cells. A cell
`<config>.<traffic>` finds its configuration in `configs/<config>.json`
with its code, the plain reference table and trace maker, in
`configs/<config>.py`; its traffic in `traffic/<traffic>.json`; and each
metric it reports in `metrics/<metric>.py`, a module with
`read(run) -> float | None`. Adding a cell, a configuration, a traffic mix
or a metric is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    read: Callable
    bound: Optional[float] = None
    workloads: Optional[List[str]] = None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    module: object  # configs/<config>.py
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_reader(name: str) -> Callable:
    """`read` of metrics/<name>.py, loaded from its file."""
    path = HERE / "metrics" / f"{check_name(name, 'metric')}.py"
    spec = importlib.util.spec_from_file_location(f"proofbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def config_module(name: str):
    return importlib.import_module(f"{__package__}.configs.{check_name(name, 'config')}")


def _metrics(entries: List[dict]) -> List[Metric]:
    out = []
    for m in entries:
        unit = m["unit"]
        if not UNIT.match(unit):
            raise ValueError(f"metric {m['name']}: unit {unit!r} is not valid")
        if m["better"] not in ("lower", "higher"):
            raise ValueError(f"metric {m['name']}: better must be lower or higher")
        out.append(Metric(check_name(m["name"], "metric"), unit, m["better"], m["source"],
                          metric_reader(m["name"]), m.get("bound"), m.get("workloads")))
    return out


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files."""
    bench = load_json(Path(root) / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{check_name(entry['config'], 'config')}.json")
    traffic = load_json(HERE / "traffic" / f"{check_name(entry['traffic'], 'traffic')}.json")
    if traffic["log_rows"] < config["min_log_rows"]:
        raise ValueError(f"{name}: {traffic['log_rows']} row bits is under the configuration's "
                         f"{config['min_log_rows']}")
    e2e = [m for m in _metrics(bench["end_to_end"]) if m.applies(name)]
    layer = [m for m in _metrics(bench["per_layer"]) if m.applies(name)]
    return Cell(name, int(entry["chips"]), config, traffic, config_module(entry["config"]),
                e2e, layer)


def read_metrics(metrics: List[Metric], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds something."""
    out = {}
    for m in metrics:
        value = m.read(run)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out

"""Everything a run needs, found by name.

A cell is an entry of BENCHMARK.json's `workloads`; it names a
configuration (an entry of `configs`, whose `file` holds the sizes) and a
traffic mix (`benchmark/traffic/<mix>.json`, parameters that the general
driver `benchmark/drivers/<driver>.py` named in it reads). The cell's own
data (the work counted for `mfu`, the limits of the comparison) is
`benchmark/cells/<cell>.json`. A metric is read by
`benchmark/metrics/<metric>.py`. Adding a configuration, a mix, a metric
or a cell adds files and entries; no file here names one of them.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(s: str, what: str) -> str:
    if not isinstance(s, str) or not NAME.match(s):
        raise ValueError(f"{what} {s!r} is not a valid name")
    return s


def _json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, tag: str):
    """The Python file `path` as a module (file names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(f"_bench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of BENCHMARK.json with what its names point to."""
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]       # the configuration file
    mix_name: str
    mix: Dict[str, Any]          # the traffic file
    data: Dict[str, Any]         # benchmark/cells/<cell>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        return self.per_layer if trace else self.end_to_end

    def driver(self):
        """The general driver module the mix names."""
        return _module(self.bench_dir / "drivers" / f"{_name(self.mix['driver'], 'driver')}.py",
                       f"driver_{self.mix['driver']}")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench_dir: Optional[Path] = None) -> Cell:
    """The cell `name` of root/BENCHMARK.json."""
    bench_dir = bench_dir or root / "benchmark"
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[_name(w["config"], "config")]
    return Cell(name=_name(name, "workload"), chips=int(w["chips"]), config_name=conf["name"],
                config=_json(root / conf["file"]),
                mix_name=_name(w["traffic"], "traffic"),
                mix=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                data=_json(bench_dir / "cells" / f"{name}.json"),
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
                bench_dir=bench_dir)


def metric_module(name: str, bench_dir: Path = BENCH_DIR):
    """benchmark/metrics/<name>.py: read(record), the metric or None, and
    optionally samples(record), how many items the number was read from."""
    return _module(bench_dir / "metrics" / f"{_name(name, 'metric')}.py", f"metric_{name}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """read(record) of benchmark/metrics/<name>.py."""
    return metric_module(name, bench_dir).read

"""Finds a cell's pieces by name: BENCHMARK.json at the checkout's root, then
the configuration file it names, the traffic file `traffic/<traffic>.json`,
the limits file `limits/<cell>.json`, the entry driver
`entries/<entry>.py` that the configuration names, and one reader
`metrics/<metric>.py` for each per-layer metric. A later change adds a
cell, a configuration or a metric by adding files; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "port_bench"

# the characters the benchmark's contract allows in a name and in a unit
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def valid_name(name: str) -> bool:
    return isinstance(name, str) and NAME_RE.fullmatch(name) is not None


def valid_unit(unit: str) -> bool:
    return isinstance(unit, str) and UNIT_RE.fullmatch(unit) is not None


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text("utf-8"))


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(cells)}")
        self.name, self.workload = name, cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads((root / self.config_entry["file"]).read_text("utf-8"))
        here = root / "port_bench"
        self.traffic = json.loads((here / "traffic" / f"{self.workload['traffic']}.json")
                                  .read_text("utf-8"))
        self.limits = json.loads((here / "limits" / f"{name}.json").read_text("utf-8"))
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
        self.here = here

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def entry(self) -> ModuleType:
        return importlib.import_module(f"port_bench.entries.{self.config['entry']}")

    def readers(self) -> Dict[str, Callable]:
        """metric name -> its reader's `read(reading)`."""
        out = {}
        for m in self.per_layer:
            path = self.here / "metrics" / f"{m['name']}.py"
            spec = importlib.util.spec_from_file_location(f"port_bench_metric_{m['name']}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out[m["name"]] = mod.read
        return out


def metric_files(here: Path = HERE) -> List[str]:
    return sorted(p.name[:-3] for p in (here / "metrics").glob("*.py"))

"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's
root, a cell's configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``) and limits (``limits/<cell>.json``), and the
readers of its per-layer metrics (``metrics/<metric>.py``, each with a
``read(trace)`` that returns a number or None). A new cell, mix or metric
is new files and a new entry in ``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # tunebench/
ROOT = HERE.parent                                  # the checkout


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"({', '.join(sorted(cells))})")
        self.spec = cells[name]
        self.name = name
        self.bench = bench
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root / configs[self.spec["config"]]["file"])
        here = root / "tunebench"
        self.traffic = load_json(here / "traffic" /
                                 f"{self.spec['traffic']}.json")
        self.limits = load_json(here / "limits" / f"{name}.json")
        self.here = here

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read``."""
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"tunebench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

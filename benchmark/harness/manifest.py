"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is the file its entry names; a traffic mix is
``traffic/<traffic>.json``; a cell's limits for ``correct`` are
``limits/<cell>.json``; a per-layer metric's reader is
``metrics/<metric>.py`` (a ``read(trace)`` function); a traffic mix's driver
is ``drivers/<driver>.py``, the ``driver`` its file names.  A later cell,
configuration or metric is a new file and a new entry: nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(self.cells)}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        with open(self.root / self.configs[name]["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.bench / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, cell: str) -> Dict[str, float]:
        with open(self.bench / "limits" / f"{cell}.json") as f:
            return json.load(f)["limits"]

    def driver(self, name: str):
        return importlib.import_module(f"benchmark.drivers.{name}")

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics read in this cell's traced run: those whose
        ``workloads`` list it (every per-layer entry has the list)."""
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]

    def metric(self, name: str) -> Optional[dict]:
        for m in self.data["end_to_end"] + self.data["per_layer"]:
            if m["name"] == name:
                return m
        return None

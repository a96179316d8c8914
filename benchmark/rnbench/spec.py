"""``BENCHMARK.json`` and the files it names, found by name.

- a cell's configuration: the ``file`` of its ``configs`` entry;
- a cell's traffic: ``benchmark/traffic/<traffic>.json``;
- a cell's correctness limits: ``benchmark/limits/<cell>.json``;
- a per-layer metric's reader: ``benchmark/metrics/<metric>.py``, which
  declares ``LAYER``, ``UNIT``, ``MOVES`` and ``SOURCE`` and defines
  ``read(run) -> float | None``.

All paths are relative to the root that holds ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {c["name"]: c for c in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name: str) -> Dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(self.cells)}")
        return self.cells[name]

    def config(self, cell: Dict) -> Dict:
        return json.loads((self.root / self.configs[cell["config"]]["file"]).read_text())

    def traffic(self, cell: Dict) -> Dict:
        return json.loads((self.root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())

    def limits(self, cell: Dict) -> Dict[str, float]:
        return json.loads((self.root / "benchmark" / "limits" / f"{cell['name']}.json").read_text())

    @staticmethod
    def _applies(metric: Dict, cell: Dict) -> bool:
        return "workloads" not in metric or cell["name"] in metric["workloads"]

    def end_to_end(self, cell: Dict) -> List[Dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: Dict) -> List[Dict]:
        return [m for m in self.data["per_layer"] if self._applies(m, cell)]

    def reader(self, metric: Dict) -> ModuleType:
        """The metric's reader, checked against its entry in BENCHMARK.json."""
        path = self.root / "benchmark" / "metrics" / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(f"metric_reader_{metric['name']}", path)
        if spec is None:
            raise FileNotFoundError(path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        for key, attr in (("layer", "LAYER"), ("unit", "UNIT"), ("moves", "MOVES"),
                          ("source", "SOURCE")):
            if getattr(module, attr) != metric[key]:
                raise ValueError(f"{path}: {attr} {getattr(module, attr)!r} but BENCHMARK.json says "
                                 f"{metric[key]!r}")
        return module

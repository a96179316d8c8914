"""Every cell of BENCHMARK.json resolves to its files by name, and every
per-layer metric's reader agrees with its entry.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "benchmark"))

from rnbench.spec import Spec  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    spec = Spec(REPO)
    c = spec.cell(cell)
    cfg, traffic, limits = spec.config(c), spec.traffic(c), spec.limits(c)
    assert traffic["driver"] in ("predict", "train")
    assert int(traffic.get("world", 1)) == c["chips"]
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    assert cfg["name"] == c["config"]
    fam = spec.family(cfg)  # exactly one trunk family claims the kind
    assert len(fam.out_channels(cfg["model"])) == 3
    assert callable(spec.optimizer(cfg).update)
    e2e = {m["name"] for m in spec.end_to_end(c)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(c)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_match_their_entries(metric):
    spec = Spec(REPO)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = spec.reader(entry)
    assert callable(reader.read)
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == entry["moves"])
    assert set(entry["workloads"]) <= set(moved.get("workloads", entry["workloads"]))


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= max(1, len(pairs) // 4)
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024

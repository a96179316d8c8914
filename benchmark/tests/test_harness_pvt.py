"""The PVT v2 trunk family (``families/pvt_v2.py``) in the harness, on the
CPU: found by its kind, its FLOP count against the operations its trunk
runs, the program's score counter against the family's count, and a
toy-size cell of the family (pvt_v2_b2 at its published widths, 128x192,
f32, the configuration's AdamW) that reads ``correct`` on one rank and on
two, and fails the cell's limits under the fp8 control.

    python -m pytest benchmark/tests/test_harness_pvt.py -q
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
for p in (str(HERE), str(REPO / "benchmark"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import toy  # noqa: E402
from rnbench import spans  # noqa: E402
from rnbench.spec import Spec, _load  # noqa: E402

PVT = json.loads((REPO / "benchmark/configs/pvtv2_b2_fpn.json").read_text())
LIMITS = json.loads((REPO / "benchmark/limits/pvtv2_b2_train_b16.json").read_text())
TOY = {**PVT, "name": "toy_pvt", "model": {**PVT["model"], "min_size": 128, "max_size": 192,
                                           "compute_dtype": "float32"}}
CELLS = {"toy_pvt_train_cell": ("toy_train", 1), "toy_pvt_ddp2_cell": ("toy_ddp2", 2)}
NEW_METRICS = ("attention_span_ms.train", "ffn_span_ms.train", "sra_roofline.train")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The toy root, and as new files the toy PVT configuration, its cells
    and their limits (the PVT cell's)."""
    root = toy.write_root(tmp_path_factory.mktemp("bench"))
    (root / "benchmark/configs/toy_pvt.json").write_text(json.dumps(TOY))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_pvt", "source": "toy", "reduced": [], "why": "toy",
                             "file": "benchmark/configs/toy_pvt.json"})
    for cell, (traffic, chips) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": "toy_pvt", "traffic": traffic, "chips": chips,
                                   "why": "toy"})
        (root / f"benchmark/limits/{cell}.json").write_text(json.dumps(LIMITS))
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"] += list(CELLS)
    for m in bench["per_layer"]:
        if m["name"] in NEW_METRICS:
            m["workloads"].append("toy_pvt_train_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_family_is_found_by_its_kind_and_no_other_file_claims_it():
    fam = Spec(REPO).family(PVT)
    assert Path(fam.__file__).name == "pvt_v2.py"
    claims = [p.name for p in sorted((REPO / "benchmark/families").glob("*.py"))
              if "pvt_v2_b2" in _load(p, "claim_").KINDS]
    assert claims == ["pvt_v2.py"]
    assert fam.BUFFERS == frozenset() and fam.out_channels(PVT["model"]) == (128, 320, 512)


def test_trunk_flops_count_every_conv_linear_and_attention_matmul(monkeypatch):
    fam = Spec(REPO).family(PVT)
    m = PVT["model"]
    h, w = 256, 384
    seen = []
    real_conv, real_conv2d, real_matmul = fam.conv, fam.conv2d, fam.matmul

    def conv(x, wt, b=None, stride=1, q=None):
        y = real_conv(x, wt, b, stride, q)
        seen.append(2 * y[0].numel() * wt[0].numel())
        return y

    def conv2d(x, wt, b, stride, pad, groups, q=None):
        y = real_conv2d(x, wt, b, stride, pad, groups, q)
        seen.append(2 * y[0].numel() * wt[0].numel())
        return y

    def matmul(a, b, q=None):
        y = real_matmul(a, b, q)
        seen.append(2 * y[0].numel() * a.shape[-1])
        return y

    for name, spy in (("conv", conv), ("conv2d", conv2d), ("matmul", matmul)):
        monkeypatch.setattr(fam, name, spy)
    sd = {k: (torch.ones(s) if role == "ln.weight" else torch.zeros(s)) for k, s, role in fam.schema(m)}
    with torch.no_grad():
        c3, c4, c5 = fam.trunk(sd, torch.zeros(1, 3, h, w), m)
    assert [tuple(c.shape[2:]) for c in (c3, c4, c5)] == [(h // s, w // s) for s in (8, 16, 32)]
    # The patch embeddings; q, kv, proj, fc1, dwconv, fc2 and 2 matmuls a block; 13 reductions.
    assert len(seen) == 4 + 16 * 8 + 13
    assert fam.trunk_flops(h, w, m) == sum(seen)


def _run(root: Path, cell: str):
    """An untraced run of `cell`, as ``run.py`` hands it to the readers."""
    import run as bench_run
    from rnbench import train

    spec = Spec(root)
    c = spec.cell(cell)
    cfg, traffic = spec.config(c), spec.traffic(c)
    ctx = bench_run.Context(cfg, traffic, argparse.Namespace(seed=3, seconds=0.5, trace=0),
                            torch.device("cpu"), time.time(), spec)
    ctx.rank_hook = None
    out = train.run(ctx)
    run = {"e2e": out["e2e"], "trace": {}, "spans": out.get("spans") or {},
           "counters": out.get("counters") or {}, "cfg": cfg, "traffic": traffic, "batch": out["batch"],
           "bucket": out["bucket"], "world": int(c["chips"]), "device_name": "cpu", "root": str(root),
           "family": ctx.family}
    return spec, c, run, out


def test_the_score_counter_is_the_familys_count_and_the_new_readers_read_the_pass(root):
    spec, c, run, out = _run(root, "toy_pvt_train_cell")
    assert all(out["checks"][k] <= v for k, v in LIMITS.items()), out["checks"]
    result = spans.program_pass(run)
    h, w = run["bucket"]
    per_step = result["records"]["counters"]["attention.score_elems"] / result["steps"]
    assert per_step == run["family"].score_elems(h, w, run["batch"])
    read = {m["name"]: spec.reader(m).read(run) for m in spec.per_layer(c) if m["name"] in NEW_METRICS}
    assert read["attention_span_ms.train"] > 0 and read["ffn_span_ms.train"] > 0
    assert read["sra_roofline.train"] is None  # no peaks on the CPU


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_toy_cell_of_the_family_reads_correct(root, cell):
    rc, res, err = toy.run_cell(root, cell)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert set(res["checks"]) == set(LIMITS)
    assert "read grad_gap" in err  # printed, not compared


def test_the_control_fails_the_cells_limits(root, capsys):
    import control

    control.main(["--workload", "toy_pvt_train_cell", "--seeds", "1", "2", "--device", "cpu",
                  "--root", str(root)])
    for line in capsys.readouterr().out.strip().splitlines():
        read = json.loads(line)["arms"]
        for arm in ("fp8", "half", "unchanged"):
            assert any(v > LIMITS[k] for k, v in read[arm].items()), (arm, read[arm], LIMITS)

"""A toy benchmark written as new files into a temporary root: resnet18 at
a 128x192 bucket, f32 (this PyTorch's CPU bf16 goes non-finite), predict
cells and training cells, run through ``benchmark/run.py`` on the CPU with
the kernels' plain versions. Beside them, as new files too: a trunk family
that the repository lacks (:data:`FAMILY`, ResNet-34) with its own
configuration and cells, and a training cell under AdamW."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

MODEL = {"backbone_kind": "resnet18", "num_classes": 4, "min_size": 128, "max_size": 192,
         "freeze_bn": True, "compute_dtype": "float32", "prior": 0.01, "pre_nms_top_k": 1000,
         "score_thres": 0.05, "nms_thres": 0.5, "max_detections": 100}
CONFIG = {"name": "toy_r18", "source": "toy", "model": MODEL,
          "optimizer": {"class_name": "torch.optim.SGD",
                        "params": {"lr": 0.001, "momentum": 0.9, "weight_decay": 0.001}}, "reduced": []}
# The program's own options, whole to Retinanet: the trunk's blocks
# recomputed in backward.
CONFIG_R34 = {**CONFIG, "name": "toy_r34", "model": {**MODEL, "backbone_kind": "resnet34"},
              "program": {"remat": True}}
CONFIG_ADAMW = {**CONFIG, "name": "toy_r18_adamw",
                "optimizer": {"class_name": "torch.optim.AdamW",
                              "params": {"lr": 1e-4, "weight_decay": 0.05}}}
CONFIGS = [CONFIG, CONFIG_R34, CONFIG_ADAMW]
TRAFFIC = {
    "toy_predict": {"driver": "predict", "why": "toy", "batch": 2, "pool": 4,
                    "sizes": [[96, 128], [90, 120]], "arrivals": {"kind": "closed"},
                    "head_prior": 0.5, "class_head_std": 0.0295, "check_calls": 2},
    "toy_serve": {"driver": "predict", "why": "toy", "batch": 1, "pool": 4,
                  "sizes": [[96, 128], [90, 120]], "arrivals": {"kind": "open", "rate": 6, "burst": 2},
                  "head_prior": 0.5, "class_head_std": 0.0295, "check_calls": 2},
    "toy_train": {"driver": "train", "why": "toy", "world": 1, "batch": 2, "batches": 4, "warmup_steps": 5,
                  "min_fg": 4},
    "toy_ddp2": {"driver": "train", "why": "toy", "world": 2, "batch": 2, "batches": 4, "warmup_steps": 5},
}
# (cell, configuration, traffic, chips)
CELLS = [("toy_predict_cell", "toy_r18", "toy_predict", 1), ("toy_serve_cell", "toy_r18", "toy_serve", 1),
         ("toy_train_cell", "toy_r18", "toy_train", 1), ("toy_ddp2_cell", "toy_r18", "toy_ddp2", 2),
         ("toy_r34_predict_cell", "toy_r34", "toy_predict", 1),
         ("toy_r34_train_cell", "toy_r34", "toy_train", 1),
         ("toy_adamw_train_cell", "toy_r18_adamw", "toy_train", 1)]
# The real cells' limits: a toy run of the program in f32 sits far inside them.
LIMITS = {cell: json.loads((REPO / "benchmark/limits" / (
    "r50_predict_b32.json" if TRAFFIC[traffic]["driver"] == "predict" else "r50_train_b16.json"))
    .read_text()) for cell, _, traffic, _ in CELLS}
# A trunk family that the repository lacks, for a kind the program runs,
# written apart from families/resnet_fpn.py: ResNet-34 (basic blocks, 3, 4,
# 6, 3), torchvision's keys, frozen batch norm, its own draws.
FAMILY = '''"""ResNet-34, a toy family written as a new file."""

import torch
import torch.nn.functional as F

KINDS = ("resnet34",)
BUFFERS = frozenset({"mean", "var"})
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))  # width, blocks, first stride
LEAVES = (("weight", "gamma"), ("bias", "beta"), ("running_mean", "mean"), ("running_var", "var"))


def _blocks():
    cin = 64
    for s, (width, n, stride) in enumerate(STAGES, start=1):
        for i in range(n):
            st = stride if i == 0 else 1
            yield s, f"backbone.backbone.layer{s}.{i}", cin, width, st, (st, cin) != (1, width)
            cin = width


def out_channels(m):
    return (128, 256, 512)


def schema(m):
    rows = [("backbone.backbone.conv1.weight", (64, 3, 7, 7), "w")]
    rows += [(f"backbone.backbone.bn1.{leaf}", (64,), role) for leaf, role in LEAVES]
    for _, p, cin, width, _, down in _blocks():
        for j, ci in ((1, cin), (2, width)):
            rows.append((f"{p}.conv{j}.weight", (width, ci, 3, 3), "w"))
            rows += [(f"{p}.bn{j}.{leaf}", (width,), role) for leaf, role in LEAVES]
        if down:
            rows.append((f"{p}.downsample.0.weight", (width, cin, 1, 1), "w"))
            rows += [(f"{p}.downsample.1.{leaf}", (width,), role) for leaf, role in LEAVES]
    return rows


def draw(key, shape, role, m):
    if role == "w":
        return ("normal", (2.0 / (shape[0] * shape[2] * shape[3])) ** 0.5)  # He, fan-out
    if role == "gamma" and ".bn2." in key:
        return ("uniform", 0.05, 0.25)
    return {"gamma": ("uniform", 0.8, 1.2), "beta": ("uniform", -0.05, 0.05),
            "mean": ("uniform", -0.05, 0.05), "var": ("uniform", 0.8, 1.2)}[role]


def _conv_bn(sd, x, conv, bn, stride, q):
    w = sd[conv + ".weight"]
    if q is not None:
        x, w = q(x), q(w)
    y = F.conv2d(x, w, None, stride, w.shape[-1] // 2)
    for step in (getattr(q, "out", None), getattr(q, "grad", None)):
        if step is not None:
            y = step(y)
    inv = sd[bn + ".weight"] / torch.sqrt(sd[bn + ".running_var"] + 1e-5)
    shift = sd[bn + ".bias"] - sd[bn + ".running_mean"] * inv
    return y * inv[:, None, None] + shift[:, None, None]


def trunk(sd, x, m, q=None):
    x = F.max_pool2d(torch.relu(_conv_bn(sd, x, "backbone.backbone.conv1", "backbone.backbone.bn1", 2,
                                         q)), 3, 2, 1)
    ends = {}
    for stage, p, _, _, stride, down in _blocks():
        y = torch.relu(_conv_bn(sd, x, p + ".conv1", p + ".bn1", stride, q))
        y = _conv_bn(sd, y, p + ".conv2", p + ".bn2", 1, q)
        short = _conv_bn(sd, x, p + ".downsample.0", p + ".downsample.1", stride, q) if down else x
        x = ends[stage] = torch.relu(y + short)
    return [ends[2], ends[3], ends[4]]


def trunk_flops(h, w, m):
    fl, hw = 2 * (h // 2) * (w // 2) * 49 * 3 * 64, (h // 4) * (w // 4)
    for _, _, cin, width, stride, down in _blocks():
        hw //= stride * stride
        fl += 2 * hw * 9 * (cin + width) * width + (2 * hw * cin * width if down else 0)
    return fl
'''
METRIC = '''"""A metric added as a file of its own: the traced run's batch."""

LAYER = "toy"
UNIT = "img"
MOVES = "setup_s"
SOURCE = "program_counter"


def read(run):
    return run["batch"]
'''


def write_root(root: Path) -> Path:
    """BENCHMARK.json and the benchmark's files under `root`, plus the toy
    cells' configuration, traffic, limits and one metric, as new files."""
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for cfg in CONFIGS:
        (root / f"benchmark/configs/{cfg['name']}.json").write_text(json.dumps(cfg))
    (root / "benchmark/families/toy_resnet34.py").write_text(FAMILY)
    for name, t in TRAFFIC.items():
        (root / f"benchmark/traffic/{name}.json").write_text(json.dumps(t))
    for name, lim in LIMITS.items():
        (root / f"benchmark/limits/{name}.json").write_text(json.dumps(lim))
    (root / "benchmark/metrics/toy_batch.py").write_text(METRIC)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] += [{"name": cfg["name"], "source": "toy", "file": f"benchmark/configs/{cfg['name']}.json",
                          "reduced": [], "why": "toy"} for cfg in CONFIGS]
    bench["workloads"] += [{"name": cell, "config": config, "traffic": traffic, "chips": chips, "why": "toy"}
                           for cell, config, traffic, chips in CELLS]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            driver = "predict" if m["name"].startswith("predict") else "train"
            m["workloads"] += [cell for cell, _, traffic, _ in CELLS if TRAFFIC[traffic]["driver"] == driver]
    for m in bench["per_layer"]:
        if m["name"].endswith(".predict"):
            m["workloads"].append("toy_predict_cell")
        elif m["name"].endswith(".train") and m["name"] != "nccl_share.train":
            m["workloads"].append("toy_train_cell")
    bench["per_layer"].append({"name": "toy_batch", "unit": "img", "better": "higher",
                               "source": "program_counter", "layer": "toy", "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def break_exchange() -> None:
    """Leave out DDP's all-reduce: each rank steps on its own gradient (a
    rank hook: the spawned ranks call it before their job)."""
    import torch
    from pytorch_retinanet_tpu_torch.engine import trainer

    real = trainer.DistributedDataParallel

    def local_only(*args, **kwargs):
        ddp = real(*args, **kwargs)

        def hook(state, bucket):
            fut = torch.futures.Future()
            fut.set_result(bucket.buffer())
            return fut

        ddp.register_comm_hook(None, hook)
        return ddp

    trainer.DistributedDataParallel = local_only


def run_cell(root: Path, cell: str, seed: int = 3, seconds: float = 1.0, trace: int = 0,
             rank_hook=None):
    """(exit code, the last stdout line parsed or None, stderr) of one run."""
    import sys

    sys.path.insert(0, str(REPO / "benchmark"))
    import run as bench_run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                             "--trace", str(trace)], root=root, require_cuda=False,
                            rank_hook=rank_hook)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err.getvalue()

"""A toy benchmark written as new files into a temporary root: resnet18 at
a 128x192 bucket, f32 (this PyTorch's CPU bf16 goes non-finite), a predict
cell and a training cell, run through ``benchmark/run.py`` on the CPU with
the kernels' plain versions."""

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
# The real cells' limits: a toy run of the program in f32 sits far inside them.
LIMITS = {"toy_predict_cell": json.loads((REPO / "benchmark/limits/r50_predict_b32.json").read_text()),
          "toy_serve_cell": json.loads((REPO / "benchmark/limits/r50_predict_b32.json").read_text()),
          "toy_train_cell": json.loads((REPO / "benchmark/limits/r50_train_b16.json").read_text()),
          "toy_ddp2_cell": json.loads((REPO / "benchmark/limits/r50_train_b16.json").read_text())}
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
    (root / "benchmark/configs/toy_r18.json").write_text(json.dumps(CONFIG))
    for name, t in TRAFFIC.items():
        (root / f"benchmark/traffic/{name}.json").write_text(json.dumps(t))
    for name, lim in LIMITS.items():
        (root / f"benchmark/limits/{name}.json").write_text(json.dumps(lim))
    (root / "benchmark/metrics/toy_batch.py").write_text(METRIC)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_r18", "source": "toy", "file": "benchmark/configs/toy_r18.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"] += [
        {"name": "toy_predict_cell", "config": "toy_r18", "traffic": "toy_predict", "chips": 1, "why": "toy"},
        {"name": "toy_serve_cell", "config": "toy_r18", "traffic": "toy_serve", "chips": 1, "why": "toy"},
        {"name": "toy_train_cell", "config": "toy_r18", "traffic": "toy_train", "chips": 1, "why": "toy"},
        {"name": "toy_ddp2_cell", "config": "toy_r18", "traffic": "toy_ddp2", "chips": 2, "why": "toy"}]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += (["toy_predict_cell", "toy_serve_cell"] if m["name"].startswith("predict")
                               else ["toy_train_cell", "toy_ddp2_cell"])
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

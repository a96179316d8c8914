"""Ranks of the PyTorch port on torch.distributed -> MULTIHOST_TORCH.json.

The port's counterpart of ``tools/multihost_smoke.py``. It spawns the ranks
with ``torch.multiprocessing`` in ``spawn`` mode (CUDA cannot fork), joins
them through a ``file://`` store in a temporary directory (no port to
collide on), bounds every run with a join timeout, and collects each rank's
``rank{r}.json``. ``tests/test_torch_parallel.py``, ``tests/test_torch_ddp.py``
and ``tests/test_torch_card_parallel.py`` run their rank functions through
:class:`RankRun`; the jobs below are theirs and this script's.

Run as a script (resnet18 at 64x96, f32), it does what the JAX tool does:
on a seeded CSV dataset of 7 images and weights fitted 20 steps on it
(:func:`trained_state`), a multi-rank ``Trainer.test`` (each rank predicts
its shard, the detections merge through ``all_gather_objects``) and
``Trainer.validate``, then 2 SGD steps of a multi-rank ``Trainer.fit`` with
frozen and with live batch norm (2 rows a rank); it holds them against one
process (the merged records and AP, the validation loss, the step losses,
and the parameters after the first step by :func:`update_gaps`; the live-BN
reference on the layer's global path, :func:`one_process_global_bn`) and
the ranks against each other. Then the spatial meshes
(``parallel/sharding.py``) at 128x192: data 1 x spatial ``world`` and, on 4
ranks, 2 x 2 (:func:`spatial_meshes`): ``build_sharded_forward`` against one
process's forward within 1e-4, and 2 SGD steps with frozen BN on
``make_train_mesh`` against one process (NCCL exchanges the halo rows with
``batch_isend_irecv``). It writes the checks:

    python tools/torch_multihost_smoke.py --world 4 \
        --out multihost_torch_nccl.json                      # NCCL, one card per rank
    python tools/torch_multihost_smoke.py --device cpu \
        [--out MULTIHOST_TORCH.json]                         # 2 gloo ranks on the CPU
    python tools/torch_multihost_smoke.py --world 4 --only spatial ...   # one part
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import types
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# The CPU protocol's model: resnet18, 4 classes, f32, the 64x96 bucket.
MODEL = dict(num_classes=4, backbone_kind="resnet18", pretrained=False, min_size=64,
             max_size=96, compute_dtype="float32", prior=0.5, score_thres=1e-3)
OPTIMIZER = {"class_name": "torch.optim.SGD",
             "params": {"lr": 0.01, "momentum": 0.9, "weight_decay": 0.001}}
# Training runs start from the default prior: prior 0.5 puts the focal loss
# in the hundreds.
TRAIN_MODEL = {**MODEL, "prior": 0.01}
TRAIN_KW = dict(warmup_steps=0, num_sanity_val_steps=0, log_every_n_steps=1, logger=False)


# --------------------------------------------------------------------------- #
# Spawning and joining ranks
# --------------------------------------------------------------------------- #
def _rank_entry(rank: int, world: int, fn: Callable, params: dict, workdir: str,
                backend: str) -> None:
    """One rank: join the group, run ``fn(rank, world, params)``, write its
    result (or its error) to ``rank{rank}.json``; a failure exits non-zero."""
    import torch.distributed as dist

    from pytorch_retinanet_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)  # ranks share the host's cores
    torch.backends.cudnn.allow_tf32 = False  # f32 comparisons on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    out = os.path.join(workdir, f"rank{rank}.json")
    try:
        init_distributed(f"file://{os.path.join(workdir, 'store')}", world, rank, backend=backend)
        result = fn(rank, world, params)
        with open(out, "w") as f:
            json.dump(result, f)
    except BaseException as e:
        with open(out, "w") as f:
            json.dump({"error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()},
                      f)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankRun:
    """``world`` ranks of ``fn(rank, world, params) -> dict`` (a module-level
    function: the ranks import it), started at construction; :meth:`join`
    waits up to ``timeout`` seconds in all, ends any rank still running, and
    returns the exit codes and each rank's JSON (None where it wrote none).

    ``workdir`` holds the store, the rank files, and whatever the jobs
    write; ``params["workdir"]`` names it to them. Without one, a temporary
    directory is made and removed by :meth:`join`.
    """

    def __init__(self, fn: Callable, params: Optional[dict] = None, *, world: int = 2,
                 backend: str = "gloo", timeout: float = 120.0, workdir: Optional[str] = None):
        import torch.multiprocessing as mp

        self._own_workdir = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(prefix="torch_ranks_")
        os.makedirs(self.workdir, exist_ok=True)
        self.world, self.timeout = world, timeout
        params = {**(params or {}), "workdir": self.workdir}
        ctx = mp.get_context("spawn")
        self.t0 = time.perf_counter()
        self.procs = [ctx.Process(target=_rank_entry, daemon=True,
                                  args=(r, world, fn, params, self.workdir, backend))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self) -> Dict[str, Any]:
        deadline = self.t0 + self.timeout
        for p in self.procs:
            p.join(max(deadline - time.perf_counter(), 0.0))
        timed_out = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
        results = []
        for r in range(self.world):
            path = os.path.join(self.workdir, f"rank{r}.json")
            results.append(json.load(open(path)) if os.path.isfile(path) else None)
        if self._own_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)
        return {"exitcodes": [p.exitcode for p in self.procs], "timed_out": timed_out,
                "results": results, "seconds": time.perf_counter() - self.t0}


# --------------------------------------------------------------------------- #
# What the jobs share
# --------------------------------------------------------------------------- #
def state_digest(module: torch.nn.Module) -> str:
    """sha256 of the parameters and buffers, bit for bit, in key order."""
    h = hashlib.sha256()
    for k, v in sorted(module.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def rows_of(batch: dict, shard: int, num_shards: int) -> dict:
    """Rows ``[shard*B/n, (shard+1)*B/n)`` of a global batch."""
    b = len(batch["images"])
    return {k: v[shard * b // num_shards:(shard + 1) * b // num_shards] for k, v in batch.items()}


def served_model_class():
    """A ``RetinaNetModel`` serving global batches, each rank its rows."""
    from pytorch_retinanet_tpu_torch import RetinaNetModel

    class Served(RetinaNetModel):
        batches: list = []
        val_batches: Optional[list] = None

        def prepare_data(self):
            pass

        def train_dataloader(self, shard=0, num_shards=1):
            return [rows_of(b, shard, num_shards) for b in self.batches]

        def val_dataloader(self, shard=0, num_shards=1):
            if self.val_batches is None:
                return None
            return [rows_of(b, shard, num_shards) for b in self.val_batches]

    return Served


def served_model(model: dict, batches: list, state: Optional[dict] = None, device: str = "cpu",
                 optimizer: dict = OPTIMIZER, val_batches: Optional[list] = None):
    from pytorch_retinanet_tpu_torch import ConfigDict

    m = served_model_class()(ConfigDict({"model": model, "optimizer": optimizer}), device=device)
    m.batches, m.val_batches = batches, val_batches
    if state is not None:
        m.net.load_state_dict(state)
    return m


def seeded_train_batches(n: int, b: int, h: int = 64, w: int = 96, seed: int = 0,
                         num_classes: int = 4) -> list:
    """`n` global batches of `b` f32 images with 0-3 boxes each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        boxes = np.zeros((b, 100, 4), np.float32)
        labels = np.zeros((b, 100), np.int32)
        valid = np.zeros((b, 100), bool)
        for i in range(b):
            k = int(rng.integers(0, 4))
            ctr = rng.uniform([8, 8], [w - 8, h - 8], (k, 2))
            wh = rng.uniform(12, 40, (k, 2))
            boxes[i, :k] = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
            labels[i, :k] = rng.integers(1, num_classes + 1, k)
            valid[i, :k] = True
        out.append({"images": rng.random((b, h, w, 3), dtype=np.float32), "boxes": boxes,
                    "labels": labels, "valid": valid})
    return out


def seeded_state(model: dict, seed: int = 0) -> dict:
    """Seeded weights with random BN statistics and affine, so that frozen
    and live BN differ from the identity."""
    from pytorch_retinanet_tpu_torch import Retinanet

    net = Retinanet(device="cpu", seed=seed, **model)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        if v.ndim == 1 and k.endswith((".weight", "running_var")):
            v = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif v.ndim == 1 and k.endswith(("running_mean", ".bias")) and "backbone" in k:
            v = torch.from_numpy(rng.normal(0, 0.05, v.shape).astype(np.float32))
        sd[k] = v.clone()
    return sd


def fit_served(model: dict, batches: list, state: dict, trainer_kw: dict, device: str = "cpu",
               devices: Optional[list] = None, optimizer: dict = OPTIMIZER, mesh: Any = None,
               grads: Optional[dict] = None):
    """``Trainer.fit`` of a served model: (trainer, model, the module's
    state after the first optimizer step). `grads`, when given, receives
    the gradients the first optimizer step applied."""
    from pytorch_retinanet_tpu_torch import Trainer

    m = served_model(model, batches, state, device, optimizer)
    t = Trainer(devices=devices, mesh=mesh, **{**TRAIN_KW, **trainer_kw})
    first: dict = {}
    fit_loop = t._fit_loop

    def capture(*args):
        opt = getattr(t._optimizer, "optimizer", t._optimizer)
        step = opt.step

        def first_step(*a, **k):
            if not first and grads is not None:
                grads.update({n: p.grad.detach().cpu().clone()
                              for n, p in m.net.module.named_parameters() if p.grad is not None})
            out = step(*a, **k)
            if not first:
                first.update({k: v.detach().cpu().clone()
                              for k, v in m.net.state_dict().items()})
            return out

        opt.step = first_step
        return fit_loop(*args)

    t._fit_loop = capture
    t.fit(m)
    return t, m, first


def update_gaps(got: dict, want: dict, before: dict, rtol: float = 1e-5) -> Dict[str, float]:
    """Per floating tensor: max |(got - before) - (want - before)| over
    ``rtol`` times the largest |want - before| plus 2 f32 ulp of the
    largest |want| (the updates are read back from rounded weights, and a
    tensor whose update is ~1e-4 of its values has update ulps of ~1e-3).
    A value above 1 is outside the bound."""
    gaps = {}
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        bound = (rtol * float((w - before[k]).abs().max())
                 + 2 * torch.finfo(torch.float32).eps * float(w.abs().max()))
        gaps[k] = float((got[k] - w).abs().max()) / max(bound, 1e-30)
    return gaps


def write_csv_dataset(root: str, n: int = 7, seed: int = 3) -> str:
    """`n` images of a rectangle on white (100x80), one CSV row each."""
    import cv2
    import pandas as pd

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        img = np.full((100, 80, 3), 255, np.uint8)
        x1, y1 = int(rng.integers(5, 30)), int(rng.integers(5, 40))
        x2, y2 = min(x1 + int(rng.integers(20, 40)), 79), min(y1 + int(rng.integers(20, 40)), 99)
        cls = ["car", "dog"][i % 2]
        cv2.rectangle(img, (x1, y1), (x2, y2), (255, 0, 0) if cls == "car" else (0, 0, 255), -1)
        path = os.path.join(root, f"{i}.png")
        cv2.imwrite(path, img)
        rows.append({"filename": path, "width": 80, "height": 100, "class": cls,
                     "xmin": float(x1), "ymin": float(y1), "xmax": float(x2), "ymax": float(y2),
                     "labels": 1 + i % 2})
    path = os.path.join(root, "data.csv")
    pd.DataFrame(rows).to_csv(path, index=False)
    return path


def csv_conf(csv: str, model: dict = MODEL, bs: int = 2) -> dict:
    return {"model": model, "optimizer": OPTIMIZER,
            "dataset": {"kind": "csv", "trn_paths": csv, "valid_paths": csv, "test_paths": csv},
            "dataloader": {"train_bs": bs, "valid_bs": bs, "test_bs": bs,
                           "args": {"num_workers": 1}},
            "transforms": []}


def trained_state(csv: str, steps: int = 20) -> dict:
    """Weights fitted for `steps` steps on the CSV dataset in one process
    (seeded, from the default prior), so that the test's AP is not 0."""
    from pytorch_retinanet_tpu_torch import OmegaConf, RetinaNetModel, Trainer

    m = RetinaNetModel(OmegaConf.create(csv_conf(csv, TRAIN_MODEL)), device="cpu")
    Trainer(max_steps=steps, max_epochs=steps, warmup_steps=4, gradient_clip_val=10.0,
            logger=False, num_sanity_val_steps=0, val_check_interval=steps).fit(m)
    return {k: v.clone() for k, v in m.net.state_dict().items()}


def test_with_records(trainer, model) -> dict:
    """``trainer.test(model)``: the AP and the evaluator's merged bbox records."""
    seen = {}
    make = model.test_evaluator

    def evaluator(*a, **k):
        e = make(*a, **k)
        seen["e"] = e
        return e

    model.test_evaluator = evaluator
    ap = trainer.test(model)[0]["AP"]
    model.test_evaluator = make
    recs = [{"image_id": int(r["image_id"]), "category_id": int(r["category_id"]),
             "bbox": [float(v) for v in r["bbox"]], "score": float(r["score"])}
            for r in seen["e"].results["bbox"]]
    return {"AP": ap, "records": recs, "img_ids": [int(i) for i in seen["e"].img_ids]}


# --------------------------------------------------------------------------- #
# Jobs: fn(rank, world, params) -> JSON-able dict
# --------------------------------------------------------------------------- #
def rank_devices(world: int, params: dict):
    """(the model's device, ``Trainer(devices=...)``): the CPU, or under
    ``params["device"] == "cuda"`` one card per rank, unless
    ``params["devices"]`` names them (``[0, 0]``: two ranks on one card)."""
    if params.get("device", "cpu") == "cuda":
        return "cuda", params.get("devices") or list(range(world))
    return "cpu", ["cpu"] * world


BN_STATE = ("weight", "bias", "running_mean", "running_var")


def live_bn_rows(x: torch.Tensor, w_out: torch.Tensor, state: dict, rank: int,
                 world: int) -> dict:
    """A live ``BatchNorm2d`` (``state``: its weight, bias and running
    statistics) in training mode on this rank's rows of the global batch
    `x`, backward from ``sum(y * w_out)``: the rows' output and input
    gradient, this rank's weight and bias gradients, the running statistics
    after the step and ``num_batches_tracked``."""
    from pytorch_retinanet_tpu_torch.models.layers import BatchNorm2d

    rows = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
    layer = BatchNorm2d(x.shape[1], frozen=False).to(x.device)
    with torch.no_grad():
        for name in BN_STATE:
            getattr(layer, name).copy_(state[name])
    layer.train()
    xr = x[rows].clone().requires_grad_(True)
    y = layer(xr)
    (y * w_out[rows]).sum().backward()
    return {"y": y.detach(), "x_grad": xr.grad, "weight_grad": layer.weight.grad,
            "bias_grad": layer.bias.grad, "running_mean": layer.running_mean,
            "running_var": layer.running_var,
            "num_batches_tracked": int(layer.num_batches_tracked)}


def job_collectives(rank: int, world: int, params: dict) -> dict:
    """The helpers, the synced live BN layer and the ``match_mesh`` split."""
    import torch.distributed as dist

    from pytorch_retinanet_tpu_torch import parallel
    from pytorch_retinanet_tpu_torch.kernels import match_targets_plain
    from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level, retinanet_loss_levels
    from pytorch_retinanet_tpu_torch.ops.losses import _split_over_ranks

    out: Dict[str, Any] = {
        "world": parallel.get_world_size(), "rank": parallel.get_rank(),
        "main": parallel.is_main_process(),
        # Unequal payloads: rank r sends 10 + 1000 r characters.
        "gathered": parallel.all_gather_objects({"rank": rank, "pad": "x" * (10 + 1000 * rank)}),
        "mean": parallel.reduce_dict({"a": float(rank + 1), "b": torch.tensor([rank * 2.0, 4.0])}),
        "sum": parallel.reduce_dict({"a": float(rank + 1)}, average=False),
        "any": parallel.any_rank([rank == world - 1, False]),
    }
    out["gathered"] = [(g["rank"], len(g["pad"])) for g in out["gathered"]]
    out["train_mesh"] = job_train_meshes(rank, world, {"knobs": {"spatial": {"spatial": world}}})

    bn = params["bn"]
    got = live_bn_rows(torch.tensor(bn["x"]), torch.tensor(bn["w_out"]),
                       {k: torch.tensor(bn[k]) for k in BN_STATE}, rank, world)
    out["bn"] = {k: v.tolist() if isinstance(v, torch.Tensor) else v for k, v in got.items()}

    # The match split over the ranks against the unsplit match, on one
    # global batch every rank holds.
    gt = seeded_train_batches(1, 4, seed=11)[0]
    anchors = [torch.from_numpy(a) for a in generate_anchors_per_level((64, 96))]
    boxes, labels, valid = (torch.from_numpy(gt[k]) for k in ("boxes", "labels", "valid"))
    labels, valid = labels.to(torch.int32), valid.bool()
    args = (0.5, 0.4, (1.0, 1.0, 1.0, 1.0))
    split = _split_over_ranks(match_targets_plain, dist.group.WORLD)
    same = all(torch.equal(a, b)
               for anc in anchors
               for a, b in zip(split(anc, boxes, labels, valid, *args),
                               match_targets_plain(anc, boxes, labels, valid, *args)))
    g = torch.Generator().manual_seed(5)
    cls = [torch.randn((4, a.shape[0], 4), generator=g) for a in anchors]
    box = [torch.randn((4, a.shape[0], 4), generator=g) for a in anchors]
    kw = dict(num_classes=4, reduction="none")
    plan = parallel.make_mesh(["cpu"] * world)
    with_mesh = retinanet_loss_levels(cls, box, anchors, boxes, labels, valid, match_mesh=plan, **kw)
    unsplit = retinanet_loss_levels(cls, box, anchors, boxes, labels, valid, **kw)
    out["match"] = {"targets_equal": same,
                    "losses_equal": all(torch.equal(with_mesh[k], unsplit[k]) for k in unsplit),
                    "n_fg": int(sum(int((match_targets_plain(a, boxes, labels, valid, *args)[0]
                                         >= 0).sum()) for a in anchors))}
    return out


def job_train(rank: int, world: int, params: dict) -> dict:
    """Multi-rank ``Trainer.fit`` runs from one state on global batches (each
    data shard its rows). A run names its ``trainer`` arguments and may
    override the ``model`` and the ``optimizer``; with ``spatial`` it trains
    on ``make_train_mesh(spatial=...)`` (the data axis the rest of the
    world). Per run: the logged (rank-averaged) losses and the state digest;
    rank 0 saves the state after the first optimizer step to
    ``<workdir>/<run>.pt`` (and, under ``save_last``, the final one to
    ``<workdir>/<run>_last.pt``)."""
    from pytorch_retinanet_tpu_torch.parallel import make_train_mesh

    data = torch.load(params["data"], weights_only=False)
    device, devices = rank_devices(world, params)
    out = {}
    for name, run in params["runs"].items():
        mesh = make_train_mesh(devices, spatial=run["spatial"]) if run.get("spatial") else None
        t, m, first = fit_served({**TRAIN_MODEL, **run.get("model", {})}, data["batches"],
                                 data["state"], run["trainer"], device=device, devices=devices,
                                 optimizer=run.get("optimizer", OPTIMIZER), mesh=mesh)
        out[name] = {"losses": list(t.logger_.meters["loss"].window),
                     "digest": state_digest(m.net.module), "global_step": t.global_step}
        if rank == 0:
            torch.save(first, os.path.join(params["workdir"], f"{name}.pt"))
            if run.get("save_last"):
                torch.save({k: v.cpu() for k, v in m.net.state_dict().items()},
                           os.path.join(params["workdir"], f"{name}_last.pt"))
    return out


def train_against_one_process(work: str, name: str, run: dict, batches: list, state: dict,
                              ranks: list, device: str, loss_rtol: float,
                              update_rtol: float) -> dict:
    """One process over the global batches against :func:`job_train`'s
    ranks (``ranks``: their results, ``work``: their workdir) on `run`:
    the step losses (relative error against `loss_rtol`), the first
    optimizer step's update gap (:func:`update_gaps` at `update_rtol`; a
    value above 1 is outside), whether the ranks hold the same state bit
    for bit, and under ``save_last`` the running statistics' largest error
    relative to each tensor's largest value. A live-BN reference runs the
    layer's global-batch path (:func:`one_process_global_bn`)."""
    model = {**TRAIN_MODEL, **run.get("model", {})}
    live = model.get("freeze_bn") is False
    with one_process_global_bn() if live else contextlib.nullcontext():
        t, m, first = fit_served(model, batches, state, run["trainer"], device=device,
                                 optimizer=run.get("optimizer", OPTIMIZER))
    got = torch.load(os.path.join(work, f"{name}.pt"), weights_only=True)
    want = list(t.logger_.meters["loss"].window)
    losses = ranks[0][name]["losses"]
    gaps = update_gaps(got, first, state, update_rtol)
    out = {"losses": losses, "single": want,
           "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(losses, want)),
           "update_gap_of_bound": max(gaps.values()), "worst_tensor": max(gaps, key=gaps.get),
           "ranks_bit_for_bit": len({r[name]["digest"] for r in ranks}) == 1
           and all(r[name]["losses"] == losses for r in ranks)}
    out["loss_ok"] = len(losses) == len(want) and out["loss_rel_err"] <= loss_rtol
    if run.get("save_last"):
        last = torch.load(os.path.join(work, f"{name}_last.pt"), weights_only=True)
        out["stats_rel_err"] = max(
            float((last[k] - v.cpu()).abs().max()) / float(v.abs().max())
            for k, v in m.net.state_dict().items() if "running_" in k)
    return out


def job_eval(rank: int, world: int, params: dict) -> dict:
    """``Trainer.test`` (merged records and AP) of ``params["conf"]``'s
    dataset from ``params["state"]`` (else the config's seeded weights),
    and unless ``validate`` is false ``Trainer.validate``. Also this rank's
    shard (batches, real images), the kernels launched by the test, its
    seconds and the stem's last input dtype. Under ``warm`` the shard's
    first batch is predicted once before the count (cuDNN plans, the
    allocator)."""
    from pytorch_retinanet_tpu_torch import OmegaConf, RetinaNetModel, Trainer
    from pytorch_retinanet_tpu_torch.kernels import KERNELS, reset_launch_counts, stem_forward

    device, devices = rank_devices(world, params)
    model = RetinaNetModel(OmegaConf.create(params["conf"]), device=device)
    if params.get("state"):
        model.net.load_state_dict(torch.load(params["state"], weights_only=True))
    model.prepare_data()
    n_batches = shard_images = 0
    for b in model.test_dataloader(shard=rank, num_shards=world):
        if params.get("warm") and not n_batches:
            model.net._predict_impl(b["images"].to(model.net.device),
                                    b["image_sizes"].to(model.net.device))
        n_batches += 1
        shard_images += int(np.asarray(b["batch_mask"]).sum())
    t = Trainer(logger=False, devices=devices, log_every_n_steps=1000)
    if device == "cuda":
        torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = test_with_records(t, model)
    out.update(seconds=time.perf_counter() - t0, n_batches=n_batches, shard_images=shard_images,
               launches={k.name: k.wrapper.launches for k in KERNELS},
               stem_dtype=str(stem_forward.last_dtype))
    if params.get("validate", True):
        out["val"] = t.validate(model)
    return out


def job_checkpoint(rank: int, world: int, params: dict) -> dict:
    """A checkpointed, logged 1-epoch fit, a resume of it to epoch 2, and an
    uninterrupted 2-epoch fit: who wrote, and the state digests."""
    from pytorch_retinanet_tpu_torch import Trainer
    from pytorch_retinanet_tpu_torch.engine import CSVLogger

    data = torch.load(params["data"], weights_only=False)
    work = params["workdir"]
    writes = []

    def trainer(**kw):
        t = Trainer(devices=["cpu"] * world, **{**TRAIN_KW, **kw})
        write = t._write_checkpoint
        t._write_checkpoint = lambda path, epochs: (writes.append(path), write(path, epochs))
        return t

    def run(t):
        m = served_model(TRAIN_MODEL, data["batches"], data["state"])
        t.fit(m)
        return state_digest(m.net.module)

    ckpt = os.path.join(work, "ckpt")
    logs = os.path.join(work, f"logs_rank{rank}")
    first = run(trainer(max_epochs=1, checkpoint_dir=ckpt, logger=CSVLogger(logs)))
    resumed = run(trainer(max_epochs=2, resume_from_checkpoint=os.path.join(ckpt, "last")))
    straight = run(trainer(max_epochs=2))
    return {"writes": writes, "first": first, "resumed": resumed, "straight": straight,
            "logs_written": os.path.isdir(logs)}


def job_nonfinite(rank: int, world: int, params: dict) -> dict:
    """2 steps where the last rank's rows are NaN: every rank must raise."""
    batches = seeded_train_batches(2, 2 * world, seed=2)
    for b in batches:
        b["images"][len(b["images"]) - 2:] = np.nan
    fit_served(TRAIN_MODEL, batches, seeded_state(TRAIN_MODEL), {"max_steps": 2},
               devices=["cpu"] * world)
    return {"finished": True}


# --------------------------------------------------------------------------- #
# Spatial and tensor-parallel meshes (parallel/sharding.py)
# --------------------------------------------------------------------------- #
# build_sharded_forward's cases: the mesh (make_inference_mesh's axes) and
# the images ("images": [2, 128, 128, 3]; "images160": [1, 160, 160, 3],
# 5 units of 32 rows, uneven over 2 and over 4 ranks).
SHARDED_CASES = {
    "spatial2": ({"spatial": 2}, "images"),
    "data2_spatial2": ({"data": 2, "spatial": 2}, "images"),
    "model2": ({"model": 2}, "images"),
    "spatial2_model2": ({"spatial": 2, "model": 2}, "images"),
    "h160_spatial2": ({"spatial": 2}, "images160"),
    "h160_spatial4": ({"spatial": 4}, "images160"),
}
# place_images' guards: (mesh, batch shape) -> JAX's ValueError.
PLACE_GUARDS = {
    "height": ({"spatial": 4}, (2, 64, 64, 3)),
    "batch": ({"data": 2, "spatial": 2}, (3, 128, 128, 3)),
}
# The script's spatial forwards against one process: JAX's bar for its
# sharded forwards (tests/test_sharding.py), absolute and relative.
SPATIAL_FORWARD_TOL = 1e-4
# Spatial training runs (f32, frozen BN): the model's options.
SPATIAL_TRAIN_RUNS = {"plain": {}, "remat": {"remat": True}, "stem_s2d": {"stem_s2d": True}}


def halo_ops() -> dict:
    """Each op of the trunk that a height split runs with halo rows, at the
    stride of the input the trunk gives it: name -> (input stride, output
    stride, input channels, the op's module, the op on NCHW)."""
    from torch import nn

    from pytorch_retinanet_tpu_torch.models.layers import (
        conv, conv_layer, max_pool_torch, space_to_depth_2x,
    )

    torch.manual_seed(0)
    layers = {"stem 7x7/2": conv_layer(3, 4, 7, 2), "3x3/2 conv": conv_layer(4, 4, 3, 2),
              "3x3/1 conv": conv_layer(4, 4, 3, 1), "1x1 conv": conv_layer(4, 4, 1, bias=True),
              "1x1/2 conv": conv_layer(4, 4, 1, 2), "s2d 4x4/1": nn.Conv2d(12, 4, 4, bias=False)}
    layers = {k: v.double() for k, v in layers.items()}
    return {
        "stem 7x7/2": (1, 2, 3, layers["stem 7x7/2"], lambda x: conv(layers["stem 7x7/2"], x)),
        "3x3/2 max pool": (2, 2, 4, None, lambda x: max_pool_torch(x, 3, 2)),
        "3x3/2 conv": (16, 2, 4, layers["3x3/2 conv"], lambda x: conv(layers["3x3/2 conv"], x)),
        "3x3/1 conv": (32, 1, 4, layers["3x3/1 conv"], lambda x: conv(layers["3x3/1 conv"], x)),
        "1x1 conv": (4, 1, 4, layers["1x1 conv"], lambda x: conv(layers["1x1 conv"], x)),
        "1x1/2 conv": (8, 2, 4, layers["1x1/2 conv"], lambda x: conv(layers["1x1/2 conv"], x)),
        "s2d 4x4/1": (1, 2, 3, layers["s2d 4x4/1"],
                      lambda x: conv(layers["s2d 4x4/1"], space_to_depth_2x(x),
                                     pad=((2, 1), (2, 1)))),
    }


def halo_checks(plan, height: int = 64) -> dict:
    """Each op of :func:`halo_ops` on this rank's rows of an f64 input,
    through each transport of the exchange, against the unsplit op: the
    largest |difference| of the output rows, of the input gradient's rows
    (backward from ``sum(y * w)``), and of the weight gradient summed over
    the spatial ranks; and how many exchanges it made."""
    import functools

    import torch.distributed as dist

    from pytorch_retinanet_tpu_torch.models.layers import splitting
    from pytorch_retinanet_tpu_torch.parallel import sharding

    out = {}
    for name, (stride, out_stride, cin, layer, op) in halo_ops().items():
        g = torch.Generator().manual_seed(len(name))
        x = torch.randn((2, cin, height // stride, 6), generator=g, dtype=torch.float64)
        x.requires_grad_(True)
        y = op(x)
        w = torch.randn(y.shape, generator=g, dtype=torch.float64)
        params = [] if layer is None else [layer.weight]
        grads = torch.autograd.grad((y * w).sum(), [x] + params)
        for transport in ("p2p", "gathered"):
            rows = sharding._Rows(plan, height)
            exchange = (functools.partial(sharding._exchange_gathered, rows)
                        if transport == "gathered" else rows.exchange)
            calls = []
            rows.exchange = lambda down, up: calls.append(1) or exchange(down, up)
            start, stop = (v // stride for v in rows.bounds[rows.index])
            xr = x.detach()[:, :, start:stop].clone().requires_grad_(True)
            with splitting(sharding._Split(rows, {})):
                yr = op(xr)
            o0, o1 = start // out_stride, stop // out_stride
            rgrads = torch.autograd.grad((yr * w[:, :, o0:o1]).sum(), [xr] + params)
            for gr in rgrads[1:]:
                dist.all_reduce(gr, group=rows.group)
            out[f"{name} {transport}"] = {
                "y": float((yr - y.detach()[:, :, o0:o1]).abs().max()),
                "x_grad": float((rgrads[0] - grads[0][:, :, start:stop]).abs().max()),
                "weight_grad": max([float((a - b).abs().max())
                                    for a, b in zip(rgrads[1:], grads[1:])], default=0.0),
                "shape": list(yr.shape), "exchanges": len(calls)}
    return out


def job_sharding(rank: int, world: int, params: dict) -> dict:
    """``parallel/sharding.py`` on `world` (4) gloo ranks: the sharded
    forwards of :data:`SHARDED_CASES` (each rank's per-level outputs saved
    to ``<workdir>/<case>_rank<r>.pt``), the guards of
    :data:`PLACE_GUARDS`, the exchange alone (:func:`halo_checks`, 2 ranks),
    and on the ``(data 2, spatial 2)`` training mesh: the runs of
    :data:`SPATIAL_TRAIN_RUNS` (2 steps; rank 0 saves each run's first-step
    state and gradients) and the ``Trainer``'s test, validation and predict
    on ``params["conf"]``'s dataset, and its refusal of live BN at ``fit``."""
    from pytorch_retinanet_tpu_torch import OmegaConf, RetinaNetModel, Trainer
    from pytorch_retinanet_tpu_torch.models import RetinaNetModule
    from pytorch_retinanet_tpu_torch.parallel import make_train_mesh
    from pytorch_retinanet_tpu_torch.parallel.sharding import (
        build_sharded_forward, make_inference_mesh,
    )

    work, cpus = params["workdir"], ["cpu"] * world
    data = torch.load(params["data"], weights_only=False)
    module = RetinaNetModule(backbone_kind="resnet18", num_classes=4, dtype=torch.float32)
    module.load_state_dict(data["state"], strict=True)
    out: Dict[str, Any] = {"forward": {}, "guards": {}}
    for name, (mesh, key) in SHARDED_CASES.items():
        plan = make_inference_mesh(cpus, **mesh)
        if plan is None:
            continue
        forward, place = build_sharded_forward(module, plan)
        cls, box = forward(place(data[key]))
        torch.save({"cls": cls, "box": box}, os.path.join(work, f"{name}_rank{rank}.pt"))
        out["forward"][name] = list(plan.coords)
    for name, (mesh, shape) in PLACE_GUARDS.items():
        plan = make_inference_mesh(cpus, **mesh)
        if plan is not None:
            try:
                build_sharded_forward(module, plan)[1](torch.zeros(shape))
            except ValueError as e:
                out["guards"][name] = str(e)
    plan = make_inference_mesh(cpus, spatial=2)
    if plan is not None:
        out["halo"] = halo_checks(plan)

    train = torch.load(params["train"], weights_only=False)
    plan = make_train_mesh(cpus, spatial=2)
    out["train_mesh"] = [plan.data_size, plan.spatial_size, list(plan.coords)]
    out["train"] = {}
    for name, model_kw in SPATIAL_TRAIN_RUNS.items():
        grads: dict = {}
        t, m, first = fit_served({**TRAIN_MODEL, **model_kw}, train["batches"], train["state"],
                                 {"max_steps": 2}, mesh=plan, grads=grads)
        out["train"][name] = {"losses": list(t.logger_.meters["loss"].window),
                              "digest": state_digest(m.net.module)}
        if rank == 0:
            torch.save({"first": first, "grads": grads}, os.path.join(work, f"train_{name}.pt"))

    conf = params["conf"]
    model = RetinaNetModel(OmegaConf.create(conf), device="cpu")
    trainer = Trainer(mesh=plan, logger=False)
    out["test"] = test_with_records(trainer, model)
    out["val"] = trainer.validate(model)
    predicted = trainer.predict(model)
    torch.save(predicted, os.path.join(work, f"predict_rank{rank}.pt"))
    live = RetinaNetModel(OmegaConf.create({**conf, "model": {**conf["model"], "freeze_bn": False}}),
                          device="cpu")
    try:
        Trainer(mesh=plan, **TRAIN_KW).fit(live)
        out["live_fit"] = None
    except ValueError as e:
        out["live_fit"] = str(e)
    out["live_val"] = Trainer(mesh=plan, logger=False).validate(live)
    return out


def spatial_meshes(world: int) -> list:
    """The script's (data, spatial) meshes on `world` ranks: all of them
    along the height, and on 4 ranks also 2 x 2."""
    return [(1, world)] + ([(2, world // 2)] if world >= 4 else []) if world > 1 else []


def job_spatial(rank: int, world: int, params: dict) -> dict:
    """The script's spatial runs: ``build_sharded_forward`` of each mesh of
    :func:`spatial_meshes` on ``params["images"]`` (the MODEL detector,
    seeded; each rank's outputs saved to ``<workdir>/forward_<d>x<s>_rank<r>.pt``),
    then :func:`job_train`'s runs (``params["runs"]``, on spatial meshes)."""
    from pytorch_retinanet_tpu_torch import Retinanet
    from pytorch_retinanet_tpu_torch.parallel.sharding import (
        build_sharded_forward, make_inference_mesh,
    )

    device, devices = rank_devices(world, params)
    net = Retinanet(device=device, **MODEL)
    images = torch.load(params["images"], weights_only=True)
    for data, spatial in spatial_meshes(world):
        forward, place = build_sharded_forward(
            net.module, make_inference_mesh(devices, data=data, spatial=spatial))
        cls, box = forward(place(images))
        torch.save({"cls": [c.cpu() for c in cls], "box": [b.cpu() for b in box]},
                   os.path.join(params["workdir"], f"forward_{data}x{spatial}_rank{rank}.pt"))
    return job_train(rank, world, params)


def spatial_against_one_process(work: str, world: int, dev: str, images: torch.Tensor,
                                forward_tol: float) -> dict:
    """:func:`job_spatial`'s forwards against one process's (each data
    shard's rows from every rank of it): the largest |difference| and the
    values outside ``forward_tol * (1 + |value|)``."""
    from pytorch_retinanet_tpu_torch import Retinanet

    net = Retinanet(device=dev, **MODEL)
    with torch.inference_mode():
        cls, box = net.module(images.to(net.device), True)
    want = [t.cpu() for t in cls + box]
    out = {}
    for data, spatial in spatial_meshes(world):
        worst, outside = 0.0, 0
        for r in range(world):
            got = torch.load(os.path.join(work, f"forward_{data}x{spatial}_rank{r}.pt"),
                             weights_only=True)
            rows = slice(r // spatial * len(images) // data, (r // spatial + 1) * len(images) // data)
            for g, w in zip(got["cls"] + got["box"], want):
                diff = (g - w[rows]).abs()
                worst = max(worst, float(diff.max()))
                outside += int((diff > forward_tol * (1 + w[rows].abs())).sum())
        out[f"{data}x{spatial}"] = {"max_abs": worst, "outside": outside}
    return out


def job_train_meshes(rank: int, world: int, params: dict) -> dict:
    """``make_train_mesh`` of each of ``params["knobs"]`` on `world` CPU
    ranks, and a ``Trainer`` on it: the axis sizes, this rank's coordinates,
    and the error for a data axis the world cannot hold."""
    from pytorch_retinanet_tpu_torch import Trainer
    from pytorch_retinanet_tpu_torch.parallel import make_train_mesh

    out = {}
    for key, knob in params["knobs"].items():
        plan = make_train_mesh(["cpu"] * world, **knob)
        trainer = Trainer(mesh=plan)
        out[key] = {"sizes": [plan.axis_size(a) for a in ("data", "spatial", "model")],
                    "coords": list(plan.coords), "trainer_mesh": trainer.mesh is plan}
        try:
            make_train_mesh(["cpu"] * world, spatial=knob["spatial"], data=world)
        except ValueError as e:
            out[key]["wrong_data"] = str(e)
    return out


# --------------------------------------------------------------------------- #
# The script: the JAX tool's protocol on the port, on the CPU
# --------------------------------------------------------------------------- #
def records_overlap(a: list, b: list, box_tol: float = 1e-3, score_tol: float = 1e-5) -> float:
    """Share of `b`'s records that `a` has (same image and class, box and
    score within the tolerances), matched one to one."""
    left = list(a)
    hit = 0
    for r in b:
        for i, s in enumerate(left):
            if (s["image_id"] == r["image_id"] and s["category_id"] == r["category_id"]
                    and abs(s["score"] - r["score"]) <= score_tol
                    and max(abs(x - y) for x, y in zip(s["bbox"], r["bbox"])) <= box_tol):
                hit += 1
                del left[i]
                break
    return hit / max(len(b), 1)


@contextlib.contextmanager
def one_process_global_bn():
    """One process on the live layer's global-batch path (its all-reduces
    the identity): the ranks' arithmetic, for a one-process reference of a
    live-BN fit."""
    from pytorch_retinanet_tpu_torch.models import layers

    saved = layers.get_world_size, layers.dist
    layers.get_world_size = lambda: 2
    layers.dist = types.SimpleNamespace(all_reduce=lambda t: None)
    try:
        yield
    finally:
        layers.get_world_size, layers.dist = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "MULTIHOST_TORCH.json"))
    ap.add_argument("--world", type=int, default=2, help="ranks (default 2)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="cuda (default): NCCL, one card per rank; cpu: gloo ranks")
    ap.add_argument("--only", nargs="+", choices=("data", "spatial"), default=("data", "spatial"),
                    help="run only these parts: the data-parallel protocol, the spatial meshes")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == "MULTIHOST.json":
        raise SystemExit("MULTIHOST.json is the JAX package's record; write MULTIHOST_TORCH.json")
    world, dev = args.world, args.device
    cuda = dev == "cuda"
    if cuda:
        if torch.cuda.device_count() < world:
            raise SystemExit(f"--device cuda --world {world} needs {world} cards, have "
                             f"{torch.cuda.device_count()}")
        from pytorch_retinanet_tpu_torch.kernels.build import build

        build(["stem", "nms", "match"])  # once, before the ranks load them
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    # The card's f32 convolutions and sums differ in order between batch
    # shapes by more than the CPU's (tests/test_torch_card_parallel.py's bars).
    loss_rtol, update_rtol = (1e-5, 1e-4) if cuda else (1e-6, 1e-5)
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="torch_multihost_") as work:
        report = run_protocol(work, world, dev, loss_rtol, update_rtol, tuple(args.only))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"ok": report["ok"], "checks": report["checks"]}))
    return 0 if report["ok"] else 1


def run_protocol(work: str, world: int, dev: str, loss_rtol: float, update_rtol: float,
                 parts: tuple = ("data", "spatial")) -> dict:
    """The script's runs and checks, in `work`: the report. `parts`: the
    data-parallel runs (:func:`data_parallel_part`), the spatial ones
    (:func:`spatial_part`)."""
    cuda = dev == "cuda"
    train_state = seeded_state(TRAIN_MODEL)
    t0 = time.perf_counter()
    checks: Dict[str, bool] = {}
    report: Dict[str, Any] = {}
    for part in parts:
        c, r = {"data": data_parallel_part, "spatial": spatial_part}[part](
            work, world, dev, train_state, loss_rtol, update_rtol)
        checks.update(c)
        report.update(r)
    device = (f"{world} x {torch.cuda.get_device_name(0)}, NCCL" if cuda
              else f"cpu, gloo, {world} ranks")
    if cuda:
        device += "; nvidia-smi name, power.limit: " + "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines())
    only = "" if set(parts) == {"data", "spatial"} else f" --only {' '.join(parts)}"
    return {
        "ok": all(checks.values()), "checks": checks,
        "command": f"python tools/torch_multihost_smoke.py --world {world} --device {dev}{only}",
        "device": f"{device}; torch {torch.__version__}", **report,
        "tolerances": {"loss_rtol": loss_rtol, "update_rtol": update_rtol,
                       "spatial_forward": SPATIAL_FORWARD_TOL},
        "seconds": time.perf_counter() - t0,
    }


def _joined(what: str, run: RankRun) -> list:
    r = run.join()
    if r["timed_out"] or any(r["exitcodes"]):
        raise SystemExit(f"{what} ranks failed: {r['exitcodes']} {r['results']}")
    return r["results"]


def data_parallel_part(work: str, world: int, dev: str, train_state: dict, loss_rtol: float,
                       update_rtol: float) -> tuple:
    """The JAX tool's protocol: the merged test and validation, and 2 SGD
    steps with frozen and live BN, each rank its rows, against one process.
    (checks, report entries)."""
    from pytorch_retinanet_tpu_torch import OmegaConf, RetinaNetModel, Trainer

    csv = write_csv_dataset(os.path.join(work, "csv"))
    state = trained_state(csv)
    torch.save(state, os.path.join(work, "state.pt"))
    batches = seeded_train_batches(2, 2 * world)
    torch.save({"batches": batches, "state": train_state}, os.path.join(work, "train.pt"))
    runs = {"frozen": {"trainer": {"max_steps": 2}},
            "live": {"model": {"freeze_bn": False}, "trainer": {"max_steps": 2}}}
    kw = dict(world=world, backend="nccl" if dev == "cuda" else "gloo")
    ev = _joined("eval", RankRun(job_eval, {"conf": csv_conf(csv),
                                            "state": os.path.join(work, "state.pt"),
                                            "device": dev},
                                 workdir=os.path.join(work, "eval"), **kw))
    tr = _joined("train", RankRun(job_train, {"data": os.path.join(work, "train.pt"),
                                              "runs": runs, "device": dev},
                                  workdir=os.path.join(work, "train"), **kw))
    single = RetinaNetModel(OmegaConf.create(csv_conf(csv)), device=dev)
    single.net.load_state_dict(state)
    st = Trainer(logger=False)
    one = test_with_records(st, single)
    one_val = st.validate(single)
    train = {name: train_against_one_process(os.path.join(work, "train"), name, run, batches,
                                             train_state, tr, dev, loss_rtol, update_rtol)
             for name, run in runs.items()}
    overlap = records_overlap(ev[0]["records"], one["records"])
    checks = {
        f"gather_saw_{world}_shards": sum(r["shard_images"] for r in ev) == 7,
        "all_images_merged": sorted(ev[0]["img_ids"]) == sorted(one["img_ids"]),
        "ranks_agree": all(r["AP"] == ev[0]["AP"] and r["records"] == ev[0]["records"]
                           for r in ev),
        "records_match_single_process": overlap == 1.0
        and len(ev[0]["records"]) == len(one["records"]),
        "ap_matches_single_process": abs(ev[0]["AP"] - one["AP"]) <= 1e-6,
        "val_loss_matches_single_process": abs(ev[0]["val"]["val_loss"] - one_val["val_loss"])
        <= loss_rtol * abs(one_val["val_loss"]),
        "train_loss_finite": all(bool(np.isfinite(v["losses"]).all()) for v in train.values()),
        "train_matches_single_process": all(v["loss_ok"] and v["update_gap_of_bound"] <= 1.0
                                            for v in train.values()),
        "train_ranks_bit_for_bit": all(v["ranks_bit_for_bit"] for v in train.values()),
    }
    return checks, {
        "ap_merged": ev[0]["AP"], "ap_single_process": one["AP"],
        "n_merged_records": len(ev[0]["records"]), "record_overlap_vs_single": overlap,
        "val_loss": {"merged": ev[0]["val"]["val_loss"], "single": one_val["val_loss"]},
        "train": train,
    }


def spatial_part(work: str, world: int, dev: str, train_state: dict, loss_rtol: float,
                 update_rtol: float) -> tuple:
    """The spatial meshes of :func:`spatial_meshes` at 128x192 (4 units of
    32 rows): ``build_sharded_forward`` and 2 SGD steps (frozen BN) against
    one process. (checks, report entries)."""
    batches = seeded_train_batches(2, 4, h=128, w=192, seed=6)
    torch.save({"batches": batches, "state": train_state}, os.path.join(work, "spatial.pt"))
    images = torch.rand((2, 128, 192, 3), generator=torch.Generator().manual_seed(6))
    torch.save(images, os.path.join(work, "spatial_images.pt"))
    runs = {f"{d}x{s}": {"spatial": s, "trainer": {"max_steps": 2}}
            for d, s in spatial_meshes(world)}
    ranks = _joined("spatial", RankRun(
        job_spatial, {"data": os.path.join(work, "spatial.pt"),
                      "images": os.path.join(work, "spatial_images.pt"), "runs": runs,
                      "device": dev},
        workdir=os.path.join(work, "spatial"), world=world,
        backend="nccl" if dev == "cuda" else "gloo"))
    train = {name: train_against_one_process(os.path.join(work, "spatial"), name, run, batches,
                                             train_state, ranks, dev, loss_rtol, update_rtol)
             for name, run in runs.items()}
    forward = spatial_against_one_process(os.path.join(work, "spatial"), world, dev, images,
                                          SPATIAL_FORWARD_TOL)
    checks = {
        "spatial_forward_matches_single_process": all(not v["outside"] for v in forward.values()),
        "spatial_train_matches_single_process": all(
            v["loss_ok"] and v["update_gap_of_bound"] <= 1.0 for v in train.values()),
        "spatial_train_ranks_bit_for_bit": all(v["ranks_bit_for_bit"] for v in train.values()),
    }
    return checks, {"spatial_forward": forward, "spatial_train": train}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())

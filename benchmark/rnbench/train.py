"""The training driver: ``Trainer.fit`` over batches as ``DetectionLoader``
yields them (dicts of pinned CPU tensors), on one card or data-parallel.

Traffic parameters (``benchmark/traffic/<name>.json``, ``"driver": "train"``):

- ``batch``: images per rank and step; ``batches``: distinct batches a rank
  makes and cycles (rows all differ);
- ``world``: ranks, one card each, DDP over NCCL;
- ``warmup_steps``: the Trainer's steps before the window (at least 4:
  the reference follows the first three);
- ``min_fg``: foreground anchors every image has at least (0 when left
  out; :func:`_draw_boxes`).

The Trainer runs without its LR warmup, at the optimizer's constant LR: the
window stands for the job past its warmup (under the default warmup the
first steps move the f32 weights by less than their rounding, and the
reference could not tell a step from none).

The loader is the benchmark's: it hands the Trainer the warm-up batches,
then starts the window after a synchronize, yields batches until the
window's seconds have passed (the ranks agree at each fetch, over a gloo
group), synchronizes, and with ``--trace 1`` yields a few more steps inside
a profiler window; then it sets ``trainer.should_stop``. The same fit, the
same model and optimizer, serve set-up and window. ``train_img_s`` counts
the images of every step the window's fetches handed out, over the window's
seconds, which end after the last of them has completed.
"""

from __future__ import annotations

import gc
import os
import queue
import socket
import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import reference as R
from . import tracing, weights, yardstick
from .spec import Spec

MAX_GT = 100
MAX_DRAWS = 1000
CHECK_STEPS = 3
TRACE_STEPS = 3
STAGE_REPS = 3
REF_BLOCK = 4  # images per reference forward and backward
JOIN_TIMEOUT_S = 330
# The loader's ``len``, an epoch of COCO train2017 over the ranks' batches:
# the Trainer's epoch-end log never falls inside the window.
EPOCH_IMAGES = 118287


def make_batches(traffic: Dict, seed: int, rank: int, bucket, num_classes: int, device,
                 pin: bool) -> List[Dict[str, torch.Tensor]]:
    """This rank's batches: uint8 noise images made on the device and GT of
    1-100 boxes of 16-400 px an image. Every seed has the same multiset of
    GT counts, in its own order, and every image at least the traffic's
    ``min_fg`` foreground anchors (:func:`_draw_boxes`)."""
    n, b = int(traffic["batches"]), int(traffic["batch"])
    h, w = bucket
    rng = np.random.default_rng([int(seed), 3, rank])
    counts = rng.permutation(np.rint(np.linspace(1, MAX_GT, n * b)).astype(np.int64)).reshape(n, b)
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**62)))
    images = torch.randint(0, 256, (n, b, h, w, 3), generator=gen, device=device, dtype=torch.uint8)
    anchors = torch.from_numpy(np.concatenate(R.anchors_per_level(bucket))).to(device)
    min_fg = int(traffic.get("min_fg", 0))
    out = []
    for i in range(n):
        boxes = np.stack([_draw_boxes(rng, int(c), anchors, w, h, min_fg) for c in counts[i]])
        valid = np.arange(MAX_GT)[None] < counts[i][:, None]
        labels = np.where(valid, rng.integers(1, num_classes + 1, (b, MAX_GT)), 0).astype(np.int32)
        batch = {"images": images[i].cpu(), "boxes": torch.from_numpy(boxes),
                 "labels": torch.from_numpy(labels), "valid": torch.from_numpy(valid)}
        out.append({k: v.pin_memory() if pin else v for k, v in batch.items()})
    return out


def _draw_boxes(rng, count: int, anchors: torch.Tensor, w: int, h: int, min_fg: int) -> np.ndarray:
    """One image's GT rows [MAX_GT, 4] f32: `count` boxes of 16-400 px a
    side, the rest zero, drawn again until at least `min_fg` anchors
    match one of them above the foreground IoU. An image whose boxes match
    no anchor has its loss divided by 1 in place of its foreground count:
    its sum over every background logit then outweighs the rest of its
    batch, and a seed that drew one read bf16 gradient gaps 2.6 times the
    other seeds' worst (PERF.md)."""
    for _ in range(MAX_DRAWS):
        ctr = rng.uniform([0, 0], [w, h], (MAX_GT, 2))
        wh = rng.uniform(16, 400, (MAX_GT, 2))
        boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).clip(0, [w, h, w, h])
        boxes[count:] = 0.0
        boxes = boxes.astype(np.float32)
        gt = torch.from_numpy(boxes[:count]).to(anchors.device)
        if min_fg == 0 or int((R.iou(gt, anchors).max(0).values > R.FG_IOU).sum()) >= min_fg:
            return boxes
    raise ValueError(f"no draw of {count} boxes in {MAX_DRAWS} gave {min_fg} foreground anchors")


class _Job:
    """One rank's fit: set-up, the loader's phases, and what it recorded."""

    def __init__(self, p: Dict, rank: int, world: int, device, host_group):
        self.p, self.rank, self.world, self.device = p, rank, world, device
        self.group = host_group
        self.snap: Dict[str, Dict[str, torch.Tensor]] = {}
        self.losses: List[torch.Tensor] = []
        self.trace: Dict = {}
        self.window = {}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def agree(self, flag: bool) -> bool:
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def barrier(self):
        if self.world > 1:
            dist.barrier(group=self.group)

    def snapshot(self, what: str):
        module = self.model.net.module
        if what == "held":
            state, opt = self.model.optimizer.state, self.p["cfg"]["optimizer"]
            self.snap[what] = {k: self.optim.held(state.get(v, {}), v, opt).detach().clone()
                               for k, v in module.named_parameters()}
        else:
            self.snap[what] = {k: v.detach().clone() for k, v in module.named_parameters()}

    def feed(self):
        tr, batches = self.p["traffic"], self.batches
        n = len(batches)
        warm = int(tr["warmup_steps"])
        if warm <= CHECK_STEPS:
            raise ValueError(f"warmup_steps must exceed the {CHECK_STEPS} steps the reference follows")
        for k in range(warm):
            if k == 1:
                self.snapshot("held")
            if k == CHECK_STEPS:
                self.snapshot("params")
            yield batches[k % n]
        self.sync()
        self.barrier()
        t0 = time.perf_counter()
        setup_s = time.time() - self.p["t_start"]
        deadline = t0 + self.p["seconds"]
        steps = 0
        while not self.agree(time.perf_counter() >= deadline):
            yield batches[(warm + steps) % n]
            steps += 1
        self.sync()
        self.barrier()
        self.window = {"steps": steps, "seconds": time.perf_counter() - t0, "setup_s": setup_s}
        if self.p["trace"]:
            for _ in range(tracing.WINDOWS):
                self.sync()
                win = tracing.Window()
                win.start()
                for j in range(TRACE_STEPS):
                    yield batches[(warm + steps + j) % n]
                self.sync()
                self.trace = win.stop(TRACE_STEPS)
                self.trace_batches = [(warm + steps + j) % n for j in range(TRACE_STEPS)]
                if self.trace:
                    break
        self.trainer.should_stop = True

    def run(self) -> Dict:
        from pytorch_retinanet_tpu_torch import ConfigDict, RetinaNetModel, Trainer

        p, cfg, tr = self.p, self.p["cfg"], self.p["traffic"]
        m = cfg["model"]
        job = self

        class Model(RetinaNetModel):
            def prepare_data(self):
                pass

            def train_dataloader(self, shard=0, num_shards=1):
                return _Loader(job)

            def val_dataloader(self, shard=0, num_shards=1):
                return None

            def configure_optimizers(self):
                out = super().configure_optimizers()
                self.optimizer = out[0]
                return out

        spec = Spec(Path(p["root"]))
        fam, self.optim = spec.family(cfg), spec.optimizer(cfg)
        sd = weights.make_state_dict(fam, m, m["prior"], p["seed"], self.device)
        hp = {"model": {k: m[k] for k in ("backbone_kind", "num_classes", "min_size", "max_size",
                                          "compute_dtype", "freeze_bn", "prior")},
              "optimizer": cfg["optimizer"]}
        hp["model"]["pretrained"] = False
        hp["model"].update(cfg.get("program", {}))
        self.model = Model(ConfigDict(hp), device=self.device)
        self.model.net.load_torch_state_dict(sd)
        self.bucket = (R.ceil32(m["min_size"]), R.ceil32(m["max_size"]))  # landscape
        self.batches = make_batches(tr, p["seed"], self.rank, self.bucket, m["num_classes"],
                                    self.device, self.device.type == "cuda")
        self.epoch_batches = EPOCH_IMAGES // (int(tr["batch"]) * self.world)
        self.trainer = Trainer(max_epochs=1, warmup_steps=0, num_sanity_val_steps=0, logger=False)
        real_step = self.trainer.train_step

        def recorded(batch):
            out = real_step(batch)
            if len(self.losses) < CHECK_STEPS:
                self.losses.append(out["loss"].detach().clone())
            return out

        self.trainer.train_step = recorded
        self.trainer.fit(self.model)
        out = {"window": self.window, "trace": self.trace, "spans": {}, "counters": {}}
        if p["trace"] and self.rank == 0:
            out.update(self.stage_spans())
        self.barrier()
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(self.device)
                                    if self.device.type == "cuda" else 0)
        losses = [float(v) for v in self.losses]
        snap = self.snap
        del self.model, self.trainer, real_step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        with R.f32_exact():
            ref = reference_steps(sd, [[b] for b in self.batches[:CHECK_STEPS]], fam, m, self.optim,
                                  cfg["optimizer"], self.device,
                                  reduce_group=dist.group.WORLD if self.world > 1 else None)
        out["detail"] = [f"rank {self.rank}:"]
        out["checks"] = train_checks(losses, snap["held"], snap["params"], sd, ref, out["detail"])
        return out

    def stage_spans(self) -> Dict:
        """Forward, loss and backward of one batch by CUDA events, and the
        match kernel's cull counts over the traced steps' batches."""
        from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level, retinanet_loss_levels

        net = self.model.net
        module = net.module
        module.train()
        dev = self.device
        batch = {k: v.to(dev) for k, v in self.batches[0].items()}
        gt = [batch[k] for k in ("boxes", "labels", "valid")]
        anchors = [torch.from_numpy(a).to(dev) for a in generate_anchors_per_level(self.bucket)]

        def forward():
            return module(batch["images"], return_levels=True)

        def forward_loss():
            out = retinanet_loss_levels(*forward(), anchors, *gt, num_classes=net.num_classes)
            return out["classification_loss"] + out["regression_loss"]

        def forward_loss_backward():
            forward_loss().backward()
            module.zero_grad(set_to_none=True)

        f = statistics.median(tracing.cuda_ms(forward, STAGE_REPS))
        fl = statistics.median(tracing.cuda_ms(forward_loss, STAGE_REPS))
        flb = statistics.median(tracing.cuda_ms(forward_loss_backward, STAGE_REPS))
        module.eval()
        cull = []
        for i in getattr(self, "trace_batches", []):
            b = self.batches[i]
            staged = tested = 0.0
            for a in anchors:
                s, t = yardstick.match_cull_counts(a, b["boxes"].to(dev), b["valid"].to(dev))
                staged, tested = staged + s, tested + t
            cull.append([staged, tested])
        return {"spans": {"train.forward": [f], "train.loss": [fl - f], "train.backward": [flb - fl]},
                "counters": {"match.cull_per_step": cull, "match.anchors": sum(a.shape[0] for a in anchors),
                             "match.batch": int(self.p["traffic"]["batch"]), "match.max_gt": MAX_GT}}


class _Loader:
    """The Trainer's train loader: a ``len`` for the job, batches from the phases."""

    def __init__(self, job: _Job):
        self.job = job

    def __len__(self):
        return self.job.epoch_batches

    def __iter__(self):
        return self.job.feed()


def _param_keys(sd: Dict[str, torch.Tensor], fam, m: Dict) -> List[str]:
    """The keys that train: all but those of the family's buffer roles."""
    buffers = {key for key, _, role in fam.schema(m) if role in fam.BUFFERS}
    return [k for k in sd if k not in buffers]


def reference_steps(sd, steps, fam, m: Dict, optimizer, opt: Dict, device, q: R.Quant = None,
                    reduce_group=None, half: bool = False) -> Dict:
    """The reference's optimizer steps from `sd`: the detector of the trunk
    family `fam`, the update of the optimizer reference `optimizer`
    (``benchmark/optimizers/``) with the configuration's `opt`.
    ``steps[k]`` lists step k's batches, one per data-parallel rank: the
    step's gradient is their mean (and, with `reduce_group`, averaged again
    over that group's ranks, each of which passes its own). Returns each
    step's loss on its first batch, the first step's gradient, that
    gradient as the optimizer holds it after the step, and the parameters'
    change. `half` plants a fault: each batch's loss is the mean over its
    first half alone."""
    keys = _param_keys(sd, fam, m)
    params = {k: sd[k].detach().clone().requires_grad_(True) for k in keys}
    full = dict(sd)
    full.update(params)
    bucket = tuple(steps[0][0]["images"].shape[1:3])
    anchors = torch.from_numpy(np.concatenate(R.anchors_per_level(bucket))).to(device)
    losses, state, first = [], {}, {}
    for step, batches in enumerate(steps):
        for r, batch in enumerate(batches):
            loss_r = _accumulate(full, batch, fam, anchors, m, device, q, half, len(batches))
            if r == 0:
                losses.append(loss_r)
        grads = [params[k].grad for k in keys]
        if reduce_group is not None:
            flat = torch.cat([g.flatten() for g in grads])
            dist.all_reduce(flat, group=reduce_group)
            flat /= dist.get_world_size(reduce_group)
            grads = [g.view_as(params[k]) for g, k in
                     zip(torch.split(flat, [g.numel() for g in grads]), keys)]
        with torch.no_grad():
            grads = dict(zip(keys, grads))
            if step == 0:
                first["grad"] = {k: g.clone() for k, g in grads.items()}
            held = optimizer.update(params, grads, state, step, opt)
            if step == 0:
                first["held"] = {k: held[k].clone() for k in keys}
            for k in keys:
                params[k].grad = None
    return {"losses": losses, **first, "delta": {k: (params[k] - sd[k]).detach() for k in keys}}


def _accumulate(full, batch, fam, anchors, m: Dict, device, q, half: bool, share: int) -> float:
    """Backward of one batch's mean loss divided by `share`, in blocks of
    rows, into the parameters' ``.grad``; returns the batch's mean loss."""
    rows = list(range(batch["images"].shape[0]))
    if half:
        rows = rows[: len(rows) // 2]
    total = 0.0
    for start in range(0, len(rows), REF_BLOCK):
        block = rows[start:start + REF_BLOCK]
        cls, box = R.detector(full, batch["images"][block].to(device), fam, m, q)
        cls, box = torch.cat(cls, 1), torch.cat(box, 1)
        loss = 0.0
        for j, i in enumerate(block):
            v = batch["valid"][i].to(device)
            loss = loss + R.image_loss(cls[j], box[j], anchors, batch["boxes"][i].to(device)[v],
                                       batch["labels"][i].to(device)[v], m["num_classes"])
        loss = loss / len(rows)
        (loss / share).backward()
        total += float(loss.detach())
        del cls, box, loss
    return total


# A leaf whose reference gradient is under this share of the median leaf's
# moves by rounding and weight decay alone: it is left out of the
# change's comparison (a key's bias under softmax has such a gradient).
STILL_LEAF = 1e-3


def train_checks(losses: List[float], held: Dict, params3: Dict, sd: Dict, ref: Dict,
                 detail: Optional[List[str]] = None) -> Dict:
    """Each of the three steps' loss (the largest gap relative to the
    reference's), the first gradient as the optimizer holds it and the
    parameters' change after the three steps, the last two against the
    reference by the worst leaf."""
    from .compare import leaf_gaps

    if detail is not None:
        detail.append(f"losses, program {losses} reference {ref['losses']}")
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(losses, ref["losses"]))
    grad_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["grad"].items()}
    median = float(np.median(list(grad_norms.values())))
    moving = [k for k, v in grad_norms.items() if v >= STILL_LEAF * median]
    delta = {k: params3[k] - sd[k] for k in params3}
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gaps(held, ref["held"], detail=detail, what="first gradient"),
            "change_gap": leaf_gaps(delta, ref["delta"], moving, detail, "change")}


# --------------------------------------------------------------------------- #
# Ranks
# --------------------------------------------------------------------------- #
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, params: Dict, results) -> None:
    """A spawned rank: its card, the process group, its job; its result (or
    its error) on the queue."""
    try:
        from pytorch_retinanet_tpu_torch.parallel import init_distributed

        if params.get("rank_hook"):  # tests break the timed path in each rank
            module, fn = params["rank_hook"].split(":")
            getattr(__import__(module, fromlist=[fn]), fn)()
        cuda = params["device_type"] == "cuda"
        if cuda:
            torch.cuda.set_device(rank)
            torch.set_num_threads(1)  # as run.py sets it for one card
        else:  # CPU ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_distributed(f"tcp://127.0.0.1:{params['port']}", world, rank,
                         backend="nccl" if cuda else "gloo")
        group = dist.new_group(backend="gloo")
        device = torch.device("cuda", rank) if cuda else torch.device("cpu")
        out = _Job(params, rank, world, device, group).run()
        out["modules"] = sorted({m.split(".")[0] for m in list(__import__("sys").modules)})
        results.put((rank, out))
        dist.barrier(group=group)
        dist.destroy_process_group()
    except BaseException as e:  # the parent reports it and stops the other ranks
        import traceback

        results.put((rank, {"error": f"{type(e).__name__}: {e}\n{traceback.format_exc()}"}))
        raise


def run(ctx) -> Dict:
    world = int(ctx.traffic.get("world", 1))
    params = {"cfg": ctx.cfg, "traffic": ctx.traffic, "root": str(ctx.spec.root), "seed": ctx.seed,
              "seconds": ctx.seconds, "trace": ctx.trace, "t_start": ctx.t_start,
              "device_type": ctx.device.type, "rank_hook": getattr(ctx, "rank_hook", None)}
    if world == 1:
        outs = [_Job(params, 0, 1, ctx.device, None).run()]
    else:
        outs = _spawn(params, world)
    return combine(outs, ctx.cfg, ctx.traffic, world)


def _spawn(params: Dict, world: int) -> List[Dict]:
    import torch.multiprocessing as mp

    params = dict(params, port=_free_port())
    smp = mp.get_context("spawn")
    results = smp.Queue()
    procs = [smp.Process(target=_rank_main, args=(r, world, params, results), daemon=False)
             for r in range(world)]
    for p in procs:
        p.start()
    outs: Dict[int, Dict] = {}
    deadline = time.time() + JOIN_TIMEOUT_S
    try:
        while len(outs) < world:
            try:
                rank, out = results.get(timeout=5)
            except queue.Empty:
                if time.time() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError("a rank ended without a result: exit codes "
                                       f"{[p.exitcode for p in procs]}")
                continue
            if "error" in out:
                raise RuntimeError(f"rank {rank} failed:\n{out['error']}")
            outs[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [outs[r] for r in range(world)]


def combine(outs: List[Dict], cfg: Dict, traffic: Dict, world: int) -> Dict:
    """The ranks' records -> the run's: images over the window summed over
    the ranks, the widest check, the fullest card, the mean busy time."""
    w0 = outs[0]["window"]
    batch = int(traffic["batch"])
    e2e = {"train_img_s": sum(o["window"]["steps"] for o in outs) * batch / w0["seconds"],
           "setup_s": w0["setup_s"]}
    checks = {k: max(o["checks"][k] for o in outs) for k in outs[0]["checks"]}
    trace = dict(outs[0]["trace"])
    if trace:
        trace["busy_s"] = sum(o["trace"]["busy_s"] for o in outs) / len(outs)
        trace["window_s"] = sum(o["trace"]["window_s"] for o in outs) / len(outs)
    m = cfg["model"]
    return {"e2e": e2e, "attempted": w0["steps"], "failed": 0,
            "memory_peak_bytes": max(o["memory_peak_bytes"] for o in outs), "checks": checks,
            "trace": trace, "spans": outs[0]["spans"], "counters": outs[0]["counters"],
            "batch": batch, "world": world, "bucket": (R.ceil32(m["min_size"]), R.ceil32(m["max_size"])),
            "rank_modules": sorted({n for o in outs for n in o.get("modules", [])}),
            "detail": [line for o in outs for line in o.get("detail", [])]}


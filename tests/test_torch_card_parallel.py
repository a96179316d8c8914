"""Data parallel and the spatial and tensor-parallel meshes on the card.

The card's machine has one H100: NCCL runs there at world size 1 (it refuses
two ranks on one card), and the cross-rank checks run two gloo ranks that
share the card (``tools/torch_multihost_smoke.py``'s ``RankRun``; the rank
jobs are this module's functions, which the spawned ranks import). R50-FPN
at full width (``tests/torch_card.py``'s ``HPARAMS``):

- ``init_distributed(backend="nccl")`` and ``Trainer(devices=[0])``: the
  7-step fit through ``DistributedDataParallel`` launches the match kernel 35
  times; its parameters equal a plain fit's bit for bit where a second plain
  fit does, else they are within ``DDP_GAP_FACTOR`` times that pair's gap
  (cuDNN's backward is not bit-reproducible); ``all_gather_objects`` and
  ``reduce_dict`` through NCCL;
- two gloo ranks: the live BN layer on each rank's rows of
  ``LAYER_BN_SHAPE`` against ``F.batch_norm`` in f64 over the whole batch
  (every tensor within ``BN_RTOL`` of its largest |value|; in bf16 the output
  and input gradient within 1 bf16 ulp of the f64 value + ``BN_RTOL`` of the
  largest); the ``match_mesh`` loss at the training shapes equal to the
  unsplit kernel's, 5 match launches a rank; f32 resnet18 at 128x192, live
  BN, 2 SGD steps at batch 2 a rank against one process at batch 4 (losses
  within ``SMALL_LOSS_RTOL``, the first step's updates within
  ``SMALL_UPDATE_RTOL`` of each tensor's largest + 2 ulp, running statistics
  within ``SMALL_STATS_RTOL``); R50-FPN bf16 live BN, 4 steps at batch 8 a
  rank: finite, 5 match launches a step, the ranks' state bit for bit;
- ``Trainer.test`` merged across two gloo ranks on the seeded COCO val split:
  stem (f32) and NMS once a batch in each rank, the ranks' results equal,
  and equal to one process's (or within JAX's multi-process bar:
  ``MERGED_OVERLAP`` of the records, AP within ``MERGED_AP_TOL``);
- the meshes on two gloo ranks: the split forward at spatial 2 (f32, TF32
  off, within ``SPLIT_F32_TOL`` of the unsplit forward; bf16 predict through
  it, its detections within ``MERGED_OVERLAP`` of the unsplit forward's at
  ``SPLIT_BF16_*_TOL``, NMS launched once); ``build_sharded_forward(data=2)``
  on uint8 (the stem launched once, bit for bit with ``apply_detector`` on
  the rank's rows); tensor parallel (model 2, f32, within ``SPLIT_F32_TOL``);
  spatial training (f32 resnet18 against one process at the small bars;
  R50-FPN bf16, 3 steps: finite, 5 match launches a step, the ranks bit for
  bit).

Run on the card as ``tests/torch_card.py`` says; ``-k spatial`` or ``-k
gloo`` picks parts.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from torch_card import (  # noqa: F401
    H, HPARAMS, TRAIN_BATCH, TRAIN_STEPS, W, counted, coco_conf, dev, fit_seven, seeded_batches,
    served_model_class, small_batch, write_coco_dataset,
)
import torch_multihost_smoke as mh  # noqa: E402 (tools/, on the path after torch_card)

from pytorch_retinanet_tpu_torch import ConfigDict

pytestmark = pytest.mark.cuda

DDP_TIMEOUT = 600  # join timeout of each two-rank spawn, seconds
DDP_GAP_FACTOR = 4.0
SMALL_LOSS_RTOL, SMALL_UPDATE_RTOL, SMALL_STATS_RTOL = 1e-5, 1e-4, 1e-5
SMALL_NET = {"backbone_kind": "resnet18", "num_classes": 90, "pretrained": False,
             "min_size": 128, "max_size": 192, "compute_dtype": "float32", "prior": 0.1,
             "freeze_bn": False}
SMALL_OPTIMIZER = {"class_name": "torch.optim.SGD",
                   "params": {"lr": 0.01, "weight_decay": 0.001, "momentum": 0.9}}
# layer3.0.bn1's shape at 800x1344, 8 rows a rank.
LAYER_BN_SHAPE = (16, 256, 100, 168)
BN_RTOL = 1e-6
FULL_RANK_BATCH, FULL_STEPS = 8, 4
# The JAX package's own multi-process bar (tools/multihost_smoke.py:23-25).
MERGED_OVERLAP, MERGED_AP_TOL = 0.97, 2e-3
SPLIT_NET = {"backbone_kind": "resnet50", "num_classes": 90, "pretrained": False, "prior": 0.5,
             "seed": 16}
SPLIT_BATCH = 2
# JAX's bar for its sharded forwards (tests/test_sharding.py), absolute and relative.
SPLIT_F32_TOL = 1e-4
# bf16 detections of the split forward against the unsplit forward's: the
# shards' convolutions run other cuDNN algorithms, and bf16 logits one ulp
# apart move a score near 0.5 by ~1e-3.
SPLIT_BF16_BOX_TOL, SPLIT_BF16_SCORE_TOL = 2.0, 1e-2
SPATIAL_STEPS = 3


def joined(run) -> list:
    """The ranks' results; a failed or timed-out rank fails the test."""
    out = run.join()
    assert not out["timed_out"] and all(c == 0 for c in out["exitcodes"]), \
        [r.get("traceback") if r else None for r in out["results"]]
    return out["results"]


def rank_device(params: dict, rank: int) -> torch.device:
    return torch.device("cuda", params["devices"][rank])


def small_data(path: str) -> list:
    """Two global batches of 4 f32 128x192 images and the seeded live-BN
    resnet18 state, saved to `path` for the ranks."""
    rng = np.random.default_rng(8)
    batches = [small_batch(rng, n_valid) for n_valid in ([5, 0, 3, 1], [2, 4, 0, 6])]
    state = mh.seeded_state(SMALL_NET, seed=3)
    torch.save({"batches": batches, "state": state}, path)
    return batches, state


def full_width_job(rank: int, world: int, params: dict) -> dict:
    """R50-FPN bf16 steps on seeded uint8 batches of ``params["batch"]``
    rows a data shard (each rank its rows), or with ``params["spatial"]``
    every rank the whole batch through the height split: losses, launches
    and the state digest."""
    from pytorch_retinanet_tpu_torch import Trainer
    from pytorch_retinanet_tpu_torch.parallel import make_train_mesh

    model = served_model_class()(ConfigDict(params["hparams"]), device="cuda")
    spatial = params.get("spatial", 1)
    shards = 1 if spatial > 1 else world
    batches = seeded_batches(params["steps"], params["batch"] * shards, seed=14)
    model.loader = [mh.rows_of(b, rank % shards, shards) for b in batches]
    mesh = make_train_mesh(params["devices"], spatial=spatial) if spatial > 1 else None
    trainer = Trainer(devices=params["devices"], mesh=mesh, max_steps=params["steps"],
                      warmup_steps=500, log_every_n_steps=1, num_sanity_val_steps=0, logger=False)
    _, launches = counted(lambda: trainer.fit(model))
    return {"losses": list(trainer.logger_.meters["loss"].window),
            "digest": mh.state_digest(model.net.module), "launches": launches}


def layer_checks_job(rank: int, world: int, params: dict) -> dict:
    """Live BN on this rank's rows against ``F.batch_norm`` in f64 over the
    global batch (errors of each tensor's largest |value|; in bf16 also the
    y and x_grad elements outside 1 ulp + ``BN_RTOL``), and the
    ``match_mesh`` loss at the training shapes against the unsplit
    kernel's, with the launches of the split call."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from pytorch_retinanet_tpu_torch import parallel
    from pytorch_retinanet_tpu_torch.kernels import match_targets
    from pytorch_retinanet_tpu_torch.models.layers import BatchNorm2d
    from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level, retinanet_loss_levels
    from pytorch_retinanet_tpu_torch.ops.losses import _split_over_ranks

    dev = rank_device(params, rank)
    shape = tuple(params["bn_shape"])
    b, c = shape[:2]
    rows = slice(rank * b // world, (rank + 1) * b // world)
    out = {"bn": {}}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(21)
        x = (torch.randn(shape, generator=g, device=dev) * 3.0 + 1.0).to(dtype)
        w_out = torch.randn(shape, generator=g, device=dev).to(dtype)
        state = {"weight": torch.rand(c, generator=g, device=dev) + 0.5,
                 "bias": torch.randn(c, generator=g, device=dev) * 0.5,
                 "running_mean": torch.randn(c, generator=g, device=dev) * 0.1,
                 "running_var": torch.rand(c, generator=g, device=dev) + 0.5}
        got = mh.live_bn_rows(x, w_out, state, rank, world)
        for k in ("weight_grad", "bias_grad"):  # DDP averages them: their sum is the batch's
            dist.all_reduce(got[k])
        x64 = x.double().requires_grad_(True)
        weight, bias = (state[k].double().requires_grad_(True) for k in ("weight", "bias"))
        y64 = F.batch_norm(x64, None, None, weight, bias, True, 0.0,
                           BatchNorm2d(c, frozen=False).eps)
        (y64 * w_out.double()).sum().backward()
        m = BatchNorm2d.momentum
        want = {"y": y64.detach()[rows], "x_grad": x64.grad[rows], "weight_grad": weight.grad,
                "bias_grad": bias.grad,
                "running_mean": m * state["running_mean"].double()
                + (1 - m) * x64.detach().mean((0, 2, 3)),
                "running_var": m * state["running_var"].double()
                + (1 - m) * x64.detach().var((0, 2, 3), correction=0)}
        errs = {"num_batches_tracked": got["num_batches_tracked"]}
        for k, w in want.items():
            diff = (got[k].double() - w).abs()
            top = float(w.abs().max())
            if dtype == torch.bfloat16 and k in ("y", "x_grad"):
                _, e = torch.frexp(w.float().abs())
                ulp = torch.ldexp(torch.ones_like(w, dtype=torch.float32), e - 8).double()
                errs[k + "_outside"] = int((diff > ulp + BN_RTOL * top).sum())
            else:
                errs[k] = float(diff.max()) / top
        out["bn"][str(dtype)] = errs
        del x, w_out, got, x64, y64, want
    torch.cuda.empty_cache()

    # match_mesh at the training shapes: every rank holds the global batch.
    gt = seeded_batches(1, params["batch"], seed=7)[0]
    anchors = [torch.from_numpy(a).to(dev) for a in generate_anchors_per_level((H, W))]
    boxes = torch.from_numpy(gt["boxes"]).to(dev)
    labels = torch.from_numpy(gt["labels"]).to(dev, torch.int32)
    valid = torch.from_numpy(gt["valid"]).to(dev).bool()
    g = torch.Generator(device=dev).manual_seed(5)
    cls = [torch.randn((params["batch"], a.shape[0], 90), generator=g, device=dev) for a in anchors]
    box = [torch.randn((params["batch"], a.shape[0], 4), generator=g, device=dev) for a in anchors]
    kw = dict(num_classes=90, reduction="none")
    split, launches = counted(lambda: retinanet_loss_levels(
        cls, box, anchors, boxes, labels, valid, match_mesh=parallel.make_mesh(params["devices"]),
        **kw))
    unsplit = retinanet_loss_levels(cls, box, anchors, boxes, labels, valid, **kw)
    args = (0.5, 0.4, (1.0, 1.0, 1.0, 1.0))
    split_match = _split_over_ranks(match_targets, dist.group.WORLD)
    out["match"] = {"launches": launches,
                    "targets_equal": all(torch.equal(p, q) for a in anchors for p, q in zip(
                        split_match(a, boxes, labels, valid, *args),
                        match_targets(a, boxes, labels, valid, *args))),
                    "losses_equal": all(torch.equal(split[k], unsplit[k]) for k in unsplit),
                    "finite": all(bool(torch.isfinite(v).all()) for v in split.values())}
    return out


@pytest.fixture(scope="module")
def work(dev, tmp_path_factory):
    return str(tmp_path_factory.mktemp("parallel"))


def test_ddp_fit_through_nccl_at_world_size_one(dev):
    import torch.distributed as dist

    from pytorch_retinanet_tpu_torch import parallel

    first, _, _, before = fit_seven()
    fitted = {k: p.detach().cpu() for k, p in first.net.module.named_parameters()}
    del first
    second, _, _, _ = fit_seven()

    def gap(model) -> tuple:
        """(bit for bit, the largest max|got - want| over max|want - before|)."""
        got = {k: p.detach().cpu() for k, p in model.net.module.named_parameters()}
        exact = all(torch.equal(got[k], fitted[k]) for k in fitted)
        worst = max(float((got[k] - fitted[k]).abs().max())
                    / max(float((fitted[k] - before[k].cpu()).abs().max()), 1e-30) for k in fitted)
        return exact, worst

    plain_exact, plain_gap = gap(second)
    del second
    torch.cuda.empty_cache()
    parallel.init_distributed(backend="nccl")
    try:
        assert dist.get_backend() == "nccl" and parallel.get_world_size() == 1
        ddp, trainer, launches, _ = fit_seven(devices=[dev.index or 0])
        losses = trainer.logger_.meters["loss"].window
        assert launches["match_targets"] == 5 * TRAIN_STEPS
        assert trainer.global_step == TRAIN_STEPS and np.isfinite(losses).all()
        ddp_exact, ddp_gap = gap(ddp)
        assert ddp_exact or not plain_exact, "a second plain fit is bit for bit, DDP's is not"
        assert ddp_gap <= DDP_GAP_FACTOR * plain_gap, (ddp_gap, plain_gap)
        obj = {"rank": parallel.get_rank(), "x": list(range(5))}
        assert parallel.all_gather_objects(obj) == [obj]
        assert parallel.reduce_dict({"loss": torch.tensor([1.0, 3.0], device=dev)}) == {"loss": 2.0}
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def test_live_bn_and_match_mesh_on_two_gloo_ranks(work):
    out = joined(mh.RankRun(
        layer_checks_job, {"devices": [0, 0], "bn_shape": LAYER_BN_SHAPE, "batch": TRAIN_BATCH},
        timeout=DDP_TIMEOUT, workdir=os.path.join(work, "layers")))
    for o in out:
        for dtype, errs in o["bn"].items():
            assert errs["num_batches_tracked"] == 1
            assert all(v <= BN_RTOL for k, v in errs.items()
                       if k.endswith(("_grad", "y", "_mean", "_var"))), (dtype, errs)
            assert not errs.get("y_outside", 0) and not errs.get("x_grad_outside", 0), errs
        m = o["match"]
        assert m["losses_equal"] and m["targets_equal"] and m["finite"]
        assert m["launches"]["match_targets"] == 5


def test_two_gloo_ranks_train_as_one_process(work):
    os.makedirs(os.path.join(work, "small"), exist_ok=True)
    data = os.path.join(work, "small_data.pt")
    batches, state = small_data(data)
    run = {"model": SMALL_NET, "optimizer": SMALL_OPTIMIZER, "trainer": {"max_steps": 2},
           "save_last": True}
    ranks = joined(mh.RankRun(mh.job_train, {"data": data, "runs": {"small": run},
                                             "device": "cuda", "devices": [0, 0]},
                              timeout=DDP_TIMEOUT, workdir=os.path.join(work, "small")))
    # One process over the batch of 4, the layer on its global-batch path.
    c = mh.train_against_one_process(os.path.join(work, "small"), "small", run, batches, state,
                                     ranks, "cuda", SMALL_LOSS_RTOL, SMALL_UPDATE_RTOL)
    assert c["loss_ok"] and c["update_gap_of_bound"] <= 1.0, c
    assert c["stats_rel_err"] <= SMALL_STATS_RTOL and c["ranks_bit_for_bit"], c


def test_full_width_live_bn_fit_on_two_gloo_ranks(work):
    live = ConfigDict(HPARAMS).merge({"model": {"freeze_bn": False}}).to_dict()
    out = joined(mh.RankRun(
        full_width_job, {"hparams": live, "devices": [0, 0], "batch": FULL_RANK_BATCH,
                         "steps": FULL_STEPS},
        timeout=DDP_TIMEOUT, workdir=os.path.join(work, "full")))
    for o in out:
        assert np.isfinite(o["losses"]).all()
        assert o["launches"]["match_targets"] == 5 * FULL_STEPS
    assert out[0]["digest"] == out[1]["digest"]


def record_key(r: dict) -> tuple:
    return (r["image_id"], -r["score"], r["category_id"], tuple(r["bbox"]))


def test_merged_test_on_two_gloo_ranks_equals_one_process(work):
    from pytorch_retinanet_tpu_torch import RetinaNetModel, Trainer

    root = os.path.join(work, "coco")
    write_coco_dataset(root)
    model = RetinaNetModel(coco_conf(root))
    ref = mh.test_with_records(Trainer(logger=False, log_every_n_steps=1000), model)
    del model
    torch.cuda.empty_cache()
    conf = coco_conf(root).merge({"dataloader": {"args": {"num_workers": 4}}}).to_dict()
    out = joined(mh.RankRun(
        mh.job_eval, {"conf": conf, "device": "cuda", "devices": [0, 0], "warm": True,
                      "validate": False},
        timeout=DDP_TIMEOUT, workdir=os.path.join(work, "test")))
    for o in out:
        assert o["launches"]["fused_stem"] == o["launches"]["nms_keep_mask"] == o["n_batches"]
        assert o["stem_dtype"] == "torch.float32"
    r0, r1 = out
    assert r0["AP"] == r1["AP"] and r0["records"] == r1["records"]
    if sorted(r0["records"], key=record_key) != sorted(ref["records"], key=record_key):
        assert mh.records_overlap(r0["records"], ref["records"]) >= MERGED_OVERLAP
        assert abs(r0["AP"] - ref["AP"]) <= MERGED_AP_TOL


def level_outside(got, want, tol: float) -> int:
    """The elements of every level outside tol + tol * |want|."""
    return sum(int(((g.float() - w.float()).abs() > tol + tol * w.float().abs()).sum())
               for g, w in zip(got[0] + got[1], want[0] + want[1]))


def detection_records(det) -> list:
    boxes, scores, labels, valid = (t.cpu().numpy() for t in det)
    return [{"image_id": i, "category_id": int(labels[i, j]),
             "bbox": [float(v) for v in boxes[i, j]], "score": float(scores[i, j])}
            for i in range(len(valid)) for j in np.flatnonzero(valid[i])]


def split_forward_job(rank: int, world: int, params: dict) -> dict:
    """The split forward (spatial 2) in f32 and bf16, the stem sharded over
    the batch (data 2, uint8), tensor parallel (model 2, f32), each against
    the unsplit forward in this process."""
    from pytorch_retinanet_tpu_torch import Retinanet
    from pytorch_retinanet_tpu_torch.models.retinanet import apply_detector
    from pytorch_retinanet_tpu_torch.parallel.sharding import (
        build_sharded_forward, make_inference_mesh, make_split_forward,
    )

    devices, dev, b = params["devices"], rank_device(params, rank), SPLIT_BATCH
    rng = np.random.default_rng(16)
    batch8 = torch.from_numpy(rng.integers(0, 256, (2 * b, H, W, 3), dtype=np.uint8)).to(dev)
    sizes = torch.tensor([[float(H), float(W)]] * b, device=dev)
    out = {}
    net = Retinanet(compute_dtype="float32", device=dev, **SPLIT_NET)
    images = batch8[:b].float() / 255.0
    with torch.inference_mode():
        want = net.module(images, True)
    for case, mesh in (("spatial", {"spatial": 2}), ("model", {"model": 2})):
        forward, place = build_sharded_forward(net.module, make_inference_mesh(devices, **mesh))
        out[f"f32 {case} outside"] = level_outside(forward(place(images)), want, SPLIT_F32_TOL)
    del net, want, images
    torch.cuda.empty_cache()

    net = Retinanet(device=dev, **SPLIT_NET)
    split = make_split_forward(net.module, make_inference_mesh(devices, spatial=2))
    images = batch8[:b]
    got, out["bf16 launches"] = counted(lambda: net._predict_impl(images, sizes, forward=split))
    out["bf16 records"] = detection_records(got)
    out["bf16 records unsplit"] = detection_records(net._predict_impl(
        images, sizes, forward=lambda x, return_levels: net.module(x, return_levels)))

    forward, place = build_sharded_forward(net.module, make_inference_mesh(devices, data=2))
    rows = place(batch8)
    got, out["data launches"] = counted(lambda: forward(rows))
    with torch.inference_mode(), net._mode(False):
        want = apply_detector(net.module, rows, return_levels=True)
    out["data bit for bit"] = all(torch.equal(g, v) for g, v in zip(got[0] + got[1],
                                                                    want[0] + want[1]))
    return out


def spatial_job(rank: int, world: int, params: dict) -> dict:
    """Each rank: :func:`split_forward_job`, then spatial training: the small
    f32 run (``job_train`` on the spatial mesh) and R50-FPN bf16
    (:func:`full_width_job`)."""
    out = {"forward": split_forward_job(rank, world, params)}
    torch.cuda.empty_cache()
    out["small"] = mh.job_train(rank, world, params["small"])
    out["full"] = full_width_job(rank, world, params["full"])
    return out


SPATIAL_SMALL_RUN = {"model": {**SMALL_NET, "freeze_bn": True}, "optimizer": SMALL_OPTIMIZER,
                     "trainer": {"max_steps": 2}, "spatial": 2}


@pytest.fixture(scope="module")
def spatial(work):
    """Two gloo ranks sharing the card: (their results, the small run's
    batches and state)."""
    small = os.path.join(work, "spatial_small")
    os.makedirs(small, exist_ok=True)
    batches, state = small_data(os.path.join(work, "spatial_small_data.pt"))
    full = {"hparams": HPARAMS, "devices": [0, 0], "batch": SPLIT_BATCH, "steps": SPATIAL_STEPS,
            "spatial": 2}
    out = joined(mh.RankRun(
        spatial_job, {"devices": [0, 0], "full": full,
                      "small": {"data": os.path.join(work, "spatial_small_data.pt"),
                                "runs": {"spatial": SPATIAL_SMALL_RUN}, "device": "cuda",
                                "devices": [0, 0], "workdir": small}},
        timeout=DDP_TIMEOUT, workdir=os.path.join(work, "spatial")))
    return out, batches, state


def test_spatial_and_tensor_parallel_forwards_equal_the_unsplit_one(spatial):
    for o in spatial[0]:
        f = o["forward"]
        assert f["f32 spatial outside"] == 0 and f["f32 model outside"] == 0, f
        recs, ref = f["bf16 records"], f["bf16 records unsplit"]
        assert len(recs) == len(ref)
        assert mh.records_overlap(recs, ref, SPLIT_BF16_BOX_TOL, SPLIT_BF16_SCORE_TOL) \
            >= MERGED_OVERLAP
        assert f["bf16 launches"]["nms_keep_mask"] == 1


def test_stem_sharded_over_the_batch_launches_once_a_rank(spatial):
    for o in spatial[0]:
        f = o["forward"]
        assert f["data launches"]["fused_stem"] == 1 and f["data bit for bit"]


def test_spatial_training_equals_one_process(spatial, work):
    out, batches, state = spatial
    c = mh.train_against_one_process(os.path.join(work, "spatial_small"), "spatial",
                                     SPATIAL_SMALL_RUN, batches, state, [o["small"] for o in out],
                                     "cuda", SMALL_LOSS_RTOL, SMALL_UPDATE_RTOL)
    assert c["loss_ok"] and c["update_gap_of_bound"] <= 1.0 and c["ranks_bit_for_bit"], c
    for o in out:
        assert np.isfinite(o["full"]["losses"]).all()
        assert o["full"]["launches"]["match_targets"] == 5 * SPATIAL_STEPS
    assert out[0]["full"]["digest"] == out[1]["full"]["digest"]

"""The port's data-parallel Trainer on two gloo ranks vs one process and vs JAX (CPU).

resnet18 at 64x96, f32, 4 classes; seeded weights with random BN statistics
and affine; the rank runs are ``tools/torch_multihost_smoke.py``'s jobs, all
started together by one module fixture while this process computes the
references.

* 2 SGD steps (``configs/hparams.yaml``-style SGD, lr 0.01) of a 2-rank
  ``Trainer.fit`` on global batches of 4 (rank r takes rows [2r, 2r + 2)),
  with frozen BN, live BN, ``accumulate_grad_batches=2`` (two full
  windows; and one full window with a partial one flushed at the epoch's
  end) and live BN under remat, against one process over the global
  batch: every micro-batch's loss
  within 1e-6 relative, and the parameters and buffers after the first
  optimizer step within ``update_gaps``' bound (1e-5 of each tensor's
  largest update plus 2 f32 ulp of its largest value: the updates are read
  back from rounded weights). Only the first step's state is held: the
  second step's gradients, from weights one ulp apart, differ by up to 2%
  of their largest value in the regression head's first conv (measured
  here), where the sum over anchors cancels. With live BN the one-process
  reference runs the layer's global-batch path (its all-reduces made the
  identity): the 1e-7 differences between that path and ``F.batch_norm``
  grow to 1e-2 of some gradients through a live-BN resnet18 at 64x96 (its
  layer4 normalizes 24 values a channel); ``tests/test_torch_parallel.py``
  holds the layer to ``F.batch_norm`` within 1e-6. The ranks' states are
  equal bit for bit after each run.
* DDP at world size 1 (a gloo group of one) equals the plain Trainer bit
  for bit.
* One live-BN step on the 2 ranks against the JAX Trainer's train step on a
  2-device CPU mesh (``devices=jax.devices()[:2]``) over the same global
  batch: the loss within 1e-4 relative, the state within 1e-5 absolute,
  ``test_live_bn_step_matches_jax_mutable_batch_stats``' tolerances.
* A 2-rank ``Trainer.test`` on a CSV dataset of 7 images (test_bs 2 per
  rank: rank 0 tests 4 images, rank 1 three and a padding row): the merged
  detection records of both ranks equal one process's and the JAX
  Trainer's (image ids, counts and labels exactly, boxes within 1e-3 px,
  scores within 1e-5), and the AP within 1e-6 (weights fitted 20 steps
  on the dataset in one process first: AP about 0.09); the merged
  validation losses equal one process's within 1e-6 relative.
* A checkpointed, logged 2-rank fit: rank 0 alone writes the checkpoint
  and the CSV log; a 2-rank resume from ``last`` ends in the state of an
  uninterrupted 2-epoch run, bit for bit, on both ranks.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.config import ConfigDict as JaxConfigDict
from pytorch_retinanet_tpu import OmegaConf as JaxOmegaConf
from pytorch_retinanet_tpu.engine import optim as jax_optim
from pytorch_retinanet_tpu.engine.model import RetinaNetModel as JaxRetinaNetModel
from pytorch_retinanet_tpu.engine.trainer import Trainer as JaxTrainer
from pytorch_retinanet_tpu.models.converter import flax_retinanet_to_torch, torch_retinanet_to_flax
from pytorch_retinanet_tpu_torch import OmegaConf, RetinaNetModel, Trainer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
import torch_multihost_smoke as mh  # noqa: E402

LOSS_RTOL = 1e-6
RUNS = {
    "frozen": {"trainer": {"max_steps": 2}},
    "live": {"model": {"freeze_bn": False}, "trainer": {"max_steps": 2}},
    "accumulate": {"trainer": {"max_steps": 2, "accumulate_grad_batches": 2}},
    # One full window, then a partial one flushed at the epoch's end.
    "accumulate_flush": {"trainer": {"max_epochs": 1, "accumulate_grad_batches": 2,
                                     "limit_train_batches": 3}},
    "live_remat": {"model": {"freeze_bn": False, "remat": True}, "trainer": {"max_steps": 2}},
}
JAX_RUN = {"model": {"freeze_bn": False}, "trainer": {"max_steps": 1}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_live_step(state, batch):
    params, stats = torch_retinanet_to_flax({k: v.numpy() for k, v in state.items()}, "resnet18")
    model = JaxRetinaNetModel(JaxConfigDict({"model": {**mh.TRAIN_MODEL, "freeze_bn": False},
                                             "optimizer": mh.OPTIMIZER}))
    model.net.variables = {"params": params, "batch_stats": stats}
    trainer = JaxTrainer(checkpoint_dir=None, devices=jax.devices()[:2], warmup_steps=0)
    trainer._optimizer = jax_optim.build_optimizer(mh.OPTIMIZER["class_name"],
                                                   mh.OPTIMIZER["params"])
    train_step, _, _ = trainer._build_steps(model)
    db = trainer._device_batch(batch)
    new, m = train_step(trainer._init_state(model),
                        *(db[k] for k in ("images", "boxes", "labels", "valid")))
    assert trainer.mesh.num_devices == 2
    sd = flax_retinanet_to_torch({"params": new.params, "batch_stats": new.batch_stats},
                                 "resnet18")
    return float(m["loss"]), sd


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """Every rank run, started together; the references meanwhile."""
    work = tmp_path_factory.mktemp("ddp")
    state = mh.seeded_state(mh.TRAIN_MODEL)
    batches = mh.seeded_train_batches(4, 4)
    torch.save({"batches": batches, "state": state}, work / "train.pt")
    csv = mh.write_csv_dataset(str(work / "csv"))
    runs = {
        "train": mh.RankRun(mh.job_train, {"data": str(work / "train.pt"),
                                           "runs": {**RUNS, "jax": JAX_RUN}},
                            workdir=str(work / "train")),
        "world1": mh.RankRun(mh.job_train, {"data": str(work / "train.pt"),
                                            "runs": {"frozen": RUNS["frozen"]}},
                             world=1, workdir=str(work / "world1")),
        "checkpoint": mh.RankRun(mh.job_checkpoint, {"data": str(work / "train.pt")},
                                 workdir=str(work / "checkpoint")),
    }
    eval_state = mh.trained_state(csv)
    torch.save(eval_state, work / "eval_state.pt")
    runs["eval"] = mh.RankRun(mh.job_eval, {"conf": mh.csv_conf(csv),
                                            "state": str(work / "eval_state.pt")},
                              workdir=str(work / "eval"))
    refs = {"state": state}
    for name, run in RUNS.items():
        live = run.get("model", {}).get("freeze_bn") is False
        with mh.one_process_global_bn() if live else contextlib.nullcontext():
            t, m, first = mh.fit_served({**mh.TRAIN_MODEL, **run.get("model", {})}, batches,
                                        state, run["trainer"])
        refs[name] = {"losses": list(t.logger_.meters["loss"].window), "first": first,
                      "digest": mh.state_digest(m.net.module), "global_step": t.global_step}
    refs["jax"] = _jax_live_step(state, batches[0])
    model = RetinaNetModel(OmegaConf.create(mh.csv_conf(csv)), device="cpu")
    model.net.load_state_dict(eval_state)
    trainer = Trainer(logger=False)
    refs["test"] = mh.test_with_records(trainer, model)
    refs["val"] = trainer.validate(model)
    jm = JaxRetinaNetModel(JaxOmegaConf.create(mh.csv_conf(csv)))
    jm.net.load_state_dict({k: v.numpy() for k, v in eval_state.items()})
    refs["jax_test"] = mh.test_with_records(
        JaxTrainer(checkpoint_dir=None, devices=jax.devices()[:1], logger=False), jm)
    out = {k: r.join() for k, r in runs.items()}
    for name, o in out.items():
        assert not o["timed_out"] and not any(o["exitcodes"]), (name, o)
    out["refs"], out["work"] = refs, work
    yield out
    shutil.rmtree(work, ignore_errors=True)  # saved states, about 0.5 GB


# ---------------------------------------------------------------------------- #
# Training
# ---------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(RUNS))
def test_two_sgd_steps_match_one_process(rank_runs, name):
    ref = rank_runs["refs"][name]
    r0 = rank_runs["train"]["results"][0][name]
    assert r0["global_step"] == ref["global_step"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=LOSS_RTOL, atol=0)
    assert len(r0["losses"]) == {"accumulate": 4, "accumulate_flush": 3}.get(name, 2)
    got = torch.load(rank_runs["work"] / "train" / f"{name}.pt", weights_only=True)
    gaps = mh.update_gaps(got, ref["first"], rank_runs["refs"]["state"])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1.0, (worst, gaps[worst])
    still = [k for k, v in got.items() if v.is_floating_point() and "running_" not in k
             and torch.equal(v, rank_runs["refs"]["state"][k])]
    assert not still, still[:3]  # every parameter took the step
    if name.startswith("live"):
        tracked = {int(v) for k, v in got.items() if k.endswith("num_batches_tracked")}
        assert tracked == {1}


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_hold_the_same_state_bit_for_bit(rank_runs, name):
    r0, r1 = rank_runs["train"]["results"]
    assert r0[name]["digest"] == r1[name]["digest"]
    assert r0[name]["losses"] == r1[name]["losses"]


def test_ddp_at_world_size_one_is_the_plain_trainer_bit_for_bit(rank_runs):
    (r,) = rank_runs["world1"]["results"]
    assert r["frozen"]["digest"] == rank_runs["refs"]["frozen"]["digest"]
    assert r["frozen"]["losses"] == rank_runs["refs"]["frozen"]["losses"]


def test_live_bn_step_matches_jax_on_a_two_device_mesh(rank_runs):
    want_loss, want = rank_runs["refs"]["jax"]
    r0 = rank_runs["train"]["results"][0]["jax"]
    np.testing.assert_allclose(r0["losses"][0], want_loss, rtol=1e-4)
    # One step: the state after the first optimizer step is the last.
    got = torch.load(rank_runs["work"] / "train" / "jax.pt", weights_only=True)
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k
            continue
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------- #
# Evaluation
# ---------------------------------------------------------------------------- #
def _by_image(records):
    out = {}
    for r in records:
        out.setdefault(r["image_id"], []).append(r)
    return out


def _same_records(got, want):
    g, w = _by_image(got), _by_image(want)
    assert sorted(g) == sorted(w) and len(w) == 7
    for image_id, rows in w.items():
        other = g[image_id]
        assert len(other) == len(rows), image_id
        assert [r["category_id"] for r in other] == [r["category_id"] for r in rows]
        np.testing.assert_allclose([r["score"] for r in other], [r["score"] for r in rows],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose([r["bbox"] for r in other], [r["bbox"] for r in rows],
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("reference", ["test", "jax_test"])
def test_merged_test_matches_one_process(rank_runs, reference):
    want = rank_runs["refs"][reference]
    for r in rank_runs["eval"]["results"]:
        _same_records(r["records"], want["records"])
        assert abs(r["AP"] - want["AP"]) <= 1e-6 and 0.0 < r["AP"] <= 1.0
    r0, r1 = rank_runs["eval"]["results"]
    assert r0["AP"] == r1["AP"] and r0["records"] == r1["records"]


def test_each_rank_tests_its_shard(rank_runs):
    assert [r["shard_images"] for r in rank_runs["eval"]["results"]] == [4, 3]


def test_merged_validation_loss_equals_one_process(rank_runs):
    want = rank_runs["refs"]["val"]
    assert set(want) >= {"val_loss", "val_classification_loss", "val_regression_loss"}
    for r in rank_runs["eval"]["results"]:
        assert set(r["val"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(r["val"][k], v, rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------- #
# Checkpoints and logs
# ---------------------------------------------------------------------------- #
def test_rank_zero_alone_writes_checkpoints_and_logs(rank_runs):
    r0, r1 = rank_runs["checkpoint"]["results"]
    assert r0["writes"] and not r1["writes"]
    assert r0["logs_written"] and not r1["logs_written"]
    ckpt = rank_runs["work"] / "checkpoint" / "ckpt"
    assert (ckpt / "last" / "checkpoint.pt").is_file()


def test_two_rank_resume_gives_the_uninterrupted_state(rank_runs):
    r0, r1 = rank_runs["checkpoint"]["results"]
    assert r0["resumed"] == r0["straight"] == r1["resumed"] == r1["straight"]
    assert r0["first"] == r1["first"] != r0["resumed"]

"""The port's ``parallel/sharding.py`` on gloo ranks (CPU) against JAX's sharded forwards and one process.

The detector and inputs are JAX's ``tests/test_sharding.py``'s: an f32
resnet18 with 4 classes, ``[2, 128, 128, 3]`` images from
``default_rng(7)``, and the weights of ``module.init(PRNGKey(0))``, carried
to the port by the JAX package's ``flax_retinanet_to_torch`` and loaded
with ``strict=True``. One module fixture runs
``tools/torch_multihost_smoke.py``'s ``job_sharding`` on 4 gloo ranks (a
mesh of fewer ranks takes the first ones) while this process computes the
JAX and one-process references.

* ``build_sharded_forward`` against JAX's on the virtual 8-device mesh,
  every level, within JAX's own bar (1e-4 absolute and relative,
  ``tests/test_sharding.py:54``): spatial 2; data 2 x spatial 2; model 2;
  spatial 2 x model 2; H = 160 at spatial 2 and 4 (5 units of 32 rows,
  split (3, 2) and (2, 1, 1, 1) here where GSPMD splits (2, 2, 1, 0)).
  Every rank of a data shard returns the same outputs bit for bit. The
  detections of data 2 x spatial 2 through the port's postprocess against
  JAX's 2 x 2 x 2 forward through JAX's: JAX's test's bars (scores 1e-4,
  labels exact, boxes 1e-2).
* ``shard_variables``: the names it splits are the names JAX's splits
  (mapped by the converter), at model 2 and 8, and this rank's shards are
  its chunks of dim 0; a model axis of 1 replicates everything.
* ``place_images``' guards raise JAX's messages.
* The halo exchange alone, each op a height split runs with halo rows, at
  the stride the trunk gives it, on 2 ranks in f64, through each
  transport (point-to-point; the all-gather of gloo ranks on a card):
  output rows, input gradient rows and the weight gradient summed over the
  ranks equal the unsplit op's within 1e-12.
* Spatial training on the (data 2, spatial 2) mesh, f32 resnet18 with
  frozen BN at 64x96, 2 SGD steps on global batches of 4 against one
  process over them: plain, remat and ``stem_s2d``. Each step's loss
  within 1e-6 relative, the first step's gradients within ``GRAD_RTOL`` of
  each tensor's largest, its update within ``update_gaps``' bound (the
  data-parallel test's, ``tests/test_torch_ddp.py``), the four ranks bit
  for bit.
* The ``Trainer`` on that mesh: the merged test records and AP, the
  validation losses and ``predict`` equal one process's (each record
  counted once, not once a spatial rank); ``fit`` refuses live BN with
  JAX's message, and its ``validate`` still runs.
"""

from __future__ import annotations

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.models import RetinaNetModule as JaxRetinaNetModule
from pytorch_retinanet_tpu.models.converter import flax_retinanet_to_torch
from pytorch_retinanet_tpu.ops import generate_anchors_per_level as jax_anchors_per_level
from pytorch_retinanet_tpu.ops import (
    process_detections_multilevel_batch as jax_process_detections_multilevel_batch,
)
from pytorch_retinanet_tpu.parallel import sharding as jax_sharding
from pytorch_retinanet_tpu_torch import OmegaConf, RetinaNetModel, Trainer
from pytorch_retinanet_tpu_torch.models import RetinaNetModule
from pytorch_retinanet_tpu_torch.ops import (
    generate_anchors_per_level,
    process_detections_multilevel_batch,
)
from pytorch_retinanet_tpu_torch.parallel import MeshPlan
from pytorch_retinanet_tpu_torch.parallel.sharding import shard_rows, shard_variables

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
import torch_multihost_smoke as mh  # noqa: E402
from torch_main_path import seeded_gt  # noqa: E402

FORWARD_TOL = 1e-4  # JAX's tests/test_sharding.py bar, absolute and relative
HALO_TOL = 1e-12
LOSS_RTOL = 1e-6
# The first step's gradients, of each tensor's largest |value|: the trunk's
# are sums over the two spatial ranks' rows, in another order than one
# process's sum over all rows.
GRAD_RTOL = 1e-5
WORLD = 4
# The small spatial run of tests/test_torch_card_parallel.py: f32 resnet18,
# 90 classes, 128x192, prior 0.1, frozen BN, 2 SGD steps on 2 ranks.
SMALL_SPATIAL_RUN = {
    "model": {"backbone_kind": "resnet18", "num_classes": 90, "min_size": 128, "max_size": 192,
              "compute_dtype": "float32", "prior": 0.1, "freeze_bn": True},
    "optimizer": {"class_name": "torch.optim.SGD",
                  "params": {"lr": 0.01, "weight_decay": 0.001, "momentum": 0.9}},
    "trainer": {"max_steps": 2}, "spatial": 2}
SMALL_UPDATE_RTOL = 1e-4
# The split's first update against one process's, of the gap between one
# process and itself with its batch rows in another order.
ORDER_NOISE_FACTOR = 4.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def detector():
    """JAX's tests/test_sharding.py detector and images, and the port's state."""
    module = JaxRetinaNetModule(backbone_kind="resnet18", num_classes=4, freeze_bn=True,
                                dtype=jnp.float32)
    images = np.random.default_rng(7).normal(size=(2, 128, 128, 3)).astype(np.float32)
    images160 = np.random.default_rng(3).normal(size=(1, 160, 160, 3)).astype(np.float32)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    state = {k: torch.from_numpy(np.array(v))
             for k, v in flax_retinanet_to_torch(variables, "resnet18").items()}
    return module, variables, {"images": images, "images160": images160}, state


def _jax_levels(levels):
    return [np.asarray(c, np.float32) for c in levels[0]], [np.asarray(b, np.float32)
                                                            for b in levels[1]]


@pytest.fixture(scope="module")
def ranks(detector, tmp_path_factory):
    """The 4-rank run, and the references computed while it runs."""
    module, variables, images, state = detector
    work = tmp_path_factory.mktemp("sharding")
    torch.save({"state": state, **{k: torch.from_numpy(v) for k, v in images.items()}},
               work / "data.pt")
    train_state = mh.seeded_state(mh.TRAIN_MODEL)
    batches = mh.seeded_train_batches(2, 4, seed=5)
    torch.save({"batches": batches, "state": train_state}, work / "train.pt")
    conf = mh.csv_conf(mh.write_csv_dataset(str(work / "csv")))
    run = mh.RankRun(mh.job_sharding, {"data": str(work / "data.pt"),
                                       "train": str(work / "train.pt"), "conf": conf},
                     world=WORLD, workdir=str(work / "ranks"), timeout=600)

    refs = {"jax": {}, "train": {}}
    for name, (mesh, key) in mh.SHARDED_CASES.items():
        plan = jax_sharding.make_inference_mesh(**mesh)
        forward, place = jax_sharding.build_sharded_forward(module, variables, plan)
        refs["jax"][name] = _jax_levels(forward(place(jnp.asarray(images[key]))))
    plan = jax_sharding.make_inference_mesh(data=2, spatial=2, model=2)
    forward, place = jax_sharding.build_sharded_forward(module, variables, plan)
    refs["jax_hybrid"] = _jax_levels(forward(place(jnp.asarray(images["images"]))))
    refs["guards"] = {}
    for name, (mesh, shape) in mh.PLACE_GUARDS.items():
        plan = jax_sharding.make_inference_mesh(**mesh)
        with pytest.raises(ValueError) as e:
            jax_sharding.build_sharded_forward(module, variables, plan)[1](jnp.zeros(shape))
        refs["guards"][name] = str(e.value)
    for name, model_kw in mh.SPATIAL_TRAIN_RUNS.items():
        grads: dict = {}
        t, _, first = mh.fit_served({**mh.TRAIN_MODEL, **model_kw}, batches, train_state,
                                    {"max_steps": 2}, grads=grads)
        refs["train"][name] = {"losses": list(t.logger_.meters["loss"].window), "first": first,
                               "grads": grads}
    refs["train_state"] = train_state
    model = RetinaNetModel(OmegaConf.create(conf), device="cpu")
    trainer = Trainer(logger=False)
    refs["test"] = mh.test_with_records(trainer, model)
    refs["val"] = trainer.validate(model)
    refs["predict"] = trainer.predict(model)
    live = RetinaNetModel(OmegaConf.create({**conf, "model": {**conf["model"],
                                                              "freeze_bn": False}}),
                          device="cpu")
    refs["live_val"] = Trainer(logger=False).validate(live)

    out = run.join()
    assert not out["timed_out"] and not any(out["exitcodes"]), out
    out["refs"], out["work"] = refs, work / "ranks"
    yield out
    shutil.rmtree(work, ignore_errors=True)


def _rank_levels(ranks, name):
    """Each data shard's outputs (rows in order) from the ranks that ran
    `name`, after checking every rank of a shard returned the same."""
    shards: dict = {}
    for r, res in enumerate(ranks["results"]):
        if name not in res["forward"]:
            continue
        got = torch.load(ranks["work"] / f"{name}_rank{r}.pt", weights_only=True)
        d = res["forward"][name][0]
        if d in shards:
            for a, b in zip(shards[d]["cls"] + shards[d]["box"], got["cls"] + got["box"]):
                assert torch.equal(a, b), f"{name}: ranks of data shard {d} differ"
        shards[d] = got
    cls = [torch.cat([shards[d]["cls"][lvl] for d in sorted(shards)]) for lvl in range(5)]
    box = [torch.cat([shards[d]["box"][lvl] for d in sorted(shards)]) for lvl in range(5)]
    return cls, box


# ---------------------------------------------------------------------------- #
# The sharded forward against JAX's
# ---------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(mh.SHARDED_CASES))
def test_sharded_forward_matches_jax(ranks, name):
    cls, box = _rank_levels(ranks, name)
    want_cls, want_box = ranks["refs"]["jax"][name]
    for lvl in range(5):
        np.testing.assert_allclose(cls[lvl].numpy(), want_cls[lvl], atol=FORWARD_TOL,
                                   rtol=FORWARD_TOL, err_msg=f"{name} cls level {lvl}")
        np.testing.assert_allclose(box[lvl].numpy(), want_box[lvl], atol=FORWARD_TOL,
                                   rtol=FORWARD_TOL, err_msg=f"{name} box level {lvl}")


def test_detections_match_jax_through_postprocess(ranks, detector):
    """The port's data 2 x spatial 2 outputs through its postprocess (NMS's
    plain version on the CPU) against JAX's 2 x 2 x 2 through JAX's."""
    kw = dict(score_thres=0.01, nms_thres=0.5, max_detections=10)
    cls, box = _rank_levels(ranks, "data2_spatial2")
    anchors = [torch.from_numpy(a) for a in generate_anchors_per_level((128, 128))]
    got = process_detections_multilevel_batch(cls, box, anchors,
                                              torch.tensor([[128, 128], [128, 128]]), **kw)
    j_cls, j_box = ranks["refs"]["jax_hybrid"]
    want = jax_process_detections_multilevel_batch(
        [jnp.asarray(c) for c in j_cls], [jnp.asarray(b) for b in j_box],
        [jnp.asarray(a) for a in jax_anchors_per_level((128, 128))],
        jnp.asarray([[128, 128], [128, 128]], jnp.int32), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-4)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-2)
    assert int(got.valid.sum()) > 0


# ---------------------------------------------------------------------------- #
# shard_variables, shard boundaries, guards
# ---------------------------------------------------------------------------- #
@pytest.mark.parametrize("model", [2, 8])
def test_shard_variables_splits_what_jax_splits(detector, model):
    module, variables, _, state = detector
    shardings = jax_sharding.shard_variables(
        variables, jax_sharding.make_inference_mesh(model=model).mesh)
    split_tree = jax.tree_util.tree_map(
        lambda v, s: np.full(v.shape, float(s.spec != jax.sharding.PartitionSpec()), np.float32),
        variables, shardings)
    want = {k for k, v in flax_retinanet_to_torch(split_tree, "resnet18").items()
            if np.asarray(v).size and np.all(np.asarray(v) == 1.0)}
    port = RetinaNetModule(backbone_kind="resnet18", num_classes=4, dtype=torch.float32)
    port.load_state_dict(state, strict=True)
    for index in (0, model - 1):
        plan = MeshPlan(None, torch.device("cpu"), 1, model_size=model, coords=(0, 0, index))
        shards, dims = shard_variables(port, plan)
        assert {k for k, d in dims.items() if d is not None} == want
        assert len(want) > 10
        for k, t in state.items():
            want_shard = t.chunk(model)[index] if k in want else t
            assert torch.equal(shards[k], want_shard), k


def test_model_axis_of_one_replicates_everything(detector):
    _, _, _, state = detector
    port = RetinaNetModule(backbone_kind="resnet18", num_classes=4, dtype=torch.float32)
    shards, dims = shard_variables(port, MeshPlan(None, torch.device("cpu"), 8))
    assert all(d is None for d in dims.values())
    assert shards.keys() == port.state_dict().keys()


@pytest.mark.parametrize("height,spatial,want", [
    (128, 2, [(0, 64), (64, 128)]),
    (160, 2, [(0, 96), (96, 160)]),
    (160, 4, [(0, 64), (64, 96), (96, 128), (128, 160)]),
    (96, 2, [(0, 64), (64, 96)]),
])
def test_shard_rows_units_of_32_larger_first(height, spatial, want):
    assert shard_rows(height, spatial) == want


def test_shard_rows_refuses_heights_off_the_unit():
    with pytest.raises(ValueError, match="divisible by 32"):
        shard_rows(100, 2)


@pytest.mark.parametrize("name", list(mh.PLACE_GUARDS))
def test_place_images_guards_raise_jax_messages(ranks, name):
    got = {r["guards"][name] for r in ranks["results"] if name in r["guards"]}
    assert got == {ranks["refs"]["guards"][name]}


# ---------------------------------------------------------------------------- #
# The halo exchange alone
# ---------------------------------------------------------------------------- #
@pytest.mark.parametrize("transport", ["p2p", "gathered"])
@pytest.mark.parametrize("op", ["stem 7x7/2", "3x3/2 max pool", "3x3/2 conv", "3x3/1 conv",
                                "1x1 conv", "1x1/2 conv", "s2d 4x4/1"])
def test_halo_exchange_equals_the_unsplit_op(ranks, op, transport):
    results = [r["halo"][f"{op} {transport}"] for r in ranks["results"] if "halo" in r]
    assert len(results) == 2
    for res in results:
        assert res["y"] <= HALO_TOL and res["x_grad"] <= HALO_TOL, res
        assert res["weight_grad"] <= HALO_TOL, res
        # An op with halo rows exchanges once forward and once backward.
        assert res["exchanges"] == (0 if op.startswith("1x1") else 2), res
    # The split ops return exactly their shard's rows: two halves.
    assert results[0]["shape"] == results[1]["shape"]


# ---------------------------------------------------------------------------- #
# Spatial training and the Trainer on the (data 2, spatial 2) mesh
# ---------------------------------------------------------------------------- #
def test_train_mesh_layout(ranks):
    assert [r["train_mesh"] for r in ranks["results"]] == [
        [2, 2, [d, s, 0]] for d in range(2) for s in range(2)]


@pytest.mark.parametrize("name", list(mh.SPATIAL_TRAIN_RUNS))
def test_spatial_training_matches_one_process(ranks, name):
    ref = ranks["refs"]["train"][name]
    results = [r["train"][name] for r in ranks["results"]]
    assert len({r["digest"] for r in results}) == 1, "the ranks' states differ"
    losses = results[0]["losses"]
    assert len(losses) == len(ref["losses"]) == 2
    for a, b in zip(losses, ref["losses"]):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (losses, ref["losses"])
    got = torch.load(ranks["work"] / f"train_{name}.pt", weights_only=True)
    assert got["grads"].keys() == ref["grads"].keys()
    for k, g in ref["grads"].items():
        err = float((got["grads"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        assert err <= GRAD_RTOL, f"{k}: gradient {err:.3g} of its largest"
    gaps = mh.update_gaps(got["first"], ref["first"], ranks["refs"]["train_state"]
                          if name != "stem_s2d" else _s2d_state(ranks))
    assert max(gaps.values()) <= 1.0, max(gaps, key=gaps.get)


def _s2d_state(ranks):
    """The seeded state as the s2d model holds it (its stem weight repacked)."""
    net = mh.served_model({**mh.TRAIN_MODEL, "stem_s2d": True}, [],
                          ranks["refs"]["train_state"]).net
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def test_trainer_test_on_the_mesh_counts_each_record_once(ranks):
    ref = ranks["refs"]["test"]
    for r in ranks["results"]:
        got = r["test"]
        assert got["AP"] == pytest.approx(ref["AP"], abs=1e-6)
        assert sorted(got["img_ids"]) == sorted(ref["img_ids"])
        assert len(got["records"]) == len(ref["records"]) > 0
        assert mh.records_overlap(got["records"], ref["records"]) == 1.0


def test_trainer_validate_and_predict_on_the_mesh(ranks):
    val = ranks["refs"]["val"]
    for r, res in enumerate(ranks["results"]):
        assert res["val"].keys() == val.keys()
        for k, v in val.items():
            assert abs(res["val"][k] - v) <= LOSS_RTOL * abs(v), (k, res["val"][k], v)
        got = torch.load(ranks["work"] / f"predict_rank{r}.pt", weights_only=False)
        assert got.keys() == ranks["refs"]["predict"].keys()
        for image_id, want in ranks["refs"]["predict"].items():
            np.testing.assert_array_equal(got[image_id]["labels"], want["labels"])
            np.testing.assert_allclose(got[image_id]["scores"], want["scores"], atol=1e-5)
            np.testing.assert_allclose(got[image_id]["boxes"], want["boxes"], atol=1e-3)


def test_live_bn_refused_at_fit_but_validates(ranks):
    for r in ranks["results"]:
        assert r["live_fit"] is not None and "freeze_bn=True" in r["live_fit"]
        for k, v in ranks["refs"]["live_val"].items():
            assert abs(r["live_val"][k] - v) <= LOSS_RTOL * abs(v), k


def test_spatial_update_stays_within_one_process_order_noise(tmp_path):
    """The card's small spatial run on a draw where its first-update bar
    (``SMALL_UPDATE_RTOL`` of each tensor's largest update + 2 ulp) is below
    the order noise of the class head: uint8 / 255 images and ``seeded_gt``
    boxes from ``default_rng(8)``, the card run's counts. One process on 2
    threads sums the CPU's convolution gradients in another order than on 1
    and moves ``class_subnet.2``'s update about twice past that bar. The
    2-rank split (1 thread a rank) is held against one process on 1 thread,
    tensor by tensor, within the bar or ``ORDER_NOISE_FACTOR`` times that
    noise; its losses within ``LOSS_RTOL``, its ranks bit for bit."""
    rng = np.random.default_rng(8)
    batches = []
    for n_valid in ([5, 0, 3, 1], [2, 4, 0, 6]):
        images = rng.integers(0, 256, (4, 128, 192, 3), dtype=np.uint8) / np.float32(255)
        batches.append({"images": images.astype(np.float32),
                        **seeded_gt(rng, n_valid, 128, 192, 90)})
    model = {**mh.TRAIN_MODEL, **SMALL_SPATIAL_RUN["model"]}
    state = mh.seeded_state(model, seed=3)
    torch.save({"batches": batches, "state": state}, tmp_path / "data.pt")
    run = mh.RankRun(mh.job_train, {"data": str(tmp_path / "data.pt"),
                                    "runs": {"spatial": SMALL_SPATIAL_RUN}},
                     world=2, timeout=600, workdir=str(tmp_path / "ranks"))
    fits = {}
    for threads in (1, 2):
        torch.set_num_threads(threads)
        t, _, first = mh.fit_served(model, batches, state, SMALL_SPATIAL_RUN["trainer"],
                                    optimizer=SMALL_SPATIAL_RUN["optimizer"])
        fits[threads] = (list(t.logger_.meters["loss"].window), first)
    torch.set_num_threads(1)
    out = run.join()
    assert not out["timed_out"] and not any(out["exitcodes"]), out
    ranks = [r["spatial"] for r in out["results"]]
    assert ranks[0]["digest"] == ranks[1]["digest"] and ranks[0]["losses"] == ranks[1]["losses"]
    losses, want = ranks[0]["losses"], fits[1][0]
    assert len(losses) == len(want) == 2
    assert all(abs(a - b) <= LOSS_RTOL * abs(b) for a, b in zip(losses, want)), (losses, want)
    got = torch.load(tmp_path / "ranks" / "spatial.pt", weights_only=True)
    gaps = mh.update_gaps(got, fits[1][1], state, SMALL_UPDATE_RTOL)
    noise = mh.update_gaps(fits[2][1], fits[1][1], state, SMALL_UPDATE_RTOL)
    outside = {k: (g, noise[k]) for k, g in gaps.items()
               if g > max(1.0, ORDER_NOISE_FACTOR * noise[k])}
    assert not outside, outside

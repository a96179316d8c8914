"""The port's ``parallel`` package vs the JAX package's, and on two gloo ranks (CPU).

* One process: ``get_world_size``, ``get_rank``, ``is_main_process``,
  ``init_distributed`` (a no-op), ``all_gather_objects`` (``[obj]``) and
  ``reduce_dict`` give what the JAX package's give.
* Two gloo ranks (``tools/torch_multihost_smoke.py``'s ``job_collectives``,
  one run for the module): world size and rank; ``all_gather_objects``
  in rank order on payloads of unequal size; ``reduce_dict`` averaging and
  summing; ``any_rank``. Live ``BatchNorm2d`` on each rank's rows of one
  [4, 6, 5, 7] f32 batch against the layer in one process over the whole
  batch (``F.batch_norm``): the output, the input gradient, the weight and
  bias gradients (summed over the ranks, as DDP's average of the two is
  half that sum) and the running statistics within 1e-6 relative (of each
  tensor's largest |value|), ``num_batches_tracked`` 1. The ``match_mesh``
  split of the match over the ranks' rows equals the unsplit match exactly
  (targets and per-image losses).
* A non-finite loss on one rank ends both ranks non-zero, each with the
  Trainer's ``FloatingPointError``, within the join timeout.
* ``make_train_mesh(spatial=2)`` on the two ranks builds a (data 1,
  spatial 2) plan, each rank at its coordinates, and a data axis the world
  cannot hold raises JAX's message.
* Errors: a ``devices`` list whose length is not the world size raises, from
  ``make_mesh`` and from ``Trainer(devices=...)``; a Trainer whose device is
  not the model's raises.
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_retinanet_tpu import parallel as jax_parallel
from pytorch_retinanet_tpu_torch import ConfigDict, Trainer, parallel
from pytorch_retinanet_tpu_torch.models.layers import BatchNorm2d
from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level, retinanet_loss_levels

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
import torch_multihost_smoke as mh  # noqa: E402

BN_RTOL = 1e-6


def _bn_case():
    rng = np.random.default_rng(0)
    c = 6
    return {"x": (rng.normal(1.0, 3.0, (4, c, 5, 7))).astype(np.float32).tolist(),
            "w_out": rng.normal(0, 1, (4, c, 5, 7)).astype(np.float32).tolist(),
            "weight": rng.uniform(0.5, 1.5, c).astype(np.float32).tolist(),
            "bias": rng.normal(0, 0.5, c).astype(np.float32).tolist(),
            "running_mean": rng.normal(0, 0.1, c).astype(np.float32).tolist(),
            "running_var": rng.uniform(0.5, 1.5, c).astype(np.float32).tolist()}


BN = _bn_case()


@pytest.fixture(scope="module")
def rank_runs():
    """The collectives run and the non-finite run, started together."""
    runs = {"collectives": mh.RankRun(mh.job_collectives, {"bn": BN}),
            "nonfinite": mh.RankRun(mh.job_nonfinite)}
    return {k: r.join() for k, r in runs.items()}


@pytest.fixture(scope="module")
def ranks(rank_runs):
    out = rank_runs["collectives"]
    assert out["exitcodes"] == [0, 0], out["results"]
    return out["results"]


# ---------------------------------------------------------------------------- #
# One process
# ---------------------------------------------------------------------------- #
def test_single_process_helpers_equal_jax():
    assert parallel.get_world_size() == jax_parallel.get_world_size() == 1
    assert parallel.get_rank() == jax_parallel.get_rank() == 0
    assert parallel.is_main_process() is jax_parallel.is_main_process() is True
    for n in (None, 1):
        assert parallel.init_distributed(num_processes=n) is None
        assert jax_parallel.init_distributed(num_processes=n) is None
    assert not torch.distributed.is_initialized()
    obj = {"a": [1, 2], "b": "x"}
    assert parallel.all_gather_objects(obj) == jax_parallel.all_gather_objects(obj) == [obj]
    metrics = {"loss": torch.tensor([1.0, 2.0]), "cls": np.float32(0.25), "n": 3}
    want = jax_parallel.reduce_dict({"loss": np.array([1.0, 2.0]), "cls": np.float32(0.25),
                                     "n": 3})
    for average in (True, False):
        assert parallel.reduce_dict(metrics, average) == want
    assert parallel.any_rank([True, False]) == [True, False]


def test_live_bn_at_world_size_one_is_torchs_batch_norm():
    """Without a group the live layer keeps the ``F.batch_norm`` path, bit for bit."""
    x = torch.tensor(BN["x"])
    layer = BatchNorm2d(6, frozen=False).train()
    y = layer(x)
    want = F.batch_norm(x, torch.zeros(6), torch.ones(6), layer.weight, layer.bias, True, 1.0,
                        layer.eps)
    assert torch.equal(y, want)


def test_mesh_plan_without_a_group():
    plan = parallel.make_mesh(["cpu"])
    assert plan.group is None and plan.device == torch.device("cpu")
    assert plan.data_size == 1
    assert parallel.make_train_mesh(["cpu"], data=1) == plan


# ---------------------------------------------------------------------------- #
# Errors
# ---------------------------------------------------------------------------- #
def test_spatial_train_mesh_raises_naming_a14(ranks):
    """Spatial training meshes are ported (the name is the one the test had
    while they raised): the plan builds on the two ranks and a ``Trainer``
    takes it, and a wrong ``data`` raises what JAX's ``make_train_mesh``
    raises on two devices."""
    with pytest.raises(ValueError) as e:
        jax_parallel.make_train_mesh(jax.devices()[:2], spatial=2, data=2)
    for r, res in enumerate(ranks):
        assert res["train_mesh"]["spatial"] == {"sizes": [1, 2, 1], "coords": [0, r, 0],
                                                "trainer_mesh": True, "wrong_data": str(e.value)}


@pytest.mark.parametrize("make", [parallel.make_mesh, lambda d: Trainer(devices=d)])
def test_devices_of_the_wrong_length_raise(make):
    with pytest.raises(ValueError, match="one device per rank"):
        make(["cpu", "cpu"])


def test_trainer_device_must_be_the_models():
    hp = ConfigDict({"model": {**mh.TRAIN_MODEL}})
    model = mh.served_model_class()(hp, device="cpu")
    t = Trainer(mesh=parallel.MeshPlan(None, torch.device("meta"), 1))
    with pytest.raises(ValueError, match="build the model on the rank's device"):
        t.fit(model)


def test_init_distributed_of_many_needs_an_address(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator_address"):
        parallel.init_distributed(num_processes=2, process_id=0)


def test_match_mesh_without_a_group_is_the_unsplit_match():
    gt = mh.seeded_train_batches(1, 2, seed=4)[0]
    anchors = [torch.from_numpy(a) for a in generate_anchors_per_level((64, 96))]
    g = torch.Generator().manual_seed(1)
    cls = [torch.randn((2, a.shape[0], 4), generator=g) for a in anchors]
    box = [torch.randn((2, a.shape[0], 4), generator=g) for a in anchors]
    args = [torch.from_numpy(gt[k]) for k in ("boxes", "labels", "valid")]
    kw = dict(num_classes=4, reduction="none")
    got = retinanet_loss_levels(cls, box, anchors, *args, match_mesh=parallel.make_mesh(["cpu"]),
                                **kw)
    want = retinanet_loss_levels(cls, box, anchors, *args, **kw)
    assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------- #
# Two ranks
# ---------------------------------------------------------------------------- #
def test_two_ranks_world_rank_and_main(ranks):
    assert [(r["world"], r["rank"], r["main"]) for r in ranks] == [(2, 0, True), (2, 1, False)]


def test_all_gather_objects_keeps_rank_order_on_unequal_payloads(ranks):
    for r in ranks:
        assert r["gathered"] == [[0, 10], [1, 1010]]


def test_reduce_dict_averages_and_sums(ranks):
    for r in ranks:
        # rank 0 sends a=1, b=mean([0, 4])=2; rank 1 sends a=2, b=mean([2, 4])=3.
        assert r["mean"] == {"a": 1.5, "b": 2.5}
        assert r["sum"] == {"a": 3.0}
        assert r["any"] == [True, False]


def _bn_reference():
    """The layer in one process over the whole batch (``F.batch_norm``)."""
    layer = BatchNorm2d(6, frozen=False)
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(layer, name).copy_(torch.tensor(BN[name]))
    layer.train()
    x = torch.tensor(BN["x"]).requires_grad_(True)
    y = layer(x)
    (y * torch.tensor(BN["w_out"])).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": layer.weight.grad,
            "bias_grad": layer.bias.grad, "running_mean": layer.running_mean,
            "running_var": layer.running_var}


def _close(got, want, what):
    got = torch.as_tensor(got, dtype=torch.float32)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= BN_RTOL, f"{what}: {err:.3g} of the largest |value|"


@pytest.mark.parametrize("field", ["y", "x_grad"])
def test_synced_live_bn_rows_equal_one_process(ranks, field):
    want = _bn_reference()[field]
    got = torch.cat([torch.tensor(r["bn"][field]) for r in ranks])
    _close(got, want, field)


@pytest.mark.parametrize("field", ["weight_grad", "bias_grad"])
def test_synced_live_bn_parameter_grads_sum_to_one_process(ranks, field):
    want = _bn_reference()[field]
    got = sum(torch.tensor(r["bn"][field]) for r in ranks)
    _close(got, want, field)


@pytest.mark.parametrize("field", ["running_mean", "running_var"])
def test_synced_live_bn_running_stats_equal_one_process(ranks, field):
    want = _bn_reference()[field]
    for r in ranks:
        _close(r["bn"][field], want, field)
        assert r["bn"]["num_batches_tracked"] == 1
    assert ranks[0]["bn"][field] == ranks[1]["bn"][field]


def test_match_mesh_split_equals_the_unsplit_match(ranks):
    for r in ranks:
        assert r["match"]["targets_equal"] and r["match"]["losses_equal"]
        assert r["match"]["n_fg"] > 0


def test_non_finite_loss_on_one_rank_ends_both_ranks(rank_runs):
    out = rank_runs["nonfinite"]
    assert not out["timed_out"]
    assert all(c != 0 for c in out["exitcodes"]), out["exitcodes"]
    for r in out["results"]:
        assert r is not None and r["error"].startswith("FloatingPointError"), r

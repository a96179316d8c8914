"""Training path of the PyTorch port vs the JAX package (CPU).

resnet18, 4 classes, f32, the 64x96 bucket, ``prior=0.1``. Random weights
(random BN statistics and affine too) are made once, carried into both
packages with the JAX package's reference-schema importer and the port's
``load_state_dict``, and the same numpy batches go through:

* ``Retinanet.forward``: losses and every parameter's gradient against
  ``jax.value_and_grad`` of the JAX ``Retinanet._loss_impl``;
* three SGD steps with momentum and weight decay through the port's
  ``Trainer.fit`` against the JAX ``Trainer``'s ``train_step`` (built by
  ``_build_steps`` with the same optimizer), per-step losses and the
  parameters after the last step; and the per-image validation losses
  against the JAX ``eval_step``.

Tolerances: losses within 1e-4 relative (f32 convolutions sum in another
order on the two sides, and the differences grow a little step by step);
each parameter's gradient within 2e-3 of that tensor's largest gradient;
parameters after three steps within 1e-5 absolute (their updates are
lr * momentum sums of those gradients).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.config import ConfigDict as JaxConfigDict
from pytorch_retinanet_tpu.engine import optim as jax_optim
from pytorch_retinanet_tpu.engine.model import RetinaNetModel as JaxRetinaNetModel
from pytorch_retinanet_tpu.engine.trainer import Trainer as JaxTrainer
from pytorch_retinanet_tpu.models.converter import flax_retinanet_to_torch, torch_retinanet_to_flax
from pytorch_retinanet_tpu.models.retinanet import Retinanet as JaxRetinanet
from pytorch_retinanet_tpu_torch import ConfigDict, RetinaNetModel, Retinanet, Trainer
from pytorch_retinanet_tpu_torch.data import pad_targets

KIND = "resnet18"
MODEL = dict(num_classes=4, backbone_kind=KIND, pretrained=False, min_size=64, max_size=96,
             compute_dtype="float32", prior=0.1)
OPTIMIZER = {"class_name": "torch.optim.SGD",
             "params": {"lr": 0.01, "momentum": 0.9, "weight_decay": 0.001}}
LOSS_RTOL = 1e-4


def _variables():
    """Seeded port init with random BN statistics and affine, as JAX variables."""
    net = Retinanet(device="cpu", seed=0, **MODEL)
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in net.state_dict().items():
        v = v.numpy().copy()
        if v.ndim == 1 and k.endswith((".weight", "running_var")):  # BN scale and var
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif v.ndim == 1 and k.endswith(("running_mean", ".bias")) and "backbone" in k:
            v = rng.normal(0, 0.05, v.shape).astype(np.float32)
        sd[k] = v
    params, stats = torch_retinanet_to_flax(sd, KIND)
    return {"params": params, "batch_stats": stats}


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    images = rng.random((b, 64, 96, 3), dtype=np.float32)
    boxes = np.zeros((b, 100, 4), np.float32)
    labels = np.zeros((b, 100), np.int32)
    valid = np.zeros((b, 100), bool)
    for i, n in enumerate([3, 1, 0, 2][:b]):
        ctr = rng.uniform(10, 80, (n, 2))
        wh = rng.uniform(12, 50, (n, 2))
        boxes[i, :n] = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
        labels[i, :n] = rng.integers(1, 5, n)
        valid[i, :n] = True
    return {"images": images, "boxes": boxes, "labels": labels, "valid": valid}


BATCHES = [_batch(s) for s in range(3)]


@pytest.fixture(scope="module")
def variables():
    return _variables()


def _port_net(variables) -> Retinanet:
    net = Retinanet(device="cpu", **MODEL)
    net.load_state_dict(variables)
    return net


class _Served(RetinaNetModel):
    """The port's model serving fixed batches (the data slice is A8)."""

    def __init__(self, hparams, batches, val=None, **kw):
        super().__init__(hparams, **kw)
        self.batches, self.val = batches, val

    def prepare_data(self):
        pass

    def train_dataloader(self, shard=0, num_shards=1):
        return list(self.batches)

    def val_dataloader(self, shard=0, num_shards=1):
        return None if self.val is None else list(self.val)


def _served(variables, batches=BATCHES, val=None, **model):
    m = _Served(ConfigDict({"model": {**MODEL, **model}, "optimizer": OPTIMIZER}), batches, val,
                device="cpu")
    m.net.load_state_dict(variables)
    return m


def test_forward_losses_and_parameter_grads_match_jax(variables):
    batch = BATCHES[0]
    jnet = JaxRetinanet(**MODEL)
    stats = variables["batch_stats"]

    def total(params):
        out = jnet._loss_impl({"params": params, "batch_stats": stats}, jnp.asarray(batch["images"]),
                              jnp.asarray(batch["boxes"]), jnp.asarray(batch["labels"]),
                              jnp.asarray(batch["valid"]))
        return out["classification_loss"] + out["regression_loss"], out

    (_, want), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(variables["params"])
    want_grads = flax_retinanet_to_torch({"params": grads, "batch_stats": stats}, KIND)

    net = _port_net(variables)
    got = net.forward(batch["images"], {k: batch[k] for k in ("boxes", "labels", "valid")})
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, atol=0)
    (got["classification_loss"] + got["regression_loss"]).backward()
    params = dict(net.module.named_parameters())
    assert set(params) == {k for k in want_grads if "running_" not in k
                           and "num_batches" not in k}
    for k, p in params.items():
        w = np.asarray(want_grads[k])
        scale = float(np.abs(w).max())
        assert p.grad is not None and float(p.grad.abs().max()) > 0, k  # BN affine included
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=2e-3 * scale, err_msg=k)


def test_ragged_forward_matches_jax(variables):
    """The reference's ragged form: images at the bucket's size (so both
    resizes are the identity) in both orientations, letterboxed to 96x96."""
    rng = np.random.default_rng(5)
    images = [rng.random((64, 96, 3), dtype=np.float32), rng.random((96, 64, 3), dtype=np.float32)]
    targets = [{"boxes": np.array([[10, 12, 50, 40], [30, 20, 90, 60]], np.float32),
                "labels": np.array([1, 3])},
               {"boxes": np.array([[5, 5, 40, 70]], np.float32), "labels": np.array([2])}]
    jnet = JaxRetinanet(**MODEL)
    jnet.variables = variables
    want = jnet(images, targets)
    got = _port_net(variables)(images, targets)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, atol=0)


@pytest.fixture(scope="module")
def jax_steps(variables):
    """Per-step losses and final parameters of the JAX trainer's train_step,
    and its per-image validation losses on the last parameters."""
    model = JaxRetinaNetModel(JaxConfigDict({"model": MODEL, "optimizer": OPTIMIZER}))
    model.net.variables = variables
    trainer = JaxTrainer(checkpoint_dir=None, devices=jax.devices()[:1], warmup_steps=0)
    trainer._optimizer = jax_optim.build_optimizer(OPTIMIZER["class_name"], OPTIMIZER["params"])
    train_step, eval_step, _ = trainer._build_steps(model)
    state = trainer._init_state(model)
    losses = []
    for b in BATCHES:
        state, m = train_step(state, *(jnp.asarray(b[k]) for k in ("images", "boxes", "labels", "valid")))
        losses.append(float(m["loss"]))
    val = eval_step(state, *(jnp.asarray(BATCHES[0][k]) for k in ("images", "boxes", "labels", "valid")))
    params = flax_retinanet_to_torch({"params": state.params, "batch_stats": state.batch_stats}, KIND)
    return losses, params, {k: np.asarray(v) for k, v in val.items()}


@pytest.fixture(scope="module")
def port_fit(variables):
    model = _served(variables, val=[BATCHES[0]])
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    trainer = Trainer(max_steps=3, warmup_steps=0, log_every_n_steps=1, num_sanity_val_steps=0)
    metrics = trainer.fit(model)
    return model, trainer, metrics, before


def test_three_sgd_steps_match_jax_train_step(jax_steps, port_fit):
    want_losses, want_params, _ = jax_steps
    model, trainer, _, _ = port_fit
    got = trainer.logger_.meters["loss"].window
    assert trainer.global_step == 3 and len(got) == 3
    np.testing.assert_allclose(got, want_losses, rtol=LOSS_RTOL, atol=0)
    for k, p in model.net.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want_params[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_validation_losses_match_jax_eval_step(jax_steps, port_fit):
    _, _, want = jax_steps
    model, trainer, metrics, _ = port_fit
    got = trainer.eval_step(BATCHES[0])
    for k in ("classification_loss", "regression_loss", "loss"):
        assert got[k].shape == (2,)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=LOSS_RTOL, atol=1e-7)
    assert metrics["val_loss"] == pytest.approx(float(got["loss"].mean()), rel=1e-6)
    assert set(metrics) >= {"train_loss", "train_classification_loss", "train_regression_loss",
                            "val_loss", "val_classification_loss", "val_regression_loss", "lr"}


def test_training_changes_parameters_not_bn_statistics(port_fit):
    model, _, _, before = port_fit
    after = model.net.state_dict()
    for k, v in before.items():
        if "running_" in k or "num_batches" in k:
            assert torch.equal(after[k], v), k
        else:
            assert not torch.equal(after[k], v), k  # every parameter moved, BN affine too


def test_pad_targets_matches_jax():
    from pytorch_retinanet_tpu.data.loader import pad_targets as jax_pad_targets

    boxes = np.arange(12 * 4, dtype=np.float32).reshape(12, 4)
    labels = np.arange(12)
    for max_gt in (5, 12, 20):
        for g, w in zip(pad_targets(boxes, labels, max_gt), jax_pad_targets(boxes, labels, max_gt)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------- #
# The port's Trainer knobs (no JAX counterpart run)
# ---------------------------------------------------------------------------- #
@pytest.mark.parametrize("knob", [{"mesh": object()}, {"devices": [0]}])
def test_later_knobs_raise_with_their_roadmap_item(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        Trainer(**knob)


def test_trainer_test_predict_and_data_kinds_raise(variables):
    t = Trainer()
    model = _served(variables)
    with pytest.raises(NotImplementedError, match="A8"):
        t.test(model)
    with pytest.raises(NotImplementedError, match="A8"):
        t.predict(model)
    for kind in ("coco", "pascal", "csv"):
        m = RetinaNetModel(ConfigDict({"model": MODEL, "dataset": {"kind": kind}}), device="cpu")
        with pytest.raises(NotImplementedError, match="A8"):
            m.train_dataloader()
    with pytest.raises(ValueError):
        RetinaNetModel(ConfigDict({"model": MODEL}), device="cpu").prepare_data()
    with pytest.warns(UserWarning, match="ignoring"):
        Trainer(limit_trian_batchez=2)


def test_limits_fast_dev_run_and_accumulation(variables):
    batches = BATCHES * 2  # 6 batches per epoch
    t = Trainer(max_epochs=1, limit_train_batches=2, warmup_steps=0, num_sanity_val_steps=0)
    t.fit(_served(variables, batches))
    assert t.global_step == 2
    t = Trainer(fast_dev_run=1, warmup_steps=0)
    m = t.fit(_served(variables, batches, val=batches))
    assert t.global_step == 1 and "val_loss" in m
    # Windows of 4 over 6 batches: one full window, and the partial one
    # flushed at epoch end, which rounds global_step up to 8.
    t = Trainer(max_epochs=1, accumulate_grad_batches=4, gradient_clip_val=1.0, warmup_steps=0,
                num_sanity_val_steps=0, log_every_n_steps=1)
    t.fit(_served(variables, batches))
    assert t.global_step == 8 and t._opt_step == 2
    assert Trainer._resolve_limit(0.5, 6) == 3 and Trainer._resolve_limit(4, 3) == 3
    with pytest.raises(ValueError):
        Trainer._resolve_limit(1.5, 3)


def test_warmup_and_step_scheduler_set_the_lr(variables):
    hp = {"model": MODEL, "optimizer": OPTIMIZER,
          "scheduler": {"class_name": "StepLR", "params": {"step_size": 1, "gamma": 0.5},
                        "interval": "step"}}
    m = _Served(ConfigDict(hp), BATCHES, device="cpu")
    m.net.load_state_dict(variables)
    t = Trainer(max_epochs=1, warmup_steps=10, warmup_factor=0.1, num_sanity_val_steps=0)
    t.fit(m)
    # 3 optimizer steps: warmup capped at max(3 // 5, 1) = 1 step, the
    # scheduler halved the LR at each of the 3 steps.
    assert t._warmup_eff == 1
    assert t.current_lr == pytest.approx(0.01 * 0.5**3)


def test_non_finite_loss_raises(variables):
    t = Trainer(max_steps=1, warmup_steps=0, num_sanity_val_steps=0)
    with pytest.raises(FloatingPointError, match="non-finite"):
        t._check_finite({"loss": float("nan")})

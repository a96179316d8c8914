"""Training and the engine on the card, at full width.

R50-FPN, 90 classes, ``configs/hparams.yaml``'s values (``HPARAMS`` of
``tests/torch_card.py``), seeded uint8 batches of 16 at 800x1344:

- ``Trainer(max_steps=7).fit`` launches the match kernel 5 times a step, the
  focal pair twice a level and the frozen-BN pair twice for each of the 53
  BNs; its losses are finite, every parameter moves and no BN statistic;
- one f32 resnet18 step at 128x192 on the card (match kernel) against the
  same step on the CPU (plain composition), with frozen and with live BN: the
  loss within ``STEP_LOSS_RTOL`` relative, each parameter's update within
  ``STEP_UPDATE_TOL`` of that tensor's largest, and live BN's running
  statistics within ``BN_STATS_TOL`` of each tensor's largest;
- a fit of 2 epochs of 3 steps with a 1-batch validation loader,
  checkpoints, EarlyStopping, LearningRateMonitor, the CSV and TensorBoard
  loggers and the profiler: the match kernel 5 times a train and validation
  step, ``last/`` and ``best/``, the logged metrics read back equal,
  ``hparams.yaml`` holding the config, a trace; the same fit interrupted by
  SIGTERM from its loader as epoch 2 starts and resumed with
  ``auto_resume``: the restored state bit for bit, the uninterrupted run's
  LRs exactly and its losses within ``STEP_LOSS_RTOL``; ``best/`` loaded
  into a ``Retinanet`` whose predict launches stem and NMS once;
- live BN (``freeze_bn=False``) for 3 steps: every running buffer moves,
  ``num_batches_tracked`` reads 3; remat on against off, with frozen and
  with live BN: the loss within ``STEP_LOSS_RTOL``, the running statistics
  within ``REMAT_STATS_RTOL`` relative.

Run on the card as ``tests/torch_card.py`` says.
"""

from __future__ import annotations

import csv
import os
import signal

import numpy as np
import pytest
import torch
from torch_card import (  # noqa: F401
    H, HPARAMS, STEP_LOSS_RTOL, TRAIN_BATCH, TRAIN_STEPS, W, check_detections, counted, dev,
    fit_seven, main_path_batch, r50_frozen_bn_shapes, recording, seeded_batches,
    served_model_class, small_batch,
)

from pytorch_retinanet_tpu_torch import ConfigDict, Retinanet, Trainer

pytestmark = pytest.mark.cuda

# Each parameter's update (after - before), card against CPU, of that
# tensor's largest: the largest relative differences show in the FPN's convs.
STEP_UPDATE_TOL = 1e-2
# Live BN running mean / var on the card against the CPU, of each tensor's
# largest |value|: the batch statistics sum in another order.
BN_STATS_TOL = 1e-4
# Remat on against off: the running statistics after one live-BN step, relative.
REMAT_STATS_RTOL = 1e-5
ENGINE_EPOCHS, ENGINE_STEPS = 2, 3


@pytest.fixture(scope="module")
def fit7(dev):
    """The fit's launches, losses, and the parameters and buffers that did
    (not) change."""
    model, trainer, launches, before = fit_seven()
    module = model.net.module
    params = dict(module.named_parameters())
    still = [k for k, p in params.items() if torch.equal(p.detach(), before[k])]
    moved = [k for k, b in module.named_buffers() if not torch.equal(b, before[k])]
    out = {"launches": launches, "losses": list(trainer.logger_.meters["loss"].window),
           "steps": trainer.global_step, "still": still, "moved": moved}
    del model, trainer, module, params, before
    torch.cuda.empty_cache()
    return out


def test_fit_launches_the_training_kernels(fit7):
    n = fit7["launches"]
    assert n["match_targets"] == 5 * TRAIN_STEPS
    assert n["focal_loss"] == 2 * 5 * TRAIN_STEPS
    assert n["frozen_bn"] == 2 * len(r50_frozen_bn_shapes(TRAIN_BATCH, H, W)) * TRAIN_STEPS


def test_fit_moves_every_parameter_and_no_bn_statistic(fit7):
    assert fit7["steps"] == TRAIN_STEPS and len(fit7["losses"]) == TRAIN_STEPS
    assert np.isfinite(fit7["losses"]).all()
    assert not fit7["still"], fit7["still"][:3]
    assert not fit7["moved"], fit7["moved"][:3]


@pytest.mark.parametrize("freeze_bn", [True, False], ids=["frozen_bn", "live_bn"])
def test_training_step_on_the_card_equals_the_cpu(dev, freeze_bn):
    hp = ConfigDict(HPARAMS).merge({
        "model": {"backbone_kind": "resnet18", "min_size": 128, "max_size": 192,
                  "compute_dtype": "float32", "prior": 0.1, "seed": 3, "freeze_bn": freeze_bn},
        "optimizer": {"params": {"lr": 0.01}}})
    batch = small_batch(np.random.default_rng(8), [5, 0])
    Model = served_model_class()
    models = {d: Model(hp, device=d) for d in ("cuda", "cpu")}
    models["cpu"].net.load_state_dict({k: v.cpu() for k, v in models["cuda"].net.state_dict().items()})
    before = {k: p.detach().clone() for k, p in models["cpu"].net.module.named_parameters()}
    before_stats = {k: b.clone() for k, b in models["cpu"].net.module.named_buffers()}
    loss, after, stats = {}, {}, {}
    for d, m in models.items():
        m.loader = [batch]
        t = Trainer(max_steps=1, warmup_steps=0, log_every_n_steps=1, num_sanity_val_steps=0)
        t.fit(m)
        loss[d] = t.logger_.meters["loss"].value
        after[d] = {k: p.detach().cpu() for k, p in m.net.module.named_parameters()}
        stats[d] = {k: b.cpu() for k, b in m.net.module.named_buffers() if "running_" in k}
    assert abs(loss["cuda"] - loss["cpu"]) <= STEP_LOSS_RTOL * abs(loss["cpu"])
    rel = {k: float((after["cuda"][k] - after["cpu"][k]).abs().max())
           / max(float((after["cpu"][k] - p0).abs().max()), 1e-12) for k, p0 in before.items()}
    assert max(rel.values()) <= STEP_UPDATE_TOL, sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    if not freeze_bn:
        err = {k: float((v - stats["cpu"][k]).abs().max()) / float(stats["cpu"][k].abs().max())
               for k, v in stats["cuda"].items()}
        assert max(err.values()) <= BN_STATS_TOL, max(err, key=err.get)
        assert not any(torch.equal(v, before_stats[k]) for k, v in stats["cpu"].items())


class SigtermLoader:
    """A train loader that sends SIGTERM to this process when epoch 2 asks
    for its first batch."""

    def __init__(self, batches: list):
        self.batches, self.epoch = batches, 0

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        self.epoch += 1
        for i, batch in enumerate(self.batches):
            if self.epoch == 2 and i == 0:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def same_state(a, b, path: str = "") -> list:
    """Where two nested checkpoint states differ (tensors bit for bit)."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        ok = torch.is_tensor(a) and torch.is_tensor(b) and a.dtype == b.dtype \
            and torch.equal(a, b.to(a.device))
        return [] if ok else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path} keys {sorted(set(a) ^ set(b))[:3]}"]
        return [d for k in a for d in same_state(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in same_state(x, y, f"{path}/{i}")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def engine_fit(loader, val, **trainer_kw):
    """A model on `loader`, its Trainer (2 epochs, warmup as the 7-step
    fit) and its recorded steps, not yet fitted."""
    model = served_model_class()(ConfigDict(HPARAMS))
    model.loader, model.val_loader = loader, val
    trainer = Trainer(max_epochs=ENGINE_EPOCHS, warmup_steps=500, log_every_n_steps=1,
                      **trainer_kw)
    return model, trainer, recording(trainer)


@pytest.fixture(scope="module")
def engine(dev, tmp_path_factory):
    """The uninterrupted fit with every callback and logger attached."""
    from pytorch_retinanet_tpu_torch.engine import (
        Callback, CSVLogger, EarlyStopping, LearningRateMonitor, TensorBoardLogger,
    )
    from pytorch_retinanet_tpu_torch.utils import ProfilerHook

    class Epochs(Callback):
        def __init__(self):
            self.metrics = []

        def on_epoch_end(self, trainer, metrics):
            self.metrics.append(dict(metrics))

    work = str(tmp_path_factory.mktemp("engine"))
    batches = seeded_batches(ENGINE_STEPS, TRAIN_BATCH, seed=10)
    val = seeded_batches(1, TRAIN_BATCH, seed=11)
    epochs, tb = Epochs(), TensorBoardLogger(os.path.join(work, "logs"), name="tb")
    csv_logger = CSVLogger(os.path.join(work, "logs"), name="csv")
    model, trainer, steps = engine_fit(
        batches, val, checkpoint_dir=os.path.join(work, "run"),
        callbacks=[EarlyStopping(patience=5), LearningRateMonitor(), tb, epochs],
        logger=csv_logger, profile_dir=os.path.join(work, "profile"))
    trainer.profiler = ProfilerHook(os.path.join(work, "profile"), start_step=1, num_steps=2)
    _, launches = counted(lambda: trainer.fit(model))
    out = {"work": work, "batches": batches, "val": val, "steps": steps, "launches": launches,
           "epochs": epochs.metrics, "csv_dir": csv_logger.log_dir, "tb_dir": tb.log_dir,
           "trace": trainer.profiler.trace_path}
    del model, trainer
    torch.cuda.empty_cache()
    return out


def test_engine_fit_runs_its_steps_and_launches_match_each_step(engine):
    train = [x for x in engine["steps"] if x[0] != "eval"]
    n_eval = sum(1 for x in engine["steps"] if x[0] == "eval")
    assert len(train) == ENGINE_EPOCHS * ENGINE_STEPS
    assert np.isfinite([v for _, v in train]).all()
    assert engine["launches"]["match_targets"] == 5 * (len(train) + n_eval)


def test_engine_fit_writes_checkpoints_logs_and_a_trace(engine):
    from pytorch_retinanet_tpu_torch.config import to_block_yaml
    from pytorch_retinanet_tpu_torch.engine.tb import read_events
    from pytorch_retinanet_tpu_torch.engine.trainer import CHECKPOINT_FILE

    for name in ("last", "best"):
        assert os.path.isfile(os.path.join(engine["work"], "run", name, CHECKPOINT_FILE))
    with open(os.path.join(engine["csv_dir"], "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    (events,) = [os.path.join(engine["tb_dir"], e) for e in os.listdir(engine["tb_dir"])
                 if e.startswith("events.out")]
    scalars = [e for e in read_events(events) if e["values"]]
    assert len(rows) == len(scalars) == ENGINE_EPOCHS
    for m, row, ev in zip(engine["epochs"], rows, scalars):
        assert "val_loss" in m and "lr" in m
        assert all(float(row[k]) == v and ev["values"][k] == np.float32(v) for k, v in m.items())
    try:
        import yaml
    except ImportError:
        yaml = None
    with open(os.path.join(engine["csv_dir"], "hparams.yaml")) as f:
        hparams = f.read()
    hp = ConfigDict(HPARAMS).to_dict()
    own = to_block_yaml(hp)  # what to_yaml writes where PyYAML is missing
    assert "num_classes: 90" in hparams and "num_classes: 90" in own
    if yaml:
        assert yaml.safe_load(hparams) == yaml.safe_load(own) == hp
    assert engine["trace"] and os.path.getsize(engine["trace"])


def test_sigterm_interrupts_the_fit_and_auto_resume_finishes_it(engine, dev):
    from pytorch_retinanet_tpu_torch.engine.trainer import CHECKPOINT_FILE

    work = engine["work"]
    model, trainer, cut = engine_fit(SigtermLoader(engine["batches"]), engine["val"],
                                     checkpoint_dir=os.path.join(work, "cut"))
    trainer.fit(model)
    interrupt = os.path.join(work, "cut", "interrupt")
    cut = [x for x in cut if x[0] != "eval"]
    assert trainer._interrupted and len(cut) == ENGINE_STEPS
    saved = torch.load(os.path.join(interrupt, CHECKPOINT_FILE), map_location=dev,
                       weights_only=True)
    del model, trainer
    model, resumed, rest = engine_fit(engine["batches"], engine["val"],
                                      checkpoint_dir=os.path.join(work, "cut"), auto_resume=True)
    restored, restore = {}, resumed.restore_checkpoint

    def restore_and_keep(p):
        # What the restore left in the trainer, written back out by
        # save_checkpoint itself (the restored epoch count as it stands).
        restore(p)
        again = os.path.join(work, "restored")
        resumed.save_checkpoint(again, completed_epochs=resumed.current_epoch)
        restored.update(state=torch.load(os.path.join(again, CHECKPOINT_FILE), map_location=dev,
                                         weights_only=True), path=p)

    resumed.restore_checkpoint = restore_and_keep
    resumed.fit(model)
    del model, resumed
    torch.cuda.empty_cache()
    assert restored.get("path") == interrupt
    assert not same_state(restored.get("state"), saved)
    got = cut + [x for x in rest if x[0] != "eval"]
    train = [x for x in engine["steps"] if x[0] != "eval"]
    assert len(got) == len(train) and [a[0] for a in got] == [b[0] for b in train]
    assert max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, train)) <= STEP_LOSS_RTOL


def test_predict_from_the_best_checkpoint(engine, dev):
    """Six steps from the 0.01 prior leave every score below 0.05:
    threshold 0 gives NMS its full candidates."""
    from pytorch_retinanet_tpu_torch.engine.trainer import CHECKPOINT_FILE

    net = Retinanet(**ConfigDict(HPARAMS).model, seed=5, score_thres=0.0)
    net.load_torch_state_dict(torch.load(os.path.join(engine["work"], "run", "best",
                                                      CHECKPOINT_FILE),
                                         map_location="cpu", weights_only=True)["module"])
    images = main_path_batch("cpu")[0]
    net.predict(images[:2])  # cuDNN plans and the allocator, outside the counts
    preds, launches = counted(lambda: net.predict(images))
    assert launches["fused_stem"] == 1 and launches["nms_keep_mask"] == 1
    check_detections(preds, score_thres=0.0)


def test_live_bn_fit_moves_every_running_buffer(dev):
    model = served_model_class()(ConfigDict(HPARAMS).merge({"model": {"freeze_bn": False}}))
    model.loader = seeded_batches(ENGINE_STEPS, TRAIN_BATCH, seed=12)
    module = model.net.module
    before = {k: b.clone() for k, b in module.named_buffers()}
    trainer = Trainer(max_steps=ENGINE_STEPS, warmup_steps=500, log_every_n_steps=1)
    _, launches = counted(lambda: trainer.fit(model))
    losses = trainer.logger_.meters["loss"].window
    assert len(losses) == ENGINE_STEPS and np.isfinite(losses).all()
    assert not [k for k, b in module.named_buffers() if "running_" in k and torch.equal(b, before[k])]
    assert {int(b) for k, b in module.named_buffers()
            if k.endswith("num_batches_tracked")} == {ENGINE_STEPS}
    assert launches["match_targets"] == 5 * ENGINE_STEPS


@pytest.mark.parametrize("freeze_bn", [True, False], ids=["frozen_bn", "live_bn"])
def test_remat_on_equals_off(dev, freeze_bn):
    batch = seeded_batches(1, TRAIN_BATCH, seed=12)[0]
    arms = {}
    for remat in (False, True):
        model = served_model_class()(ConfigDict(HPARAMS).merge(
            {"model": {"freeze_bn": freeze_bn, "remat": remat}}))
        model.loader = [batch]
        trainer = Trainer(max_steps=1, warmup_steps=0, log_every_n_steps=1, num_sanity_val_steps=0)
        trainer.fit(model)
        arms[remat] = (trainer.logger_.meters["loss"].value,
                       {k: b.clone() for k, b in model.net.module.named_buffers()})
        del model, trainer
        torch.cuda.empty_cache()
    (off, off_stats), (on, on_stats) = arms[False], arms[True]
    assert abs(on - off) <= STEP_LOSS_RTOL * abs(off)
    assert max(float(((on_stats[k] - v).abs() / v.abs().clamp_min(1e-12)).max())
               for k, v in off_stats.items() if "running_" in k) <= REMAT_STATS_RTOL
    assert {int(v) for k, v in on_stats.items()
            if k.endswith("num_batches_tracked")} == {0 if freeze_bn else 1}

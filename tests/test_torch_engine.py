"""The training engine of the PyTorch port vs the JAX package (CPU).

resnet18, 4 classes, f32, the 64x96 bucket, seeded batches of 2 served by
a ``RetinaNetModel`` subclass (no dataset on disk), as
``test_torch_train.py``.

* One ``freeze_bn=False`` train step through the port's ``Trainer.fit``
  against the JAX ``_build_steps`` train step (``mutable=["batch_stats"]``):
  the loss within 1e-4 relative, the parameters within 1e-5, the JAX
  ``batch_stats`` against the port's running buffers within 1e-5, and
  ``num_batches_tracked`` 1.
* ``tb``: the CRC-32C check value; event files read back by the other
  package's ``read_events`` with the same steps and scalars (f32 exactly).
* The callbacks' behaviours of ``tests/test_callbacks.py``, on the port.
* Checkpoints: ``save_checkpoint`` / ``restore_checkpoint`` bit for bit
  (parameters, buffers, optimizer state, epoch, ``global_step``, the
  pre-warmup LR, the scheduler's state); an interrupted save leaves the
  previous checkpoint whole.
* Resume: 2 epochs against 1 epoch and a resume from ``last``, with StepLR
  and with OneCycleLR cycling the momentum: per-step losses, LRs and
  momenta, and the final parameters and buffers, exactly equal (the CPU
  runs the same ops in the same order). The LRs across the resume equal
  the JAX Trainer's for the same scheduler and step count (its steps
  stubbed out: the LR bookkeeping is host-side), within 1e-12 relative.
* The interrupt cases of ``tests/test_trainer_interrupt.py``: SIGTERM
  saves ``interrupt`` and ``fit`` returns; the resume re-runs the
  interrupted epoch; a partial accumulation window is flushed first;
  ``save_on_interrupt=False`` installs nothing, and neither does a Trainer
  with no ``ModelCheckpoint`` (the default), so there Ctrl-C still raises.
* ``predict`` and the ``forward`` losses of a live-BN detector left in
  training mode by a direct ``train_step``: exactly a fresh eval-mode
  detector's on the same weights, with the running buffers untouched and
  the module's mode restored.
"""

from __future__ import annotations

import csv
import os
import signal
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.config import ConfigDict as JaxConfigDict
from pytorch_retinanet_tpu.engine import optim as jax_optim
from pytorch_retinanet_tpu.engine import tb as jax_tb
from pytorch_retinanet_tpu.engine.model import RetinaNetModel as JaxRetinaNetModel
from pytorch_retinanet_tpu.engine.trainer import Trainer as JaxTrainer
from pytorch_retinanet_tpu.models.converter import flax_retinanet_to_torch, torch_retinanet_to_flax
from pytorch_retinanet_tpu_torch import ConfigDict, OmegaConf, RetinaNetModel, Retinanet, Trainer
from pytorch_retinanet_tpu_torch.engine import (
    Callback,
    CSVLogger,
    EarlyStopping,
    LearningRateMonitor,
    ModelCheckpoint,
    TensorBoardLogger,
    tb,
)
from pytorch_retinanet_tpu_torch.engine.trainer import CHECKPOINT_FILE
from pytorch_retinanet_tpu_torch.utils import ProfilerHook, device_memory_stats

KIND = "resnet18"
MODEL = dict(num_classes=4, backbone_kind=KIND, pretrained=False, min_size=64, max_size=96,
             compute_dtype="float32", prior=0.1)
OPTIMIZER = {"class_name": "torch.optim.SGD",
             "params": {"lr": 0.01, "momentum": 0.9, "weight_decay": 0.001}}
STEP_LR = {"class_name": "torch.optim.lr_scheduler.StepLR",
           "params": {"step_size": 1, "gamma": 0.5}, "interval": "epoch"}
ONE_CYCLE = {"class_name": "OneCycleLR",
             "params": {"max_lr": 0.02, "total_steps": 6, "pct_start": 0.4,
                        "base_momentum": 0.8, "max_momentum": 0.95},
             "interval": "step"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's many small CPU steps: the suite
    runs several workers at once, and eight threads each oversubscribe the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_dict(seed=0):
    """Seeded port init with random BN statistics and affine (tensors)."""
    net = Retinanet(device="cpu", seed=seed, **MODEL)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        if v.ndim == 1 and k.endswith((".weight", "running_var")):
            v = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif v.ndim == 1 and k.endswith(("running_mean", ".bias")) and "backbone" in k:
            v = torch.from_numpy(rng.normal(0, 0.05, v.shape).astype(np.float32))
        sd[k] = v.clone()
    return sd


SD = _state_dict()


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, 100, 4), np.float32)
    labels = np.zeros((b, 100), np.int32)
    valid = np.zeros((b, 100), bool)
    for i, n in enumerate([3, 1, 0, 2][:b]):
        ctr = rng.uniform(10, 80, (n, 2))
        wh = rng.uniform(12, 50, (n, 2))
        boxes[i, :n] = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
        labels[i, :n] = rng.integers(1, 5, n)
        valid[i, :n] = True
    return {"images": rng.random((b, 64, 96, 3), dtype=np.float32), "boxes": boxes,
            "labels": labels, "valid": valid}


BATCHES = [_batch(s) for s in range(4)]


class _Served(RetinaNetModel):
    """The port's model serving fixed batches."""

    def __init__(self, hparams, batches, val=None):
        super().__init__(hparams, device="cpu")
        self.batches, self.val = batches, val
        self.net.load_state_dict(SD)

    def prepare_data(self):
        pass

    def train_dataloader(self, shard=0, num_shards=1):
        return list(self.batches)

    def val_dataloader(self, shard=0, num_shards=1):
        return None if self.val is None else list(self.val)


def _served(batches=BATCHES[:3], val=None, scheduler=None, **model):
    hp = {"model": {**MODEL, **model}, "optimizer": OPTIMIZER}
    if scheduler:
        hp["scheduler"] = scheduler
    return _Served(ConfigDict(hp), batches, val)


def _trainer(**kw):
    kw = {"warmup_steps": 0, "num_sanity_val_steps": 0, "log_every_n_steps": 1, **kw}
    return Trainer(**kw)


# ---------------------------------------------------------------------------- #
# Live batch norm against the JAX train step
# ---------------------------------------------------------------------------- #
def test_live_bn_step_matches_jax_mutable_batch_stats():
    params, stats = torch_retinanet_to_flax({k: v.numpy() for k, v in SD.items()}, KIND)
    model = JaxRetinaNetModel(JaxConfigDict({"model": {**MODEL, "freeze_bn": False},
                                             "optimizer": OPTIMIZER}))
    model.net.variables = {"params": params, "batch_stats": stats}
    trainer = JaxTrainer(checkpoint_dir=None, devices=jax.devices()[:1], warmup_steps=0)
    trainer._optimizer = jax_optim.build_optimizer(OPTIMIZER["class_name"], OPTIMIZER["params"])
    train_step, _, _ = trainer._build_steps(model)
    b = BATCHES[0]
    state, m = train_step(trainer._init_state(model),
                          *(jnp.asarray(b[k]) for k in ("images", "boxes", "labels", "valid")))
    want = flax_retinanet_to_torch({"params": state.params, "batch_stats": state.batch_stats}, KIND)

    port = _served(batches=[b], freeze_bn=False)
    t = _trainer(max_steps=1)
    t.fit(port)
    np.testing.assert_allclose(t.logger_.meters["loss"].value, float(m["loss"]), rtol=1e-4)
    got = port.net.state_dict()
    moved = 0
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k
            continue
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)
        moved += "running_" in k and not torch.equal(v, SD[k])
    assert moved == sum("running_" in k for k in got)  # every running buffer moved
    assert not port.net.module.training  # fit leaves the module in eval mode


def test_predict_and_forward_after_a_train_step_run_in_eval_mode():
    port = _served(batches=BATCHES[:1], freeze_bn=False)
    t = _trainer(max_steps=1)
    t.fit(port)
    t.train_step(BATCHES[1])  # leaves the module in training mode
    net = port.net
    assert net.module.training
    buffers = {k: v.clone() for k, v in net.module.named_buffers()}
    fresh = Retinanet(device="cpu", **{**MODEL, "freeze_bn": False})
    fresh.load_state_dict(net.state_dict())
    b = BATCHES[2]
    images = [b["images"][i] for i in range(len(b["images"]))]
    targets = {k: b[k] for k in ("boxes", "labels", "valid")}
    for got, want in zip(net.predict(images), fresh.predict(images)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with torch.no_grad():
        got, want = net(b["images"], targets), fresh(b["images"], targets)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert net.module.training  # the caller's mode, restored
    for k, v in net.module.named_buffers():
        assert torch.equal(v, buffers[k]), k


# ---------------------------------------------------------------------------- #
# tb
# ---------------------------------------------------------------------------- #
def test_crc32c_known_vector():
    assert tb.crc32c(b"123456789") == 0xE3069283 == jax_tb.crc32c(b"123456789")
    assert tb.crc32c(b"") == 0


@pytest.mark.parametrize("writer, reader", [(tb, jax_tb), (jax_tb, tb)])
def test_event_files_read_back_across_packages(tmp_path, writer, reader):
    w = writer.EventFileWriter(str(tmp_path))
    w.add_scalars({"train_loss": 1.25, "AP": 0.31}, 4)
    w.add_scalars({"train_loss": 0.5}, 300)
    w.close()
    events = reader.read_events(w.path)
    assert events[0]["file_version"] == "brain.Event:2"
    assert [e["step"] for e in events[1:]] == [4, 300]
    assert events[1]["values"] == {"AP": np.float32(0.31), "train_loss": 1.25}
    assert events[2]["values"] == {"train_loss": 0.5}
    assert reader.read_events(w.path) == writer.read_events(w.path)


# ---------------------------------------------------------------------------- #
# Callbacks (tests/test_callbacks.py's behaviours)
# ---------------------------------------------------------------------------- #
def fake_trainer(epoch=0, step=0):
    return SimpleNamespace(current_epoch=epoch, global_step=step, should_stop=False,
                           current_lr=0.01, saved=[], save_checkpoint=lambda path, **kw: None)


def _csv_rows(lg):
    with open(os.path.join(lg.log_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def test_csv_logger_rows_and_union_header(tmp_path):
    lg = CSVLogger(save_dir=str(tmp_path), name="exp")
    lg.on_epoch_end(fake_trainer(0, 4), {"train_loss": 1.0})
    lg.on_epoch_end(fake_trainer(1, 8), {"train_loss": 0.5, "val_loss": 0.7})
    rows = _csv_rows(lg)
    assert lg.log_dir == os.path.join(str(tmp_path), "exp", "version_0")
    assert rows[0]["epoch"] == "0" and rows[0]["step"] == "4" and rows[0]["val_loss"] == ""
    assert rows[1]["val_loss"] == "0.7" and float(rows[1]["train_loss"]) == 0.5


def test_logger_versions_autoincrement_and_pin(tmp_path):
    for cls in (CSVLogger, TensorBoardLogger):
        a = cls(save_dir=str(tmp_path), name=cls.__name__)
        a.on_epoch_end(fake_trainer(), {})
        b = cls(save_dir=str(tmp_path), name=cls.__name__)
        b.on_epoch_end(fake_trainer(), {})
        assert a.log_dir.endswith("version_0") and b.log_dir.endswith("version_1")
        assert cls(save_dir=str(tmp_path), name=cls.__name__, version=7).log_dir.endswith(
            "version_7")


def test_csv_rewritten_each_epoch(tmp_path):
    lg = CSVLogger(save_dir=str(tmp_path))
    for e in range(3):
        lg.on_epoch_end(fake_trainer(e, e * 2), {"loss": 1.0 / (e + 1)})
        assert len(_csv_rows(lg)) == e + 1


@pytest.mark.parametrize("cls", [CSVLogger, TensorBoardLogger])
def test_log_hyperparams_yaml(tmp_path, cls, monkeypatch):
    import sys

    import yaml

    monkeypatch.setitem(sys.modules, "yaml", None)  # as on the card
    lg = cls(save_dir=str(tmp_path))
    conf = OmegaConf.create({"model": {"num_classes": 3, "lr": 1e-5}})
    lg.log_hyperparams(conf)
    monkeypatch.undo()
    with open(os.path.join(lg.log_dir, "hparams.yaml")) as f:
        assert yaml.safe_load(f) == conf.to_dict()


def test_trainer_logger_and_callback_wiring(tmp_path):
    lg = CSVLogger(save_dir=str(tmp_path))
    es = EarlyStopping()
    t = Trainer(callbacks=[es], checkpoint_dir=str(tmp_path / "ckpt"), logger=lg,
                resume_from_checkpoint=None, auto_resume=True, save_on_interrupt=True,
                profile_dir=str(tmp_path / "prof"))
    assert t.logger is lg and t.callbacks[0] is es and t.callbacks[-1] is lg
    assert [c.dirpath for c in t.callbacks if isinstance(c, ModelCheckpoint)] == [
        str(tmp_path / "ckpt")]
    assert Trainer().logger is None and Trainer(logger=False).logger is None
    fast = Trainer(fast_dev_run=1, callbacks=[ModelCheckpoint(str(tmp_path)), es],
                   checkpoint_dir=str(tmp_path), logger=lg)
    assert fast.callbacks == [es] and fast.logger is None


def test_tensorboard_events_and_nan_dropped(tmp_path):
    lg = TensorBoardLogger(save_dir=str(tmp_path), name="exp")
    lg.on_epoch_end(fake_trainer(0, 4), {"train_loss": 1.25, "bad": float("nan")})
    lg.on_epoch_end(fake_trainer(1, 300), {"train_loss": 0.5, "AP": 0.31})
    lg.on_train_end(fake_trainer())
    (name,) = [f for f in os.listdir(lg.log_dir) if f.startswith("events.out")]
    events = jax_tb.read_events(os.path.join(lg.log_dir, name))
    assert events[1]["step"] == 4 and "bad" not in events[1]["values"]
    assert events[1]["values"]["train_loss"] == 1.25
    assert events[2]["values"]["epoch"] == 1.0
    assert events[2]["values"]["AP"] == pytest.approx(0.31, abs=1e-6)


@pytest.mark.parametrize("values, mode, min_delta, patience, stops", [
    ((1.0, 1.1, 1.2), "min", 0.0, 2, True),
    ((1.0, 1.1), "min", 0.0, 2, False),
    ((1.0, 1.1, 0.9, 1.0), "min", 0.0, 2, False),
    ((0.50, 0.52), "max", 0.05, 1, True),
])
def test_early_stopping(values, mode, min_delta, patience, stops):
    es = EarlyStopping(monitor="m", patience=patience, mode=mode, min_delta=min_delta)
    t = fake_trainer()
    for v in values:
        es.on_epoch_end(t, {"m": v, "other": 0.0})
    assert t.should_stop is stops
    t = fake_trainer()
    for _ in range(3):
        es.on_epoch_end(t, {"other": 1.0})  # a missing metric is ignored
    assert not t.should_stop


def test_model_checkpoint_last_and_best_and_lr_monitor(tmp_path):
    mc = ModelCheckpoint(dirpath=str(tmp_path), monitor="val_loss")
    t = fake_trainer()
    t.save_checkpoint = lambda path, **kw: t.saved.append(path)
    for v in (1.0, 2.0, 0.5):
        mc.on_epoch_end(t, {"val_loss": v})
    assert sum(p.endswith("last") for p in t.saved) == 3
    assert sum(p.endswith("best") for p in t.saved) == 2 and mc.best == 0.5
    m = {}
    LearningRateMonitor().on_epoch_end(fake_trainer(), m)
    assert m["lr"] == 0.01


def test_profiler_hook_and_memory_stats_on_the_cpu(tmp_path):
    assert device_memory_stats() == {}
    t = _trainer(max_epochs=1, profile_dir=str(tmp_path))
    t.profiler = ProfilerHook(str(tmp_path), start_step=1, num_steps=1)
    t.fit(_served())
    assert t.profiler.trace_path == os.path.join(str(tmp_path), "trace_steps_2-2.json")
    assert os.path.getsize(t.profiler.trace_path) > 0


# ---------------------------------------------------------------------------- #
# Checkpoints and resume
# ---------------------------------------------------------------------------- #
def _snapshot(trainer, model):
    return {
        "module": {k: v.clone() for k, v in model.net.module.state_dict().items()},
        "optimizer": {i: {k: v.clone() for k, v in s.items()}
                      for i, s in trainer._optimizer.state_dict()["state"].items()},
        "counters": (trainer.current_epoch, trainer.global_step, trainer._sched_lr),
        "scheduler": trainer._scheduler.state_dict(),
    }


def _assert_same(a, b):
    assert a["counters"] == b["counters"] and a["scheduler"] == b["scheduler"]
    for k, v in a["module"].items():
        assert torch.equal(v, b["module"][k]), k
    assert a["optimizer"].keys() == b["optimizer"].keys()
    for i, s in a["optimizer"].items():
        for k, v in s.items():
            assert torch.equal(v, b["optimizer"][i][k]), (i, k)


def test_checkpoint_round_trip_bit_for_bit(tmp_path, monkeypatch):
    model = _served(scheduler=STEP_LR)
    t = _trainer(max_epochs=1, checkpoint_dir=str(tmp_path))
    t.fit(model)
    saved = _snapshot(t, model)
    saved["counters"] = (1, 3, saved["counters"][2])  # epoch = epochs completed
    path = os.path.join(str(tmp_path), "last")
    ckpt = torch.load(os.path.join(path, CHECKPOINT_FILE), weights_only=True)
    assert set(ckpt) == {"module", "optimizer", "epoch", "global_step", "sched_lr",
                         "scheduler_state"}
    assert os.listdir(path) == [CHECKPOINT_FILE]

    other = _served(scheduler=STEP_LR)
    t2 = _trainer(max_epochs=1)
    t2._model = other
    t2._optimizer, t2._scheduler, _ = other.configure_optimizers()
    t2.restore_checkpoint(path)
    _assert_same(_snapshot(t2, other), saved)

    # A save cut short leaves the previous checkpoint whole.
    before = open(os.path.join(path, CHECKPOINT_FILE), "rb").read()

    def cut(obj, f):
        open(f, "wb").write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", cut)
    with pytest.raises(KeyboardInterrupt):
        t.save_checkpoint(path)
    assert open(os.path.join(path, CHECKPOINT_FILE), "rb").read() == before


class _StopAfterFirstEpoch(Callback):
    def on_epoch_end(self, trainer, metrics):
        trainer.should_stop = True


def _recording(trainer):
    """Record each step's LR, momentum and loss."""
    seen = []
    step = trainer.train_step

    def train_step(batch):
        group = trainer._optimizer.param_groups[0]
        out = step(batch)
        seen.append((group["lr"], group["momentum"], out["loss"].item()))
        return out

    trainer.train_step = train_step
    return seen


def _jax_lrs(scheduler, epochs=2):
    """The JAX Trainer's per-step LRs for `scheduler` over `epochs` of 3
    batches, its train step stubbed out."""
    hp = {"model": MODEL, "optimizer": OPTIMIZER, "scheduler": scheduler,
          "dataloader": {"train_bs": 2}}

    class Served(JaxRetinaNetModel):
        def prepare_data(self):
            pass

        def train_dataloader(self, shard=0, num_shards=1):
            return [{k: BATCHES[i][k] for k in ("images", "boxes", "labels", "valid")}
                    for i in range(3)]

        def val_dataloader(self, shard=0, num_shards=1):
            return None

    trainer = JaxTrainer(max_epochs=epochs, checkpoint_dir=None, devices=jax.devices()[:1],
                         warmup_steps=2, num_sanity_val_steps=0, log_every_n_steps=1)
    lrs = []

    def train_step(state, *batch):
        lrs.append(trainer.current_lr)
        return state, {"loss": np.float32(1.0)}

    trainer._get_steps = lambda model: (train_step, None, None)
    trainer.fit(Served(JaxConfigDict(hp)))
    return lrs


@pytest.mark.parametrize("scheduler", [STEP_LR, ONE_CYCLE], ids=["StepLR", "OneCycleLR"])
def test_resume_continues_the_uninterrupted_run(tmp_path, scheduler):
    whole = _served(scheduler=scheduler)
    t = _trainer(max_epochs=2, warmup_steps=2)
    want = _recording(t)
    t.fit(whole)

    first = _served(scheduler=scheduler)
    t1 = _trainer(max_epochs=2, warmup_steps=2, checkpoint_dir=str(tmp_path),
                  callbacks=[_StopAfterFirstEpoch()])
    got = _recording(t1)
    t1.fit(first)
    assert t1.global_step == 3
    resumed = _served(scheduler=scheduler)
    t2 = _trainer(max_epochs=2, warmup_steps=2,
                  resume_from_checkpoint=os.path.join(str(tmp_path), "last"))
    rest = _recording(t2)
    t2.fit(resumed)
    got += rest
    assert got == want and len(got) == 6
    assert (t2.current_epoch, t2.global_step) == (1, 6)
    assert t2._scheduler.state_dict() == t._scheduler.state_dict()
    assert t2.current_lr == t.current_lr
    for k, v in whole.net.state_dict().items():
        assert torch.equal(resumed.net.state_dict()[k], v), k
    if scheduler is ONE_CYCLE:
        assert len({m for _, m, _ in got}) > 2  # the momentum cycled
    jax_lrs = _jax_lrs(scheduler)
    np.testing.assert_allclose([lr for lr, _, _ in got], jax_lrs, rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------- #
# Interrupts (tests/test_trainer_interrupt.py's cases, on served batches)
# ---------------------------------------------------------------------------- #
def _fit_with_signal_at_batch(ckpt_dir, *, n, sig, model=None, **trainer_kwargs):
    """fit() with `sig` raised just before the n-th batch goes to the device.

    A sentinel handler stands in before the fit, so that a Trainer that
    installs no handler fails the test instead of killing the process.
    """
    hits = []
    prev = signal.signal(sig, lambda s, f: hits.append(s))
    try:
        model = model or _served(batches=BATCHES, scheduler=STEP_LR)
        trainer = _trainer(max_epochs=2, checkpoint_dir=ckpt_dir, **trainer_kwargs)
        orig, calls = trainer._device_batch, {"n": 0}

        def patched(batch):
            calls["n"] += 1
            if calls["n"] == n:
                signal.raise_signal(sig)
            return orig(batch)

        trainer._device_batch = patched
        trainer.fit(model)
        assert not hits, "the Trainer installed no signal handler"
        assert signal.getsignal(sig) is not signal.SIG_DFL
        return model, trainer
    finally:
        signal.signal(sig, prev)


def test_sigterm_saves_and_returns(tmp_path):
    _, trainer = _fit_with_signal_at_batch(str(tmp_path), n=2, sig=signal.SIGTERM)
    assert trainer._interrupted and trainer.global_step == 2
    assert os.path.isfile(os.path.join(str(tmp_path), "interrupt", CHECKPOINT_FILE))
    assert not os.path.isdir(os.path.join(str(tmp_path), "last"))
    assert trainer.current_lr == pytest.approx(0.01)  # no epoch scheduler step


def test_resume_reruns_the_interrupted_epoch(tmp_path):
    model, _ = _fit_with_signal_at_batch(str(tmp_path), n=2, sig=signal.SIGINT)
    ckpt = torch.load(os.path.join(str(tmp_path), "interrupt", CHECKPOINT_FILE),
                      weights_only=True)
    assert ckpt["epoch"] == 0 and ckpt["global_step"] == 2
    resumed = _trainer(max_epochs=2, checkpoint_dir=str(tmp_path), auto_resume=True)
    metrics = resumed.fit(model)
    assert resumed.current_epoch == 1 and resumed.global_step == 2 + 2 * 4
    assert metrics["lr"] == pytest.approx(0.01 * 0.25)  # StepLR stepped once per epoch
    assert np.isfinite(metrics["train_loss"])
    # The newest of interrupt and last is the frontier; best never is.
    assert resumed._latest_checkpoint() == os.path.join(str(tmp_path), "last")


def test_partial_accumulation_window_flushed_before_the_save(tmp_path):
    _, trainer = _fit_with_signal_at_batch(str(tmp_path), n=3, sig=signal.SIGTERM,
                                           accumulate_grad_batches=2)
    assert trainer._optimizer.mini_step == 0 and trainer.global_step == 4
    assert all(p.grad is None for p in trainer._model.net.module.parameters())
    assert os.path.isfile(os.path.join(str(tmp_path), "interrupt", CHECKPOINT_FILE))


def test_save_on_interrupt_disabled_installs_nothing(tmp_path):
    trainer = _trainer(max_epochs=1, checkpoint_dir=str(tmp_path), save_on_interrupt=False)
    assert trainer._install_interrupt_handlers() == {}
    before = signal.getsignal(signal.SIGTERM)
    trainer.fit(_served())
    assert signal.getsignal(signal.SIGTERM) is before
    assert not os.path.isdir(os.path.join(str(tmp_path), "interrupt"))
    assert os.path.isfile(os.path.join(str(tmp_path), "last", CHECKPOINT_FILE))


def test_default_trainer_installs_no_handler():
    trainer = Trainer()
    assert not trainer._checkpoint_dirs()
    assert trainer._install_interrupt_handlers() == {}
    before = signal.getsignal(signal.SIGINT)
    _trainer(max_steps=1).fit(_served(batches=BATCHES[:1]))
    assert signal.getsignal(signal.SIGINT) is before


def test_signal_from_the_loader_stops_before_that_step(tmp_path):
    """SIGTERM while the loader fetches epoch 2's first batch: no step of
    epoch 2 runs, so the resume continues the uninterrupted run exactly
    (``tests/test_torch_card_train.py`` at full width on the card)."""

    class Loader:
        def __init__(self):
            self.epoch = 0

        def __len__(self):
            return 3

        def __iter__(self):
            self.epoch += 1
            for i, b in enumerate(BATCHES[:3]):
                if self.epoch == 2 and i == 0:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield b

    whole = _served(scheduler=ONE_CYCLE)
    t = _trainer(max_epochs=2)
    want = _recording(t)
    t.fit(whole)
    cut = _served(scheduler=ONE_CYCLE)
    cut.batches = Loader()
    cut.train_dataloader = lambda shard=0, num_shards=1: cut.batches
    t1 = _trainer(max_epochs=2, checkpoint_dir=str(tmp_path))
    got = _recording(t1)
    t1.fit(cut)
    assert t1._interrupted and t1.global_step == 3 and len(got) == 3
    assert torch.load(os.path.join(str(tmp_path), "interrupt", CHECKPOINT_FILE),
                      weights_only=True)["epoch"] == 1
    resumed = _served(scheduler=ONE_CYCLE)
    t2 = _trainer(max_epochs=2, checkpoint_dir=str(tmp_path), auto_resume=True)
    rest = _recording(t2)
    t2.fit(resumed)
    assert got + rest == want
    for k, v in whole.net.state_dict().items():
        assert torch.equal(resumed.net.state_dict()[k], v), k

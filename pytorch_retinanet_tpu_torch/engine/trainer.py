"""Trainer: the fit loop, validation, checkpoints and the step functions, single process.

Counterpart of ``pytorch_retinanet_tpu/engine/trainer.py`` (a
``pytorch_lightning.Trainer`` 1.0 look-alike) with the same loop design and
knobs, and without its JAX mechanics (``jit``, donation, meshes): the state
is the module's parameters and buffers and the ``torch.optim`` state,
updated in place.

A train step runs the module in training mode (live batch statistics when
it was built with ``freeze_bn=False``) through its own stem (never the
fused stem, as the JAX trainer trains), the per-level loss (whose targets
come from the match kernel on CUDA), ``backward``, the global-norm clip
when not accumulating, and the optimizer step. Validation runs in eval
mode, on the running statistics.

Checkpoints are one ``torch.save`` file per directory
(``<dir>/checkpoint.pt``: module state, optimizer state, completed epochs,
``global_step``, the pre-warmup LR and the scheduler's versioned state),
written under a temporary name and renamed into place, and readable with
``torch.load(..., weights_only=True)``. ``checkpoint_dir`` defaults to None
here (the JAX Trainer's is ``"checkpoints"``): a fit writes nothing unless
asked. With ``save_on_interrupt`` (the default) and a ``ModelCheckpoint``
configured, SIGTERM or SIGINT during ``fit`` saves
``<checkpoint_dir>/interrupt`` at the next step boundary (a signal that
lands while the loader fetches a batch stops before that batch's step) and
returns; without a ``ModelCheckpoint`` no handler is installed and the
signals keep their default behaviour. ``auto_resume`` continues from the
newer of ``interrupt`` and ``last``.

Not ported yet: ``mesh`` / ``devices`` (ROADMAP A9) and ``Trainer.test`` /
``Trainer.predict`` (ROADMAP A8), which raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import retinanet_loss_levels
from ..utils.metrics import MetricLogger, ProfilerHook, device_memory_stats
from .callbacks import Callback, ModelCheckpoint
from .model import RetinaNetModel
from .optim import (
    GradientAccumulation,
    clip_grad_norm,
    current_learning_rate,
    set_learning_rate,
    set_momentum,
    warmup_scale,
    wrap_accumulation,
)

logger = logging.getLogger(__name__)

Tensor = torch.Tensor

CHECKPOINT_FILE = "checkpoint.pt"


class Trainer:
    """``Trainer(...).fit(model)`` and ``.validate(model)``.

    Accepts and ignores the torch-specific ``gpus`` and ``precision``: the
    device is the model's, and the compute dtype is the model's. ``logger``
    takes an experiment logger callback (``CSVLogger``,
    ``TensorBoardLogger``); True, False and None mean none.
    """

    def __init__(
        self,
        max_epochs: int = 10,
        max_steps: Optional[int] = None,
        callbacks: Optional[List[Any]] = None,
        checkpoint_dir: Optional[str] = None,
        resume_from_checkpoint: Optional[str] = None,
        val_check_interval: int = 1,
        log_every_n_steps: int = 50,
        gradient_clip_val: Optional[float] = None,
        accumulate_grad_batches: int = 1,
        warmup_steps: int = 500,
        warmup_factor: float = 0.001,
        profile_dir: Optional[str] = None,
        mesh: Any = None,
        devices: Any = None,
        save_on_interrupt: bool = True,
        auto_resume: bool = False,
        logger: Any = True,
        limit_train_batches: Any = 1.0,
        limit_val_batches: Any = 1.0,
        fast_dev_run: Any = False,
        check_val_every_n_epoch: Optional[int] = None,
        overfit_batches: Any = 0.0,
        num_sanity_val_steps: int = 2,
        gpus: Any = None,
        precision: Any = None,
        **_unknown: Any,
    ):
        if _unknown:
            warnings.warn(
                f"Trainer: ignoring unsupported argument(s) {sorted(_unknown)}: they have no "
                "effect (gpus/precision are absorbed by design).",
                UserWarning, stacklevel=2,
            )
        for name, value in (("mesh", mesh), ("devices", devices)):
            if value:
                raise NotImplementedError(
                    f"Trainer({name}=...) is ROADMAP A9 (distributed): not ported yet")
        # fast_dev_run=n: one epoch of n train and n val batches, no sanity
        # check, no checkpointing and no experiment logger (Lightning 1.0).
        if fast_dev_run:
            max_epochs, max_steps = 1, None
            limit_train_batches = limit_val_batches = int(fast_dev_run)
            num_sanity_val_steps = 0
            checkpoint_dir = resume_from_checkpoint = None
            auto_resume = False
            callbacks = [c for c in (callbacks or []) if not isinstance(c, ModelCheckpoint)]
            logger = None
        self.callbacks: List[Callback] = list(callbacks or [])
        if checkpoint_dir and not any(isinstance(c, ModelCheckpoint) for c in self.callbacks):
            self.callbacks.append(ModelCheckpoint(checkpoint_dir))
        self.logger = logger if isinstance(logger, Callback) else None
        if self.logger is not None:
            self.callbacks.append(self.logger)
        self.resume_from_checkpoint = resume_from_checkpoint
        self.auto_resume = auto_resume
        # SIGTERM / SIGINT during fit: save <checkpoint_dir>/interrupt at the
        # next step boundary and return (a second signal aborts); only with
        # a ModelCheckpoint, which gives the save its directory.
        self.save_on_interrupt = save_on_interrupt
        self._interrupted = False
        self.profiler = ProfilerHook(profile_dir)
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        # overfit_batches=n: train on a fixed, unshuffled slice of n train
        # batches and validate on the same slice.
        self.overfit_batches = overfit_batches
        self.num_sanity_val_steps = int(num_sanity_val_steps or 0)
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.val_check_interval = (
            int(check_val_every_n_epoch) if check_val_every_n_epoch is not None
            else val_check_interval
        )
        self.gradient_clip_val = gradient_clip_val
        # accumulate_grad_batches=N: one optimizer step per N loader batches
        # on the window's mean gradient. Warmup, interval="step" schedulers
        # and max_steps count optimizer steps; global_step counts batches.
        self.accumulate_grad_batches = max(int(accumulate_grad_batches or 1), 1)
        self.warmup_steps = warmup_steps
        self.warmup_factor = warmup_factor
        self.logger_ = MetricLogger(print_freq=log_every_n_steps)
        self.should_stop = False
        self._train_batch_limit: Optional[int] = None
        self.current_epoch = 0
        self.global_step = 0
        self.current_lr = 0.0
        self._sched_lr = 0.0
        self._warmup_eff = warmup_steps
        self._model: Optional[RetinaNetModel] = None
        self._optimizer = None
        self._scheduler = None
        self._sched_meta: Dict[str, Any] = {}

    @staticmethod
    def _resolve_limit(limit: Any, n: int) -> int:
        """An int is an absolute batch count, a float in [0, 1] a fraction of
        the loader (1.0 = all of it)."""
        if limit is None or isinstance(limit, bool):
            return n if (limit is None or limit) else 0
        if isinstance(limit, int):
            return min(limit, n)
        frac = float(limit)
        if not 0.0 <= frac <= 1.0:
            raise ValueError(f"a float batch limit must be a fraction in [0, 1], got {limit!r}")
        return n if frac == 1.0 else int(n * frac)

    @property
    def _opt_step(self) -> int:
        """Optimizer steps: one per `accumulate_grad_batches` loader batches
        (the epoch-end flush rounds `global_step` up to the window)."""
        return self.global_step // self.accumulate_grad_batches

    def _wrap_optimizer(self, optimizer):
        if self.accumulate_grad_batches <= 1:
            return optimizer
        # The clip moves inside the accumulation, onto the window mean at
        # optimizer-step time; train_step does not clip per micro-batch then.
        return wrap_accumulation(optimizer, self.accumulate_grad_batches,
                                 clip_norm=self.gradient_clip_val)

    # ------------------------------------------------------------------ #
    # Steps
    # ------------------------------------------------------------------ #
    def _device_batch(self, batch: Dict[str, Any]) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        dev = self._model.net.device
        return tuple(
            (v if isinstance(v, Tensor) else torch.as_tensor(np.asarray(v))).to(dev)
            for v in (batch["images"], batch["boxes"], batch["labels"], batch["valid"])
        )

    def _losses(self, batch: Dict[str, Any], reduction: str) -> Dict[str, Tensor]:
        net = self._model.net
        images, boxes, labels, valid = self._device_batch(batch)
        cls_levels, box_levels = net.module(images, return_levels=True)
        losses = retinanet_loss_levels(
            cls_levels, box_levels, net._anchors_for(tuple(images.shape[1:3])),
            boxes, labels, valid, num_classes=net.num_classes, reduction=reduction,
        )
        losses["loss"] = losses["classification_loss"] + losses["regression_loss"]
        return losses

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, Tensor]:
        """Forward (training mode), loss, backward and (at a window's end)
        the optimizer step on one batch; returns the losses, detached, on
        the device."""
        self._model.net.module.train()
        losses = self._losses(batch, "mean")
        losses["loss"].backward()
        if isinstance(self._optimizer, GradientAccumulation):
            self._optimizer.step()
        else:
            if self.gradient_clip_val:
                clip_grad_norm(self._model.net.module.parameters(), self.gradient_clip_val)
            self._optimizer.step()
            self._optimizer.zero_grad(set_to_none=True)
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any]) -> Dict[str, Tensor]:
        """Per-image [B] losses (eval mode), so that padding rows can be
        masked out."""
        self._model.net.module.eval()
        return self._losses(batch, "none")

    # ------------------------------------------------------------------ #
    # Checkpoints
    # ------------------------------------------------------------------ #
    def save_checkpoint(self, path: str, completed_epochs: Optional[int] = None) -> None:
        """Write ``<path>/checkpoint.pt``: the module's parameters and
        buffers, the optimizer's state, ``epoch`` (epochs completed: this
        one, unless an interrupt save passes the interrupted epoch so that
        the resume re-runs it), ``global_step``, the pre-warmup LR and the
        scheduler's versioned state. A temporary file is renamed into place,
        so an interrupted save leaves the previous checkpoint whole."""
        if self._model is None:
            return
        ckpt = {
            "module": self._model.net.module.state_dict(),
            "optimizer": self._optimizer.state_dict(),
            "epoch": self.current_epoch + 1 if completed_epochs is None else int(completed_epochs),
            "global_step": self.global_step,
            "sched_lr": float(self._sched_lr),
            "scheduler_state": self._scheduler.state_dict(),
        }
        os.makedirs(path, exist_ok=True)
        final = os.path.join(path, CHECKPOINT_FILE)
        torch.save(ckpt, final + ".tmp")
        os.replace(final + ".tmp", final)

    def restore_checkpoint(self, path: str) -> None:
        """Restore everything :meth:`save_checkpoint` wrote into the fitted
        model, optimizer and scheduler, onto the model's device."""
        ckpt = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location=self._model.net.device,
                          weights_only=True)
        self._model.net.module.load_state_dict(ckpt["module"])
        self._optimizer.load_state_dict(ckpt["optimizer"])
        self.current_epoch = int(ckpt["epoch"])
        self.global_step = int(ckpt["global_step"])
        self._sched_lr = float(ckpt["sched_lr"])
        self._scheduler.load_state_dict(ckpt["scheduler_state"])

    def _checkpoint_dirs(self) -> List[str]:
        return [c.dirpath for c in self.callbacks if isinstance(c, ModelCheckpoint)]

    def _latest_checkpoint(self) -> Optional[str]:
        """The newer (by mtime) of ``interrupt`` and ``last`` in the
        ModelCheckpoint directories; ``best`` is never a training frontier."""
        candidates = [os.path.join(d, name) for d in self._checkpoint_dirs()
                      for name in ("interrupt", "last")
                      if os.path.isfile(os.path.join(d, name, CHECKPOINT_FILE))]
        if not candidates:
            return None
        return max(candidates, key=lambda c: os.path.getmtime(os.path.join(c, CHECKPOINT_FILE)))

    # ------------------------------------------------------------------ #
    # Loops
    # ------------------------------------------------------------------ #
    def fit(self, model: RetinaNetModel) -> Dict[str, float]:
        """Train: ``max_epochs`` epochs or ``max_steps`` optimizer steps."""
        self._model = model
        if self.logger is not None and getattr(model, "hparams", None) is not None:
            self.logger.log_hyperparams(model.hparams)
        model.prepare_data()
        self._optimizer, self._scheduler, self._sched_meta = model.configure_optimizers()
        self._optimizer = self._wrap_optimizer(self._optimizer)
        for p in model.net.module.parameters():
            p.grad = None
        self._sched_lr = current_learning_rate(self._optimizer)
        # Schedulers whose t = 0 LR differs from the optimizer's (OneCycleLR,
        # LinearLR, LambdaLR) and momentum-cycling ones apply it up front, as
        # torch does at scheduler construction.
        init_lr = self._scheduler.initial_lr()
        if init_lr != self._sched_lr:
            self._sched_lr = init_lr
            set_learning_rate(self._optimizer, init_lr)
        init_m = self._scheduler.momentum_at(0)
        if init_m is not None:
            set_momentum(self._optimizer, init_m)
        resume_path = self.resume_from_checkpoint
        if not resume_path and self.auto_resume:
            resume_path = self._latest_checkpoint()
            if resume_path:
                logger.info("auto_resume: continuing from %s", resume_path)
        if resume_path:
            self.restore_checkpoint(resume_path)
        self.current_lr = current_learning_rate(self._optimizer)

        train_loader = model.train_dataloader()
        if self.overfit_batches and hasattr(train_loader, "shuffle"):
            train_loader.shuffle = False
        limit = self._resolve_limit(self.overfit_batches or self.limit_train_batches,
                                    len(train_loader))
        self._train_batch_limit = limit if limit < len(train_loader) else None
        epoch_batches = limit or len(train_loader)
        # Warmup is capped at a fifth of the planned optimizer steps so that
        # short runs reach the full LR; warmup_steps=0 disables it.
        steps_per_epoch = -(-max(epoch_batches, 1) // self.accumulate_grad_batches)
        total_steps = self.max_epochs * steps_per_epoch
        if self.max_steps:
            total_steps = min(total_steps, self.max_steps)
        total_steps = max(total_steps, 1)
        self._warmup_eff = (min(self.warmup_steps, max(total_steps // 5, 1))
                            if self.warmup_steps else 0)
        if len(train_loader) == 0:
            raise ValueError("train dataloader is empty")
        metrics: Dict[str, float] = {}
        if self.num_sanity_val_steps and not self.overfit_batches:
            self._sanity_check(model)
        installed = self._install_interrupt_handlers()
        try:
            self._fit_loop(model, train_loader, metrics)
        finally:
            for sig, prev in installed.items():
                signal.signal(sig, prev)
            # The trace of the steps before a failure is the one most wanted.
            self.profiler.close()
            model.net.module.eval()
        for cb in self.callbacks:
            cb.on_train_end(self)
        return metrics

    def _install_interrupt_handlers(self) -> Dict[Any, Any]:
        """SIGTERM / SIGINT set a flag the loop reads at the next step
        boundary; a second signal raises ``KeyboardInterrupt``. Returns the
        previous handlers; {} (nothing installed) when disabled, when no
        ModelCheckpoint gives the save a directory, or off the main thread
        (where ``signal.signal`` cannot be called)."""
        self._interrupted = False
        if (not self.save_on_interrupt or not self._checkpoint_dirs()
                or threading.current_thread() is not threading.main_thread()):
            return {}

        def on_signal(signum, frame):
            if self._interrupted:
                raise KeyboardInterrupt
            self._interrupted = True
            logger.warning("received %s: checkpointing at the next step boundary (signal "
                           "again to abort without saving)", signal.Signals(signum).name)

        return {sig: signal.signal(sig, on_signal) for sig in (signal.SIGTERM, signal.SIGINT)}

    def _save_interrupt_checkpoint(self) -> None:
        """Save ``<checkpoint_dir>/interrupt`` with the interrupted epoch not
        counted as completed: the resume re-runs it, with the schedule's
        counters carrying the partial progress."""
        path = os.path.join(self._checkpoint_dirs()[0], "interrupt")
        self.save_checkpoint(path, completed_epochs=self.current_epoch)
        logger.warning("interrupt checkpoint saved; resume with "
                       "Trainer(resume_from_checkpoint=%r).fit(model)", path)

    def _sanity_check(self, model: RetinaNetModel) -> None:
        """Run a few validation batches before training, outputs discarded,
        so that a broken validation path fails at once."""
        loader = model.val_dataloader()
        if loader is None:
            return
        n = self.num_sanity_val_steps
        if n < 0:
            n = len(loader)
        for i, batch in enumerate(loader):
            if i >= n:
                break
            self.eval_step(batch)

    def _log_step(self, step_metrics: Dict[str, Tensor], metrics: Dict[str, float]) -> None:
        host = {k: float(v) for k, v in step_metrics.items()}
        self._check_finite(host)
        self.logger_.update(**host)
        metrics.update({f"train_{k}": v for k, v in host.items()})

    def _fit_loop(self, model, train_loader, metrics) -> None:
        interval = self._sched_meta.get("interval", "epoch")
        frequency = self._sched_meta.get("frequency", 1)
        monitor = self._sched_meta.get("monitor")
        mem_logged = False
        for epoch in range(self.current_epoch, self.max_epochs):
            self.current_epoch = epoch
            step_metrics, logged = None, False
            for bi, batch in enumerate(self.logger_.log_every(train_loader, header=f"epoch {epoch}")):
                if self._train_batch_limit is not None and bi >= self._train_batch_limit:
                    break
                if self._interrupted:  # signalled while the loader fetched this batch
                    break
                self._apply_warmup()
                step_metrics = self.train_step(batch)
                self.global_step += 1
                self.profiler.step(self.global_step)
                # Metrics stay on the device between logged steps: reading
                # them is a host sync.
                logged = self.global_step % self.logger_.print_freq == 0
                if logged:
                    self._log_step(step_metrics, metrics)
                if (interval == "step" and self.global_step % self.accumulate_grad_batches == 0
                        and self._opt_step % frequency == 0):
                    self._step_scheduler(None)
                if self.max_steps and self._opt_step >= self.max_steps:
                    self.should_stop = True
                    break
                if self._interrupted:
                    break
            self._flush_accumulation(interval, frequency)
            if step_metrics is not None and not logged:
                self._log_step(step_metrics, metrics)
            if self._interrupted:
                # No validation, epoch scheduler step or epoch callbacks: the
                # epoch does not count as completed.
                self._save_interrupt_checkpoint()
                self.should_stop = True
                break

            if (epoch + 1) % self.val_check_interval == 0:
                metrics.update(self._run_validation(model))
            if interval == "epoch" and (epoch + 1) % frequency == 0:
                self._step_scheduler(metrics.get(monitor) if monitor else None)
            metrics["lr"] = self.current_lr
            if not mem_logged:
                mem_logged = True  # once per fit
                mem = device_memory_stats()
                if mem:
                    logger.info("device memory: %s", mem)
            for cb in self.callbacks:
                cb.on_epoch_end(self, metrics)
            if self.should_stop:
                break

    def _check_finite(self, metrics: Dict[str, float]) -> None:
        """Fail loudly on divergence instead of training on garbage."""
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
        if bad:
            raise FloatingPointError(
                f"non-finite training metrics at step {self.global_step}: {bad}. "
                "Typical causes: learning rate too high, warmup disabled "
                "(warmup_steps=0), or no gradient clipping; try "
                "Trainer(warmup_steps=500, gradient_clip_val=10.0) or a lower lr."
            )

    def _apply_warmup(self) -> None:
        """Linear LR warmup over the first `warmup_steps` optimizer steps."""
        lr = self._sched_lr * warmup_scale(self._opt_step, self._warmup_eff, self.warmup_factor)
        if lr != self.current_lr:
            set_learning_rate(self._optimizer, lr)
            self.current_lr = lr

    def _flush_accumulation(self, interval: str, frequency: int) -> None:
        """Step on a partial accumulation window at epoch end (the mean over
        the full window, zeros for the missing batches), count it, and give
        step-interval schedulers and max_steps their boundary tick."""
        if not isinstance(self._optimizer, GradientAccumulation):
            return
        mini = self._optimizer.mini_step
        if not self._optimizer.flush():
            return
        self.global_step += self.accumulate_grad_batches - mini
        if interval == "step" and self._opt_step % frequency == 0:
            self._step_scheduler(None)
        if self.max_steps and self._opt_step >= self.max_steps:
            self.should_stop = True

    def _step_scheduler(self, monitor_value: Optional[float]) -> None:
        self._sched_lr = self._scheduler.step(monitor_value)
        lr = self._sched_lr * warmup_scale(self._opt_step, self._warmup_eff, self.warmup_factor)
        set_learning_rate(self._optimizer, lr)
        m = self._scheduler.momentum_at(self._scheduler.t)
        if m is not None:
            set_momentum(self._optimizer, m)
        self.current_lr = lr

    def _run_validation(self, model: RetinaNetModel) -> Dict[str, float]:
        """Mean per-image validation losses over the val loader (or, under
        ``overfit_batches``, over the same train slice)."""
        if self.overfit_batches:
            loader = model.train_dataloader()
            if hasattr(loader, "shuffle"):
                loader.shuffle = False
            limit = self._resolve_limit(self.overfit_batches, len(loader))
        else:
            loader = model.val_dataloader()
            if loader is None:
                return {}
            limit = self._resolve_limit(self.limit_val_batches, len(loader))
        totals: Dict[str, float] = {}
        count = 0
        for bi, batch in enumerate(loader):
            if bi >= limit:
                break
            losses = self.eval_step(batch)
            mask = batch.get("batch_mask")
            mask = (np.ones(len(batch["images"]), bool) if mask is None
                    else np.asarray(torch.as_tensor(mask).cpu(), bool))
            for k, v in losses.items():
                totals[k] = totals.get(k, 0.0) + float(v.cpu().numpy()[mask].sum())
            count += int(mask.sum())
        if not count:
            return {}
        out = {f"val_{k}" if k != "loss" else "val_loss": v / count for k, v in totals.items()}
        logger.info("validation: %s", out)
        return out

    def validate(self, model: RetinaNetModel) -> Dict[str, float]:
        """Standalone validation pass."""
        self._model = model
        return self._run_validation(model)

    def test(self, model: RetinaNetModel):
        raise NotImplementedError("Trainer.test (COCO evaluation) is ROADMAP A8 (data and eval): "
                                  "not ported yet")

    def predict(self, model: RetinaNetModel, loader=None):
        raise NotImplementedError("Trainer.predict is ROADMAP A8 (data and eval, its "
                                  "DetectionLoader): not ported yet; use Retinanet.predict")

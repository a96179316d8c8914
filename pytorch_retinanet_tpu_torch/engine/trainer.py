"""Trainer: the fit loop, validation and the step functions, single process.

Counterpart of ``pytorch_retinanet_tpu/engine/trainer.py`` (a
``pytorch_lightning.Trainer`` 1.0 look-alike) with the same loop design and
knobs, and without its JAX mechanics (``jit``, donation, meshes): the state
is the module's parameters and the ``torch.optim`` state, updated in place.

A train step is the forward through the module's own stem (never the fused
stem, as the JAX trainer trains), the per-level loss (whose targets come
from the match kernel on CUDA), ``backward``, the global-norm clip when not
accumulating, and the optimizer step. Frozen batch norm only.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP item
when set: callbacks and checkpoints (``checkpoint_dir`` defaults to None
until checkpoints land), ``resume_from_checkpoint``, ``auto_resume``, the
interrupt handler (``save_on_interrupt``), ``profile_dir``, ``mesh`` /
``devices``, an experiment ``logger`` object, and ``Trainer.test`` /
``Trainer.predict``.
"""

from __future__ import annotations

import logging
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import retinanet_loss_levels
from ..utils.metrics import MetricLogger
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


class Trainer:
    """``Trainer(...).fit(model)`` and ``.validate(model)``.

    Accepts and ignores the torch-specific ``gpus`` and ``precision``: the
    device is the model's, and the compute dtype is the model's.
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
        save_on_interrupt: bool = False,
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
        # fast_dev_run=n: one epoch of n train and n val batches, no sanity
        # check and no checkpointing (Lightning 1.0 semantics).
        if fast_dev_run:
            max_epochs, max_steps = 1, None
            limit_train_batches = limit_val_batches = int(fast_dev_run)
            num_sanity_val_steps = 0
            checkpoint_dir = resume_from_checkpoint = None
            auto_resume = False
        later = [
            ("callbacks", callbacks, "A7 (callbacks and checkpoints)"),
            ("checkpoint_dir", checkpoint_dir, "A7 (checkpoints with torch.save)"),
            ("resume_from_checkpoint", resume_from_checkpoint, "A7 (resume)"),
            ("auto_resume", auto_resume, "A7 (resume)"),
            ("save_on_interrupt", save_on_interrupt, "A7 (the interrupt handler)"),
            ("profile_dir", profile_dir, "A7 (ProfilerHook)"),
            ("mesh", mesh, "A9 (distributed)"),
            ("devices", devices, "A9 (distributed)"),
            ("logger", None if isinstance(logger, bool) or logger is None else logger,
             "A7 (experiment loggers, TensorBoard)"),
        ]
        for name, value, item in later:
            if value:
                raise NotImplementedError(f"Trainer({name}=...) is ROADMAP {item}: not ported yet")
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
        """Forward, loss, backward and (at a window's end) the optimizer
        step on one batch; returns the losses, detached, on the device."""
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
        """Per-image [B] losses, so that padding rows can be masked out."""
        return self._losses(batch, "none")

    # ------------------------------------------------------------------ #
    # Loops
    # ------------------------------------------------------------------ #
    def fit(self, model: RetinaNetModel) -> Dict[str, float]:
        """Train: ``max_epochs`` epochs or ``max_steps`` optimizer steps."""
        if not model.net.freeze_bn:
            raise NotImplementedError(
                "training with freeze_bn=False (live batch statistics) is ROADMAP A7; "
                "build the model with freeze_bn=True"
            )
        self._model = model
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
        self._fit_loop(model, train_loader, metrics)
        return metrics

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
                self._apply_warmup()
                step_metrics = self.train_step(batch)
                self.global_step += 1
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
            self._flush_accumulation(interval, frequency)
            if step_metrics is not None and not logged:
                self._log_step(step_metrics, metrics)

            if (epoch + 1) % self.val_check_interval == 0:
                metrics.update(self._run_validation(model))
            if interval == "epoch" and (epoch + 1) % frequency == 0:
                self._step_scheduler(metrics.get(monitor) if monitor else None)
            metrics["lr"] = self.current_lr
            if not mem_logged and model.net.device.type == "cuda":
                mem_logged = True  # once per fit
                logger.info("device memory: peak %.1f MiB",
                            torch.cuda.max_memory_allocated(model.net.device) / 2**20)
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
        raise NotImplementedError("Trainer.test (COCO evaluation) is ROADMAP A7, with A8's evaluator")

    def predict(self, model: RetinaNetModel, loader=None):
        raise NotImplementedError("Trainer.predict is ROADMAP A7; use Retinanet.predict")

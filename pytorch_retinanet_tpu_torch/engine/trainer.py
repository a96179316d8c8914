"""Trainer: the fit loop, validation, checkpoints and the step functions.

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

``test`` predicts every test batch (``limit_test_batches`` of them) and
scores the detections with the model's COCO evaluator, returning
``[{"AP": stats[0]}]``; ``predict`` returns ``{image_id: {"boxes",
"scores", "labels"}}`` with boxes in each image's original coordinates.
Both run ``Retinanet._predict_impl`` on the uploaded batch (the fused stem
and the NMS kernel on CUDA) and drop the ``batch_mask`` padding rows.
Batches in pinned memory upload with ``non_blocking=True``.

Data parallel: in a process group (``parallel.init_distributed``, or
torchrun's), ``fit`` wraps the module in ``DistributedDataParallel`` over
the group (``mesh`` / ``devices``, as ``parallel.make_mesh`` takes them,
name each rank's device and must hold the model) and every loader is the
rank's shard (``shard=rank``, ``num_shards=world``; batch sizes are per
rank, as JAX's are per host). Live batch norm normalizes with the global
batch's statistics (``models/layers.py``), so buffers are not broadcast.
The micro-batches of an accumulation window but its last run under
``no_sync``. The logged step metrics go through ``reduce_dict``, so every
rank sees the same (finite or not) values; the interrupt flag and
``should_stop`` are agreed across ranks at each step boundary. Validation
totals and test detections merge through ``all_gather_objects``, and every
rank gets the same metrics and AP. Rank 0 alone writes checkpoints and
logs, and every rank waits for the save; every rank reads a resume.
``predict`` is not sharded: each rank predicts the whole loader, as in JAX.

Spatial training (a ``mesh`` from ``parallel.make_train_mesh(spatial=S)``,
frozen batch norm only, as in JAX): the ``S`` spatial ranks of one data
shard read the same loader shard (the data index's) and run the height-split
forward (``parallel/sharding.py::make_split_forward``), each its rows of
the trunk, then the FPN, head and loss in full. DDP averages every gradient
over all ranks; the trunk's, which are partial sums over the spatial ranks'
rows, are then multiplied by ``S`` (the FPN's and head's are equal on the
spatial ranks): the result is the spatial sum, averaged over the data
shards. Validation totals and test detections count the spatial index 0
of each data shard once.
"""

from __future__ import annotations

import contextlib
import inspect
import logging
import os
import signal
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..ops import retinanet_loss_levels
from ..parallel import (
    MeshPlan,
    all_gather_objects,
    any_rank,
    average_gradients,
    get_rank,
    get_world_size,
    is_main_process,
    make_mesh,
    reduce_dict,
)
from ..ops.boxes import rescale_boxes
from ..parallel.sharding import make_split_forward
from ..utils.metrics import MetricLogger, ProfilerHook, count_syncs, device_memory_stats, span
from .callbacks import Callback, ModelCheckpoint, _ExperimentLogger
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

# DDP's switch for the buffer broadcast before each forward: renamed
# ``forward_sync_buffers`` in newer torch.
_NO_BUFFER_SYNC = ({"forward_sync_buffers": False}
                   if "forward_sync_buffers" in inspect.signature(DistributedDataParallel).parameters
                   else {"broadcast_buffers": False})


class Trainer:
    """``Trainer(...).fit(model)`` and ``.validate(model)``.

    Accepts and ignores the torch-specific ``gpus`` and ``precision``: the
    device is the model's, and the compute dtype is the model's. ``logger``
    takes an experiment logger callback (``CSVLogger``,
    ``TensorBoardLogger``); True, False and None mean none. ``mesh`` (a
    ``parallel.MeshPlan``) or ``devices`` (one per rank, for
    ``parallel.make_mesh``) name this rank's device, which must be the
    model's; without either, a process group's run uses the model's device.
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
        limit_test_batches: Any = 1.0,
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
        self.mesh: Optional[MeshPlan] = mesh if mesh is not None else (
            make_mesh(devices) if devices else None)
        # fast_dev_run=n: one epoch of n train, n val and n test batches, no
        # sanity check, no checkpointing and no experiment logger (Lightning 1.0).
        if fast_dev_run:
            max_epochs, max_steps = 1, None
            limit_train_batches = limit_val_batches = limit_test_batches = int(fast_dev_run)
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
        self.limit_test_batches = limit_test_batches
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
        self._ddp: Optional[DistributedDataParallel] = None
        self._split = None
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
    def _upload(self, batch: Dict[str, Any], *keys: str) -> Tuple[Tensor, ...]:
        """The batch's `keys` on the model's device; a pinned tensor uploads
        with ``non_blocking=True``; any other host tensor waits for a CUDA
        device (``host_syncs``)."""
        dev = self._model.net.device
        out = []
        for k in keys:
            v = batch[k]
            v = v if isinstance(v, Tensor) else torch.as_tensor(np.asarray(v))
            pinned = v.is_pinned()
            if v.device.type == "cpu" and not pinned:
                count_syncs(dev)
            out.append(v.to(dev, non_blocking=pinned))
        return tuple(out)

    def _device_batch(self, batch: Dict[str, Any]) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        return self._upload(batch, "images", "boxes", "labels", "valid")

    @property
    def _spatial(self) -> int:
        return self.mesh.spatial_size if self.mesh is not None else 1

    def _detector(self):
        """The module, or on a spatial mesh its height-split forward (made
        once for the module)."""
        module = self._model.net.module
        if self._spatial == 1:
            return module
        if self._split is None or self._split.module is not module:
            self._split = make_split_forward(module, self.mesh)
        return self._split

    def _counted(self) -> bool:
        """Whether this rank's validation totals and detections count: the
        spatial index 0 of each data shard (the others hold the same)."""
        return self._spatial == 1 or self.mesh.axis_index("spatial") == 0

    def _losses(self, batch: Dict[str, Any], reduction: str, forward=None,
                stage: str = "eval") -> Dict[str, Tensor]:
        """The batch's losses through `forward` (:meth:`_detector`, or its
        DDP wrapper, whose forward arms the gradient all-reduce), in the
        spans ``<stage>.upload``, ``<stage>.forward`` and ``<stage>.loss``."""
        net = self._model.net
        dev = net.device
        with span(stage + ".upload"):
            images, boxes, labels, valid = self._device_batch(batch)
        with span(stage + ".forward", dev):
            cls_levels, box_levels = (forward or self._detector())(images, return_levels=True)
        with span(stage + ".loss", dev):
            losses = retinanet_loss_levels(
                cls_levels, box_levels, net._anchors_for(tuple(images.shape[1:3])),
                boxes, labels, valid, num_classes=net.num_classes, reduction=reduction,
            )
            losses["loss"] = losses["classification_loss"] + losses["regression_loss"]
        return losses

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, Tensor]:
        """Forward (training mode), loss, backward and (at a window's end)
        the optimizer step on one batch; returns the losses, detached, on
        the device. Under DDP, a micro-batch that does not close its
        accumulation window runs under ``no_sync``. Traced: ``train.step``
        over ``train.upload``, ``train.forward``, ``train.loss``,
        ``train.backward`` (under DDP it includes the all-reduce's finish)
        and ``train.optimizer``."""
        dev = self._model.net.device
        with span("train.step", dev):
            self._model.net.module.train()
            opt = self._optimizer
            sync = not (self._ddp is not None and isinstance(opt, GradientAccumulation)
                        and opt.mini_step + 1 < opt.every)
            with contextlib.nullcontext() if sync else self._ddp.no_sync():
                losses = self._losses(batch, "mean", self._ddp, stage="train")
                with span("train.backward", dev):
                    losses["loss"].backward()
            with span("train.optimizer", dev):
                if sync:
                    self._sum_trunk_over_spatial()
                if isinstance(self._optimizer, GradientAccumulation):
                    self._optimizer.step()
                else:
                    if self.gradient_clip_val:
                        clip_grad_norm(self._model.net.module.parameters(), self.gradient_clip_val)
                    self._optimizer.step()
                    self._optimizer.zero_grad(set_to_none=True)
            return {k: v.detach() for k, v in losses.items()}

    def _sum_trunk_over_spatial(self) -> None:
        """After DDP's average over every rank, the trunk's gradients times
        the spatial size: their spatial sum, averaged over the data shards."""
        if self._spatial > 1 and self._ddp is not None:
            for p in self._model.net.module.backbone.parameters():
                if p.grad is not None:
                    p.grad.mul_(self._spatial)

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
        so an interrupted save leaves the previous checkpoint whole. In a
        process group every rank calls it: rank 0 writes, and all wait for
        the write."""
        if self._model is None:
            return
        if is_main_process():
            self._write_checkpoint(path, completed_epochs)
        if get_world_size() > 1:
            dist.barrier()

    def _write_checkpoint(self, path: str, completed_epochs: Optional[int]) -> None:
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
    def _data_parallel(self, model: RetinaNetModel) -> Optional[MeshPlan]:
        """This rank's plan when a process group is up (None without one),
        checked against the device the model's parameters are on."""
        plan = self.mesh
        if plan is None and dist.is_initialized():
            plan = make_mesh([model.net.device] * get_world_size())
        if plan is None:
            return None
        held = next(model.net.module.parameters()).device
        if held != plan.device:
            raise ValueError(f"Trainer: this rank's device is {plan.device}, the model's "
                             f"parameters are on {held}; build the model on the rank's device")
        return plan if plan.group is not None else None

    def _shard(self) -> Dict[str, int]:
        """This rank's loader shard: its data index (the spatial ranks of a
        data shard read the same images and augmentation draws)."""
        if self.mesh is None:
            return {"shard": get_rank(), "num_shards": get_world_size()}
        return {"shard": self.mesh.axis_index("data"), "num_shards": self.mesh.data_size}

    def fit(self, model: RetinaNetModel) -> Dict[str, float]:
        """Train: ``max_epochs`` epochs or ``max_steps`` optimizer steps."""
        self._model = model
        if self._spatial > 1 and not model.net.freeze_bn:
            # validate / test / predict run on the running statistics and
            # work on any mesh; only training would need the batch
            # statistics reduced across the spatial ranks.
            raise ValueError(
                "spatial-parallel training requires freeze_bn=True (the "
                "default, and the reference's): live batch statistics would "
                "need axis-aware cross-shard reduction. Build the model with "
                "freeze_bn=True or use a data-only mesh.")
        plan = self._data_parallel(model)
        if (self.logger in self._rank_callbacks()
                and getattr(model, "hparams", None) is not None):
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
        if plan is not None:
            # Live BN reduces its statistics over the group and frozen BN's
            # buffers are constant: nothing to broadcast before a forward.
            dev = plan.device
            self._ddp = DistributedDataParallel(
                self._detector(), device_ids=[dev.index] if dev.type == "cuda" else None,
                process_group=plan.group, **_NO_BUFFER_SYNC)

        train_loader = model.train_dataloader(**self._shard())
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
            self._ddp = None
            for sig, prev in installed.items():
                signal.signal(sig, prev)
            # The trace of the steps before a failure is the one most wanted.
            self.profiler.close()
            model.net.module.eval()
        for cb in self._rank_callbacks():
            cb.on_train_end(self)
        return metrics

    def _rank_callbacks(self) -> List[Callback]:
        """The callbacks this rank runs: all of them on rank 0, all but the
        experiment loggers (which write files) on the others."""
        if is_main_process():
            return self.callbacks
        return [c for c in self.callbacks if not isinstance(c, _ExperimentLogger)]

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
        loader = model.val_dataloader(**self._shard())
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
        count_syncs(self._model.net.device, len(step_metrics))  # each metric read to the host
        host = reduce_dict(step_metrics)
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
            for bi, batch in enumerate(self.logger_.log_every(train_loader, header=f"epoch {epoch}",
                                                              fetch_span="train.fetch")):
                if self._train_batch_limit is not None and bi >= self._train_batch_limit:
                    break
                if self._agree_to_stop():  # signalled while the loader fetched this batch
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
                if self._interrupted and self._ddp is None:
                    break
            self._agree_to_stop()
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
            for cb in self._rank_callbacks():
                cb.on_epoch_end(self, metrics)
            self._agree_to_stop()
            if self.should_stop:
                break

    def _agree_to_stop(self) -> bool:
        """The interrupt flag (returned) and ``should_stop``, each true on
        every rank when it is true on any: a rank that left the loop alone
        would leave the others waiting in DDP's next all-reduce."""
        if self._ddp is not None:
            self._interrupted, self.should_stop = any_rank(
                [self._interrupted, self.should_stop])
        return self._interrupted

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
        if self._ddp is not None and self._optimizer.mini_step:
            # A partial window's micro-batches all ran under no_sync.
            average_gradients(self._model.net.module.parameters(), self._ddp.process_group)
            self._sum_trunk_over_spatial()
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
        ``overfit_batches``, over the same train slice); each rank sums its
        shard, and the (totals, count) pairs merge across ranks."""
        if self.overfit_batches:
            loader = model.train_dataloader(**self._shard())
            if hasattr(loader, "shuffle"):
                loader.shuffle = False
            limit = self._resolve_limit(self.overfit_batches, len(loader))
        else:
            loader = model.val_dataloader(**self._shard())
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
        shards = all_gather_objects((totals, count) if self._counted() else ({}, 0))
        keys = dict.fromkeys(k for t, _ in shards for k in t)
        totals = {k: sum(t.get(k, 0.0) for t, _ in shards) for k in keys}
        count = sum(c for _, c in shards)
        if not count:
            return {}
        out = {f"val_{k}" if k != "loss" else "val_loss": v / count for k, v in totals.items()}
        logger.info("validation: %s", out)
        return out

    def validate(self, model: RetinaNetModel) -> Dict[str, float]:
        """Standalone validation pass."""
        self._model = model
        return self._run_validation(model)

    def _ensure_data(self, model: RetinaNetModel) -> None:
        """Bind `model` and build its datasets unless it has some already."""
        self._model = model
        if getattr(model, "trn_ds", None) is None and getattr(model, "test_ds", None) is None:
            model.prepare_data()

    @torch.inference_mode()
    def _predict_batch(self, batch: Dict[str, Any]) -> Dict[int, Dict[str, np.ndarray]]:
        """Detections of one loader batch, boxes rescaled to each image's
        original size, keyed by image id; padding rows are dropped."""
        net = self._model.net
        images, sizes, orig = self._upload(batch, "images", "image_sizes", "orig_sizes")
        if self._spatial == 1:
            det = net._predict_impl(images, sizes)
        else:
            det = net._predict_impl(images, sizes, forward=self._detector())
        boxes = rescale_boxes(det.boxes, sizes[:, None, :], orig[:, None, :])
        count_syncs(det.boxes.device, len(det))
        boxes, scores, labels, valid = (t.cpu().numpy() for t in (boxes, *det[1:]))
        ids = np.asarray(torch.as_tensor(batch["image_ids"]))
        mask = batch.get("batch_mask")
        mask = np.ones(len(ids), bool) if mask is None else np.asarray(torch.as_tensor(mask))
        out = {}
        for i, image_id in enumerate(ids):
            if not mask[i]:
                continue
            n = int(valid[i].sum())
            out[int(image_id)] = {"boxes": boxes[i, :n], "scores": scores[i, :n],
                                  "labels": labels[i, :n]}
        return out

    def test(self, model: RetinaNetModel) -> List[Dict[str, float]]:
        """COCO evaluation of the test set (reference test_step /
        test_epoch_end, model.py:132-146): ``[{"AP": stats[0]}]``. Each rank
        predicts its shard; the detections merge before scoring."""
        self._ensure_data(model)
        evaluator = model.test_evaluator()
        loader = model.test_dataloader(**self._shard())
        limit = self._resolve_limit(self.limit_test_batches, len(loader))
        for bi, batch in enumerate(self.logger_.log_every(loader, header="test")):
            if bi >= limit:
                break
            detections = self._predict_batch(batch)
            if self._counted():
                evaluator.update(detections)
        evaluator.synchronize_between_processes(all_gather_objects)
        evaluator.accumulate()
        stats = evaluator.summarize()
        results = {"AP": float(stats["bbox"][0])}
        logger.info("test results: %s", results)
        return [results]

    def predict(self, model: RetinaNetModel, loader=None) -> Dict[int, Dict[str, np.ndarray]]:
        """Detections over `loader` (the test loader by default):
        ``{image_id: {"boxes", "scores", "labels"}}``, boxes in each image's
        original coordinates."""
        self._ensure_data(model)
        if loader is None:
            loader = model.test_dataloader()
        out: Dict[int, Dict[str, np.ndarray]] = {}
        for batch in loader:
            out.update(self._predict_batch(batch))
        return out

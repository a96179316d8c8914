"""Trainer callbacks: checkpoints, early stopping, the LR monitor and the loggers.

Counterpart of ``pytorch_retinanet_tpu/engine/callbacks.py``, with the
knobs of the pytorch-lightning 1.0 callbacks the reference uses. The
Trainer calls ``on_epoch_end(trainer, metrics)`` after each completed epoch
(validation and the epoch's scheduler step included) and ``on_train_end``
once ``fit`` ends. An experiment logger (``CSVLogger``,
``TensorBoardLogger``) is passed as ``Trainer(logger=...)``.
"""

from __future__ import annotations

import csv
import logging
import math
import os
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class Callback:
    """Hook surface the Trainer drives."""

    def on_epoch_end(self, trainer, metrics: Dict[str, float]) -> None: ...
    def on_train_end(self, trainer) -> None: ...


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving for ``patience`` epochs
    (by more than ``min_delta``, in ``mode`` min or max)."""

    def __init__(self, monitor: str = "val_loss", patience: int = 3, mode: str = "min",
                 min_delta: float = 0.0):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_epoch_end(self, trainer, metrics: Dict[str, float]) -> None:
        value = metrics.get(self.monitor)
        if value is None or math.isnan(value):
            return
        if self._improved(value):
            self.best = value
            self.bad_epochs = 0
            return
        self.bad_epochs += 1
        if self.bad_epochs >= self.patience:
            logger.info("EarlyStopping: %s did not improve for %d epochs (best %.5f)",
                        self.monitor, self.patience, self.best)
            trainer.should_stop = True


class ModelCheckpoint(Callback):
    """Save ``<dirpath>/last`` after every epoch and ``<dirpath>/best`` when
    the monitored metric improves."""

    def __init__(self, dirpath: str = "checkpoints", monitor: Optional[str] = "val_loss",
                 mode: str = "min", save_last: bool = True):
        self.dirpath = dirpath
        self.monitor = monitor
        self.mode = mode
        self.save_last = save_last
        self.best: Optional[float] = None
        self.best_path: Optional[str] = None

    def on_epoch_end(self, trainer, metrics: Dict[str, float]) -> None:
        os.makedirs(self.dirpath, exist_ok=True)
        if self.save_last:
            trainer.save_checkpoint(os.path.join(self.dirpath, "last"))
        value = metrics.get(self.monitor) if self.monitor else None
        if value is None:
            return
        if (self.best is None or (self.mode == "min" and value < self.best)
                or (self.mode == "max" and value > self.best)):
            self.best = value
            self.best_path = os.path.join(self.dirpath, "best")
            trainer.save_checkpoint(self.best_path)
            logger.info("ModelCheckpoint: new best %s=%.5f", self.monitor, value)


class LearningRateMonitor(Callback):
    """Put the current LR into the epoch's metrics, and log it."""

    def on_epoch_end(self, trainer, metrics: Dict[str, float]) -> None:
        metrics["lr"] = trainer.current_lr
        logger.info("lr: %.6g", trainer.current_lr)


class _ExperimentLogger(Callback):
    """``<save_dir>/<name>/version_<k>/``, with ``k`` one past the largest
    existing version unless pinned, and ``hparams.yaml`` in it."""

    def __init__(self, save_dir: str = "logs", name: str = "default",
                 version: Optional[int] = None):
        self.save_dir = save_dir
        self.name = name
        self._version = version
        self._log_dir: Optional[str] = None

    @property
    def log_dir(self) -> str:
        if self._log_dir is None:
            base = os.path.join(self.save_dir, self.name)
            if self._version is None:
                existing = [int(d[8:]) for d in (os.listdir(base) if os.path.isdir(base) else [])
                            if d.startswith("version_") and d[8:].isdigit()]
                self._version = max(existing) + 1 if existing else 0
            self._log_dir = os.path.join(base, f"version_{self._version}")
            os.makedirs(self._log_dir, exist_ok=True)
        return self._log_dir

    def log_hyperparams(self, hparams) -> None:
        """Write the model's config as ``hparams.yaml`` (PyYAML not needed)."""
        from ..config import OmegaConf

        try:
            text = OmegaConf.to_yaml(hparams)
        except Exception:
            text = repr(hparams)
        with open(os.path.join(self.log_dir, "hparams.yaml"), "w") as f:
            f.write(text)


class TensorBoardLogger(_ExperimentLogger):
    """Scalars into an ``events.out.tfevents.*`` file (:mod:`.tb`), once per
    epoch at the trainer's ``global_step``; NaN values are dropped."""

    def __init__(self, save_dir: str = "logs", name: str = "default",
                 version: Optional[int] = None):
        super().__init__(save_dir, name, version)
        self._writer = None

    @property
    def writer(self):
        if self._writer is None:
            from .tb import EventFileWriter

            self._writer = EventFileWriter(self.log_dir)
        return self._writer

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        finite = {k: float(v) for k, v in metrics.items()
                  if isinstance(v, (int, float)) and not math.isnan(float(v))}
        self.writer.add_scalars(finite, step)

    def on_epoch_end(self, trainer, metrics: Dict[str, float]) -> None:
        self.log_metrics({"epoch": trainer.current_epoch, **metrics}, trainer.global_step)

    def on_train_end(self, trainer) -> None:
        if self._writer is not None:
            self._writer.close()


class CSVLogger(_ExperimentLogger):
    """``metrics.csv``: one row per epoch (``epoch``, ``step`` and the
    metrics), its columns the union of every key seen, rewritten whole each
    epoch so that an interrupted run keeps every row."""

    def __init__(self, save_dir: str = "logs", name: str = "default",
                 version: Optional[int] = None):
        super().__init__(save_dir, name, version)
        self._rows: List[dict] = []

    def _write(self) -> None:
        keys: List[str] = []
        for row in self._rows:
            keys += [k for k in row if k not in keys]
        with open(os.path.join(self.log_dir, "metrics.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self._rows)

    def on_epoch_end(self, trainer, metrics: Dict[str, float]) -> None:
        self._rows.append({"epoch": trainer.current_epoch, "step": trainer.global_step, **metrics})
        self._write()

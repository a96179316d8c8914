"""RetinaNetModel: the config-driven task module the Trainer consumes.

Counterpart of ``pytorch_retinanet_tpu/engine/model.py`` (the reference's
LightningModule): it builds the detector from ``hparams.model`` and the
optimizer and scheduler from ``hparams.optimizer`` / ``hparams.scheduler``.
The datasets of ``dataset.kind`` coco, pascal and csv are ROADMAP A8 and not
ported yet: until then a caller subclasses the model and serves its own
batches from ``train_dataloader`` (and ``val_dataloader``).

A batch is a dict of ``images [B, H, W, 3]`` (uint8, or f32 in [0, 1]),
``boxes [B, N, 4]``, ``labels [B, N]`` and ``valid [B, N]``, tensors or
numpy, plus an optional ``batch_mask [B]`` for validation batches with
padding rows. A loader is any iterable of batches with a ``len``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..config import ConfigDict
from ..models.retinanet import Retinanet
from .optim import LRScheduler, build_optimizer, build_scheduler

_DATA_TODO = ("dataset.kind {kind!r} is not ported yet (ROADMAP A8, data and eval): subclass "
              "RetinaNetModel and serve batches from train_dataloader / val_dataloader")


class RetinaNetModel:
    """Config-driven detection task over the port's ``Retinanet``.

    ``device`` goes to the detector (CUDA when it is None).
    """

    def __init__(self, hparams: ConfigDict, device: Optional[str | torch.device] = None):
        self.hparams = hparams if isinstance(hparams, ConfigDict) else ConfigDict(hparams)
        model_conf = dict(self.hparams.model or {})
        if device is not None:
            model_conf["device"] = device
        self.net = Retinanet(**model_conf)

    # ------------------------------------------------------------------ #
    # Data: ROADMAP A8
    # ------------------------------------------------------------------ #
    def _kind(self) -> Any:
        kind = (self.hparams.dataset or {}).get("kind")
        if not kind:
            raise ValueError("hparams.dataset.kind must be one of coco/pascal/csv")
        if kind not in ("coco", "pascal", "csv"):
            raise ValueError(f"unknown dataset.kind {kind!r}")
        return kind

    def prepare_data(self) -> None:
        raise NotImplementedError(_DATA_TODO.format(kind=self._kind()))

    def train_dataloader(self, shard: int = 0, num_shards: int = 1):
        raise NotImplementedError(_DATA_TODO.format(kind=self._kind()))

    def val_dataloader(self, shard: int = 0, num_shards: int = 1):
        raise NotImplementedError(_DATA_TODO.format(kind=self._kind()))

    def test_dataloader(self, shard: int = 0, num_shards: int = 1):
        raise NotImplementedError(_DATA_TODO.format(kind=self._kind()))

    # ------------------------------------------------------------------ #
    # Optimization
    # ------------------------------------------------------------------ #
    def configure_optimizers(self) -> Tuple[torch.optim.Optimizer, LRScheduler, Dict[str, Any]]:
        opt_conf = self.hparams.optimizer or ConfigDict(
            {"class_name": "torch.optim.SGD", "params": {"lr": 1e-3}})
        optimizer = build_optimizer(
            opt_conf.class_name,
            self.net.module.parameters(),
            opt_conf.get("params"),
            flatten=bool(opt_conf.get("flatten") or False),
        )
        sched_conf = self.hparams.scheduler or ConfigDict({})
        base_lr = float((opt_conf.get("params") or {}).get("lr", 1e-3))
        scheduler = build_scheduler(sched_conf.get("class_name"), base_lr, sched_conf.get("params"))
        sched_meta = {
            "interval": sched_conf.get("interval") or "epoch",
            "frequency": int(sched_conf.get("frequency") or 1),
            "monitor": sched_conf.get("monitor") or None,
        }
        return optimizer, scheduler, sched_meta

"""RetinaNetModel: the config-driven task module the Trainer consumes.

Counterpart of ``pytorch_retinanet_tpu/engine/model.py`` (the reference's
LightningModule): it builds the detector from ``hparams.model``, the
datasets of ``dataset.kind`` coco, pascal or csv (``prepare_data``), their
``DetectionLoader``s (with JAX's batch sizes, shuffle and ``drop_last``),
the COCO evaluator of the test set, and the optimizer and scheduler from
``hparams.optimizer`` / ``hparams.scheduler``.

A batch is a dict of ``images [B, H, W, 3]`` (uint8, or f32 in [0, 1]),
``boxes [B, N, 4]``, ``labels [B, N]`` and ``valid [B, N]``, tensors or
numpy, plus ``batch_mask [B]`` (and, from the ``DetectionLoader``,
``image_sizes``, ``orig_sizes`` and ``image_ids``). A subclass may serve
its own batches from ``train_dataloader`` / ``val_dataloader``: a loader is
any iterable of batches with a ``len``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ConfigDict
from ..data.coco import get_coco, get_coco_api_from_dataset
from ..data.loader import DetectionLoader
from ..data.pascal import PascalDataset, get_pascal
from ..data.transforms import build_transforms
from ..eval.coco_eval import CocoEvaluator
from ..models.retinanet import Retinanet
from .optim import LRScheduler, build_optimizer, build_scheduler


def _given(path: Any) -> bool:
    """Whether a ``valid_paths`` / ``test_paths`` entry names a dataset:
    None and False (the reference demo's "no validation") do not. An
    identity check, since a DataFrame has no truth value."""
    return path is not None and path is not False


class RetinaNetModel:
    """Config-driven detection task over the port's ``Retinanet``.

    ``device`` goes to the detector (CUDA when it is None); the loaders
    pin their batches when it is CUDA.
    """

    def __init__(self, hparams: ConfigDict, device: Optional[str | torch.device] = None):
        self.hparams = hparams if isinstance(hparams, ConfigDict) else ConfigDict(hparams)
        model_conf = dict(self.hparams.model or {})
        if device is not None:
            model_conf["device"] = device
        self.net = Retinanet(**model_conf)
        self.trn_ds = None
        self.val_ds = None
        self.test_ds = None

    # ------------------------------------------------------------------ #
    # Data (reference model.py:37-74)
    # ------------------------------------------------------------------ #
    def prepare_data(self) -> None:
        """Build the train, validation and test datasets of ``dataset.kind``.

        The train chain keeps uint8 images when every transform in it is
        byte-exact (``build_transforms(keep_bytes=True)``: the default
        HorizontalFlip), so its loader ships the uint8 wire; validation and
        test chains convert to f32.
        """
        conf = self.hparams
        kind = (conf.dataset or {}).get("kind")
        if not kind:
            raise ValueError("hparams.dataset.kind must be one of coco/pascal/csv")
        if kind not in ("coco", "pascal", "csv"):
            raise ValueError(f"unknown dataset.kind {kind!r}")
        trn_tfms = build_transforms(conf.transforms, keep_bytes=True)
        ds = conf.dataset
        if kind == "coco":
            self.trn_ds = get_coco(ds.root_dir, "train", trn_tfms)
            self.val_ds = get_coco(ds.root_dir, "val", build_transforms(None))
            self.test_ds = self.val_ds
        elif kind == "pascal":
            # (annotation_dir, image_dir) pairs (reference model.py:54-61).
            trn = list(ds.trn_paths)
            self.trn_ds, _ = get_pascal(trn[0], trn[1], "train", trn_tfms)
            self.val_ds = (get_pascal(*list(ds.valid_paths)[:2], "valid", build_transforms(None))[0]
                           if _given(ds.valid_paths) else None)
            self.test_ds = (get_pascal(*list(ds.test_paths)[:2], "test", build_transforms(None))[0]
                            if _given(ds.test_paths) else None)
        else:
            self.trn_ds = PascalDataset(ds.trn_paths, trn_tfms)
            self.val_ds = (PascalDataset(ds.valid_paths, build_transforms(None))
                           if _given(ds.valid_paths) else None)
            self.test_ds = (PascalDataset(ds.test_paths, build_transforms(None))
                            if _given(ds.test_paths) else None)

    def _loader_args(self) -> Dict[str, Any]:
        """The loaders' sizes, workers, prefetch, wire dtype
        (``dataloader.args.image_dtype``, "auto" by default: the wire
        follows the transform chain) and pinning (when the detector is on
        CUDA)."""
        args = dict((self.hparams.dataloader or {}).get("args") or {})
        dtype = str(args.get("image_dtype") or "auto")
        return {
            "min_size": self.net.min_size,
            "max_size": self.net.max_size,
            "num_workers": int(args.get("num_workers", 4) or 4),
            "prefetch": int(args.get("prefetch", 2) or 2),
            "image_dtype": dtype if dtype == "auto" else np.dtype(dtype),
            "pin_memory": self.net.device.type == "cuda",
        }

    def train_dataloader(self, shard: int = 0, num_shards: int = 1) -> DetectionLoader:
        if self.trn_ds is None:
            self.prepare_data()
        return DetectionLoader(self.trn_ds, int(self.hparams.dataloader.train_bs), shuffle=True,
                               drop_last=True, shard=shard, num_shards=num_shards,
                               **self._loader_args())

    def val_dataloader(self, shard: int = 0, num_shards: int = 1) -> Optional[DetectionLoader]:
        if self.trn_ds is None:
            self.prepare_data()
        if self.val_ds is None:  # optional (reference model.py:100-103)
            return None
        return DetectionLoader(self.val_ds, int(self.hparams.dataloader.valid_bs), shard=shard,
                               num_shards=num_shards, **self._loader_args())

    def _test_ds(self):
        if self.test_ds is None:
            self.prepare_data()
        if self.test_ds is None:
            raise ValueError("no test dataset: set dataset.test_paths (csv/pascal kinds) before "
                             "calling test(), predict() or test_dataloader()")
        return self.test_ds

    def test_dataloader(self, shard: int = 0, num_shards: int = 1) -> DetectionLoader:
        return DetectionLoader(self._test_ds(), int(self.hparams.dataloader.test_bs), shard=shard,
                               num_shards=num_shards, **self._loader_args())

    def test_evaluator(self, iou_types=("bbox",)) -> CocoEvaluator:
        """A ``CocoEvaluator`` over the test dataset's COCO ground truth
        (reference model.py:105-110); ``iou_types`` within bbox, segm and
        keypoints (the Trainer scores bbox)."""
        return CocoEvaluator(get_coco_api_from_dataset(self._test_ds()), list(iou_types))

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

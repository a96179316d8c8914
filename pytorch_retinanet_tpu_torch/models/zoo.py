"""Pretrained backbone weights: where a torchvision ResNet ``.pth`` is found.

Counterpart of ``pytorch_retinanet_tpu/models/zoo.py`` with its lookup
order (an explicit path, then ``RETINANET_TPU_WEIGHTS_DIR`` or the cache
directory) and without its download step: nothing is fetched. The file
names are those of the torchvision model zoo, which the reference detector
downloads at construction.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

# The torchvision model zoo's file per architecture.
MODEL_URLS = {
    "resnet18": "https://download.pytorch.org/models/resnet18-5c106cde.pth",
    "resnet34": "https://download.pytorch.org/models/resnet34-333f7ec4.pth",
    "resnet50": "https://download.pytorch.org/models/resnet50-19c8e357.pth",
    "resnet101": "https://download.pytorch.org/models/resnet101-5d3b4d8f.pth",
    "resnet152": "https://download.pytorch.org/models/resnet152-b121ed2d.pth",
}


def cache_dir() -> str:
    return os.environ.get(
        "RETINANET_TPU_WEIGHTS_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "pytorch_retinanet_tpu"),
    )


def cached_weight_path(kind: str) -> str:
    return os.path.join(cache_dir(), os.path.basename(MODEL_URLS[kind]))


def fetch_backbone_weights(kind: str, path: Optional[str] = None) -> Optional[str]:
    """A local ``.pth`` for `kind`: `path` when it exists, else the weights
    directory's copy; None, with a warning, when neither exists (the caller
    keeps its random init)."""
    if path and os.path.exists(path):
        return path
    cached = cached_weight_path(kind)
    if os.path.exists(cached):
        return cached
    warnings.warn(
        f"no local {kind} checkpoint at {path!r} or {cached!r}; using random init. Pass "
        "pretrained_path= a torchvision ResNet .pth, or place it in RETINANET_TPU_WEIGHTS_DIR.",
        stacklevel=3,
    )
    return None

"""Host-side utilities of the port: telemetry and tracing, FLOPs, drawing, and the reference's helpers.

Counterpart of ``pytorch_retinanet_tpu/utils/__init__.py`` (``load_obj``,
``collate_fn``, ``seed_everything``, the box drawing of ``visualize``). Its ``enable_compilation_cache`` is
JAX's persistent XLA cache and has no counterpart here: the port's kernels
are cached by ``kernels/build.py`` under ``build/``, keyed on their source.
"""

from __future__ import annotations

import importlib
import os
import random

import numpy as np
import torch

from .metrics import (
    MetricLogger,
    ProfilerHook,
    SmoothedValue,
    count,
    count_syncs,
    device_memory_stats,
    drain,
    set_tracing,
    span,
    tracing,
)
from .visualize import (
    STANDARD_COLORS,
    draw_bounding_box_on_image,
    visualize_boxes_and_labels_on_image_array,
)


def load_obj(obj_path: str, default_obj_path: str = "") -> object:
    """Dotted-path object import (the reference's ``load_obj``).

    Names in the transform, optimizer and scheduler registries resolve to
    the port's classes and constructors first, so reference config names
    (``albumentations.*``, ``torch.optim.*``) keep working.
    """
    from ..data.transforms import TRANSFORM_REGISTRY
    from ..engine.optim import OPTIMIZER_REGISTRY, SCHEDULER_REGISTRY

    for registry in (TRANSFORM_REGISTRY, OPTIMIZER_REGISTRY, SCHEDULER_REGISTRY):
        if obj_path in registry:
            return registry[obj_path]
    parts = obj_path.rsplit(".", 1)
    module_path = parts.pop(0) if len(parts) > 1 else default_obj_path
    obj_name = parts[0]
    module = importlib.import_module(module_path)
    if not hasattr(module, obj_name):
        raise AttributeError(f"Object `{obj_name}` cannot be loaded from `{module_path}`.")
    return getattr(module, obj_name)


def collate_fn(batch):
    """Ragged tuple collate (the reference's ``collate_fn``)."""
    return tuple(zip(*batch))


def seed_everything(seed: int) -> int:
    """Seed Python's ``random``, numpy, torch (every CUDA device too,
    through ``torch.manual_seed``) and the transforms' fallback generator
    for calls without an ``rng``, and export ``PL_GLOBAL_SEED``."""
    from ..data import transforms

    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    transforms.reseed(seed)
    os.environ["PL_GLOBAL_SEED"] = str(seed)
    return seed


__all__ = [
    "MetricLogger",
    "STANDARD_COLORS",
    "ProfilerHook",
    "SmoothedValue",
    "collate_fn",
    "count",
    "count_syncs",
    "device_memory_stats",
    "drain",
    "draw_bounding_box_on_image",
    "load_obj",
    "seed_everything",
    "set_tracing",
    "span",
    "tracing",
    "visualize_boxes_and_labels_on_image_array",
]

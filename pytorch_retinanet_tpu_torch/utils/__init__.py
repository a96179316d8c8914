"""Host-side utilities of the port: telemetry, FLOPs, and the reference's helpers.

Counterpart of ``pytorch_retinanet_tpu/utils/__init__.py`` (``load_obj``,
``collate_fn``, ``seed_everything``). Its ``enable_compilation_cache`` is
JAX's persistent XLA cache and has no counterpart here: the port's kernels
are cached by ``kernels/build.py`` under ``build/``, keyed on their source.
"""

from __future__ import annotations

import importlib
import os
import random

import numpy as np
import torch

from .metrics import MetricLogger, ProfilerHook, SmoothedValue, device_memory_stats


def load_obj(obj_path: str, default_obj_path: str = "") -> object:
    """Dotted-path object import (the reference's ``load_obj``).

    Names in the optimizer and scheduler registries resolve to the port's
    constructors first, so reference config names keep working; the transform
    registry arrives with the data slice (ROADMAP A8).
    """
    from ..engine.optim import OPTIMIZER_REGISTRY, SCHEDULER_REGISTRY

    for registry in (OPTIMIZER_REGISTRY, SCHEDULER_REGISTRY):
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
    """Seed Python's ``random``, numpy and torch (every CUDA device too,
    through ``torch.manual_seed``), and export ``PL_GLOBAL_SEED``."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    os.environ["PL_GLOBAL_SEED"] = str(seed)
    return seed


__all__ = [
    "MetricLogger",
    "ProfilerHook",
    "SmoothedValue",
    "collate_fn",
    "device_memory_stats",
    "load_obj",
    "seed_everything",
]

"""RetinaNet in PyTorch for NVIDIA Hopper, ported from ``pytorch_retinanet_tpu``.

Inference (``Retinanet.predict``, and the opt-in fused trunk through
``apply_detector(use_fused_trunk=True)``) and training (``Retinanet.forward``,
the ``Trainer``) run on CUDA with hand-written kernels for the fused stem,
greedy NMS, the loss's anchor matching, the fused identity bottleneck and
the per-row top-2 classes (``kernels``); everything else is plain PyTorch on
cuDNN. The package imports neither JAX nor the JAX package.
"""

from . import config, data, engine, kernels, models, ops
from .config import ConfigDict
from .engine import RetinaNetModel, Trainer
from .kernels import KERNELS
from .models import Retinanet, RetinaNetModule, apply_detector, from_jax_variables

__all__ = [
    "ConfigDict",
    "KERNELS",
    "RetinaNetModel",
    "RetinaNetModule",
    "Retinanet",
    "Trainer",
    "apply_detector",
    "config",
    "data",
    "engine",
    "from_jax_variables",
    "kernels",
    "models",
    "ops",
]

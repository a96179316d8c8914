"""RetinaNet in PyTorch for NVIDIA Hopper, ported from ``pytorch_retinanet_tpu``.

The inference path (``Retinanet.predict``) runs on CUDA with hand-written
kernels for the fused stem and greedy NMS (``kernels``); everything else is
plain PyTorch on cuDNN. The package imports neither JAX nor the JAX package.
"""

from . import config, kernels, models, ops
from .kernels import KERNELS
from .models import Retinanet, RetinaNetModule, apply_detector, from_jax_variables

__all__ = [
    "KERNELS",
    "RetinaNetModule",
    "Retinanet",
    "apply_detector",
    "config",
    "from_jax_variables",
    "kernels",
    "models",
    "ops",
]

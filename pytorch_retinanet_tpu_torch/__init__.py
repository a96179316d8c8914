"""RetinaNet in PyTorch for NVIDIA Hopper, ported from ``pytorch_retinanet_tpu``.

Inference (``Retinanet.predict``, and the opt-in fused trunk through
``apply_detector(use_fused_trunk=True)``) and training (``Retinanet.forward``,
the ``Trainer``) run on CUDA with hand-written kernels for the fused stem,
greedy NMS, the loss's anchor matching, the fused identity bottleneck and
the per-row top-2 classes (``kernels``); everything else is plain PyTorch on
cuDNN. The package imports neither JAX nor the JAX package.

The reference's surface::

    from pytorch_retinanet_tpu_torch import OmegaConf, RetinaNetModel, Trainer
    conf = OmegaConf.create({...})   # OmegaConf.load(path) where PyYAML is installed
    Trainer(max_epochs=10, checkpoint_dir="checkpoints").fit(RetinaNetModel(conf))
"""

from . import config, data, engine, kernels, models, ops, utils
from .config import ConfigDict, OmegaConf, default_hparams, ifnone, load_config
from .engine import RetinaNetModel, Trainer
from .kernels import KERNELS
from .models import (
    AnchorGenerator,
    Retinanet,
    RetinaNetModule,
    apply_detector,
    from_jax_variables,
)

__all__ = [
    "AnchorGenerator",
    "ConfigDict",
    "KERNELS",
    "OmegaConf",
    "RetinaNetModel",
    "RetinaNetModule",
    "Retinanet",
    "Trainer",
    "apply_detector",
    "config",
    "data",
    "default_hparams",
    "engine",
    "from_jax_variables",
    "ifnone",
    "kernels",
    "load_config",
    "models",
    "ops",
    "utils",
]

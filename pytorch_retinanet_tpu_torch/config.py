"""Default constants of the detector, :func:`ifnone` and :class:`ConfigDict`.

The values are those of ``pytorch_retinanet_tpu/config.py`` (the reference's
``retinanet/config.py:12-87``). The port keeps its own copy: it imports
nothing of the JAX package. :class:`ConfigDict` is that module's
attribute-access dict; its YAML loading (``OmegaConf``) is left out because
the machine with the card has no ``yaml``: build the config from a dict.
"""

from __future__ import annotations

import copy
from typing import Any, List, Mapping, Optional

# Input normalisation and resize rule.
MEAN: List[float] = [0.485, 0.456, 0.406]
STD: List[float] = [0.229, 0.224, 0.225]
MIN_IMAGE_SIZE: int = 800
MAX_IMAGE_SIZE: int = 1333

# Anchor generator.
ANCHOR_SIZES: List[List[float]] = [
    [x, x * 2 ** (1 / 3), x * 2 ** (2 / 3)] for x in [32, 64, 128, 256, 512]
]
ANCHOR_STRIDES: List[int] = [8, 16, 32, 64, 128]
ANCHOR_ASPECT_RATIOS: List[float] = [0.5, 1.0, 2.0]
ANCHOR_OFFSET: float = 0.0

# Detector head and postprocess.
NUM_CLASSES: int = 90
BACKBONE: str = "resnet50"
PRETRAINED_BACKBONE: bool = True
PRIOR: float = 0.01
FREEZE_BN: bool = True
BBOX_REG_WEIGHTS: List[float] = [1.0, 1.0, 1.0, 1.0]
SCORE_THRES: float = 0.05
NMS_THRES: float = 0.5
MAX_DETECTIONS_PER_IMAGE: int = 100
IOU_THRESHOLDS_FOREGROUND: float = 0.5
IOU_THRESHOLDS_BACKGROUND: float = 0.4
FOCAL_LOSS_GAMMA: float = 2.0
FOCAL_LOSS_ALPHA: float = 0.25
SMOOTH_L1_LOSS_BETA: float = 0.1

# Fixed-shape settings.
MAX_GT_BOXES: int = 100
# Candidates kept per image before NMS.
PRE_NMS_TOP_K: int = 1000
# Compute dtype of the conv trunk; parameters stay float32.
COMPUTE_DTYPE: str = "bfloat16"


def ifnone(a: Any, b: Any) -> Any:
    """`a` if `a` is not None, otherwise `b`."""
    return b if a is None else a


class ConfigDict(dict):
    """Attribute-style nested dict (the OmegaConf ``DictConfig`` surface).

    ``conf.model.backbone_kind`` reads nested keys; missing keys read as
    ``None`` instead of raising, as optional config sections are tested for
    falsiness (``conf.scheduler.monitor``). Mappings inside are wrapped on
    assignment, lists element-wise.
    """

    def __init__(self, data: Optional[Mapping] = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, ConfigDict):
            return value
        if isinstance(value, Mapping):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return [ConfigDict._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, self._wrap(value))

    def __getattr__(self, key: str) -> Any:
        if key.startswith("__"):
            raise AttributeError(key)
        return self.get(key)

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __deepcopy__(self, memo) -> "ConfigDict":
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def merge(self, other: Mapping) -> "ConfigDict":
        """Deep-merge `other` into a copy of self (other wins)."""
        out = copy.deepcopy(self)
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(out.get(k), ConfigDict):
                out[k] = out[k].merge(v)
            else:
                out[k] = v
        return out

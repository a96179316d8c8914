"""Default constants of the detector, :func:`ifnone`, :class:`ConfigDict`,
the ``OmegaConf`` shim, :func:`load_config` and :func:`default_hparams`.

The values are those of ``pytorch_retinanet_tpu/config.py`` (the reference's
``retinanet/config.py:12-87``). The port keeps its own copy: it imports
nothing of the JAX package. PyYAML is imported only where YAML is read, so
the package imports without it; where it is missing, ``OmegaConf.load`` and
``OmegaConf.create(str)`` raise, and ``OmegaConf.to_yaml`` writes block YAML
itself (the loggers' ``hparams.yaml``).
"""

from __future__ import annotations

import copy
import json
import math
import re
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

    def __delattr__(self, key: str) -> None:
        if key in self:
            del self[key]

    def __deepcopy__(self, memo) -> "ConfigDict":
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        """Plain nested dicts and lists."""
        def unwrap(v):
            if isinstance(v, ConfigDict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def merge(self, other: Mapping) -> "ConfigDict":
        """Deep-merge `other` into a copy of self (other wins)."""
        out = copy.deepcopy(self)
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(out.get(k), ConfigDict):
                out[k] = out[k].merge(v)
            else:
                out[k] = v
        return out


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading YAML needs PyYAML, which is not installed; build the "
                          "config from a dict with OmegaConf.create({...})") from e
    return yaml


# Plain scalars that YAML would read as something other than this string.
_YAML_WORDS = {"", "~", "null", "true", "false", "yes", "no", "on", "off", "y", "n"}
_PLAIN = re.compile(r"[A-Za-z_][A-Za-z0-9_./-]*\Z")


def _yaml_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        mantissa, _, exponent = r.partition("e")
        if "." not in mantissa:  # PyYAML reads a float only with a dot in it
            mantissa += ".0"
        return mantissa + ("e" + exponent if exponent else "")
    v = str(v)
    if _PLAIN.match(v) and v.lower() not in _YAML_WORDS:
        return v
    return json.dumps(v)  # a double-quoted YAML scalar


def _yaml_lines(v: Any, indent: str) -> List[str]:
    if isinstance(v, Mapping) and v:
        out = []
        for k, x in v.items():
            key = _yaml_scalar(k)
            if isinstance(x, (Mapping, list, tuple)) and x:
                out.append(f"{indent}{key}:")
                out += _yaml_lines(x, indent + ("" if isinstance(x, (list, tuple)) else "  "))
            else:
                out.append(f"{indent}{key}: {_yaml_block(x)}")
        return out
    if isinstance(v, (list, tuple)) and v:
        out = []
        for x in v:
            if isinstance(x, (Mapping, list, tuple)) and x:
                inner = _yaml_lines(x, indent + "  ")
                out.append(f"{indent}- {inner[0][len(indent) + 2:]}")
                out += inner[1:]
            else:
                out.append(f"{indent}- {_yaml_block(x)}")
        return out
    return [indent + _yaml_block(v)]


def _yaml_block(v: Any) -> str:
    if isinstance(v, Mapping):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _yaml_scalar(v)


def to_block_yaml(data: Any) -> str:
    """Block YAML of nested dicts, lists and scalars, without PyYAML;
    ``yaml.safe_load`` reads it back to `data`."""
    return "\n".join(_yaml_lines(data, "")) + "\n"


class OmegaConf:
    """The ``OmegaConf`` calls reference-style user code makes: ``load``,
    ``create``, ``merge``, ``to_container``, ``to_yaml``."""

    @staticmethod
    def load(path: str) -> ConfigDict:
        yaml = _yaml()
        with open(path) as f:
            return ConfigDict(yaml.safe_load(f) or {})

    @staticmethod
    def create(data: Optional[Mapping] = None) -> ConfigDict:
        if isinstance(data, str):
            return ConfigDict(_yaml().safe_load(data) or {})
        return ConfigDict(data or {})

    @staticmethod
    def merge(*configs: Mapping) -> ConfigDict:
        out = ConfigDict()
        for c in configs:
            out = out.merge(c)
        return out

    @staticmethod
    def to_container(conf: ConfigDict) -> dict:
        return conf.to_dict()

    @staticmethod
    def to_yaml(conf: ConfigDict) -> str:
        data = conf.to_dict() if isinstance(conf, ConfigDict) else ConfigDict(conf).to_dict()
        try:
            import yaml
        except ImportError:
            return to_block_yaml(data)
        return yaml.safe_dump(data, sort_keys=False)


def load_config(path: str) -> ConfigDict:
    """Load a YAML config file into a :class:`ConfigDict` (needs PyYAML)."""
    return OmegaConf.load(path)


def default_hparams() -> ConfigDict:
    """The reference ``hparams.yaml``'s top-level sections, with defaults."""
    return ConfigDict(
        {
            "model": {
                "backbone_kind": BACKBONE,
                "num_classes": NUM_CLASSES,
                "freeze_bn": FREEZE_BN,
                "min_size": MIN_IMAGE_SIZE,
                "max_size": MAX_IMAGE_SIZE,
                "pretrained": False,
            },
            "dataset": {
                "kind": False,
                "root_dir": False,
                "trn_paths": False,
                "valid_paths": False,
                "test_paths": False,
            },
            "dataloader": {"train_bs": 2, "valid_bs": 8, "test_bs": 8, "args": {"num_workers": 0}},
            "transforms": [
                {"class_name": "albumentations.HorizontalFlip", "params": {"p": 0.5}}
            ],
            "optimizer": {
                "class_name": "torch.optim.SGD",
                "params": {"lr": 0.001, "weight_decay": 0.001, "momentum": 0.9},
            },
            "scheduler": {
                "class_name": None,
                "params": {},
                "interval": "epoch",
                "frequency": 1,
                "monitor": False,
            },
        }
    )

"""Carry weights across: the JAX package's variables -> this port's state_dict.

The port's parameter names are the reference detector's ``state_dict``
schema (``backbone.backbone.*``, ``fpn.*``, ``retinanet_head.*``), so the
conversion is the JAX package's export
(``pytorch_retinanet_tpu/models/converter.py::flax_retinanet_to_torch``):
HWIO kernels become OIHW, flax BN ``scale/bias`` + ``mean/var`` become
torchvision's ``weight/bias`` + ``running_mean/running_var``. This module is
its own copy of that mapping and takes plain nested dicts of numpy arrays.
A ``stem_s2d`` stem kernel is carried across unchanged (the port's s2d
``conv1``); a ``ResNet`` of the other stem form converts it on load.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from .backbone import RESNET_SPECS, require_resnet

FPN_KEYMAP = {
    "conv_c3_1x1": "lateral_c3",
    "conv_c4_1x1": "lateral_c4",
    "conv_c5_1x1": "lateral_c5",
    "conv_c3_3x3": "smooth_p3",
    "conv_c4_3x3": "smooth_p4",
    "conv_c5_3x3": "smooth_p5",
    "conv_c6_3x3": "p6",
    "conv_c7_3x3": "p7",
}

_HEADS = (
    ("cls_subnet", "classification_head.class_subnet", "class_subnet_output"),
    ("box_subnet", "regression_head.box_subnet", "box_subnet_output"),
)


def resnet_state_dict(
    params: Mapping[str, Any], stats: Mapping[str, Any], kind: str
) -> Dict[str, np.ndarray]:
    """Flax ResNet params and batch stats -> torchvision ResNet keys (OIHW)."""
    block_kind, depths = RESNET_SPECS[kind]
    n_convs = 2 if block_kind == "basic" else 3
    out: Dict[str, np.ndarray] = {}

    def put_conv(key: str, p: Mapping[str, Any]) -> None:
        out[key] = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)

    def put_bn(prefix: str, p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
        bnp, bns = p["BatchNorm_0"], s["BatchNorm_0"]
        out[f"{prefix}.weight"] = np.asarray(bnp["scale"], np.float32)
        out[f"{prefix}.bias"] = np.asarray(bnp["bias"], np.float32)
        out[f"{prefix}.running_mean"] = np.asarray(bns["mean"], np.float32)
        out[f"{prefix}.running_var"] = np.asarray(bns["var"], np.float32)
        out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)

    # A space-to-depth stem kernel [4, 4, 12, 64] comes across as it is, to
    # the port's s2d conv1 [64, 12, 4, 4].
    put_conv("conv1.weight", params["stem_conv"])
    put_bn("bn1", params["stem_bn"], stats["stem_bn"])
    for stage, depth in enumerate(depths, start=1):
        for i in range(depth):
            blk_p = params[f"layer{stage}_block{i}"]
            blk_s = stats[f"layer{stage}_block{i}"]
            prefix = f"layer{stage}.{i}"
            for j in range(1, n_convs + 1):
                put_conv(f"{prefix}.conv{j}.weight", blk_p[f"conv{j}"])
                put_bn(f"{prefix}.bn{j}", blk_p[f"bn{j}"], blk_s[f"bn{j}"])
            if "downsample_conv" in blk_p:
                put_conv(f"{prefix}.downsample.0.weight", blk_p["downsample_conv"])
                put_bn(f"{prefix}.downsample.1", blk_p["downsample_bn"], blk_s["downsample_bn"])
    return out


def from_jax_variables(variables: Mapping[str, Any], kind: str) -> Dict[str, np.ndarray]:
    """JAX ``{"params", "batch_stats"}`` of a ``RetinaNetModule`` -> this port's
    ``state_dict`` (numpy values), loadable with ``strict=True``."""
    require_resnet(kind, "conversion from the JAX package")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    for k, v in resnet_state_dict(params["backbone"], stats["backbone"], kind).items():
        sd[f"backbone.backbone.{k}"] = v

    def put_conv(prefix: str, p: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)
        sd[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)

    for theirs, ours in FPN_KEYMAP.items():
        put_conv(f"fpn.{theirs}", params["fpn"][ours])
    for ours, theirs, out_name in _HEADS:
        sub = params["head"][ours]
        for i, ti in enumerate((0, 2, 4, 6)):
            put_conv(f"retinanet_head.{theirs}.{ti}", sub[f"conv{i}"])
        put_conv(f"retinanet_head.{theirs.split('.')[0]}.{out_name}", sub["predictor"])
    return sd

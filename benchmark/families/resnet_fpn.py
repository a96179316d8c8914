"""The ResNet trunk family: torchvision's ResNet-18/50/101/152 (V1.5: a
bottleneck strides on its 3x3), frozen batch norm, returning C3 / C4 / C5.

A trunk family is a file of ``benchmark/families/`` that declares
``KINDS``, the ``backbone_kind`` values it serves, and gives:

- ``schema(m)``: every key of the trunk's ``state_dict`` (the reference
  detector's ``backbone.backbone.*``), its shape and its role;
- ``BUFFERS``: the roles that are buffers, not trained;
- ``draw(key, shape, role, m)``: the key's seeded initialisation,
  ``("normal", std)``, ``("uniform", low, high)`` or ``("full", value)``;
- ``out_channels(m)``: the channels of C3, C4 and C5;
- ``trunk(sd, x, m, q)``: normalized f32 NCHW images -> [C3, C4, C5] in
  plain f32, every convolution through the quantizer `q`;
- ``trunk_flops(h, w, m)``: the trunk's forward convolution FLOPs (MACs x 2)
  of one image.

Trunk convs: He normal over fan-out (torchvision's init). Frozen batch
norms get random running statistics and affine parameters, so that none is
the identity; the last norm of each residual branch gets a small scale, so
that activations stay of order one through 33 blocks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from rnbench.reference import Quant, conv, frozen_bn
from rnbench.yardstick import conv_flops

KINDS = ("resnet18", "resnet50", "resnet101", "resnet152")
DEPTHS = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet50": ("bottleneck", (3, 4, 6, 3)),
          "resnet101": ("bottleneck", (3, 4, 23, 3)), "resnet152": ("bottleneck", (3, 8, 36, 3))}
BUFFERS = frozenset({"bn.running_mean", "bn.running_var"})
# (low, high) of the uniform draws of each batch-norm leaf.
BN_RANGES = {"weight": (0.7, 1.3), "bias": (-0.1, 0.1), "running_mean": (-0.1, 0.1),
             "running_var": (0.5, 1.5)}
BRANCH_END_BN_WEIGHT = (0.1, 0.3)


def blocks(m: Dict):
    """(prefix, cin, width, stride, has_downsample, block kind) of every residual block."""
    block, depths = DEPTHS[m["backbone_kind"]]
    expansion = 4 if block == "bottleneck" else 1
    cin, out = 64, []
    for stage, (depth, width) in enumerate(zip(depths, (64, 128, 256, 512)), start=1):
        for i in range(depth):
            stride = 2 if (i == 0 and stage > 1) else 1
            cout = width * expansion
            out.append((f"backbone.backbone.layer{stage}.{i}", cin, width, stride,
                        stride != 1 or cin != cout, block))
            cin = cout
    return out


def _convs(cin: int, width: int, block: str):
    """(cin, cout, kernel) of a block's branch convs."""
    if block == "bottleneck":
        return [(cin, width, 1), (width, width, 3), (width, width * 4, 1)]
    return [(cin, width, 3), (width, width, 3)]


def out_channels(m: Dict) -> Tuple[int, int, int]:
    return (512, 1024, 2048) if DEPTHS[m["backbone_kind"]][0] == "bottleneck" else (128, 256, 512)


def schema(m: Dict) -> List[Tuple[str, tuple, str]]:
    """Roles: ``conv`` (a conv weight), ``bn.<leaf>`` (weight, bias,
    running_mean, running_var)."""
    out: List[Tuple[str, tuple, str]] = []

    def bn(p, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out.append((f"{p}.{leaf}", (c,), f"bn.{leaf}"))

    out.append(("backbone.backbone.conv1.weight", (64, 3, 7, 7), "conv"))
    bn("backbone.backbone.bn1", 64)
    for p, cin, width, stride, down, block in blocks(m):
        convs = _convs(cin, width, block)
        for j, (ci, co, k) in enumerate(convs, start=1):
            out.append((f"{p}.conv{j}.weight", (co, ci, k, k), "conv"))
            bn(f"{p}.bn{j}", co)
        if down:
            co = convs[-1][1]
            out.append((f"{p}.downsample.0.weight", (co, cin, 1, 1), "conv"))
            bn(f"{p}.downsample.1", co)
    return out


def draw(key: str, shape: tuple, role: str, m: Dict) -> tuple:
    if role == "conv":
        return ("normal", math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])))
    last = "bn3" if DEPTHS[m["backbone_kind"]][0] == "bottleneck" else "bn2"
    if ".layer" in key and key.endswith(f".{last}.weight"):
        return ("uniform",) + BRANCH_END_BN_WEIGHT
    return ("uniform",) + BN_RANGES[role.split(".")[1]]


def trunk(sd: Dict[str, torch.Tensor], x: torch.Tensor, m: Dict, q: Quant = None) -> List[torch.Tensor]:
    """Normalized NCHW f32 images -> [C3, C4, C5]."""
    x = frozen_bn(conv(x, sd["backbone.backbone.conv1.weight"], stride=2, q=q), sd,
                  "backbone.backbone.bn1", True)
    x = F.max_pool2d(x, 3, 2, 1)
    feats = {}
    for p, _, _, stride, down, block in blocks(m):
        n = 3 if block == "bottleneck" else 2
        y = x
        for j in range(1, n + 1):
            # ResNet V1.5: the bottleneck strides on its 3x3, the basic block on its first conv.
            s = stride if j == (2 if block == "bottleneck" else 1) else 1
            y = frozen_bn(conv(y, sd[f"{p}.conv{j}.weight"], stride=s, q=q), sd, f"{p}.bn{j}", j < n)
        r = frozen_bn(conv(x, sd[f"{p}.downsample.0.weight"], stride=stride, q=q), sd,
                      f"{p}.downsample.1", False) if down else x
        x = torch.relu(y + r)
        feats[p.split(".")[2]] = x
    return [feats["layer2"], feats["layer3"], feats["layer4"]]


def trunk_flops(h: int, w: int, m: Dict) -> int:
    """The stem's 7x7 conv and every block's convs at their output sizes
    (a bottleneck's first 1x1 at its input's)."""
    fl = conv_flops((h // 2, w // 2), 7, 3, 64)
    sh, sw = h // 4, w // 4
    for _, cin, width, stride, down, block in blocks(m):
        oh, ow = sh // stride, sw // stride
        for j, (ci, co, k) in enumerate(_convs(cin, width, block), start=1):
            at = (sh, sw) if block == "bottleneck" and j == 1 else (oh, ow)
            fl += conv_flops(at, k, ci, co)
        if down:
            fl += conv_flops((oh, ow), 1, cin, _convs(cin, width, block)[-1][1])
        sh, sw = oh, ow
    return fl

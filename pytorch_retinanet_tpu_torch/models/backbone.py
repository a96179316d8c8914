"""ResNet-18/34/50/101/152 trunks returning C3/C4/C5, and :class:`BackBone`,
which holds a ResNet or a PVT v2 trunk (:mod:`.pvt`) by kind.

Counterpart of ``pytorch_retinanet_tpu/models/backbone.py``. Module and
parameter names are torchvision's (``conv1``, ``bn1``, ``layer{1-4}.{i}``,
``downsample.{0,1}``), so a torchvision ImageNet checkpoint and the
reference detector's ``backbone.backbone.*`` keys load as they are.
Bottlenecks put the stride on the 3x3 (ResNet V1.5).

As in JAX ``models/backbone.py:135-163``: ``freeze_bn=False`` makes every
batch norm live in training mode; ``remat`` recomputes each residual
block's activations in backward (``torch.utils.checkpoint``, in training
only), with the live statistics updated in the first pass alone.
``stem_s2d=True`` stores and trains the space-to-depth stem as JAX does
(``models/backbone.py:163-176``): ``conv1.weight`` is [64, 12, 4, 4], a
stride-1 conv with padding (2, 1) over :func:`.layers.space_to_depth_2x`
input, initialized as a repacked 7x7 weight. Loading converts a 7x7
``conv1.weight`` into the module's form and back (see
:meth:`ResNet._load_from_state_dict`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .pvt import PVT_SPECS, PyramidVisionTransformerV2
from .layers import (
    BatchNorm2d,
    conv,
    conv_layer,
    max_pool_torch,
    recomputing,
    space_to_depth_2x,
    stem_weight_from_s2d,
    stem_weight_to_s2d,
)

Tensor = torch.Tensor

# (block kind, stage depths) per architecture.
RESNET_SPECS: Dict[str, Tuple[str, Tuple[int, int, int, int]]] = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}

BACKBONE_OUT_CHANNELS: Dict[str, Tuple[int, int, int]] = {
    "resnet18": (128, 256, 512),
    "resnet34": (128, 256, 512),
    "resnet50": (512, 1024, 2048),
    "resnet101": (512, 1024, 2048),
    "resnet152": (512, 1024, 2048),
    **{kind: spec.embed_dims[1:] for kind, spec in PVT_SPECS.items()},
}
BACKBONE_KINDS = tuple(RESNET_SPECS) + tuple(PVT_SPECS)


def is_resnet(kind: str) -> bool:
    """Whether `kind` is a ResNet trunk: the fused stem and trunk, the
    spatial and tensor-parallel splits, the JAX conversion and the
    torchvision checkpoints serve those alone."""
    return kind in RESNET_SPECS


def require_resnet(kind: str, what: str) -> None:
    """Raise a ValueError saying that `what` takes a ResNet trunk, unless `kind` is one."""
    if not is_resnet(kind):
        raise ValueError(f"{what} takes a ResNet trunk; {kind} is none")


def backbone_out_channels(kind: str) -> Tuple[int, int, int]:
    return BACKBONE_OUT_CHANNELS[kind]


class _Downsample(nn.Sequential):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__(conv_layer(cin, cout, 1, stride), BatchNorm2d(cout))

    def forward(self, x: Tensor) -> Tensor:
        return self[1](conv(self[0], x))


class BasicBlock(nn.Module):
    """Two 3x3 convs and a shortcut."""

    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv_layer(cin, width, 3, stride)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = conv_layer(width, width, 3)
        self.bn2 = BatchNorm2d(width)
        self.downsample = (
            _Downsample(cin, width, stride) if stride != 1 or cin != width else None
        )

    def forward(self, x: Tensor) -> Tensor:
        y = self.bn1(conv(self.conv1, x), relu=True)
        y = self.bn2(conv(self.conv2, y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu_(y.add_(residual))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) and a shortcut."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = width * 4
        self.conv1 = conv_layer(cin, width, 1)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = conv_layer(width, width, 3, stride)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = conv_layer(width, cout, 1)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = (
            _Downsample(cin, cout, stride) if stride != 1 or cin != cout else None
        )

    def forward(self, x: Tensor) -> Tensor:
        y = self.bn1(conv(self.conv1, x), relu=True)
        y = self.bn2(conv(self.conv2, y), relu=True)
        y = self.bn3(conv(self.conv3, y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu_(y.add_(residual))


class ResNet(nn.Module):
    """ResNet trunk: stem, four stages, returning {"c3", "c4", "c5"}."""

    def __init__(self, kind: str = "resnet50", freeze_bn: bool = True, remat: bool = False,
                 stem_s2d: bool = False):
        super().__init__()
        if kind not in RESNET_SPECS:
            raise ValueError(f"backbone kind must be one of {sorted(RESNET_SPECS)}, got {kind!r}")
        block_kind, depths = RESNET_SPECS[kind]
        block_cls = BasicBlock if block_kind == "basic" else Bottleneck
        self.stem_s2d = stem_s2d
        self.conv1 = nn.Conv2d(12, 64, 4, bias=False) if stem_s2d else conv_layer(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, (depth, width) in enumerate(zip(depths, (64, 128, 256, 512)), start=1):
            blocks = []
            for i in range(depth):
                stride = 2 if (i == 0 and stage > 1) else 1
                blocks.append(block_cls(cin, width, stride))
                cin = width * block_cls.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
        self.remat = remat
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.frozen = freeze_bn

    def stem(self, x: Tensor) -> Tensor:
        """The unfused stem: conv 7x7 s2 (or its space-to-depth form), BN,
        ReLU, max pool 3x3 s2."""
        if self.stem_s2d:
            x = conv(self.conv1, space_to_depth_2x(x), pad=((2, 1), (2, 1)))
        else:
            x = conv(self.conv1, x)
        return max_pool_torch(self.bn1(x, relu=True), 3, 2)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        """A 7x7 ``conv1.weight`` (the reference schema) loads into the s2d
        stem repacked, and an s2d one into the 7x7 stem folded (which
        raises on learned taps outside the 7x7 field)."""
        key = prefix + "conv1.weight"
        w = state_dict.get(key)
        if w is not None and tuple(w.shape[2:]) != tuple(self.conv1.weight.shape[2:]):
            w = torch.as_tensor(w)
            state_dict[key] = stem_weight_to_s2d(w) if self.stem_s2d else stem_weight_from_s2d(w)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _stage(self, layer: nn.Sequential, x: Tensor) -> Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return layer(x)
        for block in layer:
            x = checkpoint(block, x, use_reentrant=False,
                           context_fn=lambda: (contextlib.nullcontext(), recomputing()))
        return x

    def forward(self, x: Tensor, stem_in: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """`x` is the normalized NCHW image in the compute dtype; `stem_in`,
        when given, is the fused stem's output and replaces the stem."""
        x = self.stem(x) if stem_in is None else stem_in
        x = self._stage(self.layer1, x)
        c3 = self._stage(self.layer2, x)
        c4 = self._stage(self.layer3, c3)
        c5 = self._stage(self.layer4, c4)
        return {"c3": c3, "c4": c4, "c5": c5}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming-normal (fan_out, ReLU) convs, identity BN, as torchvision.
        The s2d stem samples the 7x7 weight and repacks it, as JAX's
        ``_s2d_stem_init`` does, from the same draws as the 7x7 stem's."""
        for m in self.modules():
            if m is self.conv1 and self.stem_s2d:
                w7 = torch.empty((64, 3, 7, 7)).normal_(0.0, math.sqrt(2.0 / (64 * 49)),
                                                        generator=generator)
                m.weight.copy_(stem_weight_to_s2d(w7))
            elif isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


class BackBone(nn.Module):
    """Holds the trunk as ``backbone`` (the reference's ``backbone.backbone.*``
    keys): a :class:`ResNet` with `freeze_bn`, `remat` and `stem_s2d`, or a
    PVT v2 trunk with `drop_path_rate` (None: its default)."""

    def __init__(self, kind: str = "resnet50", freeze_bn: bool = True, remat: bool = False,
                 stem_s2d: bool = False, drop_path_rate: Optional[float] = None):
        super().__init__()
        if kind in PVT_SPECS:
            if remat or stem_s2d:
                raise ValueError(f"remat and stem_s2d are ResNet options; {kind} takes neither")
            rate = {} if drop_path_rate is None else {"drop_path_rate": drop_path_rate}
            self.backbone = PyramidVisionTransformerV2(kind, **rate)
            return
        if drop_path_rate is not None:
            raise ValueError(f"drop_path_rate is an option of the PVT trunks; {kind} has no drop path")
        self.backbone = ResNet(kind, freeze_bn=freeze_bn, remat=remat, stem_s2d=stem_s2d)

    def forward(self, x: Tensor, stem_in: Optional[Tensor] = None) -> Dict[str, Tensor]:
        return self.backbone(x, stem_in)

"""The opt-in kernel-fused ResNet trunk (inference, frozen BN).

Counterpart of ``pytorch_retinanet_tpu/models/fused_backbone.py``. It runs
the trunk of a port :class:`~.backbone.ResNet` from the fused stem's output,
outside the module's own ``forward``:

* every identity bottleneck after a stage's first block goes through the
  fused bottleneck kernel (``kernels/bottleneck.py``) where
  ``fused_bottleneck_supported`` takes its shape (with R50 at 800x1344: the
  blocks of layers 2-4, 10 launches; layer1's mid 64 is refused);
* every other block runs :func:`entry_bottleneck`, the JAX package's
  ``_xla_bottleneck`` formula.

Reached through ``models.retinanet.apply_detector(use_fused_trunk=True)``;
off by default, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..kernels.bottleneck import bottleneck_args, fused_bottleneck, fused_bottleneck_supported
from .backbone import RESNET_SPECS, ResNet, is_resnet

Tensor = torch.Tensor


def _conv_bn(conv: torch.nn.Conv2d, bn, x: Tensor, stride: int) -> Tensor:
    """bf16 conv (bf16 out), then folded BN ``y * scale + bias`` in f32, rounded to bf16.

    ``addcmul`` reads the bf16 conv output and writes the f32 result in one
    pass (the multiply and add possibly fused into one rounding), where an
    f32 upcast, a multiply and an add would take three.
    """
    y = F.conv2d(x, conv.weight.to(torch.bfloat16), None, stride, conv.padding)
    scale, bias = bn.folded()
    return torch.addcmul(bias[:, None, None], y, scale[:, None, None]).to(torch.bfloat16)


def entry_bottleneck(block, x: Tensor, stride: int) -> Tensor:
    """A bottleneck by the JAX package's ``_xla_bottleneck`` formula.

    NCHW bf16 in and out. Each conv runs in bf16, each folded BN in f32 with
    a bf16 rounding after it; the stride is on the 3x3 (ResNet V1.5); the
    residual is the downsample branch where the block has one, and the add
    is in bf16.
    """
    x = x.to(torch.bfloat16)
    y = torch.relu_(_conv_bn(block.conv1, block.bn1, x, 1))
    y = torch.relu_(_conv_bn(block.conv2, block.bn2, y, stride))
    y = _conv_bn(block.conv3, block.bn3, y, 1)
    if block.downsample is not None:
        residual = _conv_bn(block.downsample[0], block.downsample[1], x, stride)
    else:
        residual = x
    return torch.relu_(y.add_(residual))


def fused_trunk_applicable(kind: str) -> bool:
    """The fused trunk covers bottleneck ResNets; basic-block nets and the
    other trunks use the module."""
    return is_resnet(kind) and RESNET_SPECS[kind][0] == "bottleneck"


def apply_trunk_fused(
    resnet: ResNet, stem_out: Tensor, kind: str, use_kernel: bool = True
) -> Dict[str, Tensor]:
    """Stem output [B, H/4, W/4, 64] NHWC -> {"c3", "c4", "c5"}.

    Identity blocks that ``fused_bottleneck_supported`` takes go through the
    fused bottleneck; ``use_kernel=False`` runs :func:`entry_bottleneck` for
    every block (the cross-check path). The outputs are channels_last NCHW
    views of NHWC bf16 activations.
    """
    if not fused_trunk_applicable(kind):
        raise ValueError(f"the fused trunk takes bottleneck ResNets, got {kind}")
    _, depths = RESNET_SPECS[kind]
    x = stem_out.to(torch.bfloat16).permute(0, 3, 1, 2)
    out: Dict[str, Tensor] = {}
    for stage, (depth, width) in enumerate(zip(depths, (64, 128, 256, 512)), start=1):
        layer = getattr(resnet, f"layer{stage}")
        for i in range(depth):
            stride = 2 if (i == 0 and stage > 1) else 1
            nhwc = x.permute(0, 2, 3, 1)
            if i > 0 and use_kernel and fused_bottleneck_supported(tuple(nhwc.shape), width):
                x = fused_bottleneck(nhwc, *bottleneck_args(layer[i])).permute(0, 3, 1, 2)
            else:
                x = entry_bottleneck(layer[i], x, stride)
        if stage >= 2:
            out[f"c{stage + 1}"] = x
    return out

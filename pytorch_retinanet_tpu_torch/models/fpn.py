"""Feature pyramid P3-P7 from C3/C4/C5.

Counterpart of ``pytorch_retinanet_tpu/models/fpn.py``, with the reference's
parameter names: 1x1 laterals to 256 channels, nearest top-down upsample and
add, 3x3 smoothing; P6 is a 3x3 stride-2 conv on C5 and P7 one on ReLU(P6).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from .layers import conv, conv_layer, nearest_upsample_to

Tensor = torch.Tensor


class FeaturePyramid(nn.Module):
    def __init__(self, c3: int, c4: int, c5: int, channels: int = 256):
        super().__init__()
        self.conv_c3_1x1 = conv_layer(c3, channels, 1, bias=True)
        self.conv_c3_3x3 = conv_layer(channels, channels, 3, bias=True)
        self.conv_c4_1x1 = conv_layer(c4, channels, 1, bias=True)
        self.conv_c4_3x3 = conv_layer(channels, channels, 3, bias=True)
        self.conv_c5_1x1 = conv_layer(c5, channels, 1, bias=True)
        self.conv_c5_3x3 = conv_layer(channels, channels, 3, bias=True)
        self.conv_c6_3x3 = conv_layer(c5, channels, 3, 2, bias=True)
        self.conv_c7_3x3 = conv_layer(channels, channels, 3, 2, bias=True)

    def forward(self, feats: Dict[str, Tensor]) -> List[Tensor]:
        c3, c4, c5 = feats["c3"], feats["c4"], feats["c5"]
        m5 = conv(self.conv_c5_1x1, c5)
        m4 = conv(self.conv_c4_1x1, c4) + nearest_upsample_to(m5, c4.shape[2:])
        m3 = conv(self.conv_c3_1x1, c3) + nearest_upsample_to(m4, c3.shape[2:])
        p6 = conv(self.conv_c6_3x3, c5)
        return [
            conv(self.conv_c3_3x3, m3),
            conv(self.conv_c4_3x3, m4),
            conv(self.conv_c5_3x3, m5),
            p6,
            conv(self.conv_c7_3x3, torch.relu(p6)),
        ]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming-uniform (fan_in, ReLU gain) weights and zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                bound = math.sqrt(6.0 / fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.zero_()

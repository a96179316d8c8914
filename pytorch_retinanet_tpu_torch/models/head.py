"""RetinaNet classification and box subnets, shared across pyramid levels.

Counterpart of ``pytorch_retinanet_tpu/models/head.py`` with the reference's
parameter names. Layout contract: each level's predictor output
``[N, A*K, H, W]`` is permuted to NHWC before it is reshaped to
``[N, H*W*A, K]``, so rows line up with the anchors (row-major grid, cell
anchor innermost), level after level.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

from .layers import conv, conv_layer

Tensor = torch.Tensor


class _Subnet(nn.Module):
    """Four 3x3 conv + ReLU layers (Sequential indices 0, 2, 4, 6) and a predictor."""

    def __init__(self, name: str, channels: int, out_channels: int, depth: int = 4):
        super().__init__()
        layers = []
        for _ in range(depth):
            layers += [conv_layer(channels, channels, 3, bias=True), nn.ReLU()]
        self.subnet_name = name
        self.add_module(name, nn.Sequential(*layers))
        self.add_module(f"{name}_output", conv_layer(channels, out_channels, 3, bias=True))

    def forward(self, x: Tensor) -> Tensor:
        for layer in getattr(self, self.subnet_name):
            if isinstance(layer, nn.Conv2d):
                x = torch.relu(conv(layer, x))
        return conv(getattr(self, f"{self.subnet_name}_output"), x)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, predictor_bias: float) -> None:
        """Normal(0, 0.01) weights, zero biases, the predictor's bias set apart."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 0.01, generator=generator)
                m.bias.zero_()
        getattr(self, f"{self.subnet_name}_output").bias.fill_(predictor_bias)


class RetinaNetHead(nn.Module):
    """Class and box subnets over the pyramid."""

    def __init__(self, num_classes: int, num_anchors: int = 9, channels: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.classification_head = _Subnet("class_subnet", channels, num_anchors * num_classes)
        self.regression_head = _Subnet("box_subnet", channels, num_anchors * 4)

    def forward(
        self, pyramid: List[Tensor], return_levels: bool = False
    ) -> Tuple[List[Tensor], List[Tensor]] | Tuple[Tensor, Tensor]:
        """Per level ``[N, H*W*A, K]`` logits and ``[N, H*W*A, 4]`` deltas in the
        compute dtype; without `return_levels`, both concatenated in f32."""
        cls_out, box_out = [], []
        for level in pyramid:
            n = level.shape[0]
            c = self.classification_head(level).permute(0, 2, 3, 1)
            b = self.regression_head(level).permute(0, 2, 3, 1)
            cls_out.append(c.reshape(n, -1, self.num_classes))
            box_out.append(b.reshape(n, -1, 4))
        if return_levels:
            return cls_out, box_out
        return torch.cat(cls_out, dim=1).float(), torch.cat(box_out, dim=1).float()

    def reset_parameters(self, generator: torch.Generator, prior: float) -> None:
        self.classification_head.reset_parameters(generator, -math.log((1.0 - prior) / prior))
        self.regression_head.reset_parameters(generator, 0.0)

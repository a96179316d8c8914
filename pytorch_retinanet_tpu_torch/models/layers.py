"""Building blocks shared by the backbone, FPN and head.

Conventions of the port, mirroring ``pytorch_retinanet_tpu/models/layers.py``:

* Tensors are NCHW in shape and channels_last in memory where the caller
  asks for it (the model does, on the card), so cuDNN runs NHWC.
* Parameters are f32; convolutions run in the compute dtype (bf16 by
  default), with the weights cast per call.
* Batch norm is frozen by default: running statistics, applied in f32 and
  rounded to the compute dtype. A live one (``frozen=False``, in training
  mode) normalizes with the batch's statistics and updates the running ones
  as flax's ``nn.BatchNorm`` does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def conv(layer: nn.Conv2d, x: Tensor) -> Tensor:
    """Apply `layer` in the dtype of `x`, with torch-style symmetric padding."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride, layer.padding)


def conv_layer(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    """A conv holding its parameters, padded ``(k - 1) // 2`` on both sides."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=bias)


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """Marks a rematerialized forward (the recompute in backward of
    ``torch.utils.checkpoint``): live batch norms leave their running
    statistics alone inside it, so that a step updates them once."""
    prev = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


class BatchNorm2d(nn.Module):
    """Batch norm with torchvision's parameter names, frozen or live.

    Frozen (the default), or live outside training mode: ``(x - mean) /
    sqrt(var + eps) * weight + bias`` on the running statistics, in f32,
    returned in the dtype of `x`. Live in training mode: the same on the
    batch's mean and biased variance over (N, H, W), computed in f32, and
    ``running = 0.9 * running + 0.1 * batch`` with the biased variance,
    flax's ``nn.BatchNorm(momentum=0.9)``. :meth:`folded`
    gives the running map as a per-channel ``scale`` and ``shift``, the form
    the fused stem takes.
    """

    momentum = 0.9  # flax's convention: the running statistics' own weight

    def __init__(self, num_features: int, eps: float = 1e-5, frozen: bool = True):
        super().__init__()
        self.eps = eps
        self.frozen = frozen
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def folded(self):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: Tensor, relu: bool = False) -> Tensor:
        if self.frozen or not self.training:
            # Eval-mode batch_norm: f32 math on f32 statistics, one rounding
            # into x's dtype, one pass over the activation (cuDNN on the card).
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
        else:
            # Train-mode batch_norm normalizes with the biased variance; with
            # momentum 1 it writes the batch mean and the *unbiased* variance
            # into the scratch buffers, which the update below corrects.
            mean = torch.zeros_like(self.running_mean)
            var = torch.ones_like(self.running_var)
            y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
            if not getattr(_RECOMPUTE, "on", False):
                n = x.numel() // x.shape[1]
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                    self.running_var.mul_(m).add_(var, alpha=(1.0 - m) * (n - 1) / n)
                    self.num_batches_tracked.add_(1)
        return torch.relu_(y) if relu else y


def max_pool_torch(x: Tensor, window: int, stride: int) -> Tensor:
    """Max pool with symmetric ``(window - 1) // 2`` padding (-inf padded)."""
    return F.max_pool2d(x, window, stride, (window - 1) // 2)


def nearest_upsample_to(x: Tensor, target_hw: Sequence[int]) -> Tensor:
    """Nearest upsample of NCHW `x` to an exact (H, W) by repeat and slice.

    Index ``i`` of the output reads ``i // ceil(H_out / H_in)`` of the input,
    as the JAX ``repeat`` + slice does; ``F.interpolate(mode="nearest")``
    reads ``floor(i * H_in / H_out)``, which differs on odd sizes. Works in
    the NHWC view so a channels_last tensor stays channels_last.
    """
    n, c, h, w = x.shape
    th, tw = int(target_hw[0]), int(target_hw[1])
    rh, rw = -(-th // h), -(-tw // w)
    y = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(n, h, rh, w, rw, c)
    y = y.reshape(n, h * rh, w * rw, c)[:, :th, :tw, :]
    return y.permute(0, 3, 1, 2)


"""Building blocks shared by the backbone, FPN and head.

Conventions of the port, mirroring ``pytorch_retinanet_tpu/models/layers.py``:

* Tensors are NCHW in shape and channels_last in memory where the caller
  asks for it (the model does, on the card), so cuDNN runs NHWC.
* Parameters are f32; convolutions run in the compute dtype (bf16 by
  default), with the weights cast per call.
* Batch norm is frozen by default: running statistics, applied in f32 and
  rounded to the compute dtype. A live one (``frozen=False``, in training
  mode) normalizes with the batch's statistics and updates the running ones
  as flax's ``nn.BatchNorm`` does; in a process group of more than one rank
  the statistics are the global batch's, as JAX's over a data-sharded batch.
* Inside :func:`splitting`, :func:`conv` and :func:`max_pool_torch` run
  on this rank's part of a split (``parallel/sharding.py``): its rows of
  the height, with halo rows from the neighbouring ranks, and its output
  channels of a conv whose weight is split.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..kernels.frozen_bn import frozen_batch_norm
from ..parallel import get_world_size

Tensor = torch.Tensor


def conv(layer: nn.Conv2d, x: Tensor, pad=None) -> Tensor:
    """Apply `layer` in the dtype of `x`, with torch-style symmetric padding,
    or `pad` = ((top, bottom), (left, right)) zeros in its place."""
    split = getattr(_SPLIT, "on", None)
    if split is not None:
        return split.conv(layer, x, pad)
    padding = layer.padding
    if pad is not None:
        (top, bottom), (left, right) = pad
        x, padding = F.pad(x, (left, right, top, bottom)), 0
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride, padding, 1, layer.groups)


def conv_layer(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    """A conv holding its parameters, padded ``(k - 1) // 2`` on both sides."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=bias)


_RECOMPUTE = threading.local()
_SPLIT = threading.local()


@contextlib.contextmanager
def splitting(split):
    """Run :func:`conv` and :func:`max_pool_torch` through `split` (an object
    with their signatures as ``conv`` and ``max_pool`` methods; None for
    none) on this thread."""
    prev = getattr(_SPLIT, "on", None)
    _SPLIT.on = split
    try:
        yield
    finally:
        _SPLIT.on = prev


@contextlib.contextmanager
def _recompute(split):
    prev = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        with splitting(split):
            yield
    finally:
        _RECOMPUTE.on = prev


def recomputing():
    """Marks a rematerialized forward (the recompute in backward of
    ``torch.utils.checkpoint``): live batch norms leave their running
    statistics alone inside it, so that a step updates them once. Made at
    the forward, it recomputes inside the split the forward ran in (the
    recompute's exchanges run in the same order on every rank)."""
    return _recompute(getattr(_SPLIT, "on", None))


class BatchNorm2d(nn.Module):
    """Batch norm with torchvision's parameter names, frozen or live.

    Frozen (the default), or live outside training mode: ``(x - mean) /
    sqrt(var + eps) * weight + bias`` on the running statistics, in f32,
    returned in the dtype of `x`; where autograd records (grad enabled, and
    `x` or the weight requiring grad), through :func:`frozen_batch_norm` with the
    ReLU fused, else through eval-mode ``F.batch_norm``. Live in training mode: the same on the
    batch's mean and biased variance over (N, H, W), computed in f32, and
    ``running = 0.9 * running + 0.1 * batch`` with the biased variance,
    flax's ``nn.BatchNorm(momentum=0.9)``. In a process group of more than
    one rank, live training normalizes with the global batch's statistics
    (:meth:`_global_batch_norm`) and the running update counts the global
    batch. :meth:`folded` gives the running map as a per-channel ``scale``
    and ``shift``, the form the fused stem takes.
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
            if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad):
                # Under autograd: one pass each way, the ReLU fused, y not
                # saved (kernels/frozen_bn.py).
                return frozen_batch_norm(x, self.weight, self.bias, self.running_mean,
                                         self.running_var, self.eps, relu)
            # Eval-mode batch_norm: f32 math on f32 statistics, one rounding
            # into x's dtype, one pass over the activation (cuDNN on the card).
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
        elif get_world_size() > 1:
            y = self._global_batch_norm(x)
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

    def _global_batch_norm(self, x: Tensor) -> Tensor:
        """Live batch norm over every rank's batch (:class:`_GlobalBatchNorm`),
        and the running update with the global batch's mean and biased
        variance, outside a rematerialized forward."""
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
        if not getattr(_RECOMPUTE, "on", False):
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
                self.num_batches_tracked.add_(1)
        return y


def _channel_sums(*ts: Tensor) -> Tensor:
    """Per-channel sums of NCHW tensors over (N, H, W), accumulated in f64
    and packed into one vector, the payload of one all-reduce."""
    return torch.cat([t.sum((0, 2, 3), dtype=torch.float64) for t in ts])


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch norm of each rank's rows with the statistics of the global batch.

    Forward: all-reduce the local per-channel ``[sum, count]`` for the mean,
    then the centred ``sum((x - mean)^2)`` for the biased variance (two
    passes, for stability). Backward: all-reduce the per-channel ``sum(dy)``
    and ``sum(dy * (x - mean))``, which every rank's input gradient needs;
    the weight and bias gradients stay this rank's (DDP averages them).
    Each rank issues these collectives per layer in the same order, the
    rematerialized forward included. Sums accumulate in f64; the
    normalization runs in f32 and returns `x`'s dtype.
    """

    @staticmethod
    def forward(ctx, x: Tensor, weight: Tensor, bias: Tensor, eps: float):
        c = x.shape[1]
        packet = torch.cat([_channel_sums(x), x.new_full((1,), x.numel() // c, dtype=torch.float64)])
        dist.all_reduce(packet)
        n = packet[c]  # a device scalar: no host sync under NCCL
        mean = (packet[:c] / n).float()
        xmu = x.float() - mean[None, :, None, None]
        var_sum = _channel_sums(xmu.square())
        dist.all_reduce(var_sum)
        var = (var_sum / n).float()
        invstd = torch.rsqrt(var + eps)
        scale = invstd * weight
        y = (xmu * scale[None, :, None, None] + bias[None, :, None, None]).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy: Tensor, _mean, _var):
        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        dy32 = dy.float()
        xmu = x.float() - mean[None, :, None, None]
        local = _channel_sums(dy32, dy32 * xmu)
        sums = local.clone()
        dist.all_reduce(sums)
        mean_dy = (sums[:c] / ctx.n).float()
        proj = (sums[c:] / ctx.n).float() * invstd * invstd
        dx = (dy32 - mean_dy[None, :, None, None] - xmu * proj[None, :, None, None]) \
            * (invstd * weight)[None, :, None, None]
        return dx.to(x.dtype), (local[c:].float() * invstd), local[:c].float(), None


def space_to_depth_2x(x: Tensor) -> Tensor:
    """NCHW [B, C, H, W] -> [B, 4C, H/2, W/2], channel order (dy, dx, c), as
    the JAX ``space_to_depth_2x`` packs its NHWC channels."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def stem_weight_to_s2d(w7: Tensor) -> Tensor:
    """[Cout, Cin, 7, 7] stride-2 stem weight -> the [Cout, 4 Cin, 4, 4]
    stride-1 weight that computes the same conv on :func:`space_to_depth_2x`
    input padded (2, 1): the OIHW form of JAX's ``stem_kernel_to_s2d``.

    With torch padding 3, ``out[i] = sum_k w[k] x[2i + k - 3]``; writing
    ``k + 1 = 2a + d`` turns it into 4 taps ``a`` over the packed input,
    with one zero tap (the 8x8 field's first row and column).
    """
    cout, cin = w7.shape[:2]
    w8 = w7.new_zeros((cout, cin, 8, 8))
    w8[:, :, 1:, 1:] = w7
    w4 = w8.reshape(cout, cin, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)  # o, dy, dx, c, a, b
    return w4.reshape(cout, 4 * cin, 4, 4)


def stem_weight_from_s2d(w4: Tensor, atol: float = 1e-6) -> Tensor:
    """Inverse of :func:`stem_weight_to_s2d`. Raises where the s2d weight has
    taps outside the 7x7 field above `atol` (they train in the s2d form and
    have no 7x7 counterpart), as JAX's ``_s2d_kernel_to_7x7`` does."""
    cout, cin4, kh, kw = w4.shape
    if (kh, kw) != (4, 4) or cin4 % 4:
        raise ValueError(f"not a space-to-depth stem weight: {tuple(w4.shape)}")
    cin = cin4 // 4
    w8 = w4.reshape(cout, 2, 2, cin, 4, 4).permute(0, 3, 4, 1, 5, 2).reshape(cout, cin, 8, 8)
    extra = max(float(w8[:, :, 0, :].abs().max()), float(w8[:, :, :, 0].abs().max()))
    if extra > atol:
        raise ValueError(
            "space-to-depth stem weight has learned taps outside the 7x7 field (max |tap| = "
            f"{extra:.3g} > atol {atol:.3g}); it is not representable in the reference's 7x7 "
            "stem schema. Retrain with stem_s2d=False or zero the out-of-field taps explicitly.")
    return w8[:, :, 1:, 1:].contiguous()


def max_pool_torch(x: Tensor, window: int, stride: int) -> Tensor:
    """Max pool with symmetric ``(window - 1) // 2`` padding (-inf padded)."""
    split = getattr(_SPLIT, "on", None)
    if split is not None:
        return split.max_pool(x, window, stride)
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


"""Frozen batch norm under autograd: the CUDA kernel pair (``csrc/frozen_bn.cu``) and its plain version.

Replaces no Pallas kernel: the JAX package leaves frozen BN to XLA's fusion.
Under PyTorch's autograd, eval-mode ``F.batch_norm`` on a channels-last bf16
activation takes a generic elementwise kernel, a strided copy back into
channels-last and a reduction for its gradients, and the ReLU after it a
pass each way of its own. Here frozen BN with an optional fused ReLU is one
``torch.autograd.Function`` whose forward and backward are one pass each:

- forward: ``y = act((x - mean) * scale + bias)`` with ``scale = weight *
  rsqrt(var + eps)``, f32 arithmetic, one rounding into x's dtype;
- backward: ``g`` is dy where the forward's y > 0 (the ReLU's mask,
  recomputed from x, so y is not saved) or dy; ``dx = g * scale`` in x's
  dtype and layout; ``dbias = sum g`` and ``dweight = sum g * (x - mean)
  * rsqrt(var + eps)`` per channel, in f32, in a fixed order.

Bound: bytes. At R-50, batch 16, 800x1344 the 53 frozen BNs see 3.81 G
elements a step: the backward moves 22.9 GB (6.8 ms at 3.35 TB/s), the
forward 15.2 GB (4.5 ms).

:func:`frozen_batch_norm` is the wrapper. For a CPU tensor the Function computes the
plain version (:func:`frozen_bn_plain`, :func:`frozen_bn_backward_plain`: the
same IEEE operations in the same order, so y and dx equal the kernels' bit
for bit); for a CUDA tensor it launches the kernels (counted in
``frozen_batch_norm.launches``, one a forward and one a backward) or raises. Each
backward adds one to the tracer's ``frozen_bn.backward`` counter.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from ..utils.metrics import count
from .build import on_device as _on, stream_handle as _stream

Tensor = torch.Tensor

_VEC_BYTES = 16  # one vector load of the kernels
_MAX_ROW_THREADS = 512  # channels-last: C / (elements a thread takes) at most


def _accumulate_dtype(x: Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _per_channel(*ts: Tensor, dtype: torch.dtype) -> Tuple[Tensor, ...]:
    return tuple(t.to(dtype)[None, :, None, None] for t in ts)


def _invstd(var: Tensor, eps: float, acc: torch.dtype) -> Tensor:
    """``rsqrt(var + eps)`` as the reciprocal of the square root, each
    rounded once (``torch.rsqrt`` on the card is an approximation)."""
    return torch.reciprocal(torch.sqrt(var.to(acc) + eps))


def frozen_bn_plain(x: Tensor, weight: Tensor, bias: Tensor, mean: Tensor, var: Tensor,
                    eps: float, relu: bool = False) -> Tensor:
    """The forward in PyTorch: ``(x - mean) * scale + bias`` in f32 (f64 for
    f64 x), ``scale = weight * rsqrt(var + eps)`` (flax's order of
    operations), rounded into x's dtype, then ``torch.relu`` when `relu`.
    Keeps x's memory format."""
    acc = _accumulate_dtype(x)
    scale, = _per_channel(weight.to(acc) * _invstd(var, eps, acc), dtype=acc)
    m, b = _per_channel(mean, bias, dtype=acc)
    y = ((x.to(acc) - m) * scale + b).to(x.dtype)
    return torch.relu(y) if relu else y


def frozen_bn_backward_plain(dy: Tensor, x: Tensor, weight: Tensor, bias: Tensor, mean: Tensor,
                             var: Tensor, eps: float, relu: bool = False
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward in PyTorch: ``(dx, dweight, dbias)``, dx in x's dtype
    and memory format, the parameter gradients in the accumulation dtype
    (f32, or f64 for f64 x). The ReLU's mask is the forward's rounded
    output ``<= 0``, as ``torch.relu``'s gradient reads it."""
    acc = _accumulate_dtype(x)
    invstd = _invstd(var, eps, acc)
    scale, = _per_channel(weight.to(acc) * invstd, dtype=acc)
    m, b = _per_channel(mean, bias, dtype=acc)
    xmu = x.to(acc) - m
    g = dy.to(acc)
    if relu:
        y = (xmu * scale + b).to(x.dtype)
        g = torch.where(y <= 0, torch.zeros((), dtype=acc, device=g.device), g)
    dx = torch.empty_like(x).copy_(g * scale)
    return dx, (g * xmu).sum((0, 2, 3)) * invstd, g.sum((0, 2, 3))


def _channels_last(x: Tensor) -> bool:
    """True for a channels-last activation, False for an NCHW-contiguous
    one; raises on any other stride pattern."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    if x.is_contiguous():
        return False
    raise ValueError(f"frozen_bn takes channels-last or NCHW-contiguous activations, got "
                     f"strides {x.stride()} for shape {tuple(x.shape)}")


def _launch_args(x: Tensor, *tensors: Tensor) -> Tuple[int, int, int, bool, int]:
    """(n, c, h * w, channels_last, vec) for the kernels: vec is the
    elements of one 16-byte load where the channel run (channels-last) or
    the plane (NCHW) is a whole number of them and every pointer is
    16-byte aligned, else 1."""
    n, c, h, w = x.shape
    cl = _channels_last(x)
    vec = _VEC_BYTES // x.element_size()
    run = c if cl else h * w
    if run % vec or any(t.data_ptr() % _VEC_BYTES for t in (x, *tensors)):
        vec = 1
    if cl and c // vec > _MAX_ROW_THREADS:
        raise ValueError(f"frozen_bn kernel takes at most {_MAX_ROW_THREADS * vec} channels "
                         f"here (channels-last {x.dtype}, {'un' if vec == 1 else ''}vectorised), "
                         f"got {c}")
    return n, c, h * w, cl, vec


@functools.lru_cache(maxsize=1024)
def _partial_rows(n: int, c: int, hw: int, cl: bool, vec: int, relu: bool, is_bf16: int,
                  device_index: int) -> int:
    """Rows of the backward's [rows, 2, C] scratch: its launch plan's
    (``frozen_bn_partial_rows``), fixed for a shape on a card."""
    from .build import bind

    fn = bind("frozen_bn", "frozen_bn_partial_rows",
              [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4,
              ctypes.c_longlong)
    rows = fn(n, c, hw, int(cl), vec, int(relu), is_bf16)
    if rows < 1:
        raise RuntimeError(f"frozen_bn backward has no launch plan for [{n}, {c}] x {hw}")
    return rows


def _launch_forward(x: Tensor, weight, bias, mean, var, eps: float, relu: bool) -> Tensor:
    from .build import bind

    fn = bind("frozen_bn", "frozen_bn_forward",
              [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    y = torch.empty_like(x)
    n, c, hw, cl, vec = _launch_args(x, y)
    with _on(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
                 var.data_ptr(), eps, n, c, hw, int(cl), vec, int(relu),
                 int(x.dtype == torch.bfloat16), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"frozen_bn forward kernel launch failed with CUDA error {err}")
    frozen_batch_norm.launches += 1
    return y


def _launch_backward(dy: Tensor, x: Tensor, weight, bias, mean, var, eps: float, relu: bool
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    from .build import bind

    fn = bind("frozen_bn", "frozen_bn_backward",
              [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6
              + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
              + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    # autograd hands the gradient in the layout its producer chose: the
    # kernel reads it in x's.
    fmt = torch.channels_last if _channels_last(x) else torch.contiguous_format
    dy = dy.contiguous(memory_format=fmt)
    dx = torch.empty_like(x)
    n, c, hw, cl, vec = _launch_args(x, dy, dx)
    is_bf16 = int(x.dtype == torch.bfloat16)
    dev = x.device
    dweight = torch.empty(c, dtype=torch.float32, device=dev)
    dbias = torch.empty(c, dtype=torch.float32, device=dev)
    with _on(dev):
        rows = _partial_rows(n, c, hw, cl, vec, relu, is_bf16, dev.index)
        partial = torch.empty((rows, 2, c), dtype=torch.float32, device=dev)
        err = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(), rows,
                 dweight.data_ptr(), dbias.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                 mean.data_ptr(), var.data_ptr(), eps, n, c, hw, int(cl), vec, int(relu),
                 is_bf16, _stream(dev))
    if err != 0:
        raise RuntimeError(f"frozen_bn backward kernel launch failed with CUDA error {err}")
    frozen_batch_norm.launches += 1
    return dx, dweight, dbias


class _FrozenBatchNorm(torch.autograd.Function):
    """Frozen BN (+ReLU) whose backward is one pass: saves x and the
    per-channel tensors, not y."""

    @staticmethod
    def forward(ctx, x: Tensor, weight: Tensor, bias: Tensor, mean: Tensor, var: Tensor,
                eps: float, relu: bool) -> Tensor:
        ctx.save_for_backward(x, weight, bias, mean, var)
        ctx.eps, ctx.relu = eps, relu
        if x.device.type == "cpu":
            return frozen_bn_plain(x, weight, bias, mean, var, eps, relu)
        return _launch_forward(x, weight, bias, mean, var, eps, relu)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy: Tensor):
        x, weight, bias, mean, var = ctx.saved_tensors
        count("frozen_bn.backward")
        if x.device.type == "cpu":
            dx, dweight, dbias = frozen_bn_backward_plain(dy, x, weight, bias, mean, var,
                                                          ctx.eps, ctx.relu)
        else:
            dx, dweight, dbias = _launch_backward(dy, x, weight, bias, mean, var, ctx.eps,
                                                  ctx.relu)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dweight if need[1] else None,
                dbias if need[2] else None, None, None, None, None)


def frozen_batch_norm(x: Tensor, weight: Tensor, bias: Tensor, running_mean: Tensor,
                      running_var: Tensor, eps: float, relu: bool = False) -> Tensor:
    """Frozen batch norm of an [N, C, H, W] activation, and its ReLU when
    `relu`, with the one-pass backward; gradients for x, weight and bias.

    On the CPU any floating dtype (f64 for ``gradcheck``); on a CUDA device
    bf16 or f32 activations, channels-last or NCHW-contiguous, with f32
    contiguous [C] parameters and statistics on the same device. Raises on
    anything else.
    """
    if x.dim() != 4:
        raise ValueError(f"frozen_bn takes [N, C, H, W], got {tuple(x.shape)}")
    c = x.shape[1]
    params = (weight, bias, running_mean, running_var)
    if any(t.shape != (c,) for t in params):
        raise ValueError(f"frozen_bn: parameters and statistics must be [{c}], got "
                         f"{[tuple(t.shape) for t in params]}")
    kind = x.device.type
    if kind == "cuda":
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"frozen_bn kernel takes bf16 or f32 activations, got {x.dtype}")
        if any(t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
               for t in params):
            raise ValueError("frozen_bn kernel takes contiguous f32 parameters and statistics "
                             "on the activation's device")
    elif kind != "cpu":
        raise ValueError(f"frozen_bn: activation on {x.device}")
    return _FrozenBatchNorm.apply(x, weight, bias, running_mean, running_var, float(eps),
                                  bool(relu))


frozen_batch_norm.launches = 0

"""The sigmoid focal loss's per-image sums under autograd: the CUDA kernel pair (``csrc/focal.cu``) and its plain version.

Replaces no Pallas kernel: the JAX package leaves the focal loss to XLA's
fusion. Under PyTorch's autograd, :func:`..ops.losses.sigmoid_focal_loss` on
f32 logits and a f32 one-hot target runs about twenty elementwise kernels
over [B, A, C] in f32 and saves their outputs for a backward of as many
more. Here the classification term of one anchor set is one
``torch.autograd.Function`` whose forward and backward are one pass each
over the logits, in their dtype, with integer labels in place of the
one-hot (the target of element (b, a, c) is ``labels[b, a] == c + 1``):

- forward: ``out[b] = sum over anchors a with matches[b, a] >= -1 of sum
  over c of focal(x[b, a, c])``, f32 arithmetic (f64 for f64 logits);
- backward: ``dx = grad[b] * d focal / dx`` on those anchors and 0 on the
  ignored ones, recomputed from the logits (nothing but the inputs is
  saved), rounded once into the logits' dtype.

The element's arithmetic is :func:`..ops.losses.sigmoid_focal_loss`'s
(``csrc/focal.cu`` writes it out): the same stable BCE, ``1 - p_t`` rounded
as the composition rounds it for a 0 / 1 target, ``(1 - p_t)^gamma`` with
gamma 0, 1 and 2 special-cased as ``torch.pow`` does, and in the backward
the modulating factor's own gradient, with autograd's conventions at 0 (the
clamp's gradient passes at ``x == 0``, ``abs``'s sign there is 0). The
sigmoid is ``1 / (1 + exp(-|x|))`` for ``x >= 0`` and ``exp(-|x|) / (1 +
exp(-|x|))`` below, sharing the BCE's exponential.

Bound: at R-50, batch 16, 800x1344, 90 classes the five levels hold 290.3 M
logits: the forward reads 0.58 GB (0.18 ms at 3.35 TB/s), the backward
reads them and writes their gradient (1.16 GB, 0.35 ms).

:func:`focal_loss_sums` is the wrapper. For a CPU tensor the Function
computes the plain version (:func:`focal_loss_sums_plain`,
:func:`focal_loss_backward_plain`: the kernels' IEEE operations in the same
order, through ATen; the sums differ by their order of addition); for a
CUDA tensor it launches the kernels (counted in
``focal_loss_sums.launches``, one a forward and one a backward) or raises.
Each backward adds one to the tracer's ``focal.backward`` counter.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from ..utils.metrics import count
from .build import bind, on_device as _on, stream_handle as _stream

Tensor = torch.Tensor

_VEC_BYTES = 16  # one vector load of the kernels


def _accumulate_dtype(x: Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _gamma_mode(gamma: float) -> int:
    """0, 1, 2 where ``torch.pow`` special-cases gamma (and the kernels
    with it), 3 for any other gamma."""
    return {0.0: 0, 1.0: 1, 2.0: 2}.get(float(gamma), 3)


def _modulating(u: Tensor, gamma: float) -> Tensor:
    mode = _gamma_mode(gamma)
    if mode == 0:
        return torch.ones_like(u)
    if mode == 1:
        return u
    if mode == 2:
        return u * u
    return torch.pow(u, gamma)


def _modulating_grad(u: Tensor, gamma: float) -> Tensor:
    mode = _gamma_mode(gamma)
    if mode == 0:
        return torch.zeros_like(u)
    if mode == 1:
        return torch.ones_like(u)
    if mode == 2:
        return 2.0 * u
    return gamma * torch.pow(u, gamma - 1.0)


def _terms(x: Tensor, labels: Tensor, alpha: float):
    """(t, er, p, q, bce, u, alpha_t) of every element of x ([B, A, C] in
    the accumulation dtype): the terms the loss and its gradient share."""
    c = x.shape[-1]
    t = labels[..., None] == torch.arange(1, c + 1, dtype=labels.dtype, device=labels.device)
    e = torch.exp(-x.abs())
    r = torch.reciprocal(1.0 + e)
    er = e * r
    p = torch.where(x >= 0, r, er)
    relu = torch.clamp(x, min=0.0)
    bce = torch.where(t, relu - x, relu) + torch.log1p(e)
    q = 1.0 - p
    u = torch.where(t, q, 1.0 - q)
    consts = torch.tensor([1.0 - alpha, alpha], dtype=x.dtype, device=x.device)
    return t, er, p, q, bce, u, consts[t.long()]


def focal_loss_sums_plain(logits: Tensor, labels: Tensor, matches: Tensor, alpha: float,
                          gamma: float) -> Tensor:
    """The forward in PyTorch: per-image sums [B] in f32 (f64 for f64
    logits) over the anchors with ``matches >= -1``."""
    x = logits.to(_accumulate_dtype(logits))
    _, _, _, _, bce, u, a = _terms(x, labels, alpha)
    per_anchor = ((a * _modulating(u, gamma)) * bce).sum(dim=-1)
    return torch.where(matches >= -1, per_anchor, torch.zeros((), dtype=x.dtype,
                                                              device=x.device)).sum(dim=1)


def focal_loss_backward_plain(grad: Tensor, logits: Tensor, labels: Tensor, matches: Tensor,
                              alpha: float, gamma: float) -> Tensor:
    """The backward in PyTorch: dx in the logits' dtype, ``grad[b]`` times
    the element's derivative on the anchors with ``matches >= -1``, 0 on
    the others."""
    x = logits.to(_accumulate_dtype(logits))
    t, er, p, q, bce, u, a = _terms(x, labels, alpha)
    step = (x >= 0).to(x.dtype)
    dbce = (step - t.to(x.dtype)) - torch.sign(x) * er
    sp = q * p
    du = torch.where(t, -sp, sp)
    dm = (_modulating_grad(u, gamma) * du) * bce
    dldx = a * (dm + _modulating(u, gamma) * dbce)
    g = grad.to(x.dtype)[:, None, None]
    dx = torch.where((matches >= -1)[..., None], g * dldx,
                     torch.zeros((), dtype=x.dtype, device=x.device))
    return dx.to(logits.dtype)


def _launch_args(x: Tensor, *tensors: Tensor) -> Tuple[int, int, int, int, int]:
    """(B, A, C, vec, is_bf16) for the kernels: vec is the elements of one
    16-byte load where every pointer is 16-byte aligned, else 1."""
    b, a, c = x.shape
    vec = _VEC_BYTES // x.element_size()
    if any(t.data_ptr() % _VEC_BYTES for t in (x, *tensors)):
        vec = 1
    return b, a, c, vec, int(x.dtype == torch.bfloat16)


def _constants(alpha: float, gamma: float) -> Tuple[float, float, float, float, int]:
    """alpha, 1 - alpha, gamma, gamma - 1 (each computed in double and
    rounded to f32 at the call, as ATen rounds a Python scalar), mode."""
    return float(alpha), 1.0 - float(alpha), float(gamma), float(gamma) - 1.0, _gamma_mode(gamma)


@functools.lru_cache(maxsize=1024)
def _blocks(b: int, a: int, c: int, vec: int, mode: int, is_bf16: int, device_index: int) -> int:
    """Blocks per image of the forward's [B, blocks] scratch: its launch
    plan's (``focal_blocks``), fixed for a shape on a card."""
    fn = bind("focal", "focal_blocks", [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 4,
              ctypes.c_longlong)
    blocks = fn(b, a, c, vec, mode, is_bf16)
    if blocks < 1:
        raise RuntimeError(f"focal forward has no launch plan for [{b}, {a}, {c}]")
    return blocks


def _launch_forward(x: Tensor, labels: Tensor, matches: Tensor, alpha: float,
                    gamma: float) -> Tensor:
    fn = bind("focal", "focal_forward",
              [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                                       ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 4
              + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    b, a, c, vec, is_bf16 = _launch_args(x)
    consts = _constants(alpha, gamma)
    dev = x.device
    if x.numel() == 0:
        return torch.zeros(b, dtype=torch.float32, device=dev)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    with _on(dev):
        blocks = _blocks(b, a, c, vec, consts[-1], is_bf16, dev.index)
        partial = torch.empty((b, blocks), dtype=torch.float32, device=dev)
        err = fn(x.data_ptr(), labels.data_ptr(), matches.data_ptr(), partial.data_ptr(), blocks,
                 out.data_ptr(), b, a, c, *consts, vec, is_bf16, _stream(dev))
    if err != 0:
        raise RuntimeError(f"focal forward kernel launch failed with CUDA error {err}")
    focal_loss_sums.launches += 1
    return out


def _launch_backward(grad: Tensor, x: Tensor, labels: Tensor, matches: Tensor, alpha: float,
                     gamma: float) -> Tensor:
    fn = bind("focal", "focal_backward",
              [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
              + [ctypes.c_float] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    grad = grad.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    b, a, c, vec, is_bf16 = _launch_args(x, dx)
    dev = x.device
    with _on(dev):
        err = fn(x.data_ptr(), labels.data_ptr(), matches.data_ptr(), grad.data_ptr(),
                 dx.data_ptr(), b, a, c, *_constants(alpha, gamma), vec, is_bf16, _stream(dev))
    if err != 0:
        raise RuntimeError(f"focal backward kernel launch failed with CUDA error {err}")
    focal_loss_sums.launches += 1
    return dx


class _FocalLossSums(torch.autograd.Function):
    """Per-image focal sums whose backward is one pass: saves the logits,
    labels and matches, no f32 intermediate."""

    @staticmethod
    def forward(ctx, logits: Tensor, labels: Tensor, matches: Tensor, alpha: float,
                gamma: float) -> Tensor:
        ctx.save_for_backward(logits, labels, matches)
        ctx.alpha, ctx.gamma = alpha, gamma
        if logits.device.type == "cpu":
            return focal_loss_sums_plain(logits, labels, matches, alpha, gamma)
        return _launch_forward(logits, labels, matches, alpha, gamma)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: Tensor):
        logits, labels, matches = ctx.saved_tensors
        count("focal.backward")
        if logits.device.type == "cpu":
            dx = focal_loss_backward_plain(grad, logits, labels, matches, ctx.alpha, ctx.gamma)
        else:
            dx = _launch_backward(grad, logits, labels, matches, ctx.alpha, ctx.gamma)
        return dx, None, None, None, None


def focal_loss_sums(logits: Tensor, labels: Tensor, matches: Tensor, alpha: float,
                    gamma: float) -> Tensor:
    """Per-image sums [B] of the sigmoid focal loss of [B, A, C] logits
    against integer labels ([B, A], 1..C foreground, 0 background) over the
    anchors whose ``matches`` ([B, A], the match's -1 background / -2
    ignored / row index) is at least -1; gradient for the logits.

    On the CPU any floating dtype (f64 for ``gradcheck``); on a CUDA device
    the kernels take bf16 or f32 logits (another floating dtype is cast to
    f32 first, as the composition before them cast every dtype) with labels
    and matches on the same device. The sums are f32 (f64 for f64 logits on
    the CPU). Raises on anything else.
    """
    if logits.dim() != 3 or labels.shape != logits.shape[:2] or matches.shape != logits.shape[:2]:
        raise ValueError(f"focal_loss_sums takes logits [B, A, C] with labels and matches [B, A], "
                         f"got {tuple(logits.shape)}, {tuple(labels.shape)}, "
                         f"{tuple(matches.shape)}")
    kind = logits.device.type
    if kind == "cuda":
        if not logits.is_floating_point():
            raise TypeError(f"focal_loss_sums takes floating logits, got {logits.dtype}")
        if logits.dtype not in (torch.bfloat16, torch.float32):
            logits = logits.float()
        if labels.device != logits.device or matches.device != logits.device:
            raise ValueError("focal kernel takes labels and matches on the logits' device")
        if logits.shape[0] > 65535:
            raise ValueError(f"focal kernel takes at most 65535 images, got {logits.shape[0]}")
        logits = logits.contiguous()
        labels, matches = (t.to(torch.int32).contiguous() for t in (labels, matches))
    elif kind != "cpu":
        raise ValueError(f"focal_loss_sums: logits on {logits.device}")
    return _FocalLossSums.apply(logits, labels, matches, float(alpha), float(gamma))


focal_loss_sums.launches = 0

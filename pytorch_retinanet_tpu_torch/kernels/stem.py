"""Fused ResNet stem: the CUDA kernel (``csrc/stem.cu``) and its plain version.

Replaces ``pytorch_retinanet_tpu/kernels/stem_pallas.py::fused_stem``:
7x7 stride-2 conv (pad 3, 3 -> 64) on the normalized image -> folded frozen
BN -> ReLU -> 3x3 stride-2 max pool (pad 1), NHWC in and out. This first
version is bound by operations (f32 multiply-adds on the CUDA cores); the
source's header note gives the numbers and the design.

:func:`stem_forward` is the wrapper: for a CPU tensor it computes the plain
version, for a CUDA tensor it launches the kernel (and counts the launch in
``stem_forward.launches``) or raises. Its gradient recomputes through the
plain version, as the TPU kernel's custom VJP does.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def stem_supported(image_shape: Sequence[int]) -> bool:
    """Shapes the kernel takes: NHWC with 3 channels, H % 32 == 0, W % 4 == 0."""
    if len(image_shape) != 4:
        return False
    _, h, w, c = image_shape
    return c == 3 and h % 32 == 0 and w % 4 == 0


def stem_plain(x_norm: Tensor, w_oihw: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """The stem in plain PyTorch, with the kernel's rounding points.

    f32 conv of the bf16-rounded image and weights, ``y * scale + bias`` and
    ReLU in f32, a bf16 cast, then the 3x3 stride-2 max pool. [B, H, W, 3]
    f32 -> [B, H/4, W/4, 64] bf16, both NHWC and contiguous.
    """
    x = x_norm.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    w = w_oihw.to(torch.bfloat16).float()
    y = F.conv2d(x, w, stride=2, padding=3)
    y = torch.relu(y * scale.float()[:, None, None] + bias.float()[:, None, None])
    y = F.max_pool2d(y.to(torch.bfloat16), kernel_size=3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _launch(x_norm: Tensor, w_oihw: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    from .build import load

    lib = load("stem")
    fn = lib.stem_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, h, w, _ = x_norm.shape
    x = x_norm.contiguous()
    # [64, 3, 7, 7] -> [7, 7, 3, 64], values rounded to bf16 like the input.
    wk = w_oihw.detach().to(torch.bfloat16).float().permute(2, 3, 1, 0).contiguous()
    sc = scale.detach().float().contiguous()
    bi = bias.detach().float().contiguous()
    out = torch.empty((b, h // 4, w // 4, 64), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), wk.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(),
                 b, h, w, stream)
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed with CUDA error {err}")
    stem_forward.launches += 1
    return out


class _FusedStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_norm, w_oihw, scale, bias):
        ctx.save_for_backward(x_norm, w_oihw, scale, bias)
        return _launch(x_norm, w_oihw, scale, bias)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = stem_plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, grad) if wanted else [])
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def stem_forward(x_norm: Tensor, w_oihw: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """Fused stem on a normalized NHWC image.

    Args:
      x_norm: [B, H, W, 3] f32, already normalized; H % 32 == 0, W % 4 == 0.
      w_oihw: [64, 3, 7, 7] stem conv weight.
      scale, bias: [64] frozen BN folded into ``y * scale + bias``.

    Returns:
      [B, H/4, W/4, 64] bf16 NHWC.
    """
    if not stem_supported(x_norm.shape):
        raise ValueError(f"fused stem takes [B, H, W, 3] with H % 32 == 0 and W % 4 == 0, "
                         f"got {tuple(x_norm.shape)}")
    if tuple(w_oihw.shape) != (64, 3, 7, 7) or scale.shape != (64,) or bias.shape != (64,):
        raise ValueError(f"fused stem weight/scale/bias shapes {tuple(w_oihw.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    if x_norm.device.type == "cpu":
        return stem_plain(x_norm, w_oihw, scale, bias)
    if x_norm.device.type != "cuda" or any(t.device != x_norm.device for t in (w_oihw, scale, bias)):
        raise ValueError("fused stem: every input must lie on the same CUDA device")
    if x_norm.dtype != torch.float32:
        raise TypeError(f"fused stem takes a float32 image, got {x_norm.dtype}")
    return _FusedStem.apply(x_norm, w_oihw, scale, bias)


stem_forward.launches = 0

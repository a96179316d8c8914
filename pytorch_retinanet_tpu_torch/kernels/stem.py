"""Fused ResNet stem: the CUDA kernel (``csrc/stem.cu``) and its plain version.

Replaces ``pytorch_retinanet_tpu/kernels/stem_pallas.py::fused_stem``:
normalize -> 7x7 stride-2 conv (pad 3, 3 -> 64) -> folded frozen BN ->
ReLU -> 3x3 stride-2 max pool (pad 1), NHWC in and out, from uint8 or f32
images. The kernel runs the conv as an implicit GEMM on the tensor cores;
the source's header note gives the bound and the design.

:func:`stem_forward` is the wrapper: it checks its arguments and calls the
custom op ``torch.ops.retinanet_torch.stem_forward``, which computes the
plain version for a CPU tensor and, for a CUDA tensor, launches the kernel
(counting the launch in ``stem_forward.launches``) or raises. Graphs that
``torch.export`` records keep the op, so a loaded artifact launches the
kernel through the same count. Its gradient recomputes through the plain
version, as the TPU kernel's custom VJP does.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Constants = Union[Tensor, Sequence[float]]

# K of the implicit GEMM: 7 kernel rows of 24 (21 taps x channels, 3 zero
# slots), padded to 11 steps of 16.
K_ROW, K_STEPS = 24, 11


def stem_supported(image_shape: Sequence[int]) -> bool:
    """Shapes the kernel takes: NHWC with 3 channels, H % 32 == 0, W % 4 == 0."""
    if len(image_shape) != 4:
        return False
    _, h, w, c = image_shape
    return c == 3 and h % 32 == 0 and w % 4 == 0


def _constants(mean: Constants, std: Constants, device) -> tuple:
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(std, dtype=torch.float32, device=device)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError(f"fused stem takes 3 means and 3 stds, got {tuple(mean.shape)}, "
                         f"{tuple(std.shape)}")
    return mean, std


def stem_plain(images: Tensor, mean: Constants, std: Constants, w_oihw: Tensor, scale: Tensor,
               bias: Tensor) -> Tensor:
    """The stem in plain PyTorch, with the kernel's rounding points.

    ``(float(images) - mean) / std`` in f32 rounded to bf16, an f32 conv of
    that and the bf16-rounded weights (zero padding in normalized space),
    ``y * scale + bias`` and ReLU in f32, a bf16 cast, then the 3x3 stride-2
    max pool. [B, H, W, 3] uint8 or f32 -> [B, H/4, W/4, 64] bf16, both NHWC
    and contiguous. For uint8 images pass the constants with /255 folded in
    (mean * 255, std * 255), as ``apply_detector`` does.
    """
    mean, std = _constants(mean, std, images.device)
    x = ((images.float() - mean) / std).to(torch.bfloat16).float().permute(0, 3, 1, 2)
    w = w_oihw.to(torch.bfloat16).float()
    y = F.conv2d(x, w, stride=2, padding=3)
    y = torch.relu(y * scale.float()[:, None, None] + bias.float()[:, None, None])
    y = F.max_pool2d(y.to(torch.bfloat16), kernel_size=3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def stem_gemm_weights(w_oihw: Tensor) -> Tensor:
    """[64, 3, 7, 7] -> the kernel's B operand [176, 64] bf16.

    Row ``24 ky + 3 kx + c`` holds ``w[:, c, ky, kx]``: for kernel row ky the
    21 (kx, c) taps in NHWC order, then 3 zero rows; rows 168-175 are zero.
    """
    w = w_oihw.detach().to(torch.bfloat16).permute(2, 3, 1, 0).reshape(7, 21, 64)
    w = F.pad(w, (0, 0, 0, K_ROW - 21)).reshape(7 * K_ROW, 64)
    return F.pad(w, (0, 0, 0, 16 * K_STEPS - 7 * K_ROW))


def pack_stem_weights(w_oihw: Tensor) -> Tensor:
    """The B operand as ``wgmma`` reads it from shared memory, [3, 64, 64] bf16.

    K (176, padded to 192) is cut into 3 chunks of 64; chunk kc holds 64 rows,
    one per output channel n, of its 64 K values (128 bytes), K-major, with
    the 128-byte swizzle: the 8-value group j of row n sits at group
    ``j ^ (n % 8)``. So ``[kc, n, 8 (j ^ (n % 8)) + i]`` is B[64 kc + 8 j + i, n].
    """
    b = F.pad(stem_gemm_weights(w_oihw), (0, 0, 0, 3 * 64 - 16 * K_STEPS))  # [192, 64]
    b = b.t().reshape(64, 3, 8, 8).permute(1, 0, 2, 3)  # [kc, n, j, i]
    n = torch.arange(64, device=b.device)
    swz = torch.arange(8, device=b.device)[None, :] ^ (n % 8)[:, None]  # group stored at j
    return b[:, n[:, None], swz].reshape(3, 64, 64).contiguous()


def _launch(images: Tensor, mean: List[float], std: List[float], w_oihw: Tensor, scale: Tensor,
            bias: Tensor) -> Tensor:
    """The op's CUDA implementation: one launch of ``csrc/stem.cu``."""
    from .build import bind

    fn = bind("stem", "stem_forward",
              [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_float] * 6 + [ctypes.c_void_p] * 4
              + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    b, h, w, _ = images.shape
    x = images.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    wp = pack_stem_weights(w_oihw)
    sc = scale.detach().float().contiguous()
    bi = bias.detach().float().contiguous()
    out = torch.empty((b, h // 4, w // 4, 64), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), int(x.dtype == torch.uint8), *mean, *std,
                 wp.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(), b, h, w, stream)
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed with CUDA error {err}")
    stem_forward.launches += 1
    stem_forward.last_dtype = x.dtype
    return out


# The op that graphs (``torch.export``) record: its CPU implementation is the
# plain version, its CUDA one the kernel; the fake one gives the shape.
@torch.library.custom_op("retinanet_torch::stem_forward", mutates_args=(), device_types="cpu")
def _stem_op(images: Tensor, mean: List[float], std: List[float], w_oihw: Tensor, scale: Tensor,
             bias: Tensor) -> Tensor:
    return stem_plain(images, mean, std, w_oihw, scale, bias)


_stem_op.register_kernel("cuda")(_launch)


@_stem_op.register_fake
def _stem_fake(images, mean, std, w_oihw, scale, bias):
    b, h, w, _ = images.shape
    return images.new_empty((b, h // 4, w // 4, 64), dtype=torch.bfloat16)


def _stem_setup_context(ctx, inputs, output):
    images, mean, std, w_oihw, scale, bias = inputs
    ctx.save_for_backward(images, w_oihw, scale, bias)
    ctx.constants = (mean, std)


def _stem_backward(ctx, grad):
    """Recompute through the plain version, as the TPU kernel's custom VJP does."""
    needs = [ctx.needs_input_grad[i] for i in (0, 3, 4, 5)]
    images, w_oihw, scale, bias = (t.detach().requires_grad_(need)
                                   for t, need in zip(ctx.saved_tensors, needs))
    with torch.enable_grad():
        y = stem_plain(images, *ctx.constants, w_oihw, scale, bias)
    wanted = [t for t in (images, w_oihw, scale, bias) if t.requires_grad]
    grads = iter(torch.autograd.grad(y, wanted, grad) if wanted else [])
    gi, gw, gs, gb = (next(grads) if t.requires_grad else None
                      for t in (images, w_oihw, scale, bias))
    return gi, None, None, gw, gs, gb


_stem_op.register_autograd(_stem_backward, setup_context=_stem_setup_context)


def _constant_list(c: Constants) -> List[float]:
    return [float(v) for v in (c.tolist() if isinstance(c, Tensor) else c)]


def stem_forward(images: Tensor, mean: Constants, std: Constants, w_oihw: Tensor, scale: Tensor,
                 bias: Tensor) -> Tensor:
    """Fused stem on a raw NHWC image, normalized inside the kernel.

    Args:
      images: [B, H, W, 3] uint8 or f32; H % 32 == 0, W % 4 == 0.
      mean, std: 3 per-channel constants (tensors or floats); for uint8
        images with /255 folded in (mean * 255, std * 255).
      w_oihw: [64, 3, 7, 7] stem conv weight.
      scale, bias: [64] frozen BN folded into ``y * scale + bias``.

    Returns:
      [B, H/4, W/4, 64] bf16 NHWC. A uint8 image gets no gradient.
    """
    if not stem_supported(images.shape):
        raise ValueError(f"fused stem takes [B, H, W, 3] with H % 32 == 0 and W % 4 == 0, "
                         f"got {tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"fused stem takes uint8 or float32 images, got {images.dtype}")
    if tuple(w_oihw.shape) != (64, 3, 7, 7) or scale.shape != (64,) or bias.shape != (64,):
        raise ValueError(f"fused stem weight/scale/bias shapes {tuple(w_oihw.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    # The constants reach the kernel by value, so they travel as floats.
    mean, std = _constant_list(mean), _constant_list(std)
    if len(mean) != 3 or len(std) != 3:
        raise ValueError(f"fused stem takes 3 means and 3 stds, got ({len(mean)},), ({len(std)},)")
    kind = images.device.type
    if kind not in ("cpu", "cuda") or (
            kind == "cuda" and any(t.device != images.device for t in (w_oihw, scale, bias))):
        raise ValueError("fused stem: every input must lie on the same CUDA device")
    return torch.ops.retinanet_torch.stem_forward(images, mean, std, w_oihw, scale, bias)


stem_forward.launches = 0
stem_forward.last_dtype = None

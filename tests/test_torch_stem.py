"""Fused stem of the PyTorch port vs the JAX package (CPU).

``stem_plain`` (what ``stem_forward`` computes for CPU tensors) is held
against the Pallas kernel ``_fused_stem`` run in interpret mode, against
JAX's ``fused_stem`` (which normalizes raw uint8 or f32 images first, in
interpret mode) and against ``stem_reference_xla``, on the same numpy inputs.
The packed weights the CUDA kernel reads are checked here on the CPU.

Tolerances, per output element, with ``ulp(v)`` the bf16 spacing at |v|:
* against the Pallas kernel, which has the same rounding points: within
  1 bf16 ulp of the larger value (+1e-6), since the f32 sums run in another
  order and can round to the neighbouring bf16 value;
* against ``stem_reference_xla``, which also rounds the conv output to bf16
  before BN: that rounding's half ulp of the conv value times |scale| on top.

The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_retinanet_tpu.kernels.stem_pallas import _fused_stem, fused_stem, stem_reference_xla
from pytorch_retinanet_tpu_torch.config import MEAN, STD
from pytorch_retinanet_tpu_torch.kernels import (
    pack_stem_weights,
    stem_forward,
    stem_gemm_weights,
    stem_plain,
    stem_supported,
)

IDENTITY = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))  # already normalized inputs


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def _inputs(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, 3)) * 1.5).astype(np.float32)
    w_oihw = (rng.standard_normal((64, 3, 7, 7)) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.normal(0, 0.3, 64).astype(np.float32)
    return x, w_oihw, scale, bias


def _port(x, w_oihw, scale, bias, mean=IDENTITY[0], std=IDENTITY[1]):
    x, w_oihw, scale, bias = (torch.from_numpy(a) for a in (x, w_oihw, scale, bias))
    out = stem_forward(x, mean, std, w_oihw, scale, bias)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


def _jax_args(x, w_oihw, scale, bias):
    return jnp.asarray(x), jnp.asarray(w_oihw.transpose(2, 3, 1, 0)), jnp.asarray(scale), jnp.asarray(bias)


def _assert_within_one_ulp(got, ref):
    tol = bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + 1e-6
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("hw", [(64, 96), (96, 64)])
def test_stem_plain_matches_pallas_interpret(hw):
    args = _inputs(2, *hw)
    got = _port(*args)
    ref = np.asarray(_fused_stem(*_jax_args(*args), True), np.float32)
    assert got.shape == ref.shape == (2, hw[0] // 4, hw[1] // 4, 64)
    _assert_within_one_ulp(got, ref)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64)])
def test_stem_plain_matches_xla_reference(hw):
    x, w_oihw, scale, bias = _inputs(2, *hw, seed=1)
    got = _port(x, w_oihw, scale, bias)
    jargs = _jax_args(x, w_oihw, scale, bias)
    ref = np.asarray(stem_reference_xla(*jargs), np.float32)
    # Largest conv value any pooled output reads bounds the extra rounding.
    conv = jax.lax.conv_general_dilated(
        jargs[0], jargs[1], (2, 2), [(3, 3), (3, 3)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    conv_max = float(jnp.abs(conv).max())
    tol = bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + 0.5 * bf16_ulp(conv_max) * scale.max()
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()
    # About three quarters agree exactly; the rest differ by that extra rounding.
    assert (got == ref).mean() > 0.5


def _stem_variables(w_oihw, scale, bias):
    """JAX stem variables whose folded BN is (scale, bias) up to f32 rounding;
    returns them and the exact fold ``fused_stem`` computes from them."""
    var = np.full(64, 1.0 - 1e-5, np.float32)
    variables = {
        "params": {"stem_conv": {"kernel": jnp.asarray(w_oihw.transpose(2, 3, 1, 0))},
                   "stem_bn": {"BatchNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}},
        "batch_stats": {"stem_bn": {"BatchNorm_0": {"mean": jnp.zeros(64), "var": jnp.asarray(var)}}},
    }
    s = jnp.asarray(scale) / jnp.sqrt(jnp.asarray(var) + 1e-5)
    return variables, np.array(s, np.float32), bias  # running mean 0: the bias folds to itself


@pytest.mark.parametrize("dtype,hw", [("uint8", (64, 96)), ("uint8", (96, 64)), ("float32", (64, 96)),
                                      ("float32", (32, 36))])
def test_stem_plain_normalizes_raw_images_like_jax_fused_stem(dtype, hw):
    """Raw images through the stem, normalize included: uint8 with /255
    folded into the constants (as both packages' ``apply_detector`` fold
    them), and f32 in [0, 1] with the plain constants."""
    rng = np.random.default_rng(4)
    _, w_oihw, scale, bias = _inputs(1, *hw, seed=5)
    if dtype == "uint8":
        images = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
        mean, std = tuple(m * 255.0 for m in MEAN), tuple(s * 255.0 for s in STD)
    else:
        images = rng.random((2, *hw, 3), dtype=np.float32)
        mean, std = MEAN, STD
    variables, s, b = _stem_variables(w_oihw, scale, bias)
    got = _port(images, w_oihw, s, b, mean, std)
    ref = np.asarray(fused_stem(variables, jnp.asarray(images), mean=mean, std=std, interpret=True),
                     np.float32)
    assert got.shape == ref.shape == (2, hw[0] // 4, hw[1] // 4, 64)
    _assert_within_one_ulp(got, ref)
    # The normalize is the same f32 arithmetic on both sides.
    x_jax = (jnp.asarray(images).astype(jnp.float32) - jnp.asarray(mean, jnp.float32)) / jnp.asarray(
        std, jnp.float32)
    x_port = (torch.from_numpy(images).float() - torch.tensor(mean)) / torch.tensor(std)
    np.testing.assert_array_equal(x_port.numpy(), np.asarray(x_jax))
    ref_xla = np.asarray(stem_reference_xla(x_jax, *_jax_args(images, w_oihw, s, b)[1:]), np.float32)
    assert (got == ref_xla).mean() > 0.5


def test_stem_shape_guard():
    assert stem_supported((2, 64, 96, 3))
    assert not stem_supported((2, 48, 96, 3))  # h % 32
    assert not stem_supported((2, 64, 94, 3))  # w % 4
    assert not stem_supported((2, 64, 96, 4))
    x, w_oihw, scale, bias = (torch.from_numpy(a) for a in _inputs(1, 48, 96))
    with pytest.raises(ValueError):
        stem_forward(x, *IDENTITY, w_oihw, scale, bias)


def test_stem_forward_raises_on_what_the_kernel_cannot_take():
    x, w_oihw, scale, bias = (torch.from_numpy(a) for a in _inputs(1, 32, 32))
    with pytest.raises(TypeError):
        stem_forward(x.double(), *IDENTITY, w_oihw, scale, bias)
    with pytest.raises(TypeError):
        stem_forward(x.to(torch.int32), *IDENTITY, w_oihw, scale, bias)
    with pytest.raises(ValueError):
        stem_forward(x, *IDENTITY, w_oihw[:, :, :5, :5], scale, bias)
    with pytest.raises(ValueError):
        stem_forward(x, (0.0, 0.0), (1.0, 1.0), w_oihw, scale, bias)
    with pytest.raises(ValueError, match="CUDA device"):
        stem_forward(x.to("meta"), *IDENTITY, w_oihw, scale, bias)


def test_stem_forward_on_cpu_is_plain_and_differentiable():
    x, w_oihw, scale, bias = (torch.from_numpy(a) for a in _inputs(1, 32, 32))
    w_oihw.requires_grad_(True)
    x.requires_grad_(True)
    out = stem_forward(x, *IDENTITY, w_oihw, scale, bias)
    torch.testing.assert_close(out, stem_plain(x, *IDENTITY, w_oihw, scale, bias), rtol=0, atol=0)
    out.float().sum().backward()
    assert w_oihw.grad is not None and torch.isfinite(w_oihw.grad).all()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_stem_forward_on_uint8_images_equals_scaled_floats():
    """uint8 with the constants times 255 normalizes to the same f32 values
    as the f32 image v / 255 would with the plain constants, up to the f32
    rounding of the two divisions; the stem outputs agree within 1 ulp."""
    raw = np.random.default_rng(6).integers(0, 256, (1, 32, 64, 3), dtype=np.uint8)
    _, w_oihw, scale, bias = _inputs(1, 32, 64, seed=7)
    got = _port(raw, w_oihw, scale, bias, tuple(m * 255.0 for m in MEAN), tuple(s * 255.0 for s in STD))
    want = _port(raw.astype(np.float32) / 255.0, w_oihw, scale, bias, MEAN, STD)
    _assert_within_one_ulp(got, want)


def test_stem_gemm_weights_compute_the_conv():
    """The kernel's implicit GEMM: conv pixel (i, j) reads, for kernel row
    ky, the 24 contiguous NHWC elements of input row 2i + ky - 3 from
    element 3 (2j - 3); times the [176, 64] B operand this is the conv."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 16, 20, 3)).astype(np.float32)).to(torch.bfloat16)
    w_oihw = torch.from_numpy((rng.standard_normal((64, 3, 7, 7)) * 0.05).astype(np.float32))
    b = stem_gemm_weights(w_oihw).float()
    assert b.shape == (176, 64) and not b[168:].any()
    assert not b.reshape(-1)[:168 * 64].reshape(7, 24, 64)[:, 21:].any()
    rows = F.pad(x.float()[0].reshape(16, 60), (9, 15, 3, 3))  # 3 pixels of zeros each side
    a = torch.stack([torch.stack([rows[2 * i + ky, 6 * j: 6 * j + 24] for ky in range(7)]).reshape(168)
                     for i in range(8) for j in range(10)])
    got = F.pad(a, (0, 8)) @ b
    want = F.conv2d(x.float().permute(0, 3, 1, 2), w_oihw.to(torch.bfloat16).float(), stride=2, padding=3)
    torch.testing.assert_close(got.reshape(8, 10, 64), want[0].permute(1, 2, 0), rtol=1e-5, atol=1e-5)


def test_packed_stem_weights_are_the_swizzled_wgmma_b_operand():
    """[kc, n, 8 (j ^ (n % 8)) + i] is B[64 kc + 8 j + i, n] (0 past K = 176):
    K-major rows of 64 with the 128-byte swizzle, as the kernel's wgmma
    descriptor reads them from shared memory."""
    w_oihw = torch.randn((64, 3, 7, 7), generator=torch.Generator().manual_seed(9))
    b = F.pad(stem_gemm_weights(w_oihw), (0, 0, 0, 16))
    packed = pack_stem_weights(w_oihw)
    assert packed.shape == (3, 64, 64) and packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() * 2 == 24576  # the kernel's shared-memory copy
    want = torch.empty_like(packed)
    for kc in range(3):
        for n in range(64):
            for j in range(8):
                want[kc, n, 8 * (j ^ (n % 8)): 8 * (j ^ (n % 8)) + 8] = b[64 * kc + 8 * j: 64 * kc + 8 * j + 8, n]
    assert torch.equal(packed, want)

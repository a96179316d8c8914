"""Fused stem of the PyTorch port vs the JAX package (CPU).

``stem_plain`` (what ``stem_forward`` computes for CPU tensors) is held
against the Pallas kernel ``_fused_stem`` run in interpret mode and against
``stem_reference_xla``, on the same numpy inputs.

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

from pytorch_retinanet_tpu.kernels.stem_pallas import _fused_stem, stem_reference_xla
from pytorch_retinanet_tpu_torch.kernels import stem_forward, stem_plain, stem_supported


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


def _port(x, w_oihw, scale, bias):
    out = stem_forward(*(torch.from_numpy(a) for a in (x, w_oihw, scale, bias)))
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


def _jax_args(x, w_oihw, scale, bias):
    return jnp.asarray(x), jnp.asarray(w_oihw.transpose(2, 3, 1, 0)), jnp.asarray(scale), jnp.asarray(bias)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64)])
def test_stem_plain_matches_pallas_interpret(hw):
    args = _inputs(2, *hw)
    got = _port(*args)
    ref = np.asarray(_fused_stem(*_jax_args(*args), True), np.float32)
    assert got.shape == ref.shape == (2, hw[0] // 4, hw[1] // 4, 64)
    tol = bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + 1e-6
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


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


def test_stem_shape_guard():
    assert stem_supported((2, 64, 96, 3))
    assert not stem_supported((2, 48, 96, 3))  # h % 32
    assert not stem_supported((2, 64, 94, 3))  # w % 4
    assert not stem_supported((2, 64, 96, 4))
    x, w_oihw, scale, bias = (torch.from_numpy(a) for a in _inputs(1, 48, 96))
    with pytest.raises(ValueError):
        stem_forward(x, w_oihw, scale, bias)


def test_stem_forward_on_cpu_is_plain_and_differentiable():
    x, w_oihw, scale, bias = (torch.from_numpy(a) for a in _inputs(1, 32, 32))
    w_oihw.requires_grad_(True)
    out = stem_forward(x, w_oihw, scale, bias)
    torch.testing.assert_close(out, stem_plain(x, w_oihw, scale, bias), rtol=0, atol=0)
    out.float().sum().backward()
    assert w_oihw.grad is not None and torch.isfinite(w_oihw.grad).all()

"""Detector network of the PyTorch port vs the JAX package (CPU).

Random JAX ``RetinaNetModule`` variables (random BN statistics and biases
too, so every converted tensor matters) are carried into the port with
``from_jax_variables`` and ``load_state_dict(strict=True)``; the same
numpy images go through JAX ``apply_detector(return_levels=True)`` and the
port's ``apply_detector``, per level.

Tolerances on the per-level logits and deltas:
* f32: ``rtol=1e-4`` and ``atol=1e-4 * max|ref|`` of the level (convs sum
  in another order on the two sides);
* bf16: ``atol=2**-5 * max|ref|`` of the level (measured: at most
  1.8e-2 * max|ref|). Both sides round every conv output and BN to bf16
  (8 significant bits), but in different places (oneDNN vs XLA fusions), so
  one-ulp differences start in the stem and grow through the trunk, FPN
  and head.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pytorch_retinanet_tpu.models.converter import (
    flax_retinanet_to_torch,
    torch_retinanet_to_flax,
)
from pytorch_retinanet_tpu.models.retinanet import RetinaNetModule as JaxModule
from pytorch_retinanet_tpu.models.retinanet import apply_detector as jax_apply
from pytorch_retinanet_tpu_torch.models import (
    RetinaNetModule,
    apply_detector,
    from_jax_variables,
)
from pytorch_retinanet_tpu_torch.ops import feature_grid_sizes

NUM_CLASSES = 4


def _jax_variables(kind, seed=0):
    """Random weights as the JAX package's variables.

    Made on the port's side (seeded init, then random BN statistics and
    affine and random conv biases, so every converted tensor matters) and
    turned into flax variables by the JAX package's own importer; this is
    much cheaper than a flax ``init`` on the CPU.
    """
    module = RetinaNetModule(backbone_kind=kind, num_classes=NUM_CLASSES, prior=0.1)
    module.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        v = v.numpy()
        if v.ndim == 1 and k.endswith((".weight", "running_var")):  # BN scale and var
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(("running_mean", ".bias")):
            v = rng.normal(0, 0.05, v.shape).astype(np.float32)
        sd[k] = v
    params, stats = torch_retinanet_to_flax(sd, kind)
    return {"params": params, "batch_stats": stats}


def _jax_module(kind, dtype):
    return JaxModule(backbone_kind=kind, num_classes=NUM_CLASSES, prior=0.1, dtype=dtype)


def _port_module(kind, dtype, variables):
    module = RetinaNetModule(backbone_kind=kind, num_classes=NUM_CLASSES, prior=0.1, dtype=dtype)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in from_jax_variables(variables, kind).items()}
    module.load_state_dict(sd, strict=True)
    return module.to(memory_format=torch.channels_last).eval()


CASES = [
    # kind, compute dtype, fused stem, (B, H, W)
    ("resnet18", "float32", False, (2, 64, 96)),
    ("resnet18", "bfloat16", False, (2, 64, 96)),
    ("resnet18", "bfloat16", True, (2, 64, 96)),
    ("resnet50", "float32", False, (1, 64, 64)),
]


@pytest.mark.parametrize("kind,dtype,fused,shape", CASES)
def test_per_level_outputs_match_jax(kind, dtype, fused, shape):
    b, h, w = shape
    jmod, variables = _jax_module(kind, getattr(jnp, dtype)), _jax_variables(kind)
    port = _port_module(kind, getattr(torch, dtype), variables)
    images = np.random.default_rng(3).random((b, h, w, 3), dtype=np.float32)

    run = jax.jit(lambda v, x: jax_apply(jmod, v, x, return_levels=True, use_fused_stem=fused))
    if fused:
        with pltpu.force_tpu_interpret_mode():
            jcls, jbox = run(variables, jnp.asarray(images))
    else:
        jcls, jbox = run(variables, jnp.asarray(images))
    with torch.inference_mode():
        pcls, pbox = apply_detector(port, torch.from_numpy(images), return_levels=True,
                                    use_fused_stem=fused)

    assert len(pcls) == len(jcls) == 5
    for p, j in zip(list(pcls) + list(pbox), list(jcls) + list(jbox)):
        ref = np.asarray(j, np.float32)
        got = p.float().numpy()
        assert got.shape == ref.shape and p.dtype == getattr(torch, dtype)
        scale = np.abs(ref).max()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=2.0**-5 * scale)


def test_from_jax_variables_equals_jax_export_and_loads_strict():
    kind = "resnet50"
    variables = _jax_variables(kind, seed=5)
    ours = from_jax_variables(variables, kind)
    ref = flax_retinanet_to_torch(variables, kind)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        assert ours[k].dtype == ref[k].dtype, k
    module = RetinaNetModule(backbone_kind=kind, num_classes=NUM_CLASSES)
    assert set(module.state_dict()) == set(ours)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in ours.items()},
                           strict=True)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64), (96, 160)])
def test_level_sizes_follow_ceil_halving(hw):
    """Every stride-2 op pads (k-1)//2, so level l has ceil(H/s_l) x ceil(W/s_l)
    cells, landscape and portrait alike, as the anchors assume."""
    module = RetinaNetModule(backbone_kind="resnet18", num_classes=NUM_CLASSES,
                             dtype=torch.float32).eval()
    with torch.inference_mode():
        cls, box = module(torch.zeros((1, *hw, 3)), return_levels=True)
    for (gh, gw), c, b in zip(feature_grid_sizes(hw), cls, box):
        assert c.shape == (1, gh * gw * 9, NUM_CLASSES) and b.shape == (1, gh * gw * 9, 4)


def test_uint8_wire_format_folds_the_scale():
    module = RetinaNetModule(backbone_kind="resnet18", num_classes=NUM_CLASSES,
                             dtype=torch.float32).eval()
    module.reset_parameters(torch.Generator().manual_seed(0))
    raw = np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    with torch.inference_mode():
        a = module(torch.from_numpy(raw))
        b = module(torch.from_numpy(raw.astype(np.float32) / 255.0))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4 * float(y.abs().max()))

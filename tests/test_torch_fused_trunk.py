"""The opt-in fused trunk of the PyTorch port vs the JAX package (CPU).

An R50-FPN at 64x96 (4 classes) with random weights and mildly perturbed BN
statistics and affine (as tests/test_fused_backbone.py perturbs them, so the
fold matters without blowing up activations through 16 blocks), made on the
port's side and carried into JAX variables with the JAX package's importer.

JAX's ``apply_detector(use_fused_trunk=True)`` cannot run on the CPU (it
passes no ``interpret`` to its kernels), so the JAX side is composed here as
that path computes: ``stem_reference_xla`` for the stem, then per block
``bottleneck_reference_xla`` with ``fold_bn`` where the JAX predicate routes
the block to the kernel and ``_xla_bottleneck`` elsewhere, then
``RetinaNetModule.apply(..., feats_in=...)``. At 64x96 the predicate takes
the same 10 blocks as at 800x1344 (layers 2-4, blocks 1 and up).

Tolerances, against each output's largest |value| ``M``:
* the trunk from the same stem, with the kernel's blocks or with
  ``use_kernel=False`` against JAX's ``use_pallas=False``: c3, c4, c5
  within ``2**-5 * M`` (measured at most 1.2e-2 * M). Both sides round to
  bf16 after every conv or BN, but sum in other orders, and the port's
  fused blocks round only y1, y2 and the output where the reference also
  rounds each conv output; one-ulp differences grow through the blocks.
* ``apply_detector`` per level (each side with its own stem): within
  ``2**-5 * M``, the bf16 bound of tests/test_torch_model.py (measured at
  most 1.7e-2 * M).
* ``feats_in`` through ``RetinaNetModule.forward``: equal to the full forward.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.kernels.bottleneck_pallas import (
    bottleneck_reference_xla,
    fold_bn,
)
from pytorch_retinanet_tpu.kernels.bottleneck_pallas import (
    fused_bottleneck_supported as jax_supported,
)
from pytorch_retinanet_tpu.kernels.stem_pallas import stem_reference_xla
from pytorch_retinanet_tpu.models.converter import torch_retinanet_to_flax
from pytorch_retinanet_tpu.models.fused_backbone import _xla_bottleneck
from pytorch_retinanet_tpu.models.fused_backbone import apply_trunk_fused as jax_trunk
from pytorch_retinanet_tpu.models.retinanet import RetinaNetModule as JaxModule
from pytorch_retinanet_tpu_torch.models import (
    RetinaNetModule,
    apply_detector,
    apply_trunk_fused,
    fused_backbone,
    fused_trunk_applicable,
)

KIND, NUM_CLASSES, SHAPE = "resnet50", 4, (1, 64, 96)
MEAN, STD = np.array([0.485, 0.456, 0.406], np.float32), np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(scope="module")
def setup():
    port = RetinaNetModule(backbone_kind=KIND, num_classes=NUM_CLASSES, prior=0.1)
    port.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in port.state_dict().items():
        v = v.numpy().copy()
        if k.startswith("backbone.") and v.ndim == 1:
            if k.endswith((".weight", "running_var")):
                v = v * rng.uniform(0.9, 1.1, v.shape).astype(np.float32)
            elif k.endswith((".bias", "running_mean")):
                v = v + rng.normal(0, 0.05, v.shape).astype(np.float32)
        sd[k] = v
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    port = port.to(memory_format=torch.channels_last).eval()
    params, stats = torch_retinanet_to_flax(sd, KIND)
    variables = {"params": params, "batch_stats": stats}
    images = rng.random((*SHAPE, 3), dtype=np.float32)
    return port, variables, images


def _jax_stem(variables, images):
    p, s = variables["params"]["backbone"], variables["batch_stats"]["backbone"]
    bn_p, bn_s = p["stem_bn"]["BatchNorm_0"], s["stem_bn"]["BatchNorm_0"]
    scale = bn_p["scale"] / jnp.sqrt(bn_s["var"] + 1e-5)
    bias = bn_p["bias"] - bn_s["mean"] * scale
    return stem_reference_xla(jnp.asarray((images - MEAN) / STD), p["stem_conv"]["kernel"], scale, bias)


def _jax_fused_trunk(variables, stem):
    """The blocks as JAX's fused trunk routes them, with the kernel's
    documented composition in the kernel's place. Returns the features and
    the number of blocks routed to the kernel."""
    p, s = variables["params"]["backbone"], variables["batch_stats"]["backbone"]
    x, out, fused = stem.astype(jnp.bfloat16), {}, 0
    for stage, (depth, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512)), start=1):
        for i in range(depth):
            bp, bs = p[f"layer{stage}_block{i}"], s[f"layer{stage}_block{i}"]
            if i > 0 and jax_supported(x.shape, width):
                folded = [fold_bn(bp, bs, f"bn{j}") for j in (1, 2, 3)]
                x = bottleneck_reference_xla(
                    x, bp["conv1"]["kernel"], *folded[0], bp["conv2"]["kernel"], *folded[1],
                    bp["conv3"]["kernel"], *folded[2])
                fused += 1
            else:
                x = _xla_bottleneck(bp, bs, x, 2 if (i == 0 and stage > 1) else 1)
        if stage >= 2:
            out[f"c{stage + 1}"] = x
    return out, fused


def _port_trunk(port, stem, use_kernel):
    stem_t = torch.from_numpy(np.asarray(stem, np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        return apply_trunk_fused(port.backbone.backbone, stem_t, KIND, use_kernel=use_kernel)


def _assert_close(got: torch.Tensor, want, tol: float, name: str):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=name)


def test_fused_trunk_matches_the_jax_composition(setup):
    port, variables, images = setup
    stem = _jax_stem(variables, images)
    want, fused = _jax_fused_trunk(variables, stem)
    assert fused == 10
    got = _port_trunk(port, stem, use_kernel=True)
    for k in ("c3", "c4", "c5"):
        # NCHW views of NHWC activations, as the FPN takes them.
        assert got[k].dtype == torch.bfloat16
        assert got[k].is_contiguous(memory_format=torch.channels_last)
        _assert_close(got[k].permute(0, 2, 3, 1), want[k], 2.0**-5, k)


def test_trunk_without_the_kernel_matches_jax_use_pallas_false(setup):
    port, variables, images = setup
    stem = _jax_stem(variables, images)
    want = jax_trunk(variables, stem, KIND, use_pallas=False)
    got = _port_trunk(port, stem, use_kernel=False)
    for k in ("c3", "c4", "c5"):
        _assert_close(got[k].permute(0, 2, 3, 1), want[k], 2.0**-5, k)


def test_trunk_routes_the_ten_identity_blocks_of_layers_2_to_4(setup, monkeypatch):
    port, variables, images = setup
    calls = []
    real = fused_backbone.fused_bottleneck

    def counting(x, *args):
        calls.append(tuple(x.shape))
        return real(x, *args)

    monkeypatch.setattr(fused_backbone, "fused_bottleneck", counting)
    _port_trunk(port, _jax_stem(variables, images), use_kernel=True)
    assert [c[-1] for c in calls] == [512] * 3 + [1024] * 5 + [2048] * 2
    calls.clear()
    _port_trunk(port, _jax_stem(variables, images), use_kernel=False)
    assert calls == []


def test_apply_detector_fused_trunk_matches_jax(setup):
    port, variables, images = setup
    feats, _ = _jax_fused_trunk(variables, _jax_stem(variables, images))
    jmod = JaxModule(backbone_kind=KIND, num_classes=NUM_CLASSES, prior=0.1)
    jcls, jbox = jmod.apply(variables, jnp.asarray(images), False, True, feats_in=feats)
    with torch.inference_mode():
        pcls, pbox = apply_detector(port, torch.from_numpy(images), return_levels=True,
                                    use_fused_stem=True, use_fused_trunk=True)
    assert len(pcls) == len(jcls) == 5
    for i, (p, j) in enumerate(zip(list(pcls) + list(pbox), list(jcls) + list(jbox))):
        assert p.dtype == torch.bfloat16
        _assert_close(p, j, 2.0**-5, f"output {i}")


def test_fused_trunk_is_opt_in_and_bottleneck_only(setup):
    port, _, images = setup
    x = torch.from_numpy(images)
    with torch.inference_mode():
        default = apply_detector(port, x, use_fused_stem=True)
        stem_only = apply_detector(port, x, use_fused_stem=True, use_fused_trunk=False)
        module_stem = apply_detector(port, x, use_fused_stem=False, use_fused_trunk=True)
        plain = port(x)
    for a, b in zip(default, stem_only):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(module_stem, plain):  # no fused stem: the trunk is the module's
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fused_trunk_applicable("resnet50") and fused_trunk_applicable("resnet152")
    assert not fused_trunk_applicable("resnet18") and not fused_trunk_applicable("resnet34")
    small = RetinaNetModule(backbone_kind="resnet18", num_classes=NUM_CLASSES).eval()
    with torch.inference_mode():
        for a, b in zip(apply_detector(small, x, use_fused_stem=True, use_fused_trunk=True),
                        apply_detector(small, x, use_fused_stem=True)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feats_in_equals_the_full_forward(dtype):
    module = RetinaNetModule(backbone_kind="resnet18", num_classes=NUM_CLASSES, dtype=dtype)
    module.reset_parameters(torch.Generator().manual_seed(1))
    module.eval()
    images = torch.rand((1, 64, 96, 3), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        full = module(images, return_levels=True)
        feats = module.backbone(module.normalize(images).permute(0, 3, 1, 2).to(dtype))
        via = module(images, return_levels=True, feats_in=feats)
    for a, b in zip(full[0] + full[1], via[0] + via[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

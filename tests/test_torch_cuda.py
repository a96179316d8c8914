"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips where there is no card: a CUDA
kernel has no CPU or interpret mode. The file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch; there, skip
the repository's conftest (it sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the stem kernel within 1 bf16 ulp of the larger value (+1e-6)
per output, the plain version run with TF32 off (the f32 sums run in
another order and can round to the neighbouring bf16 value); the NMS kernel
exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu_torch.kernels import (
    nms_keep_mask,
    nms_keep_mask_plain,
    stem_forward,
    stem_plain,
)
from pytorch_retinanet_tpu_torch.models import RetinaNetModule, apply_detector

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def _stem_inputs(dev, b, h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, 3), generator=g) * 1.5
    wt = torch.randn((64, 3, 7, 7), generator=g) * 0.05
    scale = 0.5 + torch.rand(64, generator=g)
    bias = torch.randn(64, generator=g) * 0.3
    return [t.to(dev) for t in (x, wt, scale, bias)]


# Landscape and portrait buckets, and shapes whose pooled map leaves partial
# tiles (the tile is 8 x 7 pooled outputs) in height, width or both.
@pytest.mark.parametrize("shape", [(2, 64, 96), (2, 96, 64), (1, 1344, 800), (1, 128, 36),
                                   (3, 32, 4)])
def test_stem_kernel_matches_plain(dev, shape):
    args = _stem_inputs(dev, *shape)
    before = stem_forward.launches
    got = stem_forward(*args).float().cpu().numpy()
    assert stem_forward.launches == before + 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref = stem_plain(*args).float().cpu().numpy()
    assert got.shape == ref.shape == (shape[0], shape[1] // 4, shape[2] // 4, 64)
    tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + 1e-6
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


def test_stem_kernel_gradient_recomputes_through_plain(dev):
    x, wt, scale, bias = _stem_inputs(dev, 1, 32, 64)
    w1 = wt.clone().requires_grad_(True)
    w2 = wt.clone().requires_grad_(True)
    g = torch.randn((1, 8, 16, 64), device=dev)
    (stem_forward(x, w1, scale, bias).float() * g).sum().backward()
    (stem_plain(x, w2, scale, bias).float() * g).sum().backward()
    # cuDNN's weight gradient may sum in another order from call to call.
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-3, atol=1e-3 * float(w2.grad.abs().max()))


def test_stem_kernel_rejects_what_it_cannot_take(dev):
    x, wt, scale, bias = _stem_inputs(dev, 1, 48, 64)
    with pytest.raises(ValueError):
        stem_forward(x, wt, scale, bias)  # h % 32 != 0
    x, wt, scale, bias = _stem_inputs(dev, 1, 32, 64)
    with pytest.raises(TypeError):
        stem_forward(x.double(), wt, scale, bias)


def _clusters(dev, b, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    centers = torch.rand((b, k // 20 + 1, 2), generator=g) * 600
    which = torch.randint(0, centers.shape[1], (b, k), generator=g)
    c = torch.gather(centers, 1, which[..., None].expand(-1, -1, 2))
    c = c + torch.randn((b, k, 2), generator=g) * 5
    wh = 10 + torch.rand((b, k, 2), generator=g) * 50
    boxes = torch.cat([c - wh / 2, c + wh / 2], dim=-1)
    boxes = boxes + (torch.randint(0, 3, (b, k), generator=g) * 4097.0)[..., None]
    valid = torch.rand((b, k), generator=g) < 0.9
    return boxes.to(dev), valid.to(dev)


# K = 2000 does not fit the scan's shared-memory staging and reads the mask
# from global memory instead.
@pytest.mark.parametrize("b,k", [(3, 1000), (2, 1), (2, 100), (1, 2000)])
def test_nms_kernel_equals_plain(dev, b, k):
    boxes, valid = _clusters(dev, b, k)
    before = nms_keep_mask.launches
    keep = nms_keep_mask(boxes, valid, 0.5)
    assert nms_keep_mask.launches == before + 1
    assert torch.equal(keep, nms_keep_mask_plain(boxes, valid, 0.5))


def test_nms_kernel_edge_cases(dev):
    same = torch.tensor([[10.0, 10.0, 50.0, 50.0]], device=dev).expand(1, 500, 4).contiguous()
    keep = nms_keep_mask(same, torch.ones((1, 500), dtype=torch.bool, device=dev), 0.5)
    assert keep[0, 0] and not keep[0, 1:].any()
    boxes, _ = _clusters(dev, 1, 300)
    none = torch.zeros((1, 300), dtype=torch.bool, device=dev)
    assert not nms_keep_mask(boxes, none, 0.5).any()


def test_fused_stem_path_portrait(dev):
    """R50 forward on the portrait bucket through the stem kernel, per level,
    within 2**-4 of the level's max against the same forward with
    ``stem_plain`` as its stem and against the module's own cuDNN stem.

    The stems differ by at most 1 bf16 ulp per output (the cuDNN stem also
    rounds the conv output before BN), and the trunk re-rounds to bf16 after
    every op, so those differences grow through 16 bottlenecks of a random
    R50: measured 2.4e-2 and 3.1e-2 of the max. A stem wired in the wrong
    layout would be off by the order of the max itself.
    """
    module = RetinaNetModule(backbone_kind="resnet50", num_classes=90)
    module.reset_parameters(torch.Generator().manual_seed(0))
    module.to(dev, memory_format=torch.channels_last).eval()
    images = torch.rand((2, 1344, 800, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    resnet = module.backbone.backbone
    with torch.inference_mode():
        fused = apply_detector(module, images, return_levels=True, use_fused_stem=True)
        scale, shift = resnet.bn1.folded()
        stem = stem_plain(module.normalize(images), resnet.conv1.weight, scale, shift)
        same_stem = module(images, return_levels=True, stem_in=stem)
        cudnn_stem = apply_detector(module, images, return_levels=True, use_fused_stem=False)
    for a, b, c in zip(fused[0] + fused[1], same_stem[0] + same_stem[1],
                       cudnn_stem[0] + cudnn_stem[1]):
        a, b, c = a.float(), b.float(), c.float()
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 2.0**-4 * b.abs().max()
        assert (a - c).abs().max() <= 2.0**-4 * c.abs().max()

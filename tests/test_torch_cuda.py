"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips where there is no card: a CUDA
kernel has no CPU or interpret mode. The file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch; there, skip
the repository's conftest (it sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is also held at its main path's shapes: the stem at [32, 800,
1344, 3], NMS at [32, 1000], the match at the five levels of the 800x1344
bucket at batch 16 with 100 GT rows, the bottleneck at R50's three stages at
batch 32, top-2 at the five levels of one image, frozen BN at R-50's 53 BNs
and the focal pair at its five levels at batch 16 (the shapes and inputs
of ``tools/torch_main_path.py``, which ``tools/torch_kernel_table.py``
times). ``-k <kernel>`` (``stem``, ``nms``,
``match_kernel``, ``bottleneck``, ``top2``, ``frozen_bn``, ``focal``) runs
one kernel's tests (``match`` alone also picks every ``*_matches_plain``).

Tolerances: the stem kernel within 1 bf16 ulp of the larger value (+1e-6)
per output, from uint8 and f32 images, the plain version run with TF32 off (the f32 sums run in
another order and can round to the neighbouring bf16 value); the NMS kernel
exactly; the match kernel's matches, labels and centre targets exactly and
its size targets (through ``logf``) within 2 f32 ulp; losses through the
match kernel within 1e-6 relative of the plain composition's; the bottleneck
kernel within 1 bf16 ulp of the element plus 1 bf16 ulp (2**-8) of the
output's largest value, on every row, border rows included (the f32 sums run
in another order and flip bf16 roundings of y1 and y2, which move an output
by a term of the output's scale, not of the element's), and at least 90% of
the outputs equal; the top-2 kernel exactly; the flat postprocess through
the NMS kernel equal to it through the plain version; an artifact exported on the
card equal to eager ``_predict_impl`` bit for bit, and the serve loop over
it equal to ``predict`` on the same full batches (labels exactly, scores
within 1e-5, boxes within 1e-3 px); the frozen-BN pair's y and dx bit for
bit, its parameter gradients within 2**-14 of the sums of their terms'
magnitudes (another order of addition); the focal pair's per-image sums
within 1e-6 of the sums of their terms' magnitudes (another order of
addition) and its dx within 1 bf16 ulp of the larger value (bf16) or 1e-6 of
the largest |dx| (f32) of its plain version run on the card, each twice bit
for bit.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from torch_card import (
    LEVEL_ANCHORS, bottleneck_inputs, focal_inputs, frozen_bn_inputs, match_inputs,
    r50_frozen_bn_shapes,
)

from pytorch_retinanet_tpu_torch.config import MEAN, STD
from pytorch_retinanet_tpu_torch.kernels import (
    BOTTLENECK_TRACE_FIELDS,
    bottleneck_phase_trace,
    bottleneck_plain,
    fused_bottleneck,
    match_targets,
    match_targets_plain,
    nms_keep_mask,
    nms_keep_mask_plain,
    pack_bottleneck_weights,
    stem_forward,
    stem_plain,
    top2_classes,
    top2_classes_plain,
)
from pytorch_retinanet_tpu_torch.models import (
    Retinanet,
    RetinaNetModule,
    apply_detector,
    resize_for_bucket,
)
from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level, retinanet_loss_levels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def _stem_inputs(dev, b, h, w, seed=0, dtype=torch.float32):
    """Raw images and the stem's arguments: uint8 with the constants times
    255 (the predict path's wire format), f32 in [0, 1] with the plain ones."""
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.uint8:
        x = torch.randint(0, 256, (b, h, w, 3), generator=g, dtype=torch.uint8)
        mean, std = tuple(m * 255.0 for m in MEAN), tuple(s * 255.0 for s in STD)
    else:
        x = torch.rand((b, h, w, 3), generator=g)
        mean, std = MEAN, STD
    wt = torch.randn((64, 3, 7, 7), generator=g) * 0.05
    scale = 0.5 + torch.rand(64, generator=g)
    bias = torch.randn(64, generator=g) * 0.3
    return [x.to(dev), mean, std] + [t.to(dev) for t in (wt, scale, bias)]


# Landscape and portrait buckets, and shapes whose pooled map leaves partial
# tiles (the tile is 8 x 16 pooled outputs) in height, width or both (1000 /
# 4 = 250 = 15 x 16 + 10); predict's batch of 32.
STEM_SHAPES = [(2, 64, 96), (2, 96, 64), (1, 1344, 800), (1, 128, 36), (3, 32, 4), (3, 96, 132),
               (2, 800, 1344), (2, 128, 1000), (32, 800, 1344)]


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_kernel_matches_plain(dev, shape):
    args = _stem_inputs(dev, *shape)
    before = stem_forward.launches
    got = stem_forward(*args)
    assert stem_forward.launches == before + 1 and stem_forward.last_dtype == torch.float32
    assert got.dtype == torch.bfloat16
    got = got.float().cpu().numpy()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref = stem_plain(*args).float().cpu().numpy()
    assert got.shape == ref.shape == (shape[0], shape[1] // 4, shape[2] // 4, 64)
    tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + 1e-6
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_kernel_on_uint8_images_matches_plain(dev, shape):
    args = _stem_inputs(dev, *shape, seed=1, dtype=torch.uint8)
    before = stem_forward.launches
    got = stem_forward(*args)
    assert stem_forward.launches == before + 1 and stem_forward.last_dtype == torch.uint8
    assert got.dtype == torch.bfloat16 and got.shape == (shape[0], shape[1] // 4, shape[2] // 4, 64)
    got = got.float().cpu().numpy()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref = stem_plain(*args).float().cpu().numpy()
    tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + 1e-6
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


def test_stem_kernel_takes_a_batch_view(dev):
    """Image 1 of a batch: a view that starts one image into the storage."""
    x, *rest = _stem_inputs(dev, 3, 32, 68, seed=2, dtype=torch.uint8)
    got = stem_forward(x[1:], *rest)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref = stem_plain(x[1:], *rest)
    a, b = got.float(), ref.float()
    assert ((a - b).abs() <= torch.from_numpy(_bf16_ulp(np.maximum(
        a.abs().cpu().numpy(), b.abs().cpu().numpy()))).to(dev) + 1e-6).all()


def test_stem_kernel_gradient_recomputes_through_plain(dev):
    x, mean, std, wt, scale, bias = _stem_inputs(dev, 1, 32, 64)
    w1, x1 = wt.clone().requires_grad_(True), x.clone().requires_grad_(True)
    w2, x2 = wt.clone().requires_grad_(True), x.clone().requires_grad_(True)
    g = torch.randn((1, 8, 16, 64), device=dev)
    (stem_forward(x1, mean, std, w1, scale, bias).float() * g).sum().backward()
    (stem_plain(x2, mean, std, w2, scale, bias).float() * g).sum().backward()
    # cuDNN's weight gradient may sum in another order from call to call.
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-3, atol=1e-3 * float(w2.grad.abs().max()))
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-3, atol=1e-3 * float(x2.grad.abs().max()))
    # A uint8 image takes no gradient; the weights still get theirs.
    x8, mean8, std8, _, _, _ = _stem_inputs(dev, 1, 32, 64, dtype=torch.uint8)
    w3 = wt.clone().requires_grad_(True)
    (stem_forward(x8, mean8, std8, w3, scale, bias).float() * g).sum().backward()
    assert w3.grad is not None and torch.isfinite(w3.grad).all()


def test_stem_kernel_rejects_what_it_cannot_take(dev):
    x, mean, std, wt, scale, bias = _stem_inputs(dev, 1, 48, 64)
    with pytest.raises(ValueError):
        stem_forward(x, mean, std, wt, scale, bias)  # h % 32 != 0
    x, mean, std, wt, scale, bias = _stem_inputs(dev, 1, 32, 64)
    with pytest.raises(TypeError):
        stem_forward(x.double(), mean, std, wt, scale, bias)
    with pytest.raises(ValueError):
        stem_forward(x, mean, std, wt.cpu(), scale, bias)


@pytest.mark.parametrize("hw", [(480, 640), (600, 400), (1600, 2666)])
def test_uint8_resize_on_the_card_equals_the_cpu(dev, hw):
    """cv2's fixed-point bilinear resize in int32: bit for bit on both."""
    image = torch.randint(0, 256, (*hw, 3), generator=torch.Generator().manual_seed(3),
                          dtype=torch.uint8)
    got, new_hw, _, _ = resize_for_bucket(image.to(dev), 800, 1333, wire_dtype=torch.uint8)
    want, want_hw, _, _ = resize_for_bucket(image, 800, 1333, wire_dtype=torch.uint8)
    assert new_hw == want_hw and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), want)


def test_predict_runs_the_stem_kernel_on_a_uint8_batch(dev):
    net = Retinanet(backbone_kind="resnet18", num_classes=4, pretrained=False, min_size=64,
                    max_size=96, prior=0.5)
    images = [np.random.default_rng(4).integers(0, 256, (50, 70, 3), dtype=np.uint8)] * 2
    before = stem_forward.launches
    out = net.predict(images)
    assert stem_forward.launches == before + 1 and stem_forward.last_dtype == torch.uint8
    assert all(len(o["scores"]) > 0 for o in out)


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


# The scan resolves 64-candidate chunks: K = 63, 65 and 100 leave a partial
# chunk; up to K ~ 12,600 two chunks of rows are staged in shared memory, and
# K = 13000 reads them from global memory instead; predict's [32, 1000].
@pytest.mark.parametrize("b,k", [(3, 1000), (2, 1), (2, 100), (1, 2000), (2, 63), (2, 65),
                                 (1, 4096), (1, 13000), (32, 1000)])
def test_nms_kernel_equals_plain(dev, b, k):
    boxes, valid = _clusters(dev, b, k)
    before = nms_keep_mask.launches
    keep = nms_keep_mask(boxes, valid, 0.5)
    assert nms_keep_mask.launches == before + 1
    assert torch.equal(keep, nms_keep_mask_plain(boxes, valid, 0.5))


def test_flat_postprocess_kernel_arm_equals_plain_arm(dev):
    from pytorch_retinanet_tpu_torch.ops import generate_anchors, process_detections_batch

    g = torch.Generator().manual_seed(5)
    anchors = torch.from_numpy(generate_anchors((256, 384))).to(dev)
    cls = ((torch.randint(-16, 8, (2, anchors.shape[0], 20), generator=g) * 0.25)
           .to(dev, torch.bfloat16))  # quarter steps: many ties
    box = (torch.randn((2, anchors.shape[0], 4), generator=g) * 0.3).to(dev, torch.bfloat16)
    sizes = torch.tensor([[256.0, 384.0], [200.0, 300.0]], device=dev)
    before = nms_keep_mask.launches
    got = process_detections_batch(cls, box, anchors, sizes, pre_nms_top_k=4096)
    assert nms_keep_mask.launches == before + 1
    ref = process_detections_batch(cls, box, anchors, sizes, pre_nms_top_k=4096, use_kernel=False)
    assert nms_keep_mask.launches == before + 1
    assert got.valid.any()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_nms_kernel_edge_cases(dev):
    """Identical boxes (one long chain: the first of each image kept),
    disjoint ones (none suppressed), none valid; each equal to plain."""
    same = torch.tensor([[10.0, 10.0, 50.0, 50.0]], device=dev).expand(2, 500, 4).contiguous()
    i = torch.arange(2000, device=dev, dtype=torch.float32)
    grid = torch.stack([(i % 40) * 30, (i // 40) * 30, (i % 40) * 30 + 20, (i // 40) * 30 + 20], -1)
    boxes, _ = _clusters(dev, 1, 300)
    keeps = []
    for b, valid in ((same, True), (grid[None], True), (boxes, False)):
        valid = torch.full(b.shape[:2], valid, dtype=torch.bool, device=dev)
        keeps.append(nms_keep_mask(b, valid, 0.5))
        assert torch.equal(keeps[-1], nms_keep_mask_plain(b, valid, 0.5))
    assert keeps[0][:, 0].all() and not keeps[0][:, 1:].any()
    assert keeps[1].all() and not keeps[2].any()


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
        stem = stem_plain(images, module.mean, module.std, resnet.conv1.weight, scale, shift)
        same_stem = module(images, return_levels=True, stem_in=stem)
        cudnn_stem = apply_detector(module, images, return_levels=True, use_fused_stem=False)
    for a, b, c in zip(fused[0] + fused[1], same_stem[0] + same_stem[1],
                       cudnn_stem[0] + cudnn_stem[1]):
        a, b, c = a.float(), b.float(), c.float()
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 2.0**-4 * b.abs().max()
        assert (a - c).abs().max() <= 2.0**-4 * c.abs().max()


def _f32_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _match_case(dev, b, a, n, n_valid, seed=0):
    g = torch.Generator().manual_seed(seed)
    ctr = torch.rand((a, 2), generator=g) * 600
    wh = 8 + torch.rand((a, 2), generator=g) * 250
    anchors = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    gctr = torch.rand((b, n, 2), generator=g) * 600
    gwh = 8 + torch.rand((b, n, 2), generator=g) * 300
    gt = torch.cat([gctr - gwh / 2, gctr + gwh / 2], -1)
    valid = torch.arange(n)[None] < torch.tensor(n_valid)[:, None]
    gt = torch.where(valid[..., None], gt, torch.zeros_like(gt))
    labels = torch.where(valid, torch.randint(1, 91, (b, n), generator=g), torch.zeros((b, n), dtype=torch.long))
    if n >= 3 and n_valid[0] >= 3:  # a tie: row 2 repeats row 1, under anchor 0
        gt[:, 2] = gt[:, 1]
        anchors[0] = gt[0, 1]
    return [t.to(dev) for t in (anchors, gt, labels, valid)]


def _assert_match_equal(got, want):
    for x, y, name in zip(got[:2], want[:2], ("matches", "fg_labels")):
        assert x.dtype == y.dtype == torch.int32 and torch.equal(x, y), name
    torch.testing.assert_close(got[2][..., :2], want[2][..., :2], rtol=0, atol=0, equal_nan=True,
                               msg="centre targets")
    assert _f32_ulp_distance(got[2][..., 2:], want[2][..., 2:]) <= 2, "size targets"


def _training_match_case(dev, level: int):
    """Level `level` of the 800x1344 bucket and the training shapes' GT
    (``match_inputs`` of ``tools/torch_main_path.py``): a tie under anchor 5000 of P3,
    image 3's rows 4 and 5."""
    levels =[torch.from_numpy(a).to(dev) for a in generate_anchors_per_level((800, 1344))]
    return [levels[level], *match_inputs(levels, dev)]


# Partial anchor blocks (the block is 256), A smaller than one block, N not
# a multiple of 8, one GT row, images without GT, and more rows than fit in
# 48 KB of shared memory's default (N = 3000 -> 75 KB); the five levels of
# the training shapes (A given as the level's name).
@pytest.mark.parametrize("b,a,n,n_valid", [
    (3, 1000, 13, [13, 0, 5]), (2, 37, 100, [100, 1]), (1, 256, 1, [1]), (2, 300, 8, [0, 0]),
    (1, 700, 3000, [2500]), *[(16, f"P{lvl}", 100, None) for lvl in range(3, 8)],
])
def test_match_kernel_equals_plain(dev, b, a, n, n_valid):
    if isinstance(a, str):
        case, tie = _training_match_case(dev, int(a[1]) - 3), (3, 5000, 4) if a == "P3" else None
    else:
        case = _match_case(dev, b, a, n, n_valid)
        tie = (0, 0, 1) if n >= 3 and n_valid[0] >= 3 else None
    before = match_targets.launches
    got = match_targets(*case)
    assert match_targets.launches == before + 1
    want = match_targets_plain(*case)
    _assert_match_equal(got, want)
    if tie:
        assert int(got[0][tie[:2]]) == tie[2]  # the tie went to the first of the equal rows


def _match_sentinel_case(dev, hw, tie):
    """P3 anchors of the `hw` bucket; image 0 has only rows 5 and 7 valid,
    both the box of anchor `tie` (near the bottom), so the upper blocks stage
    no row and their anchors take row 5, the first valid one, at IoU 0;
    image 1 adds row 6 in the top corner, culled in the tie's block, and
    image 2 has no GT."""
    anchors = torch.from_numpy(generate_anchors_per_level(hw)[0])
    gt = torch.zeros((3, 12, 4))
    gt[:, 5] = gt[:, 7] = anchors[tie]
    gt[:, 6] = torch.tensor([0.0, 0.0, 2.0, 2.0])
    valid = torch.zeros((3, 12), dtype=torch.bool)
    valid[0, [5, 7]] = True
    valid[1, 5:8] = True
    gt = torch.where(valid[..., None], gt, torch.zeros_like(gt))
    labels = torch.where(valid, torch.arange(12) + 1, torch.zeros((3, 12), dtype=torch.long))
    return [t.to(dev) for t in (anchors, gt, labels, valid)]


# (0.5, 0.4) are the detector's; with (-0.5, 0.0) an anchor whose IoU is 0
# everywhere is matched to the first valid row, so the sentinel shows. The
# tie's anchor: row 13 of 16, column 12 of P3 at 128x192; row 90 of 100,
# column 84 at 800x1344 (the first anchor shape).
@pytest.mark.parametrize("hw,tie", [((128, 192), 2916), ((800, 1344), 9 * (90 * 168 + 84))])
@pytest.mark.parametrize("fg,bg", [(0.5, 0.4), (-0.5, 0.0)])
def test_match_kernel_sentinel_only_blocks_and_first_valid_row(dev, fg, bg, hw, tie):
    case = _match_sentinel_case(dev, hw, tie)
    got = match_targets(*case, fg_iou_thr=fg, bg_iou_thr=bg)
    _assert_match_equal(got, match_targets_plain(*case, fg_iou_thr=fg, bg_iou_thr=bg))
    m = got[0].cpu()
    assert (m[:2, tie] == 5).all() and (m[2] == -2).all()
    if fg < 0:
        assert (m[0, :256] == 5).all()  # the first block stages no row of image 0


def test_match_kernel_takes_int64_labels_and_unaligned_views(dev):
    anchors, gt, labels, valid = _match_case(dev, 2, 500, 20, [20, 7])
    buf = torch.empty(anchors.numel() + 1, device=dev)
    shifted = buf[1:].view(-1, 4)  # data_ptr 4 bytes off the 16-byte grid
    shifted.copy_(anchors)
    _assert_match_equal(match_targets(shifted, gt, labels.long(), valid),
                        match_targets_plain(anchors, gt, labels, valid))


def test_loss_through_the_match_kernel_equals_plain(dev):
    g = torch.Generator().manual_seed(3)
    anchors = [torch.from_numpy(a).to(dev) for a in generate_anchors_per_level((128, 192))]
    cls = [(torch.randn((2, a.shape[0], 90), generator=g) * 2).to(dev) for a in anchors]
    box = [(torch.randn((2, a.shape[0], 4), generator=g) * 0.3).to(dev) for a in anchors]
    _, gt, labels, valid = _match_case(dev, 2, 1, 30, [30, 0], seed=4)
    gt = gt * 0.3
    before = match_targets.launches
    ker = retinanet_loss_levels(cls, box, anchors, gt, labels, valid, num_classes=90)
    assert match_targets.launches == before + 5
    plain = retinanet_loss_levels(cls, box, anchors, gt, labels, valid, num_classes=90,
                                  use_match_kernel=False)
    assert match_targets.launches == before + 5
    for k in ker:
        torch.testing.assert_close(ker[k], plain[k], rtol=1e-6, atol=0)


def test_forward_on_the_card_runs_the_match_kernel(dev):
    net = Retinanet(backbone_kind="resnet18", num_classes=4, pretrained=False, min_size=64,
                    max_size=96, prior=0.1)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    boxes = np.zeros((2, 100, 4), np.float32)
    boxes[0, :2] = [[10, 10, 40, 50], [30, 5, 90, 60]]
    labels = np.zeros((2, 100), np.int32)
    labels[0, :2] = [1, 3]
    before = match_targets.launches
    out = net.forward(images, {"boxes": boxes, "labels": labels, "valid": boxes[..., 2] > 0})
    assert match_targets.launches == before + 1
    (out["classification_loss"] + out["regression_loss"]).backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in net.module.parameters())


def _assert_bottleneck_close(got, want):
    got, want = got.float(), want.float()
    d = (got - want).abs()
    tol = torch.from_numpy(_bf16_ulp(torch.maximum(got.abs(), want.abs()).cpu().numpy())).to(d.device)
    tol = tol + 2.0**-8 * want.abs().max()
    per_row = (d - tol).amax(dim=(0, 2, 3))
    assert (per_row <= 0).all(), per_row
    assert (d == 0).float().mean() >= 0.9


# The three R50 stage widths; shapes whose H and W do not divide the tile the
# kernel picks (10x12 at mid 128 and 256, 5x12 at mid 512), or divide one of
# them; at mid 512 an odd (29 columns) and an even (40) number of tiles along
# W; batch 1 at the layer2 and layer3 shapes; one image row and one column;
# the fused trunk's three stages at batch 32 (800x1344).
@pytest.mark.parametrize("b,h,w,mid", [(2, 8, 16, 128), (2, 13, 21, 128), (1, 25, 42, 512),
                                       (2, 9, 7, 256), (1, 1, 5, 128), (1, 6, 1, 256),
                                       (2, 23, 29, 128), (2, 17, 31, 256), (2, 12, 40, 512),
                                       (2, 11, 29, 512), (1, 100, 168, 128), (1, 50, 84, 256),
                                       (4, 13, 21, 128), (32, 100, 168, 128), (32, 50, 84, 256),
                                       (32, 25, 42, 512)])
def test_bottleneck_kernel_matches_plain(dev, b, h, w, mid):
    args = bottleneck_inputs(dev, b, h, w, mid)
    before = fused_bottleneck.launches
    got = fused_bottleneck(*args)
    assert fused_bottleneck.launches == before + 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = bottleneck_plain(*args)
    assert got.shape == want.shape and got.dtype == torch.bfloat16 and got.is_contiguous()
    _assert_bottleneck_close(got, want)


def test_bottleneck_phase_trace_is_ordered(dev):
    """One row per CTA (2 images x 3 x 3 tiles of 10x12), its stamps in phase
    order, its waits within its cycles; the launch counts like any other."""
    args = bottleneck_inputs(dev, 2, 23, 29, 128)
    before = fused_bottleneck.launches
    trace = bottleneck_phase_trace(*args)
    assert fused_bottleneck.launches == before + 1
    assert trace.shape == (18, len(BOTTLENECK_TRACE_FIELDS))
    f = {k: trace[:, i] for i, k in enumerate(BOTTLENECK_TRACE_FIELDS)}
    stamps = [f[k] for k in ("start_ns", "conv1_done_ns", "conv2_wgmma_done_ns", "y2_written_ns",
                             "end_ns")]
    assert all(bool((a <= b).all()) for a, b in zip(stamps, stamps[1:]))
    assert bool((0 <= f["conv1_full_wait_cycles"]).all())
    assert bool((f["conv1_full_wait_cycles"] <= f["full_wait_cycles"]).all())
    assert bool((f["full_wait_cycles"] < f["cycles"]).all())


@pytest.mark.parametrize("mid", [128, 256, 512])
def test_bottleneck_weight_packing_on_the_card_equals_the_cpu(dev, mid):
    _, w1, _, _, w2, _, _, w3, _, _ = bottleneck_inputs(dev, 1, 2, 2, mid)
    got = pack_bottleneck_weights(w1, w2, w3)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), pack_bottleneck_weights(w1.cpu(), w2.cpu(), w3.cpu()))


def test_bottleneck_kernel_takes_the_channels_last_trunk_view(dev):
    x, *rest = bottleneck_inputs(dev, 2, 10, 12, 128)
    nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    view = nchw.permute(0, 2, 3, 1)
    assert view.is_contiguous()
    torch.testing.assert_close(fused_bottleneck(view, *rest), fused_bottleneck(x, *rest),
                               rtol=0, atol=0)


@pytest.mark.parametrize("b,h,w,seed", [(1, 6, 10, 1), (2, 12, 20, 20)])
def test_bottleneck_kernel_gradient_recomputes_through_plain(dev, b, h, w, seed):
    args = bottleneck_inputs(dev, b, h, w, 128, seed=seed)
    args = [t.float() if t.dtype == torch.bfloat16 and i else t for i, t in enumerate(args)]
    ker = [t.clone().requires_grad_(t.is_floating_point()) for t in args]
    ref = [t.clone().requires_grad_(t.is_floating_point()) for t in args]
    g = torch.randn(args[0].shape, device=dev)
    # TF32 off for both backwards too: the kernel's recomputes through the plain
    # version. Deterministic cuDNN algorithms: a nondeterministic one has put
    # the two sides 0.00154 apart.
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        (fused_bottleneck(*ker).float() * g).sum().backward()
        (bottleneck_plain(*ref).float() * g).sum().backward()
    for a, r in zip(ker, ref):
        # The same recompute on both sides: cuDNN may sum in another order.
        torch.testing.assert_close(a.grad, r.grad, rtol=1e-3, atol=1e-3 * float(r.grad.abs().max()))
        assert float((a.grad - r.grad).abs().max()) <= 1e-3 * float(r.grad.abs().max())


def test_bottleneck_kernel_rejects_what_it_cannot_take(dev):
    args = bottleneck_inputs(dev, 1, 4, 4, 128)
    with pytest.raises(ValueError):
        fused_bottleneck(args[0].cpu(), *args[1:])  # a CPU/CUDA mix
    with pytest.raises(TypeError):
        fused_bottleneck(args[0].float(), *args[1:])
    with pytest.raises(ValueError):
        fused_bottleneck(*bottleneck_inputs(dev, 1, 4, 4, 64))  # mid 64: not the kernel's tiling
    with pytest.raises(ValueError):
        fused_bottleneck(*bottleneck_inputs(dev, 1, 4, 4, 384))  # built for mid 128, 256 and 512
    with pytest.raises(ValueError):
        fused_bottleneck(args[0], args[1], args[2][:64], *args[3:])


# The five levels of one 800x1344 image, rows that do not fill the last CTA,
# few classes, f32, and a row too wide for 256 rows of shared memory.
@pytest.mark.parametrize("a,c,dtype", [*[(a, 90, torch.bfloat16) for a in LEVEL_ANCHORS],
                                       (37, 90, torch.bfloat16), (1001, 13, torch.float32),
                                       (8, 1, torch.float32), (300, 5000, torch.float32)])
def test_top2_kernel_equals_plain(dev, a, c, dtype):
    x = (torch.randn((a, c), generator=torch.Generator().manual_seed(a)) * 2 - 4).to(dev, dtype)
    before = top2_classes.launches
    got = top2_classes(x)
    assert top2_classes.launches == before + 1
    want = top2_classes_plain(x)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_top2_kernel_ties_and_unaligned_rows(dev):
    x = torch.zeros((24, 17), dtype=torch.bfloat16, device=dev)
    x[:, 3] = x[:, 11] = 5.0
    v1, c1, v2, c2 = top2_classes(x)
    assert (v1 == 5).all() and (c1 == 3).all() and (v2 == 5).all() and (c2 == 11).all()
    tie = torch.zeros((4096, 90), dtype=torch.bfloat16, device=dev)
    tie[:, 7] = tie[:, 50] = tie[::3, 2] = 3.0
    got = top2_classes(tie)
    assert all(torch.equal(g, w) for g, w in zip(got, top2_classes_plain(tie)))
    assert (got[1] != got[3]).all() and (got[0] >= got[2]).all()
    flat = torch.randn(1 + 50 * 7, device=dev).to(torch.bfloat16)
    view = flat[1:].view(50, 7)  # rows 2 bytes off the 16-byte grid
    for g, w in zip(top2_classes(view), top2_classes_plain(view)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        top2_classes(torch.zeros((7, 90), device=dev))


def test_top2_kernel_constant_rows_and_extremes(dev):
    """All-equal rows, -inf, and values below the -3e38 fill of the second scan."""
    x = torch.zeros((16, 5), device=dev)
    x[8:] = -float("inf")
    x[12:, 2] = -3.3e38
    for logits in (x, x.to(torch.bfloat16)):
        for g, w in zip(top2_classes(logits), top2_classes_plain(logits)):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------- #
# The engine on the card: checkpoints across devices, telemetry, the profiler
# ---------------------------------------------------------------------------- #
ENGINE_MODEL = dict(num_classes=4, backbone_kind="resnet18", pretrained=False, min_size=64,
                    max_size=96, compute_dtype="float32", prior=0.1)


def _engine_model(device, freeze_bn=True):
    from pytorch_retinanet_tpu_torch import ConfigDict, RetinaNetModel

    class Served(RetinaNetModel):
        def prepare_data(self):
            pass

        def train_dataloader(self, shard=0, num_shards=1):
            rng = np.random.default_rng(0)
            boxes = np.zeros((2, 100, 4), np.float32)
            boxes[:, 0] = [8, 8, 40, 30]
            labels = np.zeros((2, 100), np.int32)
            labels[:, 0] = 1
            return [{"images": rng.random((2, 64, 96, 3), dtype=np.float32), "boxes": boxes,
                     "labels": labels, "valid": labels > 0}] * 2

        def val_dataloader(self, shard=0, num_shards=1):
            return None

    hp = {"model": {**ENGINE_MODEL, "freeze_bn": freeze_bn},
          "optimizer": {"class_name": "SGD", "params": {"lr": 0.01, "momentum": 0.9}}}
    return Served(ConfigDict(hp), device=device)


@pytest.mark.parametrize("src,dst", [("cuda", "cpu"), ("cpu", "cuda")])
def test_checkpoint_restores_across_devices(dev, tmp_path, src, dst):
    from pytorch_retinanet_tpu_torch import Trainer

    model = _engine_model(src, freeze_bn=False)
    trainer = Trainer(max_epochs=1, warmup_steps=0, checkpoint_dir=str(tmp_path))
    trainer.fit(model)
    other = _engine_model(dst, freeze_bn=False)
    resumed = Trainer(max_epochs=1, warmup_steps=0)
    resumed._model = other
    resumed._optimizer, resumed._scheduler, _ = other.configure_optimizers()
    resumed.restore_checkpoint(str(tmp_path / "last"))
    for k, v in model.net.module.state_dict().items():
        got = other.net.module.state_dict()[k]
        assert got.device.type == dst and torch.equal(got.cpu(), v.cpu()), k
    want = trainer._optimizer.state_dict()["state"]
    got = resumed._optimizer.state_dict()["state"]
    for i, s in want.items():
        assert got[i]["momentum_buffer"].device.type == dst
        assert torch.equal(got[i]["momentum_buffer"].cpu(), s["momentum_buffer"].cpu()), i
    assert (resumed.current_epoch, resumed.global_step) == (1, 2)


def test_device_memory_stats_keys(dev):
    from pytorch_retinanet_tpu_torch.utils import device_memory_stats

    x = torch.ones(1 << 20, device=dev)
    stats = device_memory_stats()
    n = torch.cuda.device_count()
    assert set(stats) == {f"cuda{i}_{k}" for i in range(n) for k in ("mb", "peak_mb")}
    assert stats["cuda0_mb"] >= 4.0 and stats["cuda0_peak_mb"] >= stats["cuda0_mb"]
    del x


def test_profiler_hook_writes_a_trace(dev, tmp_path):
    import json

    from pytorch_retinanet_tpu_torch import Trainer
    from pytorch_retinanet_tpu_torch.utils import ProfilerHook

    trainer = Trainer(max_epochs=1, warmup_steps=0, profile_dir=str(tmp_path))
    trainer.profiler = ProfilerHook(str(tmp_path), start_step=1, num_steps=1)
    trainer.fit(_engine_model("cuda"))
    with open(trainer.profiler.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)  # device activity was traced


# ---------------------------------------------------------------------------- #
# Export and serving on the card
# ---------------------------------------------------------------------------- #
def _small_bf16_net():
    return Retinanet(backbone_kind="resnet18", num_classes=4, pretrained=False, min_size=64,
                     max_size=96, prior=0.5)


def test_artifact_on_the_card_equals_eager_and_launches_the_kernels(dev):
    """A uint8 artifact exported on the card: its weights equal the module's
    and keep their memory format; one call launches the stem (on uint8) and
    NMS once each and equals ``_predict_impl`` bit for bit."""
    from pytorch_retinanet_tpu_torch.export import export_inference, load_exported

    net = _small_bf16_net()
    infer = load_exported(export_inference(net, 2, wire_dtype="uint8"))
    assert infer.device.type == "cuda" and infer.meta["device"] == "cuda"
    mine = dict(net.module.named_parameters())
    for name, p in infer.program.named_parameters():
        want = mine[name.removeprefix("module.")]
        assert p.device == want.device and p.stride() == want.stride(), name
        assert torch.equal(p, want), name
    images = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 64, 96, 3),
                                                                dtype=np.uint8)).to(dev)
    sizes = torch.tensor([[64.0, 96.0], [60.0, 90.0]], device=dev)
    stem_before, nms_before = stem_forward.launches, nms_keep_mask.launches
    got = infer.dispatch(images, sizes)
    torch.cuda.synchronize()
    assert stem_forward.launches == stem_before + 1 and stem_forward.last_dtype == torch.uint8
    assert nms_keep_mask.launches == nms_before + 1
    want = net._predict_impl(images, sizes)
    assert int(want.valid.sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_serve_on_the_card_uses_a_pinned_ring(dev, monkeypatch):
    """The serve loop's host buffers are page-locked on the card, and its
    detections equal ``predict`` on the same batches (full batches, so both
    run the same batch size): labels exactly, scores within 1e-5, boxes
    within 1e-3 px."""
    import importlib.util
    from pathlib import Path

    from pytorch_retinanet_tpu_torch.export import export_inference, load_exported

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_serve.py"
    spec = importlib.util.spec_from_file_location("torch_serve", path)
    torch_serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_serve)
    slots = []
    init = torch_serve._Slot.__init__

    def recording_init(self, *args):
        init(self, *args)
        slots.append(self)

    monkeypatch.setattr(torch_serve._Slot, "__init__", recording_init)
    net = _small_bf16_net()
    infer = load_exported(export_inference(net, 2, wire_dtype="uint8"))
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in [(60, 90), (48, 80), (70, 100), (64, 96)]]
    got = torch_serve.serve(infer, images, depth=2)
    assert len(slots) == 2 and all(s.images.is_pinned() and s.sizes.is_pinned() for s in slots)
    assert all(t.is_pinned() for s in slots for t in s.outputs)
    want = net.predict(images[:2]) + net.predict(images[2:])
    for g, w in zip(got, want):
        assert len(g["labels"]) == len(w["labels"]) > 0
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)


# The frozen-BN pair: (n, c, h, w, dtype, channels-last, ReLU, storage offset
# in elements) over its paths: 16-byte vectors of channels, channels that are
# no vector, a row a block, unaligned storage (an element a thread), NCHW
# planes with and without vectors; then R-50's 53 frozen BNs at batch 16,
# 800x1344, bf16 channels-last.
FROZEN_BN_SHAPES = [
    (2, 64, 40, 68, torch.bfloat16, True, True, 0), (2, 2048, 7, 11, torch.bfloat16, True, False, 0),
    (3, 24, 9, 13, torch.bfloat16, True, True, 0), (2, 2048, 5, 7, torch.float32, True, True, 0),
    (2, 3, 9, 11, torch.float32, True, False, 0), (2, 64, 16, 24, torch.bfloat16, False, True, 0),
    (2, 128, 10, 13, torch.float32, False, False, 0), (2, 3, 9, 11, torch.float32, True, True, 0),
    (2, 24, 7, 5, torch.bfloat16, True, False, 0), (4, 2048, 5, 7, torch.float32, True, True, 0),
    (1, 4096, 3, 3, torch.bfloat16, True, False, 0), (2, 256, 6, 10, torch.bfloat16, True, True, 3),
    (3, 64, 13, 17, torch.bfloat16, False, True, 0), (2, 64, 16, 24, torch.bfloat16, False, False, 0),
    (2, 128, 10, 12, torch.float32, False, True, 0),
    *[pytest.param(n, c, h, w, torch.bfloat16, True, relu, 0, id=f"r50-bn{i}")
      for i, (n, c, h, w, relu) in enumerate(r50_frozen_bn_shapes(16, 800, 1344))],
]


@pytest.mark.parametrize("n,c,h,w,dtype,channels_last,relu,offset", FROZEN_BN_SHAPES)
def test_frozen_bn_kernels_match_plain(dev, n, c, h, w, dtype, channels_last, relu, offset):
    """y and dx bit for bit (the same IEEE operations) in x's strides, the
    parameter gradients within 2**-14 of the sums of their terms'
    magnitudes (another order of addition), the backward deterministic."""
    fb = importlib.import_module("pytorch_retinanet_tpu_torch.kernels.frozen_bn")
    x, dy, params = frozen_bn_inputs(dev, n, c, h, w, dtype, channels_last, offset, seed=c + h)
    y = fb._launch_forward(x, *params, 1e-5, relu)
    y_ref = fb.frozen_bn_plain(x, *params, 1e-5, relu)
    assert y.stride() == x.stride() and torch.equal(y, y_ref)
    got = fb._launch_backward(dy, x, *params, 1e-5, relu)
    again = fb._launch_backward(dy, x, *params, 1e-5, relu)
    dx_ref, dw_ref, db_ref = fb.frozen_bn_backward_plain(dy, x, *params, 1e-5, relu)
    assert got[0].stride() == x.stride() and torch.equal(got[0], dx_ref)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    gm = torch.where(y_ref <= 0, torch.zeros((), device=dev), dy.float()) if relu else dy.float()
    xmu = (x.float() - params[2][None, :, None, None]).abs()
    limits = torch.cat([2**-14 * (gm.abs() * xmu).sum((0, 2, 3)) / torch.sqrt(params[3] + 1e-5),
                        2**-14 * gm.abs().sum((0, 2, 3))])
    gaps = torch.cat([(got[1] - dw_ref).abs(), (got[2] - db_ref).abs()])
    assert float((gaps / (limits + 1e-30)).max()) <= 1.0


def test_frozen_bn_through_autograd_equals_the_kernels(dev):
    from pytorch_retinanet_tpu_torch.kernels import frozen_batch_norm

    fb = importlib.import_module("pytorch_retinanet_tpu_torch.kernels.frozen_bn")
    x, dy, (w, b, m, v) = frozen_bn_inputs(dev, 2, 256, 12, 20, torch.bfloat16, True, 0, seed=17)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    before = frozen_batch_norm.launches
    frozen_batch_norm(xr, wr, br, m, v, 1e-5, True).backward(dy)
    assert frozen_batch_norm.launches - before == 2
    dx, dw, db = fb._launch_backward(dy, x, w, b, m, v, 1e-5, True)
    assert torch.equal(xr.grad, dx) and torch.equal(wr.grad, dw) and torch.equal(br.grad, db)


def test_frozen_bn_training_step_launches_the_pair(dev):
    """A resnet18 training step on the card launches the pair once a BN each
    way; predict launches it not at all."""
    from pytorch_retinanet_tpu_torch.kernels import frozen_batch_norm

    net = _small_bf16_net()
    images = torch.rand(2, 64, 96, 3, device=dev)
    targets = {"boxes": torch.tensor([[[4.0, 6.0, 40.0, 50.0]]] * 2, device=dev),
               "labels": torch.tensor([[1], [2]], device=dev),
               "valid": torch.ones(2, 1, dtype=torch.bool, device=dev)}
    before = frozen_batch_norm.launches
    losses = net.forward(images, targets)
    (losses["classification_loss"] + losses["regression_loss"]).backward()
    torch.cuda.synchronize()
    assert frozen_batch_norm.launches - before == 2 * 20
    before = frozen_batch_norm.launches
    net.predict([np.zeros((64, 96, 3), np.uint8)])
    assert frozen_batch_norm.launches == before


# The focal pair: (B, A, C, dtype, storage offset) over its paths: 16-byte
# vectors with heads and tails around each image's run (C * A not a whole
# number of vectors), fewer classes than a vector, unaligned storage (one
# element a thread), and R-50's five levels at batch 16, 800x1344 (A given
# as the level's name), on the head's logits as training sees them
# (``focal_inputs``: around the prior, 1% foreground, 2% ignored).
FOCAL_SHAPES = [(2, 37, 3, torch.bfloat16, 0), (3, 50, 7, torch.float32, 0),
                (2, 693, 90, torch.bfloat16, 0), (2, 693, 90, torch.float32, 0),
                (4, 1000, 20, torch.bfloat16, 0), (2, 693, 90, torch.bfloat16, 1),
                (3, 101, 5, torch.float32, 3),
                *[(16, f"P{lvl}", 90, torch.bfloat16, 0) for lvl in range(3, 8)]]


def _focal_case(dev, b, a, c, dtype, offset, seed=0):
    """Logits (storage `offset` elements in), labels, matches with
    foreground, background and ignored anchors, and an upstream gradient."""
    g = torch.Generator(device=dev).manual_seed(seed + c)
    flat = (torch.randn(b * a * c + offset, generator=g, device=dev) * 3 - 2).to(dtype)
    x = flat[offset:].view(b, a, c)
    kind = torch.randint(0, 8, (b, a), generator=g, device=dev)  # 0 ignored, 1 fg, else bg
    matches = torch.where(kind == 1, torch.zeros_like(kind), torch.where(kind == 0, -2, -1))
    labels = torch.where(kind == 1, torch.randint(1, c + 1, (b, a), generator=g, device=dev), 0)
    grad = torch.rand(b, generator=g, device=dev) + 0.5
    return x, labels.to(torch.int32), matches.to(torch.int32), grad


@pytest.mark.parametrize("b,a,c,dtype,offset", FOCAL_SHAPES)
def test_focal_kernels_match_plain(dev, b, a, c, dtype, offset):
    """The sums within 1e-6 of the sums of their terms' magnitudes, dx
    within 1 bf16 ulp (bf16) or 1e-6 of the largest |dx| (f32); both twice
    bit for bit."""
    fl = importlib.import_module("pytorch_retinanet_tpu_torch.kernels.focal")
    if isinstance(a, str):
        a = LEVEL_ANCHORS[int(a[1]) - 3]
        x, labels, matches, grad = focal_inputs(dev, b, a, c, dtype, offset, seed=a)
    else:
        x, labels, matches, grad = _focal_case(dev, b, a, c, dtype, offset)
    assert fl._launch_args(x)[3] == (1 if offset else 16 // x.element_size())
    out = fl._launch_forward(x, labels, matches, 0.25, 2.0)
    again = fl._launch_forward(x, labels, matches, 0.25, 2.0)
    ref = fl.focal_loss_sums_plain(x, labels, matches, 0.25, 2.0)
    assert out.dtype == torch.float32 and torch.equal(out, again)
    xf = x.float()
    e = torch.exp(-xf.abs())
    terms = ((torch.clamp(xf, min=0) + torch.log1p(e)).sum(-1) * (matches >= -1)).sum(1)
    assert bool(((out - ref).abs() <= 1e-6 * terms).all()), (out, ref)
    dx = fl._launch_backward(grad, x, labels, matches, 0.25, 2.0)
    dx_again = fl._launch_backward(grad, x, labels, matches, 0.25, 2.0)
    dx_ref = fl.focal_loss_backward_plain(grad, x, labels, matches, 0.25, 2.0)
    assert dx.dtype == dtype and dx.shape == x.shape and torch.equal(dx, dx_again)
    diff = (dx.float() - dx_ref.float()).abs()
    if dtype == torch.bfloat16:
        _, ex = torch.frexp(torch.maximum(dx.float().abs(), dx_ref.float().abs()))
        assert bool((diff <= torch.ldexp(torch.ones_like(diff), ex - 8)).all())
    else:
        assert float(diff.max()) <= 1e-6 * float(dx_ref.abs().max())
    assert bool((dx[matches < -1] == 0).all())


def test_focal_through_autograd_equals_the_kernels(dev):
    from pytorch_retinanet_tpu_torch.kernels import focal_loss_sums

    fl = importlib.import_module("pytorch_retinanet_tpu_torch.kernels.focal")
    x, labels, matches, grad = _focal_case(dev, 2, 693, 90, torch.bfloat16, 0, seed=3)
    xr = x.clone().requires_grad_()
    before = focal_loss_sums.launches
    out = focal_loss_sums(xr, labels, matches, 0.25, 2.0)
    out.backward(grad)
    assert focal_loss_sums.launches - before == 2
    assert torch.equal(out.detach(), fl._launch_forward(x, labels, matches, 0.25, 2.0))
    assert torch.equal(xr.grad, fl._launch_backward(grad, x, labels, matches, 0.25, 2.0))


def test_focal_takes_other_float_dtypes_as_f32(dev):
    """f16 and f64 logits on the card go through the kernels as f32, as the
    composition before them cast every dtype; the gradient comes back in
    the logits' dtype. An empty anchor set sums to 0 without a launch."""
    from pytorch_retinanet_tpu_torch.kernels import focal_loss_sums

    x, labels, matches, grad = _focal_case(dev, 2, 693, 90, torch.float32, 0, seed=5)
    want = focal_loss_sums(x, labels, matches, 0.25, 2.0)
    for dtype in (torch.float16, torch.float64):
        xd = x.to(dtype).requires_grad_()
        got = focal_loss_sums(xd, labels, matches, 0.25, 2.0)
        got.backward(grad)
        assert got.dtype == torch.float32 and xd.grad.dtype == dtype
        ref = focal_loss_sums(xd.detach().float(), labels, matches, 0.25, 2.0)
        assert torch.equal(got, ref)
    assert torch.equal(focal_loss_sums(x.double(), labels, matches, 0.25, 2.0), want)
    empty = torch.zeros(2, 0, 90, device=dev, requires_grad=True)
    none = torch.zeros(2, 0, dtype=torch.int32, device=dev)
    out = focal_loss_sums(empty, none, none, 0.25, 2.0)
    out.sum().backward()
    assert out.tolist() == [0.0, 0.0] and empty.grad.shape == empty.shape


def test_focal_training_step_launches_the_pair(dev):
    """A resnet18 training step's per-level loss (the Trainer's) launches
    the pair once a level each way (2 x 5) on the bf16 logits; the
    concatenated loss of ``forward`` once each way on f32 logits; predict
    not at all."""
    from pytorch_retinanet_tpu_torch.kernels import focal_loss_sums

    net = _small_bf16_net()
    images = torch.rand(2, 64, 96, 3, device=dev)
    gt = (torch.tensor([[[4.0, 6.0, 40.0, 50.0]]] * 2, device=dev),
          torch.tensor([[1], [2]], device=dev), torch.ones(2, 1, dtype=torch.bool, device=dev))
    net.module.train()
    before = focal_loss_sums.launches
    cls_levels, box_levels = net.module(images, return_levels=True)
    assert all(c.dtype == torch.bfloat16 for c in cls_levels)
    losses = retinanet_loss_levels(cls_levels, box_levels, net._anchors_for((64, 96)), *gt,
                                   num_classes=net.num_classes)
    (losses["classification_loss"] + losses["regression_loss"]).backward()
    torch.cuda.synchronize()
    assert focal_loss_sums.launches - before == 2 * 5
    before = focal_loss_sums.launches
    losses = net.forward(images, dict(zip(("boxes", "labels", "valid"), gt)))
    (losses["classification_loss"] + losses["regression_loss"]).backward()
    torch.cuda.synchronize()
    assert focal_loss_sums.launches - before == 2
    before = focal_loss_sums.launches
    net.predict([np.zeros((64, 96, 3), np.uint8)])
    assert focal_loss_sums.launches == before

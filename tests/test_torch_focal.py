"""The focal loss's per-image sums under autograd (``kernels/focal.py``) on the CPU.

On the CPU the autograd Function computes its plain version, whose
operations the CUDA kernels repeat (``tests/test_torch_cuda.py`` holds them
to it on the card, at R-50's five levels too). Held here against
autograd through :func:`sigmoid_focal_loss` on a one-hot target of the
same dtype, masked to the anchors with ``matches >= -1`` and summed per
image: the composition the loss ran before, and still the reference.

Tolerances:

- f64: the sums within 1e-12 of the sum of their terms' magnitudes, the
  gradients within 1e-12 of the tensor's largest |gradient|;
- f32: the same at 1e-6 (the sigmoid below 0 is ``e * (1 / (1 + e))``
  where ``torch.sigmoid`` is ``1 / (1 + exp(-x))``: a few f32 ulp per term,
  and autograd rounds the gradient's chain at other points);
- bf16 logits: the sums as f32, the gradients within 1 bf16 ulp of the
  larger value (the f32 gradients that both round into bf16 sit a few f32
  ulp apart and may straddle a bf16 rounding boundary);
- through ``retinanet_loss_levels`` / ``retinanet_loss``: the losses
  within 1e-6 relative and the gradients within 1e-6 of each tensor's
  largest, in f32.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu_torch import KERNELS
from pytorch_retinanet_tpu_torch.config import (
    BBOX_REG_WEIGHTS,
    IOU_THRESHOLDS_BACKGROUND,
    IOU_THRESHOLDS_FOREGROUND,
    SMOOTH_L1_LOSS_BETA,
)
from pytorch_retinanet_tpu_torch.kernels import focal_loss_sums, match_targets_plain
from pytorch_retinanet_tpu_torch.ops import (
    generate_anchors_per_level,
    retinanet_loss,
    retinanet_loss_levels,
    sigmoid_focal_loss,
    smooth_l1_loss,
)
from pytorch_retinanet_tpu_torch.utils import metrics

fl = importlib.import_module("pytorch_retinanet_tpu_torch.kernels.focal")

TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def _case(b, a, c, dtype, seed=0, scale=3.0):
    """Logits, labels in 0..c (0 background) and matches in {-2, -1, row}:
    foreground, background and ignored anchors mixed."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, a, c, generator=g, dtype=torch.float64) * scale).to(dtype)
    kind = torch.randint(0, 3, (b, a), generator=g)  # 0 ignored, 1 background, 2 foreground
    matches = torch.where(kind == 2, torch.randint(0, 5, (b, a), generator=g),
                          kind - 2).to(torch.int32)
    labels = torch.where(kind == 2, torch.randint(1, c + 1, (b, a), generator=g),
                         torch.zeros((), dtype=torch.int64)).to(torch.int32)
    return x, labels, matches


def _composition(x, labels, matches, alpha, gamma):
    """The loss before the pair: sigmoid_focal_loss on a one-hot target of
    x's dtype, summed over classes, masked, summed over anchors."""
    c = x.shape[-1]
    onehot = (labels[..., None].long() == torch.arange(1, c + 1)).to(x.dtype)
    elem = sigmoid_focal_loss(x, onehot, alpha, gamma)
    return (elem.sum(-1) * (matches >= -1).to(x.dtype)).sum(1), elem


def _both(x, labels, matches, alpha, gamma, grad):
    """(sums, dx, |terms| per image) of the pair and of the composition,
    for the upstream gradient `grad` [B]."""
    xp = x.clone().requires_grad_()
    got = focal_loss_sums(xp, labels, matches, alpha, gamma)
    got.backward(grad)
    xc = x.clone().requires_grad_()
    want, elem = _composition(xc.float() if x.dtype == torch.bfloat16 else xc, labels, matches,
                              alpha, gamma)
    want.backward(grad.to(want.dtype))
    terms = (elem.detach().abs().sum(-1) * (matches >= -1)).sum(1)
    return got.detach(), xp.grad, want.detach(), xc.grad, terms


def _assert_sums(got, want, terms, tol):
    assert got.dtype == want.dtype
    assert bool(((got - want).abs() <= tol * terms + 1e-30).all()), (got, want)


def _assert_grads(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale + 1e-300


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("c", [3, 7, 90])
@pytest.mark.parametrize("gamma", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("alpha", [0.25, 0.5])
def test_plain_sums_and_gradients_match_the_composition(dtype, c, gamma, alpha):
    x, labels, matches = _case(3, 40, c, dtype, seed=c)
    grad = torch.tensor([0.5, -1.25, 2.0], dtype=dtype)
    got, dx, want, dx_ref, terms = _both(x, labels, matches, alpha, gamma, grad)
    _assert_sums(got, want, terms, TOL[dtype])
    _assert_grads(dx, dx_ref, TOL[dtype])


@pytest.mark.parametrize("c", [3, 90])
def test_bf16_logits_give_f32_sums_and_bf16_gradients(c):
    x, labels, matches = _case(2, 30, c, torch.bfloat16, seed=1)
    grad = torch.tensor([1.0, 0.25])
    got, dx, want, dx_ref, terms = _both(x, labels, matches, 0.25, 2.0, grad)
    assert got.dtype == torch.float32 and dx.dtype == torch.bfloat16
    _assert_sums(got, want, terms, 1e-6)
    _, e = torch.frexp(torch.maximum(dx.float().abs(), dx_ref.float().abs()))
    ulp = torch.ldexp(torch.ones_like(dx, dtype=torch.float32), e - 8)
    assert bool(((dx.float() - dx_ref.float()).abs() <= ulp).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_an_image_all_ignored_and_one_without_gt(dtype):
    """Image 0: every anchor ignored (sum 0, gradient 0); image 1: no GT,
    every anchor background; image 2: mixed."""
    x, labels, matches = _case(3, 25, 7, dtype, seed=4)
    matches[0] = -2
    labels[1], matches[1] = 0, -1
    grad = torch.ones(3, dtype=dtype)
    got, dx, want, dx_ref, terms = _both(x, labels, matches, 0.25, 2.0, grad)
    assert float(got[0]) == 0.0 and bool((dx[0] == 0).all())
    assert float(got[1]) > 0 and bool((dx[1] > 0).all())  # background pushes every logit down
    _assert_sums(got, want, terms, TOL[dtype])
    _assert_grads(dx, dx_ref, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("gamma", [0.0, 1.0, 2.0])
def test_saturated_logits_are_finite_and_equal_the_composition(dtype, gamma):
    """Logits of +-30 (and 0, where autograd's conventions decide) on
    foreground and background targets."""
    x = torch.tensor([30.0, -30.0, 0.0, 30.0, -30.0, 0.0, 1.5], dtype=dtype).repeat(2, 3, 1)
    labels = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    matches = torch.tensor([[0, 1, 2], [3, 4, -1]], dtype=torch.int32)
    grad = torch.tensor([1.0, 3.0], dtype=dtype)
    got, dx, want, dx_ref, terms = _both(x, labels, matches, 0.25, gamma, grad)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(dx).all())
    _assert_sums(got, want, terms, TOL[dtype])
    _assert_grads(dx, dx_ref, TOL[dtype])


def test_gradcheck_in_f64():
    x, labels, matches = _case(2, 6, 5, torch.float64, seed=7, scale=2.0)
    x.requires_grad_()
    assert torch.autograd.gradcheck(lambda t: focal_loss_sums(t, labels, matches, 0.25, 2.0),
                                    (x,), eps=1e-6, atol=1e-8)


def test_the_function_saves_only_its_inputs():
    x, labels, matches = _case(2, 10, 4, torch.float32)
    x.requires_grad_()
    out = focal_loss_sums(x, labels, matches, 0.25, 2.0)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and saved[0] is x and saved[1] is labels and saved[2] is matches


def test_plain_backward_is_autograd_through_the_plain_forward():
    """The hand-written plain backward against autograd through the plain
    forward's own operations, in f64."""
    x, labels, matches = _case(2, 20, 6, torch.float64, seed=9)
    grad = torch.tensor([0.75, -2.0], dtype=torch.float64)
    xr = x.clone().requires_grad_()
    fl.focal_loss_sums_plain(xr, labels, matches, 0.25, 2.0).backward(grad)
    dx = fl.focal_loss_backward_plain(grad, x, labels, matches, 0.25, 2.0)
    _assert_grads(dx, xr.grad, 1e-12)


# ---------------------------------------------------------------------------
# Through the loss: the per-level and concatenated losses on the pair equal
# the composition's, and the tracer's counter.
# ---------------------------------------------------------------------------
SIZE = (64, 96)
NUM_CLASSES = 6


def _loss_case(seed=0, b=3, n=9, n_valid=(4, 0, 9)):
    rng = np.random.default_rng(seed)
    anchors = [torch.from_numpy(np.asarray(a)) for a in generate_anchors_per_level(SIZE)]
    cls = [torch.from_numpy(rng.standard_normal((b, a.shape[0], NUM_CLASSES)).astype(np.float32) * 2)
           for a in anchors]
    box = [torch.from_numpy(rng.standard_normal((b, a.shape[0], 4)).astype(np.float32) * 0.3)
           for a in anchors]
    ctr = rng.uniform(0, 90, (b, n, 2))
    wh = rng.uniform(8, 60, (b, n, 2))
    valid = np.arange(n)[None] < np.asarray(n_valid)[:, None]
    gt = np.where(valid[..., None], np.concatenate([ctr - wh / 2, ctr + wh / 2], -1), 0.0)
    labels = np.where(valid, rng.integers(1, NUM_CLASSES + 1, (b, n)), 0)
    return (anchors, cls, box, torch.from_numpy(gt.astype(np.float32)),
            torch.from_numpy(labels.astype(np.int32)), torch.from_numpy(valid))


def _composition_losses(cls_levels, box_levels, anchors, gt, labels, valid, reduction):
    """The per-level loss as it ran before the pair: the one-hot and
    sigmoid_focal_loss."""
    reg_sum = cls_sum = num_fg = 0
    for cls_l, box_l, anc in zip(cls_levels, box_levels, anchors):
        with torch.no_grad():
            matches, fg_labels, reg_t = match_targets_plain(
                anc, gt, labels, valid, IOU_THRESHOLDS_FOREGROUND, IOU_THRESHOLDS_BACKGROUND,
                tuple(BBOX_REG_WEIGHTS))
        fg = matches >= 0
        c, _ = _composition(cls_l, fg_labels, matches, 0.25, 2.0)
        r = (smooth_l1_loss(box_l, reg_t, SMOOTH_L1_LOSS_BETA).sum(-1) * fg.float()).sum(1)
        reg_sum, cls_sum, num_fg = reg_sum + r, cls_sum + c, num_fg + fg.sum(1)
    norm = torch.clamp(num_fg.float(), min=1.0)
    out = {"classification_loss": cls_sum / norm, "regression_loss": reg_sum / norm}
    return {k: v.mean() for k, v in out.items()} if reduction == "mean" else out


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("concat", [False, True])
def test_the_loss_on_the_pair_equals_the_composition(reduction, concat):
    anchors, cls, box, gt, labels, valid = _loss_case()
    runs = []
    for fn in ("pair", "composition"):
        cls_t = [c.clone().requires_grad_() for c in cls]
        box_t = [b.clone().requires_grad_() for b in box]
        if fn == "composition":
            out = _composition_losses(cls_t, box_t, anchors, gt, labels, valid, reduction)
        elif concat:
            out = retinanet_loss(torch.cat(cls_t, 1), torch.cat(box_t, 1), torch.cat(anchors), gt,
                                 labels, valid, num_classes=NUM_CLASSES, reduction=reduction)
        else:
            out = retinanet_loss_levels(cls_t, box_t, anchors, gt, labels, valid,
                                        num_classes=NUM_CLASSES, reduction=reduction)
        (out["classification_loss"].sum() + out["regression_loss"].sum()).backward()
        runs.append((out, [t.grad for t in cls_t + box_t]))
    (got, got_g), (want, want_g) = runs
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].detach().numpy(), rtol=1e-6)
    for g, w in zip(got_g, want_g):
        _assert_grads(g, w, 1e-6)


def test_the_counter_counts_each_level_once_a_backward():
    anchors, cls, box, gt, labels, valid = _loss_case(seed=2)
    cls_t = [c.clone().requires_grad_() for c in cls]
    metrics.drain()
    with metrics.tracing():
        out = retinanet_loss_levels(cls_t, box, anchors, gt, labels, valid, num_classes=NUM_CLASSES)
        counters = metrics.drain()["counters"]
        assert "focal.backward" not in counters  # forwards are not counted
        out["classification_loss"].backward()
        counters = metrics.drain()["counters"]
    assert len(anchors) == 5 and counters["focal.backward"] == 5


def test_the_counter_reads_nothing_under_no_grad():
    anchors, cls, box, gt, labels, valid = _loss_case(seed=3)
    metrics.drain()
    with metrics.tracing(), torch.no_grad():
        out = retinanet_loss_levels([c.requires_grad_() for c in cls], box, anchors, gt, labels,
                                    valid, num_classes=NUM_CLASSES)
        counters = metrics.drain()["counters"]
    assert out["classification_loss"].grad_fn is None
    assert counters.get("focal.backward", 0) == 0


def test_the_loss_refuses_logits_of_another_class_count():
    anchors, cls, box, gt, labels, valid = _loss_case()
    with pytest.raises(ValueError, match="num_classes"):
        retinanet_loss_levels(cls, box, anchors, gt, labels, valid, num_classes=NUM_CLASSES + 1)


# ---------------------------------------------------------------------------
# The wrapper and the kernels' launch arguments.
# ---------------------------------------------------------------------------
def test_kernels_names_the_focal_pair():
    entry = next(k for k in KERNELS if k.name == "focal_loss")
    assert entry.wrapper is focal_loss_sums and entry.route == "cuda"
    assert entry.source == "pytorch_retinanet_tpu_torch/csrc/focal.cu"
    assert entry.replaces.startswith("none")
    assert isinstance(focal_loss_sums.launches, int)


@pytest.mark.parametrize("dtype,offset,want", [
    (torch.bfloat16, 0, 8),  # the main path: 16-byte vectors
    (torch.float32, 0, 4),
    (torch.bfloat16, 1, 1),  # storage off 16-byte alignment
    (torch.float32, 2, 1),
])
def test_launch_arguments(dtype, offset, want):
    flat = torch.zeros(2 * 5 * 7 + offset, dtype=dtype)[offset:]
    x = flat.view(2, 5, 7)
    assert fl._launch_args(x) == (2, 5, 7, want, int(dtype == torch.bfloat16))
    assert fl._launch_args(torch.zeros(2, 5, 7, dtype=dtype), x)[3] == want


@pytest.mark.parametrize("gamma,mode", [(0, 0), (1.0, 1), (2, 2), (2.5, 3), (0.5, 3)])
def test_gamma_modes(gamma, mode):
    assert fl._gamma_mode(gamma) == mode
    assert fl._constants(0.25, gamma) == (0.25, 0.75, float(gamma), float(gamma) - 1.0, mode)


def test_generic_gamma_matches_the_composition():
    x, labels, matches = _case(2, 30, 5, torch.float64, seed=11)
    grad = torch.tensor([1.0, -0.5], dtype=torch.float64)
    got, dx, want, dx_ref, terms = _both(x, labels, matches, 0.25, 2.5, grad)
    _assert_sums(got, want, terms, 1e-12)
    _assert_grads(dx, dx_ref, 1e-12)


def test_wrapper_refuses_mismatched_shapes():
    x = torch.zeros(2, 5, 3)
    ok = torch.zeros(2, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="logits \\[B, A, C\\]"):
        focal_loss_sums(x[0], ok[0], ok[0], 0.25, 2.0)
    with pytest.raises(ValueError, match="labels and matches \\[B, A\\]"):
        focal_loss_sums(x, ok[:, :4], ok, 0.25, 2.0)
    with pytest.raises(ValueError, match="labels and matches \\[B, A\\]"):
        focal_loss_sums(x, ok, ok[:1], 0.25, 2.0)


def test_an_empty_anchor_set_sums_to_zero():
    x = torch.zeros(2, 0, 4, requires_grad=True)
    none = torch.zeros(2, 0, dtype=torch.int32)
    out = focal_loss_sums(x, none, none, 0.25, 2.0)
    out.sum().backward()
    assert out.tolist() == [0.0, 0.0] and x.grad.shape == x.shape

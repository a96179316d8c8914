"""Training losses of the PyTorch port vs the JAX package (CPU).

The same numpy head outputs, anchors (the 64x96 bucket's five levels) and
padded GT (a few rows, padding rows, an image without GT) go through the
JAX ``retinanet_loss`` / ``retinanet_loss_levels`` and the port's; the
gradients with respect to the head outputs come from ``jax.grad`` and from
``torch.autograd``.

Tolerances: losses within 2e-6 relative; gradients within 1e-5 relative to
each tensor's largest gradient (f32; ``exp``, ``log1p`` and ``sigmoid`` are
not correctly rounded and the sums run in another order). The elementwise
focal and smooth-L1 terms within 1e-6 relative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.ops import losses as jax_losses
from pytorch_retinanet_tpu_torch.ops import (
    generate_anchors_per_level,
    retinanet_loss,
    retinanet_loss_levels,
    sigmoid_focal_loss,
    smooth_l1_loss,
)

NUM_CLASSES = 6
SIZE = (64, 96)
LOSS_RTOL = 2e-6
GRAD_TOL = 1e-5


def make_case(seed=0, b=3, n=9, n_valid=(4, 0, 9)):
    rng = np.random.default_rng(seed)
    anchors = [np.asarray(a) for a in generate_anchors_per_level(SIZE)]
    cls = [rng.standard_normal((b, a.shape[0], NUM_CLASSES)).astype(np.float32) * 2 for a in anchors]
    box = [rng.standard_normal((b, a.shape[0], 4)).astype(np.float32) * 0.3 for a in anchors]
    ctr = rng.uniform(0, 90, (b, n, 2))
    wh = rng.uniform(8, 60, (b, n, 2))
    gt = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    valid = np.arange(n)[None] < np.asarray(n_valid)[:, None]
    gt = np.where(valid[..., None], gt, 0.0).astype(np.float32)
    labels = np.where(valid, rng.integers(1, NUM_CLASSES + 1, (b, n)), 0).astype(np.int32)
    return anchors, cls, box, gt, labels, valid


@pytest.fixture(scope="module")
def case():
    return make_case()


def _jax_levels(case, reduction="mean"):
    anchors, cls, box, gt, labels, valid = case

    def total(levels):
        out = jax_losses.retinanet_loss_levels(
            levels[0], levels[1], [jnp.asarray(a) for a in anchors], jnp.asarray(gt),
            jnp.asarray(labels), jnp.asarray(valid), num_classes=NUM_CLASSES, reduction=reduction)
        return out["classification_loss"].sum() + out["regression_loss"].sum(), out

    levels = ([jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box])
    (_, out), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(levels)
    return out, grads


def _port_levels(case, reduction="mean", use_match_kernel=None):
    anchors, cls, box, gt, labels, valid = case
    cls_t = [torch.tensor(c, requires_grad=True) for c in cls]
    box_t = [torch.tensor(b, requires_grad=True) for b in box]
    out = retinanet_loss_levels(
        cls_t, box_t, [torch.from_numpy(a) for a in anchors], torch.from_numpy(gt),
        torch.from_numpy(labels), torch.from_numpy(valid), num_classes=NUM_CLASSES,
        reduction=reduction, use_match_kernel=use_match_kernel)
    (out["classification_loss"].sum() + out["regression_loss"].sum()).backward()
    return out, ([t.grad for t in cls_t], [t.grad for t in box_t])


def _assert_grads(got, want):
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            w = np.asarray(w)
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * scale)


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_loss_levels_and_grads_match_jax(case, reduction):
    want, want_grads = _jax_levels(case, reduction)
    got, got_grads = _port_levels(case, reduction)
    for k in ("classification_loss", "regression_loss"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=LOSS_RTOL, atol=0)
    _assert_grads(got_grads, want_grads)
    assert any(float(g.abs().max()) > 0 for g in got_grads[1])


def test_concat_loss_and_grads_match_jax(case):
    anchors, cls, box, gt, labels, valid = case
    cls_cat, box_cat = np.concatenate(cls, 1), np.concatenate(box, 1)
    anc_cat = np.concatenate(anchors, 0)

    def total(c, b):
        out = jax_losses.retinanet_loss(c, b, jnp.asarray(anc_cat), jnp.asarray(gt),
                                        jnp.asarray(labels), jnp.asarray(valid),
                                        num_classes=NUM_CLASSES)
        return out["classification_loss"] + out["regression_loss"], out

    (_, want), want_grads = jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True))(
        jnp.asarray(cls_cat), jnp.asarray(box_cat))
    c_t = torch.tensor(cls_cat, requires_grad=True)
    b_t = torch.tensor(box_cat, requires_grad=True)
    got = retinanet_loss(c_t, b_t, torch.from_numpy(anc_cat), torch.from_numpy(gt),
                         torch.from_numpy(labels), torch.from_numpy(valid), num_classes=NUM_CLASSES)
    (got["classification_loss"] + got["regression_loss"]).backward()
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, atol=0)
    _assert_grads(([c_t.grad], [b_t.grad]), ([want_grads[0]], [want_grads[1]]))


def test_levels_equal_concat_on_the_port(case):
    anchors, cls, box, gt, labels, valid = case
    t = [torch.from_numpy(x) for x in (gt, labels, valid)]
    lv = retinanet_loss_levels([torch.from_numpy(c) for c in cls], [torch.from_numpy(b) for b in box],
                               [torch.from_numpy(a) for a in anchors], *t, num_classes=NUM_CLASSES,
                               reduction="none")
    cat = retinanet_loss(torch.from_numpy(np.concatenate(cls, 1)), torch.from_numpy(np.concatenate(box, 1)),
                         torch.from_numpy(np.concatenate(anchors, 0)), *t, num_classes=NUM_CLASSES,
                         reduction="none")
    for k in lv:
        torch.testing.assert_close(lv[k], cat[k], rtol=1e-6, atol=0)


def test_zero_gt_images_give_finite_zero_regression_loss():
    case = make_case(seed=1, b=2, n_valid=(0, 0))
    got, grads = _port_levels(case, reduction="none")
    assert torch.equal(got["regression_loss"].detach(), torch.zeros(2))
    assert torch.isfinite(got["classification_loss"]).all()
    # Every anchor is ignored: neither loss has a gradient.
    assert all(float(g.abs().max()) == 0 for g in grads[0] + grads[1])


def test_match_kernel_on_cpu_raises(case):
    with pytest.raises(ValueError, match="CUDA"):
        _port_levels(case, use_match_kernel=True)
    with pytest.raises(TypeError, match="match_mesh"):
        retinanet_loss_levels([], [], [], None, None, None, num_classes=1, match_mesh=object())


def test_explicit_plain_arm_equals_default_on_cpu(case):
    a, _ = _port_levels(case, use_match_kernel=False)
    b, _ = _port_levels(case)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_elementwise_terms_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((500, 7)) * 4).astype(np.float32)
    t = (rng.uniform(size=(500, 7)) < 0.2).astype(np.float32)
    np.testing.assert_allclose(sigmoid_focal_loss(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
                               np.asarray(jax_losses.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(t))),
                               rtol=1e-6, atol=1e-12)
    y = (rng.standard_normal((500, 4)) * 0.2).astype(np.float32)
    for beta in (0.1, 0.0):
        np.testing.assert_allclose(
            smooth_l1_loss(torch.from_numpy(x[:, :4]), torch.from_numpy(y), beta).numpy(),
            np.asarray(jax_losses.smooth_l1_loss(jnp.asarray(x[:, :4]), jnp.asarray(y), beta)),
            rtol=1e-6, atol=0)

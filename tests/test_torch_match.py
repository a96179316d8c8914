"""Match targets of the PyTorch port vs the JAX package (CPU).

The same numpy inputs go through the port's ``match_targets_plain`` (and its
``match_targets`` wrapper, which takes the plain version for CPU tensors),
the JAX ``match_targets`` Pallas kernel in interpret mode, and the XLA
composition of ``ops/losses.py::_loss_sums`` that the JAX kernel tests hold
it to (``tests/test_match_kernel.py::reference_targets``).

Tolerances: ``matches`` and ``fg_labels`` exactly equal; the centre targets
(``reg_targets[..., :2]``, differences and divisions, correctly rounded on
both sides) exactly equal; the size targets (``reg_targets[..., 2:]``,
through ``log``, which is not correctly rounded) within 2 f32 ulp.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.kernels.match_pallas import match_targets as jax_match_targets
from pytorch_retinanet_tpu.ops.matcher import match_anchors_batch as jax_match_anchors_batch
from pytorch_retinanet_tpu_torch.kernels import match_targets, match_targets_plain
from pytorch_retinanet_tpu_torch.ops import match_anchors, match_anchors_batch
from test_match_kernel import reference_targets


def random_case(rng, b=2, a=300, n=13, n_valid=None, num_classes=7, spread=800.0):
    ctr = rng.uniform(0, spread, (a, 2))
    wh = rng.uniform(8, 256, (a, 2))
    anchors = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    gctr = rng.uniform(0, spread, (b, n, 2))
    gwh = rng.uniform(8, 300, (b, n, 2))
    gt = np.concatenate([gctr - gwh / 2, gctr + gwh / 2], -1).astype(np.float32)
    labels = rng.integers(1, num_classes + 1, (b, n)).astype(np.int32)
    if n_valid is None:
        valid = rng.uniform(size=(b, n)) > 0.3
    else:
        valid = np.arange(n)[None] < np.asarray(n_valid)[:, None]
    gt = np.where(valid[..., None], gt, 0.0).astype(np.float32)
    labels = np.where(valid, labels, 0).astype(np.int32)
    return anchors, gt, labels, valid


def tie_case():
    """Two identical GT rows (and a third that overlaps less) under one
    anchor: the first of the two must win."""
    anchors = np.array([[0, 0, 10, 10], [100, 100, 120, 130]], np.float32)
    gt = np.array([[[50, 50, 60, 60], [0, 0, 10, 10], [0, 0, 10, 10], [1, 1, 9, 9]]], np.float32)
    labels = np.array([[4, 3, 5, 6]], np.int32)
    valid = np.ones((1, 4), bool)
    return anchors, gt, labels, valid


def threshold_case():
    """IoU exactly 0.5 and exactly 0.4: both strict, so both ignored."""
    anchors = np.array([[0.0, 0.0, 1.0, 0.5], [0.0, 0.0, 1.0, 0.4]], np.float32)
    gt = np.array([[[0.0, 0.0, 1.0, 1.0]]], np.float32)
    return anchors, gt, np.array([[1]], np.int32), np.ones((1, 1), bool)


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def assert_targets_equal(got, want):
    g_m, g_l, g_r = (np.asarray(t) for t in got)
    w_m, w_l, w_r = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(g_m, w_m, err_msg="matches")
    np.testing.assert_array_equal(g_l, w_l, err_msg="fg_labels")
    np.testing.assert_array_equal(g_r[..., :2], w_r[..., :2], err_msg="centre targets")
    assert ulp_distance(g_r[..., 2:], w_r[..., 2:]).max() <= 2, "size targets beyond 2 ulp"


def port(case):
    return match_targets_plain(*(torch.from_numpy(x) for x in case))


def jax_kernel(case, tile=256):
    a, g, l, v = (jnp.asarray(x) for x in case)
    return jax_match_targets(a, g, l, v, fg_iou_thr=0.5, bg_iou_thr=0.4, tile=tile, interpret=True)


def jax_xla(case):
    return reference_targets(*(jnp.asarray(x) for x in case))


CASES = {
    "random0": lambda: random_case(np.random.default_rng(0)),
    "random1": lambda: random_case(np.random.default_rng(1), b=3, num_classes=90),
    "a_tile_remainder_37": lambda: random_case(np.random.default_rng(2), a=37),
    "a_tile_remainder_300": lambda: random_case(np.random.default_rng(3), a=300, spread=300.0),
    "one_gt_row": lambda: random_case(np.random.default_rng(4), n=1),
    "130_gt_rows": lambda: random_case(np.random.default_rng(5), n=130, spread=400.0),
    "zero_gt_image": lambda: random_case(np.random.default_rng(6), b=3, n_valid=[5, 0, 2]),
    "all_padding": lambda: random_case(np.random.default_rng(7), b=2, n_valid=[0, 0]),
    "tie": tie_case,
    "threshold": threshold_case,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel_and_xla(name):
    case = CASES[name]()
    got = port(case)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    assert got[2].dtype == torch.float32 and got[2].shape == (*case[1].shape[:1], case[0].shape[0], 4)
    assert_targets_equal(got, jax_kernel(case))
    assert_targets_equal(got, jax_xla(case))


def test_wrapper_takes_the_plain_version_on_cpu():
    case = [torch.from_numpy(x) for x in random_case(np.random.default_rng(8))]
    before = match_targets.launches
    got, want = match_targets(*case), match_targets_plain(*case)
    assert match_targets.launches == before  # no kernel launch on the CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_mixed_devices_and_bad_shapes():
    anchors, gt, labels, valid = (torch.from_numpy(x) for x in random_case(np.random.default_rng(9)))
    with pytest.raises(ValueError, match="same device"):
        match_targets(anchors.to("meta"), gt, labels, valid)
    with pytest.raises(ValueError):
        match_targets(anchors, gt[:, :, :3], labels, valid)
    with pytest.raises(ValueError, match="at least one"):
        match_targets(anchors, gt[:, :0], labels[:, :0], valid[:, :0])


def test_tie_and_zero_gt_rules():
    m, l, _ = port(tie_case())
    assert m.tolist() == [[1, -1]] and l.tolist() == [[3, 0]]
    m, l, r = port(random_case(np.random.default_rng(10), b=3, n_valid=[5, 0, 2]))
    assert (m[1] == -2).all() and (l[1] == 0).all() and torch.isfinite(r).all()
    m, _, _ = port(threshold_case())
    assert m.tolist() == [[-2, -2]]


def test_matcher_max_iou_matches_jax():
    """The matcher's own outputs: matches exact, max_iou exactly equal (IoU
    is correctly rounded on both sides), and the single-image form."""
    anchors, gt, _, valid = random_case(np.random.default_rng(11), b=3, n_valid=[4, 0, 13])
    got = match_anchors_batch(torch.from_numpy(anchors), torch.from_numpy(gt), torch.from_numpy(valid))
    want = jax_match_anchors_batch(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid))
    np.testing.assert_array_equal(got.matches.numpy(), np.asarray(want.matches))
    np.testing.assert_array_equal(got.max_iou.numpy(), np.asarray(want.max_iou))
    one = match_anchors(torch.from_numpy(anchors), torch.from_numpy(gt[2]), torch.from_numpy(valid[2]))
    assert torch.equal(one.matches, got.matches[2]) and torch.equal(one.max_iou, got.max_iou[2])

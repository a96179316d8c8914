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


# --- The CUDA kernel's scan, emulated in numpy --------------------------------
#
# ``csrc/match.cu`` scans, per 256-anchor block, only the valid GT rows that
# overlap the block's bounding box, from IoU 0 at the first valid row, and
# skips the division where the intersection has a zero side. The emulation
# below follows those steps with the kernel's f32 operations in its order;
# it must equal ``match_targets_plain`` (held above against JAX) exactly.

MATCH_BLOCK = 256


def _area(b):
    return np.maximum(b[..., 2] - b[..., 0], np.float32(0)) * np.maximum(b[..., 3] - b[..., 1], np.float32(0))


def kernel_scan_emulation(anchors, gt, labels, valid, fg_thr=0.5, bg_thr=0.4):
    """(matches [B, A], fg_labels [B, A], staged rows [B, blocks], valid rows [B])."""
    n_blocks = -(-anchors.shape[0] // MATCH_BLOCK)
    matches = np.empty((gt.shape[0], anchors.shape[0]), np.int32)
    staged = np.zeros((gt.shape[0], n_blocks), np.int64)
    area_g = _area(gt)
    for b in range(gt.shape[0]):
        rows = np.flatnonzero(valid[b])
        for blk in range(n_blocks):
            sl = slice(blk * MATCH_BLOCK, (blk + 1) * MATCH_BLOCK)
            an = anchors[sl]
            bx1, by1, bx2, by2 = an[:, 0].min(), an[:, 1].min(), an[:, 2].max(), an[:, 3].max()
            g = gt[b, rows]
            culled = (g[:, 2] <= bx1) | (g[:, 0] >= bx2) | (g[:, 3] <= by1) | (g[:, 1] >= by2)
            kept = rows[~culled]
            staged[b, blk] = len(kept)
            any_gt = len(rows) > 0
            best = np.full(len(an), 0.0 if any_gt else -2.0, np.float32)
            idx = np.full(len(an), rows[0] if any_gt else 0, np.int32)
            area_a = _area(an)
            for j in kept:
                gj = gt[b, j]
                iw = np.maximum(np.minimum(gj[2], an[:, 2]) - np.maximum(gj[0], an[:, 0]), np.float32(0))
                ih = np.maximum(np.minimum(gj[3], an[:, 3]) - np.maximum(gj[1], an[:, 1]), np.float32(0))
                inter = iw * ih
                v = inter / np.maximum((area_g[b, j] + area_a) - inter, np.float32(1e-12))
                upd = (iw != 0) & (ih != 0) & (v > best)
                best = np.where(upd, v, best)
                idx = np.where(upd, np.int32(j), idx)
            m = np.where(best < bg_thr, -1, -2)
            m = np.where(best > fg_thr, idx, m)
            matches[b, sl] = m if any_gt else -2
    fg_labels = np.where(matches >= 0, np.take_along_axis(labels, np.maximum(matches, 0), 1), 0)
    return matches, fg_labels.astype(np.int32), staged, valid.sum(1)


def _level0_anchors():
    from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level

    return generate_anchors_per_level((128, 192))


TIE_ANCHOR = 2916  # P3 of 128x192: position row 13, column 12, the first shape


def bucket_case(seed):
    """The real anchor layout of the 128x192 bucket, and GT that exercises the
    cull: large and small boxes, valid masks that are not a prefix (the first
    valid row past 0), zero-area rows, an image without GT, one whose only
    rows (5 and 7) lie near the bottom, and a tie between rows 5 and 7 under
    anchor TIE_ANCHOR of P3 with row 6, in the top corner, culled there."""
    rng = np.random.default_rng(seed)
    levels = _level0_anchors()
    b, n = 4, 24
    ctr = rng.uniform([0, 0], [192, 128], (b, n, 2))
    wh = np.where(rng.uniform(size=(b, n, 1)) < 0.5, rng.uniform(4, 40, (b, n, 2)),
                  rng.uniform(16, 200, (b, n, 2)))
    gt = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).clip(0, [192, 128, 192, 128])
    gt[:, 3, 2] = gt[:, 3, 0]                 # zero width
    gt[:, 8, 3] = gt[:, 8, 1]                 # zero height
    gt[:, 5] = gt[:, 7] = levels[0][TIE_ANCHOR]
    gt[:, 6] = [0.0, 0.0, 2.0, 2.0]
    valid = rng.uniform(size=(b, n)) < 0.7
    valid[:, :2] = False                      # first valid row past 0
    valid[:, 3:9] = True
    valid[2] = False                          # no GT
    valid[3] = False
    valid[3, [5, 7]] = True                   # near the bottom only: upper blocks stage nothing
    gt = np.where(valid[..., None], gt, 0.0).astype(np.float32)
    labels = np.where(valid, rng.integers(1, 91, (b, n)), 0).astype(np.int32)
    return levels, gt, labels, valid


def unordered_case(seed):
    anchors, gt, labels, valid = random_case(np.random.default_rng(seed), b=3, a=700, n=40,
                                             spread=600.0)
    rng = np.random.default_rng(seed + 100)
    anchors = anchors[rng.permutation(len(anchors))]
    valid[:, 0] = False
    valid[1] = False
    gt = np.where(valid[..., None], gt, 0.0).astype(np.float32)
    return [anchors], gt, labels, valid


EMULATION_CASES = {
    "bucket_128x192_seed0": lambda: bucket_case(0),
    "bucket_128x192_seed1": lambda: bucket_case(1),
    "unordered_anchors": lambda: unordered_case(12),
}
# (0.5, 0.4) are the detector's; (-0.5, 0.0) makes the row chosen for an
# anchor with IoU 0 everywhere (the first valid row) show in ``matches``.
THRESHOLDS = [(0.5, 0.4), (-0.5, 0.0)]


@pytest.mark.parametrize("thr", THRESHOLDS, ids=["detector", "sentinel_visible"])
@pytest.mark.parametrize("name", sorted(EMULATION_CASES))
def test_kernel_scan_emulation_equals_plain(name, thr):
    levels, gt, labels, valid = EMULATION_CASES[name]()
    staged_total = pairs_total = 0
    for anchors in levels:
        m, fl, staged, n_valid = kernel_scan_emulation(anchors, gt, labels, valid, *thr)
        want = match_targets_plain(*(torch.from_numpy(x) for x in (anchors, gt, labels, valid)), *thr)
        np.testing.assert_array_equal(m, want[0].numpy())
        np.testing.assert_array_equal(fl, want[1].numpy())
        staged_total += staged.sum()
        pairs_total += (n_valid[:, None] * np.ones_like(staged)).sum()
    assert staged_total > 0
    if name.startswith("bucket"):  # unordered anchors span the image: nothing to cull
        assert staged_total < pairs_total


def test_kernel_scan_emulation_edge_blocks():
    """On P3 of the bucket: a block that stages no row while the image has
    valid rows (its anchors then take the first valid row at IoU 0), and the
    tie under TIE_ANCHOR going to row 5 across the culled row 6."""
    levels, gt, labels, valid = bucket_case(0)
    m, _, staged, n_valid = kernel_scan_emulation(levels[0], gt, labels, valid, -0.5, 0.0)
    first_valid = valid.argmax(1)
    sentinel_only = np.argwhere((staged == 0) & (n_valid[:, None] > 0))
    assert len(sentinel_only) > 0
    b, blk = sentinel_only[0]
    assert (m[b, blk * MATCH_BLOCK:(blk + 1) * MATCH_BLOCK] == first_valid[b]).all()
    assert first_valid[0] > 0
    m, _, staged, _ = kernel_scan_emulation(levels[0], gt, labels, valid)
    assert (m[[0, 1, 3], TIE_ANCHOR] == 5).all() and (m[2] == -2).all()
    blk = TIE_ANCHOR // MATCH_BLOCK
    box = levels[0][blk * MATCH_BLOCK:(blk + 1) * MATCH_BLOCK]
    g6 = gt[0, 6]
    assert g6[2] <= box[:, 0].min() or g6[0] >= box[:, 2].max() or \
        g6[3] <= box[:, 1].min() or g6[1] >= box[:, 3].max()  # row 6 is culled there

"""PyTorch port vs the JAX package: anchors and box ops (CPU).

Tolerances: anchors are bit-identical (both are the same numpy code).
Box ops built from +, -, *, /, min and max are bit-identical. Ops that call
``exp`` or ``log`` (encode, decode) agree within 2 f32 ulps of the largest
magnitude in each box, because XLA's CPU ``exp``/``log`` and PyTorch's are
different approximations (measured: 1 ulp apart on ~10% of inputs).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.ops import anchors as jax_anchors
from pytorch_retinanet_tpu.ops import boxes as jax_boxes
from pytorch_retinanet_tpu_torch.ops import anchors as port_anchors
from pytorch_retinanet_tpu_torch.ops import boxes as port_boxes


@pytest.mark.parametrize("size", [(800, 1344), (1344, 800), (64, 96)])
def test_anchors_bit_identical(size):
    ref = jax_anchors.generate_anchors_per_level(size)
    got = port_anchors.generate_anchors_per_level(size)
    assert len(ref) == len(got) == 5
    for r, g in zip(ref, got):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(
        port_anchors.generate_anchors(size), jax_anchors.generate_anchors(size)
    )
    assert port_anchors.feature_grid_sizes(size) == jax_anchors.feature_grid_sizes(size)
    assert port_anchors.num_anchors_per_location() == jax_anchors.num_anchors_per_location()


def _random_boxes(rng, n):
    lo = rng.uniform(-20, 500, (n, 2)).astype(np.float32)
    wh = rng.uniform(0.0, 200, (n, 2)).astype(np.float32)
    wh[: n // 10] = 0.005  # some below small_box_mask's 1e-2
    return np.concatenate([lo, lo + wh], axis=-1)


@pytest.fixture(scope="module")
def boxes():
    rng = np.random.default_rng(0)
    a, b = _random_boxes(rng, 300), _random_boxes(rng, 200)
    deltas = rng.normal(0, 3, (300, 4)).astype(np.float32)  # some beyond the ±6 clip
    return rng, a, b, deltas


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_ulps(got, ref, ulps=2):
    tol = ulps * np.spacing(np.abs(ref).max(axis=-1, keepdims=True))
    excess = np.abs(got - ref) - tol
    assert excess.max() <= 0, f"{int((excess > 0).sum())} values beyond {ulps} ulps"


def test_exact_box_ops(boxes):
    rng, a, b, _ = boxes
    np.testing.assert_array_equal(
        port_boxes.box_iou(_t(a), _t(b)).numpy(), np.asarray(jax_boxes.box_iou(a, b))
    )
    np.testing.assert_array_equal(
        port_boxes.box_area(_t(a)).numpy(), np.asarray(jax_boxes.box_area(a))
    )
    np.testing.assert_array_equal(
        port_boxes.small_box_mask(_t(a)).numpy(), np.asarray(jax_boxes.small_box_mask(a))
    )
    np.testing.assert_array_equal(
        port_boxes.clip_boxes(_t(a), (300, 410)).numpy(),
        np.asarray(jax_boxes.clip_boxes(a, (300, 410))),
    )
    np.testing.assert_array_equal(
        port_boxes.xyxy_to_cxcywh(_t(a)).numpy(), np.asarray(jax_boxes.xyxy_to_cxcywh(a))
    )
    frm = np.array([[64.0, 96.0], [50.0, 70.0]], np.float32)
    to = np.array([[480.0, 640.0], [33.0, 47.0]], np.float32)
    batched = a[:200].reshape(2, 100, 4)
    np.testing.assert_array_equal(
        port_boxes.rescale_boxes(_t(batched), _t(frm)[:, None], _t(to)[:, None]).numpy(),
        np.asarray(jax_boxes.rescale_boxes(batched, frm[:, None], to[:, None])),
    )


def test_clip_boxes_per_image_sizes(boxes):
    """[B, 2] tensor sizes clip each image to its own size, like the JAX vmap."""
    _, a, _, _ = boxes
    batched = a[:200].reshape(2, 100, 4)
    sizes = np.array([[300.0, 410.0], [120.0, 90.0]], np.float32)
    got = port_boxes.clip_boxes(_t(batched), _t(sizes)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax_boxes.clip_boxes(batched[i], jnp.asarray(sizes[i])))
        )


def test_encode_decode_within_ulps(boxes):
    _, a, b, deltas = boxes
    gt = _random_boxes(np.random.default_rng(1), 300)
    gt[:, 2:] += 1.0  # positive sizes for the log
    anchors = a + np.float32([0, 0, 1, 1])
    _assert_ulps(
        port_boxes.encode_boxes(_t(gt), _t(anchors)).numpy(),
        np.asarray(jax_boxes.encode_boxes(gt, anchors)),
    )
    weights = (10.0, 10.0, 5.0, 5.0)
    _assert_ulps(
        port_boxes.decode_boxes(_t(deltas), _t(a), weights).numpy(),
        np.asarray(jax_boxes.decode_boxes(deltas, a, weights)),
    )
    # ±6 clip on the size logs: huge deltas stay finite.
    huge = np.full((4, 4), 50.0, np.float32)
    assert np.isfinite(port_boxes.decode_boxes(_t(huge), _t(a[:4])).numpy()).all()

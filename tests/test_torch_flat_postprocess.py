"""Batched flat postprocess of the PyTorch port vs the JAX flat path (CPU).

Identical bf16 logits over all anchors, quantized to quarter steps so that
many values tie, and bf16 deltas go through the port's
``process_detections_batch`` and JAX's
``process_detections_batch(..., use_pallas=False)``: the top-k over every
(anchor, class) pair's sigmoid, decode, clip, class-offset NMS, packing.

Tolerances, as ``tests/test_torch_postprocess.py`` states them: labels and
valid flags exactly equal (so the selection, its tie order and NMS agree);
scores within 1 f32 ulp (XLA's CPU sigmoid uses its own ``exp``); boxes
within 1e-4 absolute plus 1e-6 relative, for the same ``exp`` in the decode.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.ops.nms import process_detections_batch as jax_flat
from pytorch_retinanet_tpu_torch.ops import (
    generate_anchors,
    process_detections,
    process_detections_batch,
)

C = 5


def _inputs(seed, image=(128, 192)):
    rng = np.random.default_rng(seed)
    anchors = generate_anchors(image)
    cls = (rng.integers(-12, 8, (2, len(anchors), C)) * 0.25).astype(np.float32)
    d = rng.normal(0, 0.5, (2, len(anchors), 4)).astype(np.float32)
    box = np.asarray(jnp.asarray(d, jnp.bfloat16), np.float32)  # bf16-exact
    sizes = np.array([image, [image[0] - 28, image[1] - 42]], np.float32)
    return cls, box, anchors, sizes


def _port(cls, box, anchors, sizes, **kw):
    return process_detections_batch(
        torch.from_numpy(cls).to(torch.bfloat16), torch.from_numpy(box).to(torch.bfloat16),
        torch.from_numpy(anchors), torch.from_numpy(sizes), **kw,
    )


# (pre_nms_top_k, image): k below A * C (4608 anchors x 5 classes at
# 128x192), and a 32x32 image whose A * C (207 x 5 = 1035) is below the k
# asked for.
CASES = [(1000, (128, 192)), (100, (128, 192)), (4096, (32, 32))]


@pytest.mark.parametrize("pre_nms_top_k,image", CASES)
def test_flat_postprocess_matches_jax(pre_nms_top_k, image):
    cls, box, anchors, sizes = _inputs(pre_nms_top_k, image)
    if image == (32, 32):
        assert len(anchors) * C < pre_nms_top_k
    kw = dict(score_thres=0.05, nms_thres=0.5, max_detections=100, pre_nms_top_k=pre_nms_top_k)
    ref = jax_flat(
        jnp.asarray(cls, jnp.bfloat16), jnp.asarray(box, jnp.bfloat16),
        anchors, jnp.asarray(sizes), use_pallas=False, **kw,
    )
    got = _port(cls, box, anchors, sizes, **kw)
    assert got.labels.dtype == torch.int32 and got.valid.dtype == torch.bool
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert got.valid.any()
    np.testing.assert_array_max_ulp(got.scores.numpy(), np.asarray(ref.scores), maxulp=1)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), rtol=1e-6, atol=1e-4)
    # The plain NMS arm is the same function on the CPU.
    plain = _port(cls, box, anchors, sizes, use_kernel=False, **kw)
    for a, b in zip(plain, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_single_image_equals_a_row_of_the_batch():
    cls, box, anchors, sizes = _inputs(3)
    batch = _port(cls, box, anchors, sizes, pre_nms_top_k=500)
    one = process_detections(
        torch.from_numpy(cls[1]).to(torch.bfloat16), torch.from_numpy(box[1]).to(torch.bfloat16),
        torch.from_numpy(anchors), torch.from_numpy(sizes[1]), pre_nms_top_k=500,
    )
    for a, b in zip(one, batch):
        torch.testing.assert_close(a, b[1], rtol=0, atol=0)

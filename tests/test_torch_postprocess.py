"""Batched multilevel postprocess of the PyTorch port vs the JAX exact path (CPU).

Identical bf16 per-level logits, quantized to quarter steps so that many
values tie, and bf16 deltas go through the port's
``process_detections_multilevel_batch`` and JAX's
``process_detections_multilevel_batch(..., approx_top_k=False, use_pallas=False)``.

Tolerances: labels and valid flags exactly equal (so the selection, tie
order, merge and NMS agree); scores within 1 f32 ulp, because XLA's CPU
sigmoid uses its own ``exp`` (measured 1 ulp apart from ``torch.sigmoid``
on 0.4% of inputs); boxes within 1e-4 absolute plus 1e-6 relative, for the
same ``exp`` in the box decode.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.ops.nms import (
    process_detections_multilevel_batch as jax_postprocess,
)
from pytorch_retinanet_tpu_torch.ops import (
    Detections,
    generate_anchors_per_level,
    pack_detections,
    process_detections_multilevel,
    process_detections_multilevel_batch,
    unpack_detections,
)

IMAGE = (128, 192)
C = 5


def _levels(seed):
    rng = np.random.default_rng(seed)
    anchors = generate_anchors_per_level(IMAGE)
    cls, box = [], []
    for a in anchors:
        cls.append((rng.integers(-12, 8, (2, len(a), C)) * 0.25).astype(np.float32))
        d = rng.normal(0, 0.5, (2, len(a), 4)).astype(np.float32)
        box.append(np.asarray(jnp.asarray(d, jnp.bfloat16), np.float32))  # bf16-exact
    sizes = np.array([[128.0, 192.0], [100.0, 150.0]], np.float32)
    return cls, box, anchors, sizes


@pytest.mark.parametrize("pre_nms_top_k", [1000, 100])
def test_postprocess_matches_jax_exact_mode(pre_nms_top_k):
    cls, box, anchors, sizes = _levels(pre_nms_top_k)
    kw = dict(score_thres=0.05, nms_thres=0.5, max_detections=100, pre_nms_top_k=pre_nms_top_k)
    ref = jax_postprocess(
        [jnp.asarray(c, jnp.bfloat16) for c in cls],
        [jnp.asarray(b, jnp.bfloat16) for b in box],
        anchors, jnp.asarray(sizes), approx_top_k=False, use_pallas=False, **kw,
    )
    got = process_detections_multilevel_batch(
        [torch.from_numpy(c).to(torch.bfloat16) for c in cls],
        [torch.from_numpy(b).to(torch.bfloat16) for b in box],
        [torch.from_numpy(a) for a in anchors], torch.from_numpy(sizes), **kw,
    )
    assert got.labels.dtype == torch.int32 and got.valid.dtype == torch.bool
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert got.valid.any()
    np.testing.assert_array_max_ulp(got.scores.numpy(), np.asarray(ref.scores), maxulp=1)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), rtol=1e-6, atol=1e-4)


def test_single_image_and_packing():
    cls, box, anchors, sizes = _levels(7)
    t = lambda xs, i: [torch.from_numpy(x[i]).to(torch.bfloat16) for x in xs]  # noqa: E731
    batch = process_detections_multilevel_batch(
        [torch.from_numpy(c).to(torch.bfloat16) for c in cls],
        [torch.from_numpy(b).to(torch.bfloat16) for b in box],
        anchors, torch.from_numpy(sizes),
    )
    one = process_detections_multilevel(t(cls, 1), t(box, 1), anchors, torch.from_numpy(sizes[1]))
    for a, b in zip(one, batch):
        torch.testing.assert_close(a, b[1], rtol=0, atol=0)
    back = unpack_detections(pack_detections(batch))
    assert isinstance(back, Detections)
    np.testing.assert_array_equal(back.valid, batch.valid.numpy())
    np.testing.assert_array_equal(back.labels, np.where(batch.valid, batch.labels, 0))
    np.testing.assert_array_equal(back.boxes, batch.boxes.numpy())

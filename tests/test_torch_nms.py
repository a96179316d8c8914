"""Greedy NMS keep mask of the PyTorch port vs the JAX package (CPU).

``nms_keep_mask_plain`` (what the wrapper computes for CPU tensors) is held
against the Pallas kernel ``pallas_nms_keep_mask`` in interpret mode and
against the XLA fixpoint ``ops.nms.nms_keep_mask``, image by image, on the
same numpy boxes. Tolerance: none, the masks must be exactly equal (both
sides compute the IoU with the same f32 operations in the same order).
The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pytorch_retinanet_tpu.kernels.nms_pallas import pallas_nms_keep_mask
from pytorch_retinanet_tpu.ops.nms import nms_keep_mask as jax_nms_keep_mask
from pytorch_retinanet_tpu_torch.kernels import nms_keep_mask, nms_keep_mask_plain
from pytorch_retinanet_tpu_torch.ops import nms_keep_mask as port_ops_keep_mask

B, K, THR = 3, 1000, 0.5


def clustered_boxes(rng, b=B, k=K):
    """Score-ordered boxes in tight clusters, class-offset like the postprocess."""
    centers = rng.uniform(0, 600, (b, k // 25, 2))
    which = rng.integers(0, centers.shape[1], (b, k))
    c = np.take_along_axis(centers, which[..., None], axis=1) + rng.normal(0, 5, (b, k, 2))
    wh = rng.uniform(10, 60, (b, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=-1)
    boxes += (rng.integers(0, 3, (b, k)) * 4097.0)[..., None]
    valid = rng.random((b, k)) < 0.9
    return boxes.astype(np.float32), valid


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(0)
    boxes, valid = clustered_boxes(rng)
    same = np.tile(np.float32([[10, 10, 50, 50]]), (K, 1))
    return {
        "clusters": (boxes, valid),
        "all_invalid": (boxes[:1], np.zeros((1, K), bool)),
        "identical": (same[None], np.ones((1, K), bool)),
    }


def _port(boxes, valid):
    return nms_keep_mask_plain(torch.from_numpy(boxes), torch.from_numpy(valid), THR).numpy()


@pytest.mark.parametrize("case", ["clusters", "all_invalid", "identical"])
def test_plain_equals_xla_fixpoint(cases, case):
    boxes, valid = cases[case]
    got = _port(boxes, valid)
    for i in range(len(boxes)):
        ref = jax_nms_keep_mask(jnp.asarray(boxes[i]), None, THR, jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got[i], np.asarray(ref))
    if case == "clusters":
        assert 0 < got.sum() < valid.sum()  # suppression happened
    if case == "identical":
        assert got[0, 0] and not got[0, 1:].any()
    if case == "all_invalid":
        assert not got.any()


@pytest.mark.parametrize("case", ["clusters", "identical"])
def test_plain_equals_pallas_interpret(cases, case):
    boxes, valid = cases[case]
    got = _port(boxes, valid)
    with pltpu.force_tpu_interpret_mode():
        for i in range(len(boxes)):
            ref = pallas_nms_keep_mask(jnp.asarray(boxes[i]), jnp.asarray(valid[i]), THR)
            np.testing.assert_array_equal(got[i], np.asarray(ref))


def test_wrapper_on_cpu_is_plain(cases):
    boxes, valid = cases["clusters"]
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    before = nms_keep_mask.launches
    keep = nms_keep_mask(tb, tv, THR)
    assert nms_keep_mask.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(keep.numpy(), _port(boxes, valid))
    # ops-level form takes one image [K, 4] or a batch, like the JAX signature.
    np.testing.assert_array_equal(
        port_ops_keep_mask(tb[0], None, THR, tv[0]).numpy(), keep[0].numpy()
    )
    with pytest.raises(ValueError):
        nms_keep_mask(tb[0], tv[0], THR)

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


# --- The CUDA kernel's chunked scan, emulated in numpy -------------------------
#
# ``csrc/nms.cu`` writes the upper triangle of the suppression bitmask in
# 64-candidate chunks (a zero intersection side decides `0 > thr` without the
# division), then one warp resolves each chunk from its removed word and its
# 64 diagonal words, visiting only the alive candidates whose diagonal word
# is non-zero, and ORs the kept rows into the later words. The emulation
# follows those steps bit for bit; it must equal ``nms_keep_mask_plain``
# (held above against JAX) exactly.

CHUNK = 64
ALL = (1 << 64) - 1
HALF = (1 << 32) - 1


def suppression_words(boxes, valid, thr):
    """[64 * chunks, chunks] uint64: bit u of word (i, c) says that kept
    candidate i removes 64c + u; and the [chunks] valid words."""
    k = len(boxes)
    nw = -(-k // CHUNK)
    kp = nw * CHUNK
    a, b = boxes[:, None, :], boxes[None, :, :]
    ix = np.maximum(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), np.float32(0))
    iy = np.maximum(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), np.float32(0))
    zero = np.float32(0)
    area = np.maximum(boxes[:, 2] - boxes[:, 0], zero) * np.maximum(boxes[:, 3] - boxes[:, 1], zero)
    inter = ix * iy
    iou = inter / np.maximum((area[:, None] + area[None, :]) - inter, np.float32(1e-12))
    sup = np.where((ix == 0) | (iy == 0), np.float32(0) > thr, iou > thr)
    sup &= np.triu(np.ones((k, k), bool), 1) & valid[:, None] & valid[None, :]
    full = np.zeros((kp, kp), bool)
    full[:k, :k] = sup
    words = np.packbits(full.reshape(kp, nw, CHUNK), axis=-1, bitorder="little").view("<u8")[..., 0]
    vpad = np.zeros(kp, bool)
    vpad[:k] = valid
    vwords = np.packbits(vpad.reshape(nw, CHUNK), axis=-1, bitorder="little").view("<u8")[:, 0]
    return words, vwords


def chunked_scan_emulation(boxes, valid, thr):
    """One image: the keep mask [K] and the length of the serial chain (the
    candidates the in-chunk resolution visited)."""
    k = len(boxes)
    words, vwords = suppression_words(boxes, valid, thr)
    nw = len(vwords)
    removed_words = [~int(v) & ALL for v in vwords]
    keep = np.zeros(nw * CHUNK, bool)
    chain = 0
    for c in range(nw):
        diag = [int(words[c * CHUNK + t, c]) for t in range(CHUNK)]
        has_diag = sum(1 << t for t in range(CHUNK) if diag[t])
        # Candidates 0-31, then 32-63, on 32-bit halves as the kernel runs them.
        rm_lo, rm_hi = removed_words[c] & HALF, removed_words[c] >> 32
        todo = ~rm_lo & has_diag & HALF
        while todo:
            t = (todo & -todo).bit_length() - 1
            lo, hi = diag[t] & HALF, diag[t] >> 32
            rm_lo, rm_hi = rm_lo | lo, rm_hi | hi
            todo &= ~lo & (todo - 1)
            chain += 1
        todo = ~rm_hi & (has_diag >> 32) & HALF
        while todo:
            t = (todo & -todo).bit_length() - 1
            assert diag[32 + t] & HALF == 0  # a word has no bits at or below its row
            hi = diag[32 + t] >> 32
            rm_hi |= hi
            todo &= ~hi & (todo - 1)
            chain += 1
        kept = ~(rm_lo | rm_hi << 32) & ALL
        keep[c * CHUNK:(c + 1) * CHUNK] = [(kept >> t) & 1 for t in range(CHUNK)]
        for w in range(c + 1, nw):
            for t in range(CHUNK):
                if (kept >> t) & 1:
                    removed_words[w] |= int(words[c * CHUNK + t, w])
    return keep[:k], chain


def scan_case(kind, k, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "clusters":  # as clustered_boxes, with at least one cluster
        centers = rng.uniform(0, 600, (k // 25 + 1, 2))
        c = centers[rng.integers(0, len(centers), k)] + rng.normal(0, 5, (k, 2))
        wh = rng.uniform(10, 60, (k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1) + (rng.integers(0, 3, k) * 4097.0)[:, None]
        return boxes.astype(np.float32), rng.random(k) < 0.9
    if kind == "identical":
        return np.tile(np.float32([[10, 10, 50, 50]]), (k, 1)), np.ones(k, bool)
    # disjoint: a grid of boxes that do not touch, in score order
    i = np.arange(k)
    x, y = (i % 40) * 30.0, (i // 40) * 30.0
    boxes = np.stack([x, y, x + 20.0, y + 20.0], -1).astype(np.float32)
    return boxes, rng.random(k) < 0.9


@pytest.mark.parametrize("k", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("kind", ["clusters", "identical", "disjoint"])
def test_chunked_scan_emulation_equals_plain(kind, k):
    boxes, valid = scan_case(kind, k)
    got, chain = chunked_scan_emulation(boxes, valid, THR)
    want = nms_keep_mask_plain(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], THR)
    np.testing.assert_array_equal(got, want[0].numpy())
    if kind == "identical":
        assert got[0] and not got[1:].any()
        assert chain == (1 if k > 1 else 0)  # the first box removes all the others at once
    if kind == "disjoint":
        np.testing.assert_array_equal(got, valid)
        assert chain == 0  # no diagonal word is non-zero: no serial step at all
    if kind == "clusters" and k == 1000:
        assert 0 < got.sum() < valid.sum() and 0 < chain < k


def test_chunked_scan_emulation_with_zero_suppressing_threshold():
    """Below 0 every valid pair suppresses, a zero intersection included: the
    pre-test decides `0 > thr` and must keep only the first valid box."""
    boxes, valid = scan_case("disjoint", 130)
    got, _ = chunked_scan_emulation(boxes, valid, -0.5)
    want = nms_keep_mask_plain(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], -0.5)
    np.testing.assert_array_equal(got, want[0].numpy())
    assert got.sum() == 1 and got[valid.argmax()]

"""The port's native (C++) host library vs its numpy plain versions and the
JAX package's native library (CPU).

Every entry point of ``pytorch_retinanet_tpu_torch.native`` (box IoU, greedy
NMS, the COCO xywh IoU with crowd regions, the evaluator's greedy matcher,
the RLE codec and mask IoU) on seeded numpy inputs: equal to its
``*_plain`` version and to the JAX package's ``native`` function, exactly
(bit for bit, or array-equal for integer and boolean outputs). The library
builds into ``build/`` at the root of the checkout, and a failed build
raises with the compiler's message instead of falling back.

One exception, a fault of the JAX package's build: it compiles with
``-march=native``, and where the host has FMA, g++ contracts the two IoUs'
``a + b * c`` into one rounding, so its ``box_iou_xyxy`` and
``coco_iou_xywh`` differ from its own numpy versions by a few ulp on some
pairs. The port builds with ``-ffp-contract=off``: its IoUs equal the JAX
package's numpy versions (``_iou_one_to_many``, the evaluator's
``bbox_iou_xywh``) bit for bit, and the JAX native within 4 ulp (three
roundings of the union and the division's).
"""

from __future__ import annotations

import numpy as np
import pytest

from pytorch_retinanet_tpu import native as jax_native
from pytorch_retinanet_tpu.eval.coco_eval import bbox_iou_xywh as jax_bbox_iou_xywh
from pytorch_retinanet_tpu_torch import native
from pytorch_retinanet_tpu_torch.kernels.build import BUILD_DIR


def _xyxy(rng, n, spread=200.0, degenerate=0):
    ctr = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    wh[:degenerate] = 0.0  # zero-area boxes: the union-0 branch
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


def _clusters(rng, n):
    """Boxes in a few tight clusters, so that NMS suppresses chains."""
    centres = rng.uniform(20, 180, (4, 2))
    ctr = centres[rng.integers(0, 4, n)] + rng.normal(0, 4, (n, 2))
    wh = rng.uniform(20, 40, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


def _xywh(rng, n):
    return np.concatenate([rng.uniform(0, 150, (n, 2)), rng.uniform(2, 60, (n, 2))], -1)


def _masks(rng, n, h=23, w=17):
    m = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        y0, x0 = rng.integers(0, h - 2), rng.integers(0, w - 2)
        m[i, y0:y0 + rng.integers(1, h - y0), x0:x0 + rng.integers(1, w - x0)] = 1
        m[i] ^= (rng.random((h, w)) < 0.05).astype(np.uint8)  # ragged runs
    return m


def _match_inputs(rng, d=40, g=12):
    """A score-descending cell: IoUs with ties and zeros, GT sorted
    non-ignored first, crowd regions among the ignored ones."""
    ious = np.round(rng.random((d, g)), 2)
    ious[rng.random((d, g)) < 0.3] = 0.0
    gt_ig = np.sort((rng.random(g) < 0.3).astype(np.float64))
    crowd = ((gt_ig == 1) & (rng.random(g) < 0.5)).astype(np.int32)
    return ious, gt_ig, crowd, np.linspace(0.5, 0.95, 10)


def _case(name, seed):
    rng = np.random.default_rng(seed)
    if name == "box_iou_xyxy":
        return (_xyxy(rng, 13, degenerate=2), _xyxy(rng, 9, degenerate=1))
    if name == "nms_xyxy":
        return (_clusters(rng, 150), float(rng.choice([0.3, 0.5, 0.7])))
    if name == "coco_iou_xywh":
        return (_xywh(rng, 11), _xywh(rng, 7), (rng.random(7) < 0.4).astype(np.int32))
    if name == "coco_match":
        return _match_inputs(rng)
    if name == "rle_decode_runs":
        mask = _masks(rng, 1)[0]
        return (native.rle_encode_mask_plain(mask), *mask.shape)
    if name == "rle_encode_mask":
        mask = _masks(rng, 1)[0]
        mask[0, 0] = 1  # a mask whose first pixel is set: the leading 0-run
        return (mask,)
    if name == "mask_iou":
        return (_masks(rng, 6), _masks(rng, 4), np.array([0, 1, 0, 1], np.int32))
    raise KeyError(name)


FUNCTIONS = ["box_iou_xyxy", "nms_xyxy", "coco_iou_xywh", "coco_match", "rle_decode_runs",
             "rle_encode_mask", "mask_iou"]


# The JAX numpy versions of the two IoUs its native build contracts.
FMA_CONTRACTED = {
    "box_iou_xyxy": lambda a, b: np.stack([jax_native._iou_one_to_many(x, b) for x in a]),
    "coco_iou_xywh": jax_bbox_iou_xywh,
}


def _same(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        if g.dtype.kind == "f":
            assert g.tobytes() == w.astype(g.dtype).tobytes(), what  # bit for bit
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_native_equals_plain_and_jax_native(name, seed):
    args = _case(name, seed)
    got = getattr(native, name)(*args)
    _same(got, getattr(native, f"{name}_plain")(*args), f"{name} vs its plain version")
    want = getattr(jax_native, name)(*args)
    if name in FMA_CONTRACTED:
        # Contraction saves a rounding in each area product and in the
        # union's sum: up to 3 ulp of the union, and the division's own.
        np.testing.assert_array_max_ulp(got, want, maxulp=4)
        _same(got, FMA_CONTRACTED[name](*args), f"{name} vs the JAX numpy version")
    else:
        _same(got, want, f"{name} vs the JAX native")


def test_coco_iou_equals_the_jax_evaluators_numpy_iou():
    rng = np.random.default_rng(5)
    dt, gt, crowd = _xywh(rng, 20), _xywh(rng, 9), (rng.random(9) < 0.5).astype(np.int32)
    _same(native.coco_iou_xywh(dt, gt, crowd), jax_bbox_iou_xywh(dt, gt, crowd), "xywh IoU")


def test_nms_keeps_the_first_of_identical_boxes_and_all_disjoint_ones():
    same = np.tile(np.array([[10, 10, 50, 50]], np.float32), (5, 1))
    assert native.nms_xyxy(same, 0.5).tolist() == [True, False, False, False, False]
    apart = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50]], np.float32)
    assert native.nms_xyxy(apart, 0.5).all()


def test_rle_round_trip():
    mask = _masks(np.random.default_rng(7), 1, 31, 29)[0]
    runs = native.rle_encode_mask(mask)
    np.testing.assert_array_equal(native.rle_decode_runs(runs, *mask.shape), mask)
    assert int(runs[1::2].sum()) == int(mask.sum())


def test_library_builds_under_the_checkouts_build_dir():
    path = native.library_path()
    native.get_lib()
    assert path.is_file() and path.parent == BUILD_DIR
    assert path.name.startswith("libdetection_native-") and path.suffix == ".so"
    assert not list(native.SOURCE.parent.parent.glob("*.so"))  # nothing next to the source


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cc"
    broken.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").glob("*.so"))

"""The port's ``utils/visualize.py`` against the JAX package's module (CPU).

Both draw with PIL on the same inputs; the arrays they return, and the PIL
images they draw on in place, must be equal byte for byte.
"""

from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from pytorch_retinanet_tpu.utils import visualize as jax_viz
from pytorch_retinanet_tpu_torch.utils import visualize as viz

LABELS = ["__background__", "car", "person", "dog"]


def _scene(dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    if dtype != np.uint8:
        image = image.astype(np.float32) / 255.0
    boxes = np.array([[10, 30, 60, 90], [0, 0, 40, 20], [80, 50, 150, 115], [5, 5, 9, 9]],
                     np.float32)
    return image, boxes, np.array([1, 2, 3, 7]), np.array([0.91, 0.55, 0.3, 0.77])


CASES = {
    "detections": dict(),
    "groundtruth": dict(scores=None),
    "float_image": dict(dtype=np.float32),
    "no_label_map": dict(label_map=None),
    "normalized": dict(normalized=True),
    "capped_and_thin": dict(max_boxes_to_draw=2, line_thickness=1, min_score_thresh=0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_visualize_array_equals_jax(case):
    c = dict(CASES[case])
    image, boxes, classes, scores = _scene(c.pop("dtype", np.uint8))
    if c.pop("normalized", False):
        boxes = boxes / np.array([160, 120, 160, 120], np.float32)
        c["use_normalized_coordinates"] = True
    scores = c.pop("scores", scores)
    label_map = c.pop("label_map", LABELS)
    got = viz.visualize_boxes_and_labels_on_image_array(image, boxes, classes, scores, label_map,
                                                        **c)
    want = jax_viz.visualize_boxes_and_labels_on_image_array(image, boxes, classes, scores,
                                                             label_map, **c)
    assert got.dtype == np.uint8 and got.shape == (120, 160, 3)
    base = image if image.dtype == np.uint8 else (np.clip(image, 0, 1) * 255).astype(np.uint8)
    assert not np.array_equal(got, base)  # something was drawn
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("normalized", [True, False])
def test_draw_bounding_box_equals_jax(normalized):
    image, _, _, _ = _scene(seed=1)
    box = (0.1, 0.2, 0.6, 0.7) if normalized else (12.0, 32.0, 72.0, 112.0)
    images = [Image.fromarray(image.copy()) for _ in range(2)]
    for module, pil in zip((viz, jax_viz), images):
        module.draw_bounding_box_on_image(pil, *box, color="#1f77b4", thickness=3,
                                          display_str_list=["car: 91%", "id 7"],
                                          use_normalized_coordinates=normalized)
    got, want = (np.asarray(p) for p in images)
    assert not np.array_equal(got, image)
    np.testing.assert_array_equal(got, want)


def test_palette_equals_jax():
    assert viz.STANDARD_COLORS == jax_viz.STANDARD_COLORS and len(viz.STANDARD_COLORS) == 120

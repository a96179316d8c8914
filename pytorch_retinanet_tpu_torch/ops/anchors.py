"""Static anchors, a pure function of the padded image size (numpy, cached).

Counterpart of ``pytorch_retinanet_tpu/ops/anchors.py``. Layout contract,
shared with the head's reshape: level-major, then row-major over the feature
grid (y outer, x inner), then the cell-anchor index.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np

from ..config import ANCHOR_ASPECT_RATIOS, ANCHOR_OFFSET, ANCHOR_SIZES, ANCHOR_STRIDES


def feature_grid_sizes(
    image_size: Tuple[int, int], strides: Sequence[int] = tuple(ANCHOR_STRIDES)
) -> List[Tuple[int, int]]:
    """Per-level (H, W) of the pyramid: every stride-2 op halves with ceil."""
    h, w = image_size
    return [(math.ceil(h / s), math.ceil(w / s)) for s in strides]


def generate_cell_anchors(
    sizes: Sequence[float], aspect_ratios: Sequence[float]
) -> np.ndarray:
    """Anchors centred at (0, 0), XYXY, size-major then ratio-minor."""
    out = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, dtype=np.float32)


@functools.lru_cache(maxsize=32)
def generate_anchors_per_level(
    image_size: Tuple[int, int],
    sizes: Tuple[Tuple[float, ...], ...] = tuple(tuple(s) for s in ANCHOR_SIZES),
    aspect_ratios: Tuple[float, ...] = tuple(ANCHOR_ASPECT_RATIOS),
    strides: Tuple[int, ...] = tuple(ANCHOR_STRIDES),
    offset: float = ANCHOR_OFFSET,
) -> Tuple[np.ndarray, ...]:
    """Per-level anchors for one padded image size: tuple of [A_l, 4] f32 XYXY."""
    per_level = []
    for (gh, gw), stride, level_sizes in zip(
        feature_grid_sizes(image_size, strides), strides, sizes
    ):
        base = generate_cell_anchors(level_sizes, aspect_ratios)
        shift_x = (np.arange(gw, dtype=np.float32) + offset) * stride
        shift_y = (np.arange(gh, dtype=np.float32) + offset) * stride
        sx, sy = np.meshgrid(shift_x, shift_y)
        shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
        per_level.append((shifts + base[None, :, :]).reshape(-1, 4).astype(np.float32))
    return tuple(per_level)


@functools.lru_cache(maxsize=32)
def generate_anchors(
    image_size: Tuple[int, int],
    sizes: Tuple[Tuple[float, ...], ...] = tuple(tuple(s) for s in ANCHOR_SIZES),
    aspect_ratios: Tuple[float, ...] = tuple(ANCHOR_ASPECT_RATIOS),
    strides: Tuple[int, ...] = tuple(ANCHOR_STRIDES),
    offset: float = ANCHOR_OFFSET,
) -> np.ndarray:
    """All anchors for one padded image size: [A_total, 4] f32 XYXY."""
    return np.concatenate(
        generate_anchors_per_level(image_size, sizes, aspect_ratios, strides, offset),
        axis=0,
    )


def num_anchors_per_location(
    sizes: Sequence[Sequence[float]] = ANCHOR_SIZES,
    aspect_ratios: Sequence[float] = ANCHOR_ASPECT_RATIOS,
) -> int:
    """Cell anchors per spatial location (9 by default)."""
    return len(sizes[0]) * len(aspect_ratios)

"""Box and label drawing on images: the detection visualization.

The port's own copy of ``pytorch_retinanet_tpu/utils/visualize.py`` (numpy
and PIL only), which draws the same pixels: a generated 120-colour palette
(golden-angle hue walk), one pass per annotation that places the label chip
above the box or inside its top edge, luminance-adaptive chip text.

Public functions keep the reference's signatures:
``visualize_boxes_and_labels_on_image_array`` (array in, array out) and
``draw_bounding_box_on_image`` (a PIL image, in place).
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _make_palette(n: int = 120) -> List[str]:
    """n visually-spread colors: golden-angle hue walk, alternating
    saturation/value rings so neighbors differ in more than hue."""
    colors = []
    for i in range(n):
        hue = (i * 0.61803398875) % 1.0
        sat = (0.95, 0.65, 0.80)[i % 3]
        val = (0.95, 0.80)[i % 2]
        r, g, b = colorsys.hsv_to_rgb(hue, sat, val)
        colors.append(f"#{int(r * 255):02x}{int(g * 255):02x}{int(b * 255):02x}")
    return colors


#: 120-entry deterministic palette, indexed by class id (mod len).
STANDARD_COLORS: List[str] = _make_palette(120)


def _color_rgb(color: str) -> Tuple[int, int, int]:
    """'#rrggbb' or a PIL color name → (r, g, b)."""
    if color.startswith("#") and len(color) == 7:
        return tuple(int(color[i : i + 2], 16) for i in (1, 3, 5))  # type: ignore
    from PIL import ImageColor

    return ImageColor.getrgb(color)[:3]


def _text_color_for(chip_rgb: Tuple[int, int, int]) -> str:
    """Black on light chips, white on dark — ITU-R BT.601 luma."""
    luma = 0.299 * chip_rgb[0] + 0.587 * chip_rgb[1] + 0.114 * chip_rgb[2]
    return "black" if luma > 140 else "white"


def _load_font(size: int = 18):
    from PIL import ImageFont

    for name in ("DejaVuSans.ttf", "arial.ttf"):
        try:
            return ImageFont.truetype(name, size)
        except OSError:
            continue
    return ImageFont.load_default()


def _layout_label(
    draw, text: str, font, box: Tuple[float, float, float, float], pad: int
) -> Tuple[Tuple[float, float, float, float], Tuple[float, float]]:
    """One-pass chip placement: above the box when there's headroom, else
    just inside its top-left corner. Returns (chip rect, text origin)."""
    left, top, right, bottom = box
    tb = draw.multiline_textbbox((0, 0), text, font=font)
    tw, th = tb[2] - tb[0], tb[3] - tb[1]
    chip_h = th + 2 * pad
    chip_top = top - chip_h if top >= chip_h else top
    chip = (left, chip_top, left + tw + 2 * pad, chip_top + chip_h)
    origin = (left + pad, chip_top + pad - tb[1])
    return chip, origin


def _draw_annotation(
    pil_image,
    box: Tuple[float, float, float, float],
    color: str,
    thickness: int,
    label: Optional[str],
) -> None:
    """Render one box (+ optional label chip) on a PIL image in place."""
    from PIL import ImageDraw

    draw = ImageDraw.Draw(pil_image)
    left, top, right, bottom = box
    draw.rectangle((left, top, right, bottom), outline=color, width=thickness)
    if not label:
        return
    font = _load_font()
    chip, origin = _layout_label(draw, label, font, box, pad=max(2, thickness // 2))
    draw.rectangle(chip, fill=color)
    draw.multiline_text(
        origin, label, fill=_text_color_for(_color_rgb(color)), font=font
    )


def draw_bounding_box_on_image(
    image,
    ymin: float,
    xmin: float,
    ymax: float,
    xmax: float,
    color: str = "red",
    thickness: int = 4,
    display_str_list: Sequence[str] = (),
    use_normalized_coordinates: bool = True,
) -> None:
    """Draw one box + label strings on a PIL image in place.

    Reference-parity signature (utils/detection_utils.py:59); display strings
    render as one multi-line chip rather than stacked per-string rectangles.
    """
    w, h = image.size
    if use_normalized_coordinates:
        box = (xmin * w, ymin * h, xmax * w, ymax * h)
    else:
        box = (xmin, ymin, xmax, ymax)
    label = "\n".join(str(s) for s in display_str_list) or None
    _draw_annotation(image, box, color, thickness, label)


def visualize_boxes_and_labels_on_image_array(
    image: np.ndarray,
    boxes: np.ndarray,
    classes: Sequence[int],
    scores: Optional[Sequence[float]],
    label_map: Optional[Sequence[str]] = None,
    use_normalized_coordinates: bool = False,
    max_boxes_to_draw: Optional[int] = 20,
    min_score_thresh: float = 0.5,
    line_thickness: int = 4,
) -> np.ndarray:
    """Draw detections on an HWC uint8/float image array.

    Reference-parity surface (utils/detection_utils.py:134-191): boxes are
    XYXY; ``scores=None`` means groundtruth mode (black boxes, no score text);
    detections below ``min_score_thresh`` are skipped.
    """
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    pil = Image.fromarray(arr)
    w, h = pil.size

    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    limit = len(boxes) if max_boxes_to_draw is None else max_boxes_to_draw
    for i in range(min(len(boxes), limit)):
        score = None if scores is None else float(scores[i])
        if score is not None and score < min_score_thresh:
            continue
        cls = int(classes[i])
        name = (
            str(label_map[cls])
            if label_map is not None and 0 <= cls < len(label_map)
            else f"class {cls}"
        )
        if score is None:  # groundtruth mode
            color, label = "black", name
        else:
            color = STANDARD_COLORS[cls % len(STANDARD_COLORS)]
            label = f"{name}: {score:.0%}"
        x1, y1, x2, y2 = boxes[i]
        if use_normalized_coordinates:
            x1, y1, x2, y2 = x1 * w, y1 * h, x2 * w, y2 * h
        _draw_annotation(pil, (x1, y1, x2, y2), color, line_thickness, label)
    return np.array(pil)

"""Host-side image augmentation with bounding-box tracking.

The port's copy of ``pytorch_retinanet_tpu/data/transforms.py``.

Native replacement for the reference's albumentations dependency
(``utils/pascal/pascal_transforms.py:7-18``; config-driven instantiation at
``model.py:50-60``). The reference composes albumentations transforms named by
dotted path in ``hparams.yaml`` (e.g. ``albumentations.HorizontalFlip``); this
module implements the transforms detection training actually uses, with the
same names and parameter spellings, so reference YAML configs keep working —
``albumentations.X`` strings resolve to the classes here (see
:func:`build_transforms`).

All transforms are pure host-side numpy/cv2: augmentation runs in data-loader
threads, never on the card. Every transform takes and returns
``(image HWC float32 [0,1], boxes [N,4] XYXY float32, labels [N] int64)``,
plus an optional ``rng`` (``np.random.Generator``).

**Determinism**: randomness comes from the ``rng`` argument, which the
:class:`~.loader.DetectionLoader` derives per-sample from
``(seed, epoch, index)`` — so training data is bit-reproducible regardless of
loader thread scheduling (the reference relies on the global ``random`` module
from DataLoader workers, which is not). When no ``rng`` is passed (direct
calls, user code), a module-level generator reseeded by
:func:`~..utils.seed_everything` is used.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

Sample = Tuple[np.ndarray, np.ndarray, np.ndarray]

# Fallback generator for rng-less calls; reseeded by utils.seed_everything.
_GLOBAL_RNG = np.random.default_rng()


def reseed(seed: int) -> None:
    """Reseed the fallback generator (called by ``seed_everything``)."""
    global _GLOBAL_RNG
    _GLOBAL_RNG = np.random.default_rng(seed)


def _rng(rng: Optional[np.random.Generator]) -> np.random.Generator:
    return rng if rng is not None else _GLOBAL_RNG


_ACCEPTS_RNG_CACHE: Dict[type, bool] = {}


def accepts_rng(t: Any) -> bool:
    """Whether a transform callable takes an ``rng`` keyword.

    Keeps third-party/user transforms with the bare 3-arg signature working.
    Class instances are cached by type; plain functions/partials/lambdas are
    inspected directly each call (``signature(t.__call__)`` on a function
    would see the method-wrapper and miss its parameters, and one cache
    entry for all of them would be wrong anyway).
    """
    if (
        inspect.isfunction(t)
        or inspect.isbuiltin(t)
        or inspect.ismethod(t)  # bound methods all share type MethodType —
        # caching by type would let the first method inspected decide for all
        or isinstance(t, functools.partial)
    ):
        try:
            return "rng" in inspect.signature(t).parameters
        except (TypeError, ValueError):
            return False
    key = type(t)
    hit = _ACCEPTS_RNG_CACHE.get(key)
    if hit is None:
        try:
            hit = "rng" in inspect.signature(t.__call__).parameters
        except (TypeError, ValueError):  # builtins / odd callables
            hit = False
        _ACCEPTS_RNG_CACHE[key] = hit
    return hit


def apply_transform(t, image, boxes, labels, rng=None) -> Sample:
    """Call a transform, passing rng only if its signature supports it."""
    if rng is not None and accepts_rng(t):
        return t(image, boxes, labels, rng=rng)
    return t(image, boxes, labels)


class Transform:
    """Base class: callable on (image, boxes, labels[, rng])."""

    # True for transforms that are pure index operations on the pixel array
    # (flip, crop): applying them to uint8 bytes is EXACTLY applying them to
    # the floats those bytes would become — so a chain of only-uint8_exact
    # transforms can skip the leading ToFloat and keep bytes end-to-end
    # (build_transforms keep_bytes; the uint8 wire format then ships 4x
    # fewer bytes to the device). Interpolating or photometric transforms
    # stay False: they need float pixels.
    uint8_exact = False

    def __call__(self, image, boxes, labels, rng=None) -> Sample:  # pragma: no cover
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, image, boxes, labels, rng=None) -> Sample:
        for t in self.transforms:
            image, boxes, labels = apply_transform(t, image, boxes, labels, rng)
        return image, boxes, labels


class HorizontalFlip(Transform):
    """Mirror left-right, flipping box x-coordinates (reference flips via
    albumentations / coco_transforms.py:22-37)."""

    uint8_exact = True  # pure index op

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, image, boxes, labels, rng=None) -> Sample:
        if _rng(rng).random() < self.p:
            w = image.shape[1]
            image = np.ascontiguousarray(image[:, ::-1])
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        return image, boxes, labels


class VerticalFlip(Transform):
    uint8_exact = True  # pure index op

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, image, boxes, labels, rng=None) -> Sample:
        if _rng(rng).random() < self.p:
            h = image.shape[0]
            image = np.ascontiguousarray(image[::-1])
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
        return image, boxes, labels


class RandomBrightnessContrast(Transform):
    """out = clip((x - 0.5) * (1 + contrast) + 0.5 + brightness)."""

    def __init__(
        self, brightness_limit: float = 0.2, contrast_limit: float = 0.2, p: float = 0.5
    ):
        self.brightness_limit = brightness_limit
        self.contrast_limit = contrast_limit
        self.p = p

    def __call__(self, image, boxes, labels, rng=None) -> Sample:
        r = _rng(rng)
        if r.random() < self.p:
            b = r.uniform(-self.brightness_limit, self.brightness_limit)
            c = r.uniform(-self.contrast_limit, self.contrast_limit)
            image = np.clip((image - 0.5) * (1.0 + c) + 0.5 + b, 0.0, 1.0).astype(
                np.float32
            )
        return image, boxes, labels


class ShiftScaleRotate(Transform):
    """Affine jitter (shift + scale; rotation limited to 0 by default for boxes).

    Box-safe subset of albumentations.ShiftScaleRotate: boxes are transformed
    through the affine and clipped; fully-out-of-frame boxes are dropped.
    """

    def __init__(
        self,
        shift_limit: float = 0.0625,
        scale_limit: float = 0.1,
        rotate_limit: float = 0.0,
        p: float = 0.5,
    ):
        self.shift_limit = shift_limit
        self.scale_limit = scale_limit
        self.rotate_limit = rotate_limit
        self.p = p

    def __call__(self, image, boxes, labels, rng=None) -> Sample:
        r = _rng(rng)
        if r.random() >= self.p:
            return image, boxes, labels
        import cv2

        h, w = image.shape[:2]
        scale = 1.0 + r.uniform(-self.scale_limit, self.scale_limit)
        dx = r.uniform(-self.shift_limit, self.shift_limit) * w
        dy = r.uniform(-self.shift_limit, self.shift_limit) * h
        angle = r.uniform(-self.rotate_limit, self.rotate_limit)
        m = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), angle, scale)
        m[:, 2] += (dx, dy)
        image = cv2.warpAffine(image, m, (w, h), flags=cv2.INTER_LINEAR)
        if len(boxes):
            corners = np.concatenate(
                [
                    boxes[:, [0, 1]],
                    boxes[:, [2, 1]],
                    boxes[:, [0, 3]],
                    boxes[:, [2, 3]],
                ],
                axis=0,
            )  # [4N, 2]
            ones = np.ones((corners.shape[0], 1), np.float32)
            warped = (np.concatenate([corners, ones], 1) @ m.T).reshape(4, -1, 2)
            new = np.stack(
                [
                    warped[..., 0].min(0),
                    warped[..., 1].min(0),
                    warped[..., 0].max(0),
                    warped[..., 1].max(0),
                ],
                axis=1,
            ).astype(np.float32)
            new[:, [0, 2]] = np.clip(new[:, [0, 2]], 0, w)
            new[:, [1, 3]] = np.clip(new[:, [1, 3]], 0, h)
            keep = (new[:, 2] - new[:, 0] > 1) & (new[:, 3] - new[:, 1] > 1)
            boxes, labels = new[keep], labels[keep]
        return image, boxes, labels


class Resize(Transform):
    """Resize to (height, width), scaling boxes (albumentations.Resize parity)."""

    def __init__(self, height: int, width: int, p: float = 1.0):
        self.height = height
        self.width = width
        self.p = p

    def __call__(self, image, boxes, labels, rng=None) -> Sample:
        import cv2

        h, w = image.shape[:2]
        image = cv2.resize(image, (self.width, self.height), interpolation=cv2.INTER_LINEAR)
        if len(boxes):
            sx, sy = self.width / w, self.height / h
            boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
        return image, boxes, labels


class RandomCrop(Transform):
    """Random fixed-size crop; boxes clipped, empty ones dropped
    (albumentations.RandomCrop parity for detection)."""

    uint8_exact = True  # pure index op

    def __init__(self, height: int, width: int, p: float = 1.0):
        self.height = height
        self.width = width
        self.p = p

    def __call__(self, image, boxes, labels, rng=None) -> Sample:
        r = _rng(rng)
        if r.random() >= self.p:
            return image, boxes, labels
        h, w = image.shape[:2]
        ch, cw = min(self.height, h), min(self.width, w)
        y0 = int(r.integers(0, h - ch + 1))
        x0 = int(r.integers(0, w - cw + 1))
        image = image[y0 : y0 + ch, x0 : x0 + cw]
        if len(boxes):
            boxes = boxes - np.array([x0, y0, x0, y0], np.float32)
            boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, cw)
            boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, ch)
            keep = (boxes[:, 2] - boxes[:, 0] > 1) & (boxes[:, 3] - boxes[:, 1] > 1)
            boxes, labels = boxes[keep], labels[keep]
        return np.ascontiguousarray(image), boxes, labels


class Blur(Transform):
    """Box blur with random kernel size (albumentations.Blur parity)."""

    def __init__(self, blur_limit: int = 7, p: float = 0.5):
        self.blur_limit = max(3, int(blur_limit))
        self.p = p

    def __call__(self, image, boxes, labels, rng=None) -> Sample:
        r = _rng(rng)
        if r.random() < self.p:
            import cv2

            ks = range(3, self.blur_limit + 1, 2)
            k = ks[int(r.integers(len(ks)))]
            image = cv2.blur(image, (k, k))
        return image, boxes, labels


class GaussNoise(Transform):
    """Additive gaussian noise (albumentations.GaussNoise parity; var_limit in
    [0,255]^2 units like albumentations, applied to [0,1] floats)."""

    def __init__(self, var_limit=(10.0, 50.0), p: float = 0.5):
        self.var_limit = var_limit
        self.p = p

    def __call__(self, image, boxes, labels, rng=None) -> Sample:
        r = _rng(rng)
        if r.random() < self.p:
            var = r.uniform(*self.var_limit)
            sigma = (var**0.5) / 255.0
            noise = r.normal(0.0, sigma, image.shape)
            image = np.clip(image.astype(np.float32) + noise, 0, 1).astype(np.float32)
        return image, boxes, labels


class HueSaturationValue(Transform):
    """HSV jitter (albumentations.HueSaturationValue parity; limits in
    albumentations' uint8 units)."""

    def __init__(
        self,
        hue_shift_limit: float = 20,
        sat_shift_limit: float = 30,
        val_shift_limit: float = 20,
        p: float = 0.5,
    ):
        self.hue_shift_limit = hue_shift_limit
        self.sat_shift_limit = sat_shift_limit
        self.val_shift_limit = val_shift_limit
        self.p = p

    def __call__(self, image, boxes, labels, rng=None) -> Sample:
        r = _rng(rng)
        if r.random() < self.p:
            import cv2

            was_float = image.dtype != np.uint8
            img8 = (
                (np.clip(image, 0, 1) * 255).astype(np.uint8) if was_float else image
            )
            hsv = cv2.cvtColor(img8, cv2.COLOR_RGB2HSV).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + r.uniform(
                -self.hue_shift_limit, self.hue_shift_limit
            )) % 180
            hsv[..., 1] = np.clip(
                hsv[..., 1] + r.uniform(-self.sat_shift_limit, self.sat_shift_limit),
                0, 255,
            )
            hsv[..., 2] = np.clip(
                hsv[..., 2] + r.uniform(-self.val_shift_limit, self.val_shift_limit),
                0, 255,
            )
            out = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
            image = out.astype(np.float32) / 255.0 if was_float else out
        return image, boxes, labels


class ToFloat(Transform):
    """uint8 [0,255] → float32 [0,1] (albumentations.ToFloat parity; appended
    automatically by the reference's compose, pascal_transforms.py:12-13)."""

    def __init__(self, max_value: float = 255.0):
        self.max_value = max_value

    def __call__(self, image, boxes, labels, rng=None) -> Sample:
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / self.max_value
        return image.astype(np.float32), boxes, labels


# Registry keyed by the bare names, the albumentations dotted paths the
# reference's hparams.yaml uses (hparams.yaml:48-62), and the dotted paths of
# this module and of the JAX package's.
TRANSFORM_REGISTRY: Dict[str, type] = {}
for _cls in (
    Blur,
    Compose,
    GaussNoise,
    HorizontalFlip,
    HueSaturationValue,
    RandomBrightnessContrast,
    RandomCrop,
    Resize,
    ShiftScaleRotate,
    ToFloat,
    VerticalFlip,
):
    TRANSFORM_REGISTRY[_cls.__name__] = _cls
    TRANSFORM_REGISTRY[f"albumentations.{_cls.__name__}"] = _cls
    TRANSFORM_REGISTRY[f"pytorch_retinanet_tpu_torch.data.transforms.{_cls.__name__}"] = _cls
    # The JAX package's dotted names, as strings, so that its configs load.
    TRANSFORM_REGISTRY[f"pytorch_retinanet_tpu.data.transforms.{_cls.__name__}"] = _cls


def build_transforms(
    specs: Optional[Sequence[Any]],
    extra: Optional[Sequence[Transform]] = None,
    *,
    keep_bytes: bool = False,
) -> Compose:
    """Instantiate a transform pipeline from config dicts.

    Each spec is ``{"class_name": str, "params": {...}}`` — the reference's
    config shape (hparams.yaml:48-62, applied through load_obj at
    model.py:50-60). Unknown class names raise (registry-based resolution
    replaces the reference's arbitrary dotted-path import).

    ``keep_bytes``: when every requested transform is ``uint8_exact`` (pure
    index ops — flip/crop), skip the leading ToFloat so the pipeline emits
    the dataset's raw bytes: flip(u8)/255 == flip(u8/255) exactly, and the
    loader's "auto" wire then ships uint8 (4x less host work + transfer;
    the device normalizes from bytes). Any float-needing transform in the
    chain keeps the float pipeline untouched.
    """
    instances: List[Transform] = []
    for spec in specs or []:
        name = spec["class_name"]
        if name not in TRANSFORM_REGISTRY:
            raise KeyError(
                f"unknown transform {name!r}; available: "
                f"{sorted(k for k in TRANSFORM_REGISTRY if '.' not in k)}"
            )
        params = dict(spec.get("params") or {})
        instances.append(TRANSFORM_REGISTRY[name](**params))
    instances.extend(extra or [])

    if keep_bytes and all(t.uint8_exact for t in instances):
        return Compose(instances)
    # ToFloat FIRST: photometric transforms (RandomBrightnessContrast,
    # GaussNoise, ...) assume float [0,1]; running them on the uint8 images
    # datasets emit would saturate the image to ~1.0 and silently destroy
    # training. (The reference appends ToFloat last because albumentations'
    # photometric ops handle uint8 natively; ours are float-only.)
    return Compose([ToFloat(), *instances])

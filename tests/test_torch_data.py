"""The port's data layer vs the JAX package's (CPU).

Seeded files in a tmp dir (JPEG and PNG images of mixed orientations and
sizes, a COCO annotation JSON with crowd and degenerate boxes and an image
without GT, VOC XML, a CSV) are read by both packages' datasets and loaders:

* each transform of the registry (and the COCO-style transforms), called
  with generators of the same seed, gives equal images, boxes and labels;
* ``DetectionLoader`` batches equal JAX's bit for bit (values and dtypes,
  every key) for the coco, VOC-XML and CSV datasets: the f32 and the uint8
  wire (``"auto"`` on a byte-exact chain), shuffling across two epochs,
  photometric and geometric augmentation, ``drop_last`` and ``pad_last``,
  two shards with filler batches, and the letterbox fallback of a dataset
  without size metadata; a worker's exception re-raises in the consumer;
* the port's batches are CPU tensors, and pinned only when asked.
"""

from __future__ import annotations

import json
import os

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from pytorch_retinanet_tpu import data as jax_data
from pytorch_retinanet_tpu.data import coco_transforms as jax_coco_transforms
from pytorch_retinanet_tpu.data import transforms as jax_transforms
from pytorch_retinanet_tpu_torch import data, utils
from pytorch_retinanet_tpu_torch.data import coco_transforms, transforms

# (height, width) of the images: both orientations, sizes that need a resize
# to min 64 / max 96 up and down.
SIZES = [(60, 80), (80, 60), (120, 90), (48, 100), (100, 48), (64, 96), (96, 64), (75, 75),
         (90, 130), (130, 90), (70, 70)]
LOADER = dict(min_size=64, max_size=96, num_workers=3, prefetch=2, seed=5)


def _image(rng, h, w):
    img = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    img[rng.random((h, w)) < 0.2] = rng.integers(0, 256, 3)
    return img


def _boxes(rng, h, w, n):
    x1, y1 = rng.uniform(0, w * 0.6, n), rng.uniform(0, h * 0.6, n)
    bw, bh = rng.uniform(4, w * 0.4, n), rng.uniform(4, h * 0.4, n)
    return np.stack([x1, y1, np.minimum(x1 + bw, w), np.minimum(y1 + bh, h)], 1).round(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same images described three ways: COCO JSON, VOC XML and a CSV."""
    root = tmp_path_factory.mktemp("torch_data")
    rng = np.random.default_rng(0)
    img_dir, ann_dir = root / "val2017", root / "xml"
    img_dir.mkdir()
    ann_dir.mkdir()
    names = ["cat", "dog", "bird"]
    images, anns, rows = [], [], []
    for i, (h, w) in enumerate(SIZES):
        fname = f"{i}.jpg" if i % 2 else f"{i}.png"
        cv2.imwrite(str(img_dir / fname), _image(rng, h, w))
        images.append({"id": 100 + i, "file_name": fname, "height": h, "width": w})
        n = 0 if i == 3 else int(rng.integers(1, 5))
        boxes = _boxes(rng, h, w, n)
        labels = rng.integers(0, 3, n)
        objs = []
        for b, lab in zip(boxes, labels):
            anns.append({"id": len(anns) + 1, "image_id": 100 + i, "category_id": int(lab) * 3 + 1,
                         "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]],
                         "area": float((b[2] - b[0]) * (b[3] - b[1])), "iscrowd": 0})
            objs.append(f"<object><name>{names[lab]}</name><bndbox><xmin>{b[0]}</xmin>"
                        f"<ymin>{b[1]}</ymin><xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox>"
                        "</object>")
            rows.append({"filename": str(img_dir / fname), "width": w, "height": h,
                         "class": names[lab], "xmin": b[0], "ymin": b[1], "xmax": b[2],
                         "ymax": b[3], "labels": int(lab) + 1})
        if n:
            (ann_dir / f"{i}.xml").write_text(
                f"<annotation><filename>{fname}</filename><size><width>{w}</width>"
                f"<height>{h}</height><depth>3</depth></size>{''.join(objs)}</annotation>")
        if i == 1:  # a crowd box and a degenerate one, both dropped
            anns.append({"id": len(anns) + 1, "image_id": 100 + i, "category_id": 4,
                         "bbox": [5, 5, 30, 30], "area": 900.0, "iscrowd": 1})
            anns.append({"id": len(anns) + 1, "image_id": 100 + i, "category_id": 4,
                         "bbox": [10, 10, 0, 5], "area": 0.0, "iscrowd": 0})
    (root / "annotations").mkdir()
    coco = {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in (1, 4, 7)]}
    (root / "annotations" / "instances_val2017.json").write_text(json.dumps(coco))
    pd.DataFrame(rows).to_csv(root / "data.csv", index=False)
    return root


def _datasets(pkg, files, kind, tfms):
    """`pkg`'s dataset of `kind` over the files, with transforms `tfms`."""
    if kind == "coco":
        return pkg.CocoDetectionDataset(str(files / "val2017"),
                                        str(files / "annotations" / "instances_val2017.json"),
                                        tfms, filter_empty=False)
    if kind == "voc":
        out = files / f"csv_{pkg.__name__.split('.')[0]}"
        out.mkdir(exist_ok=True)
        ds, _ = pkg.get_pascal(str(files / "xml"), str(files / "val2017"), "train", tfms,
                               csv_dir=str(out))
        return ds
    return pkg.PascalDataset(str(files / "data.csv"), tfms)


class _NoSizes:
    """A dataset without ``get_height_and_width``: no orientation metadata."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def get_sample(self, idx, rng=None):
        return self.ds.get_sample(idx, rng)


FLIP = [{"class_name": "albumentations.HorizontalFlip", "params": {"p": 0.5}}]
AUGMENT = [
    {"class_name": "HorizontalFlip", "params": {"p": 0.5}},
    {"class_name": "albumentations.VerticalFlip", "params": {"p": 0.5}},
    {"class_name": "RandomBrightnessContrast", "params": {"p": 0.7}},
    {"class_name": "ShiftScaleRotate", "params": {"p": 0.7}},
    {"class_name": "GaussNoise", "params": {"p": 0.5}},
]
CASES = {
    "f32": (None, False, dict(batch_size=3)),
    "uint8_auto_shuffled": (FLIP, True, dict(batch_size=3, shuffle=True, image_dtype="auto")),
    "uint8_from_f32": (None, False, dict(batch_size=4, image_dtype=np.uint8)),
    "augmented_shuffled": (AUGMENT, True, dict(batch_size=2, shuffle=True)),
    "drop_last": (FLIP, True, dict(batch_size=4, shuffle=True, drop_last=True,
                                   image_dtype="auto")),
    "no_pad_last": (None, False, dict(batch_size=4, pad_last=False)),
    "shard_0_of_2": (None, False, dict(batch_size=3, shard=0, num_shards=2, shuffle=True)),
    "shard_1_of_2": (None, False, dict(batch_size=3, shard=1, num_shards=2)),
    "letterbox_no_sizes": (FLIP, True, dict(batch_size=3, shuffle=True)),
}


def _loader(pkg, files, kind, case):
    specs, keep_bytes, kw = CASES[case]
    ds = _datasets(pkg, files, kind, pkg.build_transforms(specs, keep_bytes=keep_bytes))
    if case == "letterbox_no_sizes":
        ds = _NoSizes(ds)
    return pkg.DetectionLoader(ds, **LOADER, **kw)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["coco", "voc", "csv"])
def test_loader_batches_equal_jax_bit_for_bit(files, kind, case):
    got_loader = _loader(data, files, kind, case)
    want_loader = _loader(jax_data, files, kind, case)
    assert len(got_loader) == len(want_loader) > 0
    fillers = 0
    for epoch in range(2):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k, v in w.items():
                t = g[k]
                assert isinstance(t, torch.Tensor) and t.device.type == "cpu" and not t.is_pinned()
                a = t.numpy()
                assert a.dtype == v.dtype and a.shape == v.shape, (k, a.dtype, v.dtype)
                assert a.tobytes() == v.tobytes(), (kind, case, epoch, k)
            fillers += int(not w["batch_mask"].any())
    if case.startswith("shard"):
        assert fillers > 0 or len(got_loader) == got_loader._shard_batch_count(
            got_loader.shard)
    if case == "letterbox_no_sizes":
        assert any(b["images"].shape[1] == b["images"].shape[2] == 96 for b in got)


def test_shards_pad_to_the_same_count_with_fillers(files):
    loaders = [data.DetectionLoader(_datasets(data, files, "csv", None), batch_size=3, shard=s,
                                    num_shards=2, **LOADER) for s in range(2)]
    counts = [lo._shard_batch_count(s) for s, lo in enumerate(loaders)]
    batches = [list(lo) for lo in loaders]
    assert counts[0] != counts[1] and len(batches[0]) == len(batches[1]) == max(counts)
    short = int(np.argmin(counts))
    assert sum(not b["batch_mask"].any() for b in batches[short]) == max(counts) - min(counts)


def test_worker_exception_reaches_the_consumer(files):
    class Broken:
        def __len__(self):
            return 4

        def get_sample(self, idx, rng=None):
            if idx == 2:
                raise FileNotFoundError("no such image: 2.jpg")
            return np.zeros((64, 96, 3), np.float32), {"boxes": np.zeros((0, 4)),
                                                       "labels": np.zeros(0)}, idx

    loader = data.DetectionLoader(Broken(), batch_size=2, **LOADER)
    with pytest.raises(FileNotFoundError, match="2.jpg"):
        list(loader)


def test_pin_memory_asks_for_pinned_tensors(files, monkeypatch):
    """The batch buffers are allocated with ``pin_memory`` (CUDA only: the
    CPU build records the request)."""
    asked = []
    real_zeros = torch.zeros

    def zeros(*args, pin_memory=False, **kw):
        asked.append(pin_memory)
        return real_zeros(*args, **kw)

    monkeypatch.setattr(torch, "zeros", zeros)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    loader = data.DetectionLoader(_datasets(data, files, "csv", None), batch_size=4,
                                  pin_memory=True, **LOADER)
    next(iter(loader))
    assert asked and all(asked)


# ---------------------------------------------------------------------------- #
# Transforms
# ---------------------------------------------------------------------------- #
TRANSFORMS = {
    "Blur": {"p": 1.0},
    "GaussNoise": {"p": 1.0},
    "HorizontalFlip": {"p": 1.0},
    "HueSaturationValue": {"p": 1.0},
    "RandomBrightnessContrast": {"p": 1.0},
    "RandomCrop": {"height": 40, "width": 50},
    "Resize": {"height": 37, "width": 53},
    "ShiftScaleRotate": {"p": 1.0, "rotate_limit": 10.0},
    "ToFloat": {},
    "VerticalFlip": {"p": 1.0},
}


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_equals_jax_with_the_same_generator(name, dtype):
    rng = np.random.default_rng(11)
    image = _image(rng, 60, 80)
    if dtype == "float32":
        image = image.astype(np.float32) / 255.0
    boxes = _boxes(rng, 60, 80, 5).astype(np.float32)
    labels = rng.integers(1, 4, 5)
    got = transforms.TRANSFORM_REGISTRY[name](**TRANSFORMS[name])(
        image.copy(), boxes.copy(), labels.copy(), rng=np.random.default_rng(3))
    want = jax_transforms.TRANSFORM_REGISTRY[name](**TRANSFORMS[name])(
        image.copy(), boxes.copy(), labels.copy(), rng=np.random.default_rng(3))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_registry_names_build_transforms_and_load_obj():
    for key in jax_transforms.TRANSFORM_REGISTRY:  # albumentations.* and the JAX dotted names
        assert key in transforms.TRANSFORM_REGISTRY
        assert utils.load_obj(key) is transforms.TRANSFORM_REGISTRY[key]
    for cls in set(transforms.TRANSFORM_REGISTRY.values()):
        dotted = f"pytorch_retinanet_tpu_torch.data.transforms.{cls.__name__}"
        assert transforms.TRANSFORM_REGISTRY[dotted] is cls
    specs = [{"class_name": "albumentations.HorizontalFlip", "params": {"p": 0.5}}]
    for keep_bytes, first in ((True, transforms.HorizontalFlip), (False, transforms.ToFloat)):
        chain = transforms.build_transforms(specs, keep_bytes=keep_bytes)
        want = jax_transforms.build_transforms(specs, keep_bytes=keep_bytes)
        assert [type(t).__name__ for t in chain.transforms] == \
            [type(t).__name__ for t in want.transforms]
        assert isinstance(chain.transforms[0], first)
    with pytest.raises(KeyError, match="unknown transform"):
        transforms.build_transforms([{"class_name": "albumentations.Nope"}])


def test_seed_everything_reseeds_the_fallback_generator():
    image = np.random.default_rng(1).random((20, 30, 3), dtype=np.float32)
    boxes, labels = np.zeros((0, 4), np.float32), np.zeros(0, np.int64)
    outs = []
    for pkg_utils, tf in ((utils, transforms), (None, jax_transforms)):
        if pkg_utils is None:
            from pytorch_retinanet_tpu import utils as pkg_utils
        pkg_utils.seed_everything(42)
        outs.append(tf.GaussNoise(p=1.0)(image, boxes, labels)[0])
    assert outs[0].tobytes() == outs[1].tobytes()


def test_coco_transforms_equal_jax():
    rng = np.random.default_rng(2)
    image = _image(rng, 40, 50)
    target = {"boxes": _boxes(rng, 40, 50, 3).astype(np.float32), "labels": np.array([1, 2, 3]),
              "masks": (rng.random((3, 40, 50)) < 0.5).astype(np.uint8),
              "keypoints": rng.uniform(0, 40, (3, 17, 3)).astype(np.float32)}
    pipes = [pkg.Compose([pkg.RandomHorizontalFlip(1.0), pkg.ToTensor()])
             for pkg in (coco_transforms, jax_coco_transforms)]
    (gi, gt), (wi, wt) = (p(image, dict(target), rng=np.random.default_rng(0)) for p in pipes)
    assert gi.tobytes() == wi.tobytes()
    for k in target:
        assert np.asarray(gt[k]).tobytes() == np.asarray(wt[k]).tobytes(), k
    adapters = [pkg.TargetTransformAdapter(pkg.RandomHorizontalFlip(1.0))
                for pkg in (coco_transforms, jax_coco_transforms)]
    got, want = (a(image, target["boxes"], target["labels"], rng=np.random.default_rng(0))
                 for a in adapters)
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("kind", ["coco", "voc", "csv"])
def test_dataset_samples_and_coco_api_equal_jax(files, kind):
    got_ds = _datasets(data, files, kind, data.build_transforms(None))
    want_ds = _datasets(jax_data, files, kind, jax_data.build_transforms(None))
    assert len(got_ds) == len(want_ds)
    for i in range(len(got_ds)):
        (gi, gt, gid), (wi, wt, wid) = got_ds.get_sample(i), want_ds.get_sample(i)
        assert gid == wid and gi.tobytes() == wi.tobytes()
        for k in wt:
            assert np.asarray(gt[k]).tobytes() == np.asarray(wt[k]).tobytes(), k
        assert got_ds.get_height_and_width(i) == want_ds.get_height_and_width(i)
    assert data.get_coco_api_from_dataset(got_ds).dataset == \
        jax_data.get_coco_api_from_dataset(want_ds).dataset
    if kind == "voc":
        df = data.convert_annotations_to_df(str(files / "xml"), str(files / "val2017"))
        want_df = jax_data.convert_annotations_to_df(str(files / "xml"), str(files / "val2017"))
        pd.testing.assert_frame_equal(df, want_df)
        assert data.generate_pascal_category_names(df) == \
            jax_data.generate_pascal_category_names(want_df)


def test_get_coco_filters_train_images_without_boxes(files, tmp_path):
    for split in ("train", "val"):
        os.makedirs(tmp_path / "annotations", exist_ok=True)
        src = files / "annotations" / "instances_val2017.json"
        (tmp_path / "annotations" / f"instances_{split}2017.json").write_text(src.read_text())
        got = data.get_coco(str(tmp_path), split)
        want = jax_data.get_coco(str(tmp_path), split)
        assert got.image_ids == want.image_ids
        assert (len(got) < len(SIZES)) == (split == "train")

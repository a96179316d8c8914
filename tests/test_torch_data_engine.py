"""The port's Trainer on datasets from disk vs the JAX Trainer (CPU).

resnet18 at min 64 / max 96, f32, ``device="cpu"``; the weights (random BN
statistics too) are made once and carried into both packages (the JAX
package's reference-schema loader, then the port's ``load_state_dict`` of
the JAX variables).

* A tiny COCO dataset (``dataset.kind: coco``; 5 landscape val images, test
  batches of 2, the last padded): ``Trainer.predict`` returns the same
  image ids, detection counts and labels as the JAX ``Trainer.predict``,
  scores within 1e-5 and boxes within 1e-3 px (the tolerance
  ``test_torch_predict.py`` holds ``predict`` to: the f32 convs sum in
  another order); boxes lie inside each original image. ``Trainer.test``'s
  AP within 1e-4 of JAX's.
* 10 SGD steps of ``Trainer.fit`` (``configs/hparams.yaml``'s SGD, the
  default prior 0.01) from one CSV dataset (``dataset.kind: csv``,
  shuffled, a flip augmentation, the uint8 wire, warmup and clipping)
  through each package's own loader: per-step losses within 1e-4
  relative of the JAX Trainer's (f32 convolutions sum in another order, and
  the differences grow a little step by step).
* ``RetinaNetModel`` with ``dataset.kind`` coco, pascal (VOC XML) and csv,
  ``valid_paths`` / ``test_paths`` None or False: the same datasets present
  and absent as JAX's, loaders with JAX's batch sizes, shuffle,
  ``drop_last``, sizes and wire, and the same test evaluator's ground truth.
* The interrupt cases of ``tests/test_trainer_interrupt.py`` on that CSV
  dataset through the port's ``DetectionLoader``: SIGTERM saves
  ``interrupt`` and ``fit`` returns; SIGINT's save resumes with
  ``auto_resume`` and re-runs the interrupted epoch; a partial accumulation
  window is flushed before the save; ``save_on_interrupt=False`` installs
  nothing.
"""

from __future__ import annotations

import json
import os
import signal
from pathlib import Path

import cv2
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from pytorch_retinanet_tpu import OmegaConf as JaxOmegaConf
from pytorch_retinanet_tpu.engine.model import RetinaNetModel as JaxRetinaNetModel
from pytorch_retinanet_tpu.engine.trainer import Trainer as JaxTrainer
from pytorch_retinanet_tpu.models.retinanet import Retinanet as JaxRetinanet
from pytorch_retinanet_tpu_torch import OmegaConf, RetinaNetModel, Retinanet, Trainer
from pytorch_retinanet_tpu_torch.engine.trainer import CHECKPOINT_FILE

MODEL = dict(num_classes=4, backbone_kind="resnet18", pretrained=False, min_size=64,
             max_size=96, compute_dtype="float32", prior=0.5)
# The fit: the default prior and configs/hparams.yaml's SGD.
FIT_MODEL = {**MODEL, "prior": 0.01}
OPTIMIZER = {"class_name": "torch.optim.SGD",
             "params": {"lr": 0.001, "momentum": 0.9, "weight_decay": 0.001}}
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(model):
    """JAX variables of seeded weights with random BN statistics and affine."""
    port = Retinanet(device="cpu", seed=0, **model)
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in port.state_dict().items():
        v = v.numpy().copy()
        if v.ndim == 1 and k.endswith((".weight", "running_var")):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("running_mean"):
            v = rng.normal(0, 0.05, v.shape).astype(np.float32)
        sd[k] = v
    ref = JaxRetinanet(seed=0, **model)
    ref.load_state_dict(sd)
    return ref.variables


@pytest.fixture(scope="module")
def variables():
    return _variables(MODEL)


def _rect_image(rng, h, w, boxes):
    img = np.full((h, w, 3), 255, np.uint8)
    for x1, y1, x2, y2 in boxes:
        cv2.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)),
                      tuple(int(c) for c in rng.integers(0, 200, 3)), -1)
    return img


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """train2017 / val2017 with the same 5 landscape images (72x96 and 60x90)."""
    root = tmp_path_factory.mktemp("coco_engine")
    rng = np.random.default_rng(1)
    images, anns = [], []
    for i in range(5):
        h, w = (72, 96) if i % 2 else (60, 90)
        n = int(rng.integers(1, 4))
        xy = rng.uniform(2, 40, (n, 2))
        wh = rng.uniform(12, 40, (n, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], 1).round()
        img = _rect_image(rng, h, w, boxes)
        images.append({"id": 10 + i, "file_name": f"{i}.jpg", "height": h, "width": w})
        for b in boxes:
            anns.append({"id": len(anns) + 1, "image_id": 10 + i,
                         "category_id": int(rng.integers(1, 4)),
                         "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]],
                         "area": float((b[2] - b[0]) * (b[3] - b[1])), "iscrowd": 0})
        for split in ("train", "val"):
            os.makedirs(root / f"{split}2017", exist_ok=True)
            cv2.imwrite(str(root / f"{split}2017" / f"{i}.jpg"), img)
    os.makedirs(root / "annotations")
    coco = {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in (1, 2, 3)]}
    for split in ("train", "val"):
        (root / "annotations" / f"instances_{split}2017.json").write_text(json.dumps(coco))
    return str(root)


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    """8 images of a rectangle on white, as ``tests/test_trainer_interrupt.py``."""
    root = tmp_path_factory.mktemp("csv_engine")
    rows = []
    rng = np.random.default_rng(3)
    for i in range(8):
        x1, y1 = int(rng.integers(5, 30)), int(rng.integers(5, 40))
        x2, y2 = min(x1 + 30, 79), min(y1 + 30, 99)
        path = str(root / f"{i}.png")
        cv2.imwrite(path, _rect_image(rng, 100, 80, [(x1, y1, x2, y2)]))
        rows.append({"filename": path, "width": 80, "height": 100, "class": "car",
                     "xmin": float(x1), "ymin": float(y1), "xmax": float(x2),
                     "ymax": float(y2), "labels": 1})
    path = str(root / "train.csv")
    pd.DataFrame(rows).to_csv(path, index=False)
    return path


def _conf(dataset, model=MODEL, **extra):
    return {"model": model, "dataset": dataset, "optimizer": OPTIMIZER,
            "dataloader": {"train_bs": 2, "valid_bs": 2, "test_bs": 2,
                           "args": {"num_workers": 2}},
            "transforms": [{"class_name": "albumentations.HorizontalFlip", "params": {"p": 0.5}}],
            **extra}


def _models(conf, variables):
    jm = JaxRetinaNetModel(JaxOmegaConf.create(conf))
    jm.net.variables = variables
    pm = RetinaNetModel(OmegaConf.create(conf), device="cpu")
    pm.net.load_state_dict(variables)
    return jm, pm


@pytest.fixture(scope="module")
def coco_runs(coco_root, variables):
    """Both Trainers' predict and test on the COCO dataset."""
    jm, pm = _models(_conf({"kind": "coco", "root_dir": coco_root}), variables)
    jt = JaxTrainer(checkpoint_dir=None, devices=jax.devices()[:1], logger=False)
    pt = Trainer(logger=False)
    return {"jax": (jt.predict(jm), jt.test(jm)[0]["AP"]),
            "port": (pt.predict(pm), pt.test(pm)[0]["AP"]), "model": pm}


def test_trainer_predict_matches_jax_on_a_coco_dataset(coco_runs):
    (got, _), (want, _) = coco_runs["port"], coco_runs["jax"]
    assert sorted(got) == sorted(want) == [10, 11, 12, 13, 14]
    ds = coco_runs["model"].test_ds
    n_dets = 0
    for image_id, w in want.items():
        g = got[image_id]
        assert len(g["scores"]) == len(w["scores"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)
        info = ds.coco.imgs[image_id]
        assert (g["boxes"] >= -1e-3).all()
        assert (g["boxes"][:, [0, 2]] <= info["width"] + 1e-3).all()
        assert (g["boxes"][:, [1, 3]] <= info["height"] + 1e-3).all()
        n_dets += len(g["scores"])
    assert n_dets > 0


def test_trainer_test_ap_matches_jax(coco_runs):
    (_, got), (_, want) = coco_runs["port"], coco_runs["jax"]
    assert abs(got - want) <= 1e-4 and 0.0 <= got <= 1.0


def test_test_respects_limit_test_batches_and_drops_padding_rows(coco_runs):
    model = coco_runs["model"]
    seen = []
    t = Trainer(logger=False, limit_test_batches=1)
    orig = t._predict_batch

    def record(batch):
        out = orig(batch)
        seen.append((int(batch["batch_mask"].sum()), sorted(out)))
        return out

    t._predict_batch = record
    t.test(model)
    assert len(seen) == 1 and seen[0][0] == len(seen[0][1]) == 2
    preds = Trainer(logger=False).predict(model, model.test_dataloader())
    assert len(preds) == 5  # 3 batches of 2, the last with one padding row dropped


def _record_losses(trainer):
    """Per-step losses, by ``global_step`` (the JAX Trainer logs an epoch's
    last step once more at the epoch's end)."""
    losses = {}
    update = trainer.logger_.update

    def record(**kw):
        losses[trainer.global_step] = kw["loss"]
        return update(**kw)

    trainer.logger_.update = record
    return losses


def test_ten_sgd_steps_from_a_csv_dataset_match_the_jax_trainer(csv_path):
    conf = _conf({"kind": "csv", "trn_paths": csv_path, "valid_paths": False,
                  "test_paths": False}, model=FIT_MODEL)
    jm, pm = _models(conf, _variables(FIT_MODEL))
    kw = dict(max_epochs=3, max_steps=10, warmup_steps=3, gradient_clip_val=10.0,
              log_every_n_steps=1, num_sanity_val_steps=0, logger=False)
    jt = JaxTrainer(checkpoint_dir=None, devices=jax.devices()[:1], **kw)
    pt = Trainer(**kw)
    want, got = _record_losses(jt), _record_losses(pt)
    jt.fit(jm)
    pt.fit(pm)
    batch = next(iter(pm.train_dataloader()))
    assert batch["images"].dtype == torch.uint8  # the flip chain keeps the uint8 wire
    assert pt.global_step == jt.global_step == 10
    assert sorted(got) == sorted(want) == list(range(1, 11))
    np.testing.assert_allclose([got[k] for k in range(1, 11)], [want[k] for k in range(1, 11)],
                               rtol=LOSS_RTOL, atol=0)


# ---------------------------------------------------------------------------- #
# Interrupts on the CSV dataset (tests/test_trainer_interrupt.py's cases)
# ---------------------------------------------------------------------------- #
STEP_LR = {"class_name": "torch.optim.lr_scheduler.StepLR",
           "params": {"step_size": 1, "gamma": 0.5}, "interval": "epoch", "frequency": 1,
           "monitor": False}


def _csv_model(csv_path):
    conf = _conf({"kind": "csv", "trn_paths": csv_path, "valid_paths": False,
                  "test_paths": csv_path}, scheduler=STEP_LR)
    conf["optimizer"] = {"class_name": "torch.optim.SGD",
                         "params": {"lr": 0.001, "momentum": 0.9}}
    # The JAX test's model, in f32: bf16 convolutions on the CPU build of
    # PyTorch go non-finite from the second model of a process (PERF.md §6).
    conf["model"] = {"backbone_kind": "resnet18", "num_classes": 2, "min_size": 64,
                     "max_size": 96, "pretrained": False, "compute_dtype": "float32"}
    return RetinaNetModel(OmegaConf.create(conf), device="cpu")


def _fit_with_signal_at_batch(model, ckpt_dir, *, n, sig, **trainer_kwargs):
    """fit() with `sig` raised just before the n-th batch goes to the device;
    a sentinel handler stands in, so that a Trainer that installs none
    fails the test instead of killing the process."""
    hits = []
    prev = signal.signal(sig, lambda s, f: hits.append(s))
    try:
        trainer = Trainer(max_epochs=2, checkpoint_dir=ckpt_dir, warmup_steps=0, logger=False,
                          **trainer_kwargs)
        orig, calls = trainer._device_batch, {"n": 0}

        def patched(batch):
            calls["n"] += 1
            if calls["n"] == n:
                signal.raise_signal(sig)
            return orig(batch)

        trainer._device_batch = patched
        trainer.fit(model)
        assert not hits, "the Trainer installed no signal handler"
        return trainer
    finally:
        signal.signal(sig, prev)


@pytest.mark.parametrize("case", ["sigterm_saves_and_returns", "resume_reruns_the_epoch",
                                  "accumulation_flushed", "disabled_installs_nothing"])
def test_interrupt_on_the_csv_dataset(csv_path, tmp_path, case):
    ckpt = str(tmp_path)
    model = _csv_model(csv_path)
    interrupt = os.path.join(ckpt, "interrupt", CHECKPOINT_FILE)
    if case == "sigterm_saves_and_returns":
        # 4 batches an epoch (8 images, batches of 2): signal before batch 2.
        t = _fit_with_signal_at_batch(model, ckpt, n=2, sig=signal.SIGTERM)
        assert t._interrupted and t.global_step == 2 and os.path.isfile(interrupt)
        assert t.current_lr == pytest.approx(0.001)  # no epoch scheduler step
    elif case == "resume_reruns_the_epoch":
        _fit_with_signal_at_batch(model, ckpt, n=2, sig=signal.SIGINT)
        resumed = Trainer(max_epochs=2, checkpoint_dir=ckpt, warmup_steps=0, logger=False,
                          auto_resume=True)
        metrics = resumed.fit(model)
        assert resumed.current_epoch == 1 and resumed.global_step == 2 + 8
        assert metrics["lr"] == pytest.approx(0.001 * 0.25)
        assert np.isfinite(metrics["train_loss"])
    elif case == "accumulation_flushed":
        t = _fit_with_signal_at_batch(model, ckpt, n=3, sig=signal.SIGTERM,
                                      accumulate_grad_batches=2)
        assert t._optimizer.mini_step == 0 and t.global_step == 4 and os.path.isfile(interrupt)
    else:
        t = Trainer(max_epochs=1, checkpoint_dir=ckpt, warmup_steps=0, logger=False,
                    save_on_interrupt=False)
        assert t._install_interrupt_handlers() == {}
        t.fit(model)
        assert not os.path.isdir(os.path.join(ckpt, "interrupt"))


# ---------------------------------------------------------------------------- #
# RetinaNetModel's datasets and loaders for each dataset.kind
# ---------------------------------------------------------------------------- #
def _voc_dirs(root):
    """VOC XML annotations of the CSV fixture's first 4 images."""
    ann = root / "xml"
    ann.mkdir(exist_ok=True)
    for i in range(4):
        (ann / f"{i}.xml").write_text(
            f"<annotation><filename>{i}.png</filename><size><width>80</width><height>100"
            "</height><depth>3</depth></size><object><name>car</name><bndbox><xmin>10</xmin>"
            "<ymin>12</ymin><xmax>40</xmax><ymax>50</ymax></bndbox></object></annotation>")
    return [str(ann), str(root)]


@pytest.mark.parametrize("kind", ["coco", "pascal", "csv"])
def test_model_loaders_match_jax_for_each_kind(kind, coco_root, csv_path):
    if kind == "coco":
        dataset = {"kind": "coco", "root_dir": coco_root}
    elif kind == "pascal":
        paths = _voc_dirs(Path(csv_path).parent)
        dataset = {"kind": "pascal", "trn_paths": paths, "valid_paths": None,
                   "test_paths": paths}
    else:
        dataset = {"kind": "csv", "trn_paths": csv_path, "valid_paths": None,
                   "test_paths": False}
    conf = _conf(dataset)
    conf["dataloader"]["test_bs"] = 3
    jm = JaxRetinaNetModel(JaxOmegaConf.create(conf))
    pm = RetinaNetModel(OmegaConf.create(conf), device="cpu")
    jm.prepare_data()
    pm.prepare_data()
    for name in ("trn_ds", "val_ds", "test_ds"):
        assert (getattr(pm, name) is None) == (getattr(jm, name) is None), name
    pairs = [(pm.train_dataloader(), jm.train_dataloader())]
    if jm.val_ds is not None:
        pairs.append((pm.val_dataloader(), jm.val_dataloader()))
    else:
        assert pm.val_dataloader() is None
    if jm.test_ds is not None:
        pairs.append((pm.test_dataloader(), jm.test_dataloader()))
        got_eval, want_eval = pm.test_evaluator(), jm.test_evaluator()
        assert got_eval.coco_gt.dataset == want_eval.coco_gt.dataset
    else:
        with pytest.raises(ValueError, match="no test dataset"):
            pm.test_dataloader()
    for got, want in pairs:
        for attr in ("batch_size", "shuffle", "drop_last", "pad_last", "min_size", "max_size",
                     "num_workers", "prefetch", "image_dtype"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert len(got) == len(want) and got.pin_memory is False  # the CPU: nothing to pin

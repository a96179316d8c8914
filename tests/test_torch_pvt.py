"""PVTv2-B2 in the port (``models/pvt.py``) against the benchmark's plain
reference trunk, ``benchmark/families/pvt_v2.py`` (loaded by path, as
``benchmark/rnbench/spec.py`` loads it), with the reference's FPN, head,
loss and postprocess (``benchmark/rnbench/reference.py``), on the CPU: the
published widths and depths, 2 images of 128x192 (token maps 32x48 down
to 4x6; every stage's keys and values on the 4x6 map), the family's
seeded draws (``benchmark/rnbench/weights.py``).

Tolerances, each with its reason:

- C3-C5 in f32: within 1e-5 of the largest magnitude. Both sides compute
  the same f32 operations in other orders (the port's SDPA blocks its
  softmax, the reference's linears are 1x1 convs): a few ulp, 1.3e-6
  measured.
- Logits and box deltas in bf16: within 2^-8 of the value plus 5e-3. The
  port holds each output in bf16, whose rounding moves a value by up to
  2^-9 of it (the class logits sit near the prior's -4.6, where that is
  0.0156); the bf16 rounding of the activations through 16 blocks, the FPN
  and the head added under 2.5e-3 more on the seeds measured. The
  reference's own fp8 control lies 0.013 away, so this holds the logits to
  bf16 and no lower.
- Loss and every leaf's gradient: the port's module in f64 (its loss in
  f32, as the program computes it) against the reference in f64: the loss
  within 1e-6 relative, each gradient within 2e-5 of its norm (the f32
  loss rounds the logits' gradient: 2.8e-6 measured). f64 on both sides,
  since in f32 on one CPU thread both drift from f64 by up to 1.7e-3 of a
  leaf's norm (long f32 sums over anchors and positions; the reference's
  explicit softmax backward cancels the scores' common-mode gradient).
- One AdamW step of the configuration's optimizer (``configs/
  pvtv2_b2_fpn.json``) as the program builds it, on the port's gradients,
  against ``benchmark/optimizers/adamw.py`` on the same gradients: within
  1e-12 relative and 1e-15 (the two round one formula apart in f64).
- ``predict``'s detections against the reference's postprocess of its f32
  outputs: the same detections, scores within 1e-5 and boxes within 1e-3
  px (outputs 1e-6 apart through the same selection and greedy NMS).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from pytorch_retinanet_tpu_torch import ConfigDict, OmegaConf, RetinaNetModel, Retinanet, Trainer
from pytorch_retinanet_tpu_torch.models import apply_detector, fused_stem_applicable
from pytorch_retinanet_tpu_torch.models.fused_backbone import fused_trunk_applicable
from pytorch_retinanet_tpu_torch.models.pvt import PyramidVisionTransformerV2, drop_path
from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level, retinanet_loss_levels
from pytorch_retinanet_tpu_torch.parallel.sharding import build_sharded_forward, make_split_forward
from pytorch_retinanet_tpu_torch.utils import metrics

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from rnbench import compare, train, weights  # noqa: E402
from rnbench import reference as R  # noqa: E402


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FAM = _load(BENCH / "families/pvt_v2.py", "pvt_v2_family")
ADAMW = _load(BENCH / "optimizers/adamw.py", "adamw_reference")
CONFIG = json.loads((BENCH / "configs/pvtv2_b2_fpn.json").read_text())
BUCKET = (128, 192)
M = {**CONFIG["model"], "min_size": 128, "max_size": 192}
SEEDS = (3, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net(dtype="float32", prior=0.01, **kw) -> Retinanet:
    return Retinanet(backbone_kind="pvt_v2_b2", num_classes=M["num_classes"], prior=prior,
                     pretrained=False, min_size=128, max_size=192, compute_dtype=dtype, device="cpu",
                     **{"drop_path_rate": 0.0, **kw})


def _images(seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (2, *BUCKET, 3), generator=gen, dtype=torch.uint8)


def _loaded(seed: int, dtype="float32", prior=0.01, head_std=None):
    sd = weights.make_state_dict(FAM, M, prior, seed, "cpu", head_std)
    net = _net(dtype, prior)
    net.load_torch_state_dict(sd)
    return net, sd


def test_state_dict_keys_are_the_familys_schema():
    net = _net()
    sd = net.state_dict()
    trunk = {k: tuple(v.shape) for k, v in sd.items() if k.startswith("backbone.")}
    assert trunk == {k: shape for k, shape, _ in FAM.schema(M)}
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: s for k, s, _ in R.schema(FAM, M)}
    assert sum(np.prod(s) for s in trunk.values()) == 24_849_856  # pvt_v2_b2 without its classifier


@pytest.mark.parametrize("seed", SEEDS)
def test_f32_trunk_matches_the_reference(seed):
    net, sd = _loaded(seed)
    images = _images(seed)
    with torch.no_grad():
        got = net.module.backbone(net.module.normalize(images).permute(0, 3, 1, 2))
        want = FAM.trunk(sd, R.normalize(images), M)
    for key, w in zip(("c3", "c4", "c5"), want):
        g = got[key]
        assert g.shape == w.shape
        assert float((g - w).abs().max() / w.abs().max()) < 1e-5, key


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_logits_match_the_reference(seed):
    net, sd = _loaded(seed, "bfloat16")
    images = _images(seed)
    with torch.no_grad():
        got_cls, got_box = net.module(images, return_levels=True)
        want_cls, want_box = R.detector(sd, images, FAM, M)
    for g, w in zip(got_cls + got_box, want_cls + want_box):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, rtol=2 ** -8, atol=5e-3)


def _reference_loss_and_grads(sd, batch):
    """The reference detector's mean loss over the batch and every
    parameter's gradient, in f64."""
    params = {k: v.double().requires_grad_(True) for k, v in sd.items()}
    c3, c4, c5 = FAM.trunk(params, R.normalize(batch["images"]).double(), M)
    cls, box = R.head(params, R.fpn(params, c3, c4, c5), M["num_classes"])
    cls, box = torch.cat(cls, 1), torch.cat(box, 1)
    anchors = torch.from_numpy(np.concatenate(R.anchors_per_level(BUCKET))).double()
    n = batch["images"].shape[0]
    loss = sum(R.image_loss(cls[i], box[i], anchors, batch["boxes"][i][batch["valid"][i]].double(),
                            batch["labels"][i][batch["valid"][i]], M["num_classes"])
               for i in range(n)) / n
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in params.items()}


@pytest.mark.parametrize("seed", SEEDS)
def test_loss_gradients_and_an_adamw_step_match_the_reference(seed):
    sd = weights.make_state_dict(FAM, M, 0.01, seed, "cpu")
    hp = {"model": {"backbone_kind": "pvt_v2_b2", "num_classes": M["num_classes"], "min_size": 128,
                    "max_size": 192, "compute_dtype": "float32", "pretrained": False,
                    **CONFIG["program"]}, "optimizer": CONFIG["optimizer"]}
    model = RetinaNetModel(ConfigDict(hp), device="cpu")
    model.net.load_torch_state_dict(sd)
    module = model.net.module.double().train()
    module.dtype = torch.float64
    optimizer = model.configure_optimizers()[0]
    traffic = {"batch": 2, "batches": 1, "min_fg": 4}
    batch = train.make_batches(traffic, seed, 0, BUCKET, M["num_classes"], "cpu", False)[0]
    anchors = [torch.from_numpy(a).double() for a in generate_anchors_per_level(BUCKET)]
    cls, box = module(batch["images"], return_levels=True)
    assert cls[0].dtype == torch.float64
    out = retinanet_loss_levels(cls, box, anchors, batch["boxes"], batch["labels"], batch["valid"],
                                num_classes=M["num_classes"])
    loss = out["classification_loss"] + out["regression_loss"]
    loss.backward()
    want_loss, want_grads = _reference_loss_and_grads(sd, batch)
    assert abs(float(loss) / want_loss - 1) < 1e-6
    params = dict(module.named_parameters())
    assert set(params) == set(want_grads)
    for k, p in params.items():
        w = want_grads[k]
        assert float(torch.linalg.vector_norm(p.grad - w)) <= 2e-5 * float(
            torch.linalg.vector_norm(w)), k
    ref = {k: p.detach().clone() for k, p in params.items()}
    grads = {k: p.grad.detach().clone() for k, p in params.items()}
    optimizer.step()
    with torch.no_grad():
        ADAMW.update(ref, grads, {}, 0, CONFIG["optimizer"])
    for k, p in params.items():
        torch.testing.assert_close(p.detach(), ref[k], rtol=1e-12, atol=1e-15)
    assert all(not torch.equal(p.detach(), sd[k].double()) for k, p in params.items())


def test_predict_matches_the_reference_postprocess():
    net, sd = _loaded(7, prior=0.5, head_std=0.0295)
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (120, 180, 3), dtype=np.uint8),
              rng.integers(0, 256, (96, 144, 3), dtype=np.uint8)]
    got = net.predict(images)
    with torch.no_grad():
        want = compare.detections_of(compare.reference_outputs(images, sd, FAM, M, "cpu"), M)
    assert sum(len(g["scores"]) for g in got) > 0
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)


def test_the_spans_and_the_score_counter():
    """Every block's three spans, and the counter equal to the family's
    count of scores, over one traced forward."""
    net, _ = _loaded(3)
    metrics.drain()
    with metrics.tracing(), torch.no_grad():
        net.module(_images(3))
    records = metrics.drain()
    names = [s["name"] for s in records["spans"]]
    assert [names.count(n) for n in ("pvt.attention", "pvt.sdpa", "pvt.ffn")] == [16, 16, 16]
    parent = {s["id"]: s["name"] for s in records["spans"]}
    sdpa = [s for s in records["spans"] if s["name"] == "pvt.sdpa"]
    assert {parent[s["parent"]] for s in sdpa} == {"pvt.attention"}
    assert records["counters"]["attention.score_elems"] == FAM.score_elems(*BUCKET, 2)


def test_drop_path_is_the_identity_in_eval_and_at_rate_0_and_per_sample_in_training():
    x = torch.randn(64, 10, 8)
    assert drop_path(x, 0.5, training=False) is x
    assert drop_path(x, 0.0, training=True) is x
    torch.manual_seed(0)
    y = drop_path(x, 0.5, training=True)
    kept = (y == 2 * x).flatten(1).all(1)
    dropped = (y == 0).flatten(1).all(1)
    assert bool((kept | dropped).all()) and 0 < int(kept.sum()) < 64
    trunk = PyramidVisionTransformerV2(drop_path_rate=0.1)
    rates = [b.drop_path_rate for i in range(1, 5) for b in getattr(trunk, f"block{i}")]
    np.testing.assert_allclose(rates, np.linspace(0, 0.1, 16), rtol=0, atol=1e-7)
    trunk.reset_parameters(torch.Generator().manual_seed(0))
    image = torch.randn(2, 3, 64, 96)
    with torch.no_grad():
        plain = PyramidVisionTransformerV2(drop_path_rate=0.0)
        plain.load_state_dict(trunk.state_dict())
        want = plain.eval()(image)
        assert all(torch.equal(trunk.eval()(image)[k], want[k]) for k in want)
        assert all(torch.equal(plain.train()(image)[k], want[k]) for k in want)
        assert not torch.equal(trunk.train()(image)["c5"], want["c5"])


def test_the_conv_only_paths_raise_clearly_for_a_pvt_trunk():
    net = _net()
    images = _images(0)
    assert not fused_stem_applicable(net.module, images.shape)
    assert not fused_trunk_applicable("pvt_v2_b2")
    with pytest.raises(ValueError, match="fused stem kernel"):
        apply_detector(net.module, images, use_fused_stem=True)
    with pytest.raises(ValueError, match="fused trunk"):
        apply_detector(net.module, images, use_fused_trunk=True)
    with pytest.raises(ValueError, match="spatial split"):
        make_split_forward(net.module, SimpleNamespace(spatial_size=2, model_size=1))
    with pytest.raises(ValueError, match="tensor-parallel split"):
        build_sharded_forward(net.module, SimpleNamespace(spatial_size=1, model_size=2))
    with pytest.raises(ValueError, match="JAX package"):
        net.load_state_dict({"params": {}, "batch_stats": {}})
    with pytest.raises(ValueError, match="pretrained=False"):
        Retinanet(backbone_kind="pvt_v2_b2", pretrained=True, device="cpu")
    with pytest.raises(ValueError, match="ResNet options"):
        Retinanet(backbone_kind="pvt_v2_b2", pretrained=False, remat=True, device="cpu")
    with pytest.raises(ValueError, match="drop_path_rate"):
        Retinanet(backbone_kind="resnet18", pretrained=False, drop_path_rate=0.1, device="cpu")


def test_fit_and_test_through_the_trainer_on_a_csv_dataset(tmp_path):
    """``Trainer.fit`` (drop path on) and ``Trainer.test`` through the
    entry points the ResNet detectors take."""
    rng = np.random.default_rng(3)
    rows = []
    for i in range(4):
        img = np.full((100, 80, 3), 255, np.uint8)
        x1, y1 = int(rng.integers(5, 30)), int(rng.integers(5, 40))
        cv2.rectangle(img, (x1, y1), (x1 + 30, y1 + 30), (40, 90, 160), -1)
        cv2.imwrite(str(tmp_path / f"{i}.png"), img)
        rows.append({"filename": str(tmp_path / f"{i}.png"), "width": 80, "height": 100,
                     "class": "car", "xmin": float(x1), "ymin": float(y1), "xmax": float(x1 + 30),
                     "ymax": float(y1 + 30), "labels": 1})
    path = str(tmp_path / "train.csv")
    pd.DataFrame(rows).to_csv(path, index=False)
    conf = {"model": {"backbone_kind": "pvt_v2_b2", "num_classes": 2, "min_size": 64, "max_size": 96,
                      "pretrained": False, "compute_dtype": "float32", "drop_path_rate": 0.1},
            "dataset": {"kind": "csv", "trn_paths": path, "valid_paths": False, "test_paths": path},
            "optimizer": CONFIG["optimizer"],
            "dataloader": {"train_bs": 2, "valid_bs": 2, "test_bs": 2, "args": {"num_workers": 1}}}
    model = RetinaNetModel(OmegaConf.create(conf), device="cpu")
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    trainer = Trainer(max_epochs=1, warmup_steps=0, num_sanity_val_steps=0, logger=False)
    trainer.fit(model)
    after = model.net.state_dict()
    assert trainer.global_step == 2
    assert all(torch.isfinite(v).all() for v in after.values())
    assert any(not torch.equal(before[k], after[k]) for k in before)
    ap = trainer.test(model)[0]["AP"]
    assert 0.0 <= ap <= 1.0

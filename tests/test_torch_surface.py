"""The model surface of the PyTorch port vs the JAX package (CPU).

resnet18, 4 classes, f32, the 64x96 bucket, as ``test_torch_train.py``.
Random reference-schema weights (random BN statistics and affine too) go
into both packages; the same numpy inputs go through both.

* ``stem_s2d``: the port's module built with it (whose stem stays the 7x7
  conv) against the JAX s2d backbone (its 4x4 kernel repacked by JAX
  ``stem_kernel_to_s2d`` from the same 7x7 weight): c3 / c4 / c5 within
  1e-4 of each map's largest |value|; the port's stem with and without it
  exactly equal, and the fused stem gate the same either way.
* A ``Retinanet`` runs ``predict`` and the ``forward`` losses in eval mode
  whatever mode its module was left in: a live-BN detector after a train
  step predicts and scores exactly as a fresh one in eval mode, and its
  running statistics do not move.
* ``remat``: with and without it, the loss and every gradient equal within
  1e-6 of the tensor's largest (the recompute repeats the same ops); with
  live batch norm, the running statistics after one step equal and each
  ``num_batches_tracked`` is 1 (a second update in the recompute would make
  it 2 and move the statistics by about 10%).
* ``AnchorGenerator``, the config shim, ``load_obj``, ``collate_fn``,
  ``seed_everything`` and the FLOPs counts: equal to the JAX package's,
  exactly. The port's PyYAML-free ``to_yaml`` loads back to the same data
  as the JAX ``to_yaml``.
* The ``Retinanet`` torch interop: the ``to_torch_state_dict`` ->
  ``load_torch_state_dict`` round trip exactly, and ``load_torch_backbone``
  of one ``.pth`` equal to the JAX method's load of it, exactly.
"""

from __future__ import annotations

import collections
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pytorch_retinanet_tpu import config as jax_config
from pytorch_retinanet_tpu import utils as jax_utils
from pytorch_retinanet_tpu.models import AnchorGenerator as JaxAnchorGenerator
from pytorch_retinanet_tpu.models.backbone import ResNetBackbone as JaxBackbone
from pytorch_retinanet_tpu.models.converter import flax_retinanet_to_torch, torch_retinanet_to_flax
from pytorch_retinanet_tpu.models.layers import stem_kernel_to_s2d
from pytorch_retinanet_tpu.models.retinanet import Retinanet as JaxRetinanet
from pytorch_retinanet_tpu.utils import flops as jax_flops
from pytorch_retinanet_tpu_torch import AnchorGenerator, OmegaConf, Retinanet, config, utils
from pytorch_retinanet_tpu_torch.engine.optim import OPTIMIZER_REGISTRY, SCHEDULER_REGISTRY
from pytorch_retinanet_tpu_torch.models import RetinaNetModule, zoo
from pytorch_retinanet_tpu_torch.ops import retinanet_loss_levels
from pytorch_retinanet_tpu_torch.utils import flops

KIND = "resnet18"
MODEL = dict(num_classes=4, backbone_kind=KIND, pretrained=False, min_size=64, max_size=96,
             compute_dtype="float32", prior=0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's many small CPU steps: the suite
    runs several workers at once, and eight threads each oversubscribe the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_state_dict(seed=0):
    """Seeded port init with random BN statistics and affine (numpy)."""
    net = Retinanet(device="cpu", seed=seed, **MODEL)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        v = v.numpy().copy()
        if v.ndim == 1 and k.endswith((".weight", "running_var")):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif v.ndim == 1 and k.endswith(("running_mean", ".bias")) and "backbone" in k:
            v = rng.normal(0, 0.05, v.shape).astype(np.float32)
        sd[k] = v
    return sd


@pytest.fixture(scope="module")
def state_dict():
    return _random_state_dict()


def _module(sd, **kw):
    module = RetinaNetModule(backbone_kind=KIND, num_classes=4, prior=0.1, dtype=torch.float32,
                             **kw)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return module.to(memory_format=torch.channels_last)


def _images(seed=0, b=2):
    return np.random.default_rng(seed).random((b, 64, 96, 3), dtype=np.float32)


# ---------------------------------------------------------------------------- #
# stem_s2d
# ---------------------------------------------------------------------------- #
def test_stem_s2d_matches_jax_s2d_backbone(state_dict):
    params, stats = torch_retinanet_to_flax(state_dict, KIND)
    bp = dict(params["backbone"])
    bp["stem_conv"] = {"kernel": stem_kernel_to_s2d(bp["stem_conv"]["kernel"])}
    images = _images()
    module = _module(state_dict, stem_s2d=True).eval()
    x = module.normalize(torch.from_numpy(images))
    want = JaxBackbone(kind=KIND, stem_s2d=True, dtype=jnp.float32).apply(
        {"params": bp, "batch_stats": stats["backbone"]}, jnp.asarray(x.numpy()), False)
    with torch.no_grad():
        got = module.backbone(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    for k in ("c3", "c4", "c5"):
        w = np.asarray(want[k])
        g = got[k].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * float(np.abs(w).max()), err_msg=k)


def test_stem_s2d_equals_the_7x7_stem(state_dict):
    x = torch.from_numpy(_images(1)).permute(0, 3, 1, 2)
    with torch.no_grad():
        s2d = _module(state_dict, stem_s2d=True).eval().backbone.backbone.stem(x)
        ref = _module(state_dict).eval().backbone.backbone.stem(x)
    assert torch.equal(s2d, ref)


def test_fused_stem_gate_ignores_s2d():
    from pytorch_retinanet_tpu_torch.models import fused_stem_applicable

    for stem_s2d in (False, True):
        m = RetinaNetModule(backbone_kind=KIND, num_classes=4, stem_s2d=stem_s2d)
        assert fused_stem_applicable(m, (2, 64, 96, 3))


# ---------------------------------------------------------------------------- #
# remat
# ---------------------------------------------------------------------------- #
def _one_step(module, batch):
    from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level

    module.train()
    cls_levels, box_levels = module(torch.from_numpy(batch["images"]), return_levels=True)
    anchors = [torch.from_numpy(a) for a in generate_anchors_per_level((64, 96))]
    out = retinanet_loss_levels(cls_levels, box_levels, anchors,
                                *(torch.from_numpy(batch[k]) for k in ("boxes", "labels", "valid")),
                                num_classes=4)
    loss = out["classification_loss"] + out["regression_loss"]
    loss.backward()
    return loss.item()


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((2, 100, 4), np.float32)
    boxes[0, :2] = [[10, 12, 50, 40], [30, 20, 90, 60]]
    boxes[1, :1] = [[5, 5, 40, 50]]
    labels = np.zeros((2, 100), np.int32)
    labels[0, :2], labels[1, 0] = [1, 3], 2
    return {"images": rng.random((2, 64, 96, 3), dtype=np.float32), "boxes": boxes,
            "labels": labels, "valid": labels > 0}


@pytest.mark.parametrize("freeze_bn", [True, False])
def test_remat_equals_no_remat(state_dict, freeze_bn):
    batch = _batch()
    plain = _module(state_dict, freeze_bn=freeze_bn)
    remat = _module(state_dict, freeze_bn=freeze_bn, remat=True)
    calls = []
    remat.backbone.backbone.layer2[1].bn1.register_forward_hook(lambda *a: calls.append(1))
    assert _one_step(remat, batch) == pytest.approx(_one_step(plain, batch), rel=1e-6)
    assert len(calls) == 2  # the forward, and the recompute in backward
    grads = dict(plain.named_parameters())
    for k, p in remat.named_parameters():
        want = grads[k].grad
        torch.testing.assert_close(p.grad, want, rtol=0, atol=1e-6 * float(want.abs().max()),
                                   msg=k)
    buffers = dict(plain.named_buffers())
    for k, b in remat.named_buffers():
        if k.endswith("num_batches_tracked"):
            assert int(b) == int(buffers[k]) == (0 if freeze_bn else 1), k
        else:
            torch.testing.assert_close(b, buffers[k], rtol=1e-6, atol=0, msg=k)
            if freeze_bn:
                assert torch.equal(b, torch.from_numpy(np.array(state_dict[k]))), k


def test_live_bn_update_is_flax_momentum_with_biased_variance():
    from pytorch_retinanet_tpu_torch.models.layers import BatchNorm2d

    bn = BatchNorm2d(3, frozen=False).train()
    bn.running_mean.fill_(0.5)
    bn.running_var.fill_(2.0)
    x = torch.randn(4, 3, 5, 7, generator=torch.Generator().manual_seed(0))
    y = bn(x)
    mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.9 * 0.5 + 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 * 2.0 + 0.1 * var)
    torch.testing.assert_close(y, (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5))
    assert int(bn.num_batches_tracked) == 1
    before = bn.running_mean.clone()
    bn.eval()(x)  # eval mode: running statistics, no update
    assert torch.equal(bn.running_mean, before)


# ---------------------------------------------------------------------------- #
# AnchorGenerator, config, utils, FLOPs
# ---------------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [{}, {"sizes": [[16, 20]] * 5, "aspect_ratios": [1.0],
                                     "strides": [8, 16, 32, 64, 128], "offset": 0.5}])
def test_anchor_generator_equals_jax(kw):
    for size in ((64, 96), (800, 1344)):
        np.testing.assert_array_equal(AnchorGenerator(**kw)(size), JaxAnchorGenerator(**kw)(size))


CONF = {"model": {"backbone_kind": "resnet50", "num_classes": 3, "extras": [1, 2.5, None]},
        "scheduler": {"class_name": None, "params": {}, "monitor": False},
        "transforms": [{"class_name": "x.Y", "params": {"p": 0.5}}]}


def test_omegaconf_create_merge_to_container_equal_jax():
    over = {"model": {"num_classes": 7, "new": "yes"}, "optimizer": {"params": {"lr": 1e-5}}}
    P, J = OmegaConf, jax_config.OmegaConf
    assert P.to_container(P.create(CONF)) == J.to_container(J.create(CONF))
    assert P.to_container(P.merge(CONF, over)) == J.to_container(J.merge(CONF, over))
    assert P.create(CONF).model.missing is None and P.create(CONF).model.num_classes == 3
    assert config.default_hparams().to_dict() == jax_config.default_hparams().to_dict()
    text = yaml.safe_dump(CONF)
    assert P.to_container(P.create(text)) == J.to_container(J.create(text))


@pytest.mark.parametrize("data", [CONF, jax_config.default_hparams().to_dict(),
                                  {"s": ["12", "x: y", "", "null", "on"], "f": [1e-5, 1e20, -0.0],
                                   "n": [[1, [2]], [], {}], "b": {"c": {"d": True}}}])
def test_to_yaml_without_pyyaml_loads_back_as_jax_to_yaml(data, monkeypatch):
    want = yaml.safe_load(jax_config.OmegaConf.to_yaml(jax_config.ConfigDict(data)))
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
    text = OmegaConf.to_yaml(config.ConfigDict(data))
    monkeypatch.undo()
    assert text == config.to_block_yaml(config.ConfigDict(data).to_dict())
    assert yaml.safe_load(text) == want


def test_load_config_and_the_missing_pyyaml_message(tmp_path, monkeypatch):
    path = tmp_path / "hparams.yaml"
    path.write_text(yaml.safe_dump(CONF))
    assert config.load_config(str(path)).to_dict() == jax_config.load_config(str(path)).to_dict()
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        OmegaConf.load(str(path))
    with pytest.raises(ImportError, match="PyYAML"):
        OmegaConf.create("a: 1")


def test_load_obj_collate_and_seed_everything_match_jax():
    assert utils.load_obj("collections.OrderedDict") is jax_utils.load_obj("collections.OrderedDict")
    assert utils.load_obj("OrderedDict", "collections") is collections.OrderedDict
    assert utils.load_obj("torch.optim.SGD") is OPTIMIZER_REGISTRY["torch.optim.SGD"]
    assert utils.load_obj("StepLR") is SCHEDULER_REGISTRY["StepLR"]
    for f in (utils.load_obj, jax_utils.load_obj):
        with pytest.raises(AttributeError, match="cannot be loaded"):
            f("collections.NoSuchThing")
    batch = [(1, {"a": 1}), (2, {"a": 2})]
    assert utils.collate_fn(batch) == jax_utils.collate_fn(batch)
    draws = []
    for seed_everything in (jax_utils.seed_everything, utils.seed_everything):
        assert seed_everything(1234) == 1234
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]
    utils.seed_everything(7)
    a = torch.rand(3)
    utils.seed_everything(7)
    assert torch.equal(a, torch.rand(3))


@pytest.mark.parametrize("kind", sorted(flops.supported_trunks()))
def test_flops_equal_jax(kind):
    assert flops.supported_trunks() == jax_flops.supported_trunks()
    for h, w in ((800, 1344), (640, 640), (96, 160)):
        assert flops.detector_flops(h, w, 90, kind) == jax_flops.detector_flops(h, w, 90, kind)
        assert flops.resnet_trunk_flops(h, w, kind) == jax_flops.resnet_trunk_flops(h, w, kind)
        assert flops.fpn_flops(h, w) == jax_flops.fpn_flops(h, w)
        assert flops.head_flops(h, w, 4) == jax_flops.head_flops(h, w, 4)
    assert flops.resnet50_flops(800, 1344) == jax_flops.resnet50_flops(800, 1344)


def test_peak_bf16_tflops(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.peak_bf16_tflops() == 989.0
    monkeypatch.setenv("PEAK_TFLOPS", "123.5")
    assert flops.peak_bf16_tflops() == 123.5
    monkeypatch.delenv("PEAK_TFLOPS")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Other Card")
    with pytest.raises(ValueError, match="PEAK_TFLOPS"):
        flops.peak_bf16_tflops()


# ---------------------------------------------------------------------------- #
# Retinanet's torch interop and the weights lookup
# ---------------------------------------------------------------------------- #
def test_torch_state_dict_round_trip(state_dict, tmp_path):
    src = Retinanet(device="cpu", **MODEL)
    src.load_state_dict(state_dict)
    exported = src.to_torch_state_dict()
    assert all(v.device.type == "cpu" for v in exported.values())
    dst = Retinanet(device="cpu", seed=9, **MODEL)
    dst.load_torch_state_dict({**exported, "anchor_generator.cell_anchors.0": torch.zeros(9, 4)})
    for k, v in dst.state_dict().items():
        assert torch.equal(v, exported[k]), k
    path = tmp_path / "detector.pth"
    src.save_torch_state_dict(str(path))
    dst = Retinanet(device="cpu", seed=9, **MODEL)
    dst.load_torch_state_dict(str(path))
    for k, v in dst.state_dict().items():
        assert torch.equal(v, exported[k]), k
    with torch.no_grad():
        x = torch.from_numpy(_images())
        for a, b in zip(dst.apply(None, x), src.module(x)):
            assert torch.equal(a, b)
        for a, b in zip(src.apply(dst.state_dict(), x), src.module(x)):
            assert torch.equal(a, b)


def test_load_torch_backbone_equals_jax(state_dict, tmp_path):
    trunk = {k[len("backbone.backbone."):]: torch.from_numpy(np.array(v))
             for k, v in state_dict.items() if k.startswith("backbone.backbone.")}
    path = tmp_path / "resnet18.pth"
    torch.save({**trunk, "fc.weight": torch.zeros(10, 512), "fc.bias": torch.zeros(10)}, path)
    port = Retinanet(device="cpu", **MODEL)
    port.load_torch_backbone(str(path))
    jnet = JaxRetinanet(**MODEL)
    jnet.load_torch_backbone(str(path))
    want = flax_retinanet_to_torch(jnet.variables, KIND)
    got = port.state_dict()
    for k, v in want.items():
        if k.startswith("backbone.backbone.") and "num_batches" not in k:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
            np.testing.assert_array_equal(got[k].numpy(), trunk[k[18:]].numpy(), err_msg=k)


def test_weights_lookup_order(tmp_path, monkeypatch):
    monkeypatch.setenv("RETINANET_TPU_WEIGHTS_DIR", str(tmp_path))
    explicit = tmp_path / "mine.pth"
    explicit.write_bytes(b"")
    assert zoo.fetch_backbone_weights(KIND, str(explicit)) == str(explicit)
    with pytest.warns(UserWarning, match="random init"):
        assert zoo.fetch_backbone_weights(KIND, str(tmp_path / "absent.pth")) is None
    cached = tmp_path / "resnet18-5c106cde.pth"
    cached.write_bytes(b"")
    assert zoo.fetch_backbone_weights(KIND, str(tmp_path / "absent.pth")) == str(cached)
    assert zoo.fetch_backbone_weights(KIND) == str(cached)

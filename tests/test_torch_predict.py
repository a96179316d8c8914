"""``Retinanet.predict`` of the PyTorch port vs the JAX package (CPU), and the
port's import and device rules.

The JAX ``Retinanet`` and the port's run with the same weights (random BN
statistics too), carried across with the JAX package's reference-schema
loader and the port's ``load_state_dict`` of JAX variables. The config is
small (resnet18, 4 classes, min 64 / max 96, f32, prior 0.5 so there are
detections) and the images are f32 at their bucket's size, so both resizes
are the identity and every level takes JAX's exact ``top_k``.

Tolerances: labels and detection counts exactly equal; scores within 1e-5
and boxes within 1e-3 px, since the f32 convs sum in another order on the
two sides (logits agree to ~3e-6 relative, test_torch_model.py).
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.models.retinanet import Retinanet as JaxRetinanet
from pytorch_retinanet_tpu.models.retinanet import resize_for_bucket as jax_resize
from pytorch_retinanet_tpu_torch.models import Retinanet, resize_for_bucket, resize_to_bucket

KW = dict(num_classes=4, backbone_kind="resnet18", pretrained=False, min_size=64,
          max_size=96, compute_dtype="float32", prior=0.5)


def test_predict_matches_jax():
    port = Retinanet(device="cpu", seed=0, **KW)
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in port.state_dict().items():
        v = v.numpy().copy()
        if v.ndim == 1 and k.endswith((".weight", "running_var")):  # BN scale and var
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("running_mean"):
            v = rng.normal(0, 0.05, v.shape).astype(np.float32)
        sd[k] = v
    ref = JaxRetinanet(seed=0, **KW)
    ref.load_state_dict(sd)  # reference schema -> JAX variables
    port.load_state_dict(ref.state_dict())  # JAX variables -> the port

    images = [rng.random((64, 96, 3), dtype=np.float32) for _ in range(2)]
    images.append(rng.random((96, 64, 3), dtype=np.float32))  # portrait bucket
    got, want = port.predict(images), ref.predict(images)
    for g, w in zip(got, want):
        assert set(g) == {"boxes", "scores", "labels"}
        assert len(g["labels"]) == len(w["labels"]) > 0
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("hw", [(50, 70), (120, 80), (64, 96)])
def test_device_resize_matches_jax_resize(hw):
    """Bilinear, half-pixel centres, no antialias, as cv2.INTER_LINEAR.
    Tolerance 1e-5 on [0, 1] pixels: both interpolate in f32."""
    image = np.random.default_rng(1).random((*hw, 3), dtype=np.float32)
    want, want_hw, want_orig, want_pad = jax_resize(image, 64, 96)
    got, got_hw, got_orig, got_pad = resize_for_bucket(torch.from_numpy(image), 64, 96)
    assert (got_hw, got_orig, got_pad) == (want_hw, want_orig, want_pad)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    padded, new_hw, _ = resize_to_bucket(torch.from_numpy(image), 64, 96)
    assert padded.shape[:2] == got_pad and new_hw == got_hw
    assert not padded[got_hw[0]:].any() and not padded[:, got_hw[1]:].any()


def test_uint8_images_resize_like_scaled_floats():
    raw = np.random.default_rng(2).integers(0, 256, (50, 70, 3), dtype=np.uint8)
    a, *_ = resize_for_bucket(torch.from_numpy(raw), 64, 96)
    b, *_ = resize_for_bucket(torch.from_numpy(raw.astype(np.float32) / 255.0), 64, 96)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_retinanet_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Retinanet(pretrained=False)


def test_pretrained_without_local_file_warns_and_keeps_random_init():
    with pytest.warns(UserWarning, match="random init"):
        net = Retinanet(device="cpu", **{**KW, "pretrained": True})
    assert net.module.backbone.backbone.conv1.weight.abs().sum() > 0


def test_pretrained_loads_a_local_torchvision_checkpoint(tmp_path):
    donor = Retinanet(device="cpu", seed=3, **KW).module.backbone.backbone.state_dict()
    path = tmp_path / "resnet18.pth"
    torch.save({**donor, "fc.weight": torch.zeros(10, 512), "fc.bias": torch.zeros(10)}, path)
    net = Retinanet(device="cpu", seed=0, **{**KW, "pretrained": True}, pretrained_path=str(path))
    for k, v in net.module.backbone.backbone.state_dict().items():
        torch.testing.assert_close(v, donor[k], rtol=0, atol=0)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pytorch_retinanet_tpu_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax')"
        " or m == 'pytorch_retinanet_tpu' or m.startswith('pytorch_retinanet_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

"""``Retinanet.predict`` of the PyTorch port vs the JAX package (CPU), and the
port's import and device rules.

The JAX ``Retinanet`` and the port's run with the same weights (random BN
statistics too), carried across with the JAX package's reference-schema
loader and the port's ``load_state_dict`` of JAX variables. The config is
small (resnet18, 4 classes, min 64 / max 96, f32, prior 0.5 so there are
detections). ``test_predict_matches_jax`` feeds f32 images at their
bucket's size, so both resizes are the identity; the uint8 tests resize
with cv2 on the JAX side and with the port's integer emulation of it.

Tolerances: labels and detection counts exactly equal; scores within 1e-5
and boxes within 1e-3 px, since the f32 convs sum in another order on the
two sides (logits agree to ~3e-6 relative, test_torch_model.py).
"""

from __future__ import annotations

import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.models.retinanet import Retinanet as JaxRetinanet
from pytorch_retinanet_tpu.models.retinanet import resize_for_bucket as jax_resize
from pytorch_retinanet_tpu_torch.models import Retinanet, resize_for_bucket, resize_to_bucket

KW = dict(num_classes=4, backbone_kind="resnet18", pretrained=False, min_size=64,
          max_size=96, compute_dtype="float32", prior=0.5)


def _twin_detectors():
    """The port's and JAX's detectors with the same weights (random BN
    statistics too), and the generator that drew the weights."""
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
    return port, ref, rng


def test_predict_matches_jax():
    port, ref, rng = _twin_detectors()

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
    """A uint8 image resizes to cv2's uint8 values exactly, and those stay
    within 1/255 of the float bilinear resize of the same image scaled to
    [0, 1] (cv2 rounds its fixed-point sum to an integer; the float path
    does not round)."""
    raw = np.random.default_rng(2).integers(0, 256, (50, 70, 3), dtype=np.uint8)
    a, new_hw, *_ = resize_for_bucket(torch.from_numpy(raw), 64, 96, wire_dtype=torch.uint8)
    assert a.dtype == torch.uint8
    np.testing.assert_array_equal(a.numpy(), cv2.resize(raw, new_hw[::-1], interpolation=cv2.INTER_LINEAR))
    b, *_ = resize_for_bucket(torch.from_numpy(raw.astype(np.float32) / 255.0), 64, 96)
    torch.testing.assert_close(a.float() / 255.0, b, rtol=0, atol=1.0 / 255.0)


# (image h, w, min_size, max_size): upscale, downscale, exact 2x down,
# portrait, a shape cv2 and the float path round to the same size, identity.
UINT8_RESIZES = [
    (50, 70, 64, 96),        # -> (64, 90)
    (480, 640, 800, 1333),   # -> (800, 1067)
    (427, 640, 800, 1333),   # -> (800, 1199)
    (600, 400, 800, 1333),   # -> (1200, 800), portrait
    (1000, 1500, 800, 1333),  # -> (800, 1200)
    (1600, 2666, 800, 1333),  # -> (800, 1333), exactly 2x down
    (37, 53, 19, 27),        # -> (19, 27)
    (64, 96, 64, 96),        # identity
]


@pytest.mark.parametrize("wire", ["uint8", "float32"])
@pytest.mark.parametrize("h,w,min_size,max_size", UINT8_RESIZES)
def test_uint8_resize_equals_jax_resize_bit_for_bit(h, w, min_size, max_size, wire):
    """The port's integer emulation of cv2's fixed-point INTER_LINEAR
    against JAX's ``resize_for_bucket`` (cv2 itself): the same uint8 values,
    and with the f32 wire the same uint8 values / 255."""
    raw = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want, want_hw, want_orig, want_pad = jax_resize(raw, min_size, max_size, wire_dtype=np.dtype(wire))
    got, got_hw, got_orig, got_pad = resize_for_bucket(
        torch.from_numpy(raw), min_size, max_size, wire_dtype=getattr(torch, wire))
    assert (got_hw, got_orig, got_pad) == (want_hw, want_orig, want_pad)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    padded, new_hw, _ = resize_to_bucket(torch.from_numpy(raw), min_size, max_size,
                                         wire_dtype=getattr(torch, wire))
    assert padded.dtype == got.dtype and padded.shape[:2] == got_pad and new_hw == got_hw
    assert torch.equal(padded[: got_hw[0], : got_hw[1]], got) and not padded[got_hw[0]:].any()


@pytest.mark.parametrize("hw", [(50, 70), (120, 80)])
def test_float_images_on_the_uint8_wire_match_jax(hw):
    """Float in [0, 1] resized, then * 255, clipped and truncated to uint8:
    the two float resizes agree within 1e-5, so a value lands on the other
    side of an integer only by that much, at most 1 apart."""
    image = np.random.default_rng(3).random((*hw, 3), dtype=np.float32)
    want, *_ = jax_resize(image, 64, 96, wire_dtype=np.uint8)
    got, *_ = resize_for_bucket(torch.from_numpy(image), 64, 96, wire_dtype=torch.uint8)
    assert got.dtype == torch.uint8
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def test_resize_rejects_other_wire_dtypes():
    with pytest.raises(ValueError, match="wire_dtype"):
        resize_for_bucket(torch.zeros((8, 8, 3)), 8, 8, wire_dtype=torch.float16)


def test_predict_on_uint8_images_that_need_a_resize_matches_jax():
    """uint8 images that the bucket rule resizes, landscape and portrait.
    JAX resizes with cv2 and runs an f32 batch of the uint8 values / 255;
    the port resizes to the same uint8 values on its device and runs a uint8
    batch with /255 folded into the normalize constants (mean * 255, std *
    255), so the normalized inputs differ by the f32 rounding of the two
    divisions. Tolerances as in ``test_predict_matches_jax``."""
    port, ref, _ = _twin_detectors()
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (50, 70, 3), dtype=np.uint8) for _ in range(2)]
    images.append(rng.integers(0, 256, (120, 80, 3), dtype=np.uint8))  # portrait bucket
    got, want = port.predict(images), ref.predict(images)
    for g, w in zip(got, want):
        assert len(g["labels"]) == len(w["labels"]) > 0
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)


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


def test_no_module_of_the_port_nor_its_card_tests_imports_jax():
    """Every import statement in the port's sources, its examples and tools
    (``examples/torch_*.py``, ``tools/torch_*.py``) and its card tests
    (``tests/test_torch_cuda.py``, ``tests/test_torch_card_*.py`` and their
    ``tests/torch_card.py``, which run on a card without jax) names neither
    jax / flax nor the JAX package (its jax-free modules included: the port
    keeps its own copies)."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    files = (sorted((root / "pytorch_retinanet_tpu_torch").rglob("*.py"))
             + sorted((root / "examples").glob("torch_*.py"))
             + sorted((root / "tools").glob("torch_*.py"))
             + [root / "tests" / "test_torch_cuda.py", root / "tests" / "torch_card.py"]
             + sorted((root / "tests").glob("test_torch_card_*.py")))
    assert len(files) > 54
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "optax", "pytorch_retinanet_tpu"):
                    bad.append(f"{path.relative_to(root)}:{node.lineno} {name}")
    assert not bad, bad

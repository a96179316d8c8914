"""The port's serving export (``export.py``) and the two custom ops it
records, against eager inference and the JAX package's export (CPU).

The config is small: resnet18, 4 classes, min 64 / max 96, batch 2, prior
0.5 so that there are detections. Tolerances:

* ``torch.library.opcheck`` on both ops (schema, fake implementation,
  autograd registration, AOT dispatch), as it checks them.
* The stem op's gradient through ``register_autograd`` equals autograd
  through ``stem_plain`` exactly: the backward recomputes the same plain
  arithmetic.
* The port's artifact equals eager ``Retinanet._predict_impl`` bit for bit
  (the same ops in the same order), in bf16 with the stem op on the CPU.
  That test runs in a subprocess: bf16 CPU convolutions of this PyTorch
  build go non-finite from the second bf16 model built in a process.
* The port's artifact against the JAX package's artifact, f32, same
  weights and images: labels and valid exactly, scores within 1e-5, boxes
  within 1e-3 px (the f32 convs sum in another order on the two sides, as
  in ``tests/test_torch_predict.py``).
* The uint8 artifact against the f32 artifact fed bytes / 255: valid
  exactly, boxes within 0.1 px, scores within 1e-3, the tolerances of
  ``tests/test_export.py::TestUint8Export`` (the /255 folded into the
  normalize constants rounds differently).
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.export import export_inference as jax_export_inference
from pytorch_retinanet_tpu.export import load_exported as jax_load_exported
from pytorch_retinanet_tpu.models.retinanet import Retinanet as JaxRetinanet
from pytorch_retinanet_tpu_torch.export import (
    artifact_meta,
    export_inference,
    load_exported,
    save_exported,
)
from pytorch_retinanet_tpu_torch.kernels import (
    nms_keep_mask,
    nms_keep_mask_plain,
    stem_forward,
    stem_plain,
)
from pytorch_retinanet_tpu_torch.models import Retinanet

ROOT = Path(__file__).resolve().parents[1]
KW = dict(num_classes=4, backbone_kind="resnet18", pretrained=False, min_size=64,
          max_size=96, compute_dtype="float32", prior=0.5)
BUCKET = (64, 96)
SIZES = np.array([[64, 96], [60, 90]], np.float32)
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def _stem_args(dtype):
    g = torch.Generator().manual_seed(0)
    w = torch.randn((64, 3, 7, 7), generator=g) * 0.05
    scale, bias = torch.rand(64, generator=g) + 0.5, torch.randn(64, generator=g) * 0.1
    if dtype == torch.uint8:
        x = torch.randint(0, 256, (2, 32, 40, 3), generator=g, dtype=torch.uint8)
        return x, [m * 255 for m in MEAN], [s * 255 for s in STD], w, scale, bias
    return torch.rand((2, 32, 40, 3), generator=g), MEAN, STD, w, scale, bias


def _nms_args():
    g = torch.Generator().manual_seed(1)
    xy = torch.rand((2, 60, 2), generator=g) * 50
    boxes = torch.cat([xy, xy + 5 + torch.rand((2, 60, 2), generator=g) * 20], dim=-1)
    return boxes, torch.rand((2, 60), generator=g) > 0.2, 0.5


@pytest.mark.parametrize("case", ["stem_f32", "stem_uint8", "nms"])
def test_custom_ops_pass_opcheck(case):
    if case == "nms":
        op, args = torch.ops.retinanet_torch.nms_keep_mask.default, _nms_args()
    else:
        dtype = torch.uint8 if case == "stem_uint8" else torch.float32
        op, args = torch.ops.retinanet_torch.stem_forward.default, _stem_args(dtype)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_ops_compute_the_plain_versions_on_the_cpu():
    stem_before, nms_before = stem_forward.launches, nms_keep_mask.launches
    for dtype in (torch.float32, torch.uint8):
        args = _stem_args(dtype)
        assert torch.equal(stem_forward(*args), stem_plain(*args))
    boxes, valid, thr = _nms_args()
    assert torch.equal(nms_keep_mask(boxes, valid, thr), nms_keep_mask_plain(boxes, valid, thr))
    assert (stem_forward.launches, nms_keep_mask.launches) == (stem_before, nms_before)


def test_stem_op_gradient_equals_autograd_through_plain():
    x, mean, std, w, scale, bias = _stem_args(torch.float32)
    grad = torch.randn((2, 8, 10, 64), generator=torch.Generator().manual_seed(2))
    leaves = [t.clone().requires_grad_() for t in (x, w, scale, bias)]
    got = torch.autograd.grad(stem_forward(leaves[0], mean, std, *leaves[1:]).float(), leaves,
                              grad)
    leaves = [t.clone().requires_grad_() for t in (x, w, scale, bias)]
    want = torch.autograd.grad(stem_plain(leaves[0], mean, std, *leaves[1:]).float(), leaves,
                               grad)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    # Only the weight asks for a gradient: the others get none.
    w_only = w.clone().requires_grad_()
    (gw,) = torch.autograd.grad(stem_forward(x, mean, std, w_only, scale, bias).float(), w_only,
                                grad)
    assert torch.equal(gw, want[1])


BF16_SCRIPT = r"""
import json, sys
import numpy as np, torch
from pytorch_retinanet_tpu_torch.export import export_inference, load_exported
from pytorch_retinanet_tpu_torch.models import Retinanet

wire = sys.argv[1]
net = Retinanet(device="cpu", seed=0, num_classes=4, backbone_kind="resnet18",
                pretrained=False, min_size=64, max_size=96, prior=0.5)
assert net.module.dtype == torch.bfloat16
infer = load_exported(export_inference(net, 2, wire_dtype=wire))
targets = {str(n.target) for n in infer.program.graph.nodes if n.op == "call_function"}
rng = np.random.default_rng(0)
images = rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
if wire == "float32":
    images = images.astype(np.float32) / 255.0
sizes = np.array([[64, 96], [60, 90]], np.float32)
got = infer(images, sizes)
want = net._predict_impl(torch.from_numpy(images), torch.from_numpy(sizes))
print(json.dumps({
    "ops": sorted(t for t in targets if "retinanet_torch" in t),
    "equal": {k: bool(np.array_equal(got[k], v.numpy()))
              for k, v in zip(("boxes", "scores", "labels", "valid"), want)},
    "finite": bool(np.isfinite(got["boxes"]).all() and np.isfinite(got["scores"]).all()),
    "valid": int(got["valid"].sum()),
}))
"""


@pytest.mark.parametrize("wire", ["uint8", "float32"])
def test_bf16_artifact_equals_eager_bit_for_bit(wire):
    out = subprocess.run([sys.executable, "-c", BF16_SCRIPT, wire], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ops"] == ["retinanet_torch.nms_keep_mask.default",
                          "retinanet_torch.stem_forward.default"]
    assert res["equal"] == {"boxes": True, "scores": True, "labels": True, "valid": True}
    assert res["finite"] and res["valid"] > 0


@pytest.fixture(scope="module")
def twins():
    """The port's and JAX's f32 detectors with the same weights (random BN
    statistics too), as ``tests/test_torch_predict.py`` carries them."""
    port = Retinanet(device="cpu", seed=0, **KW)
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in port.state_dict().items():
        v = v.numpy().copy()
        if v.ndim == 1 and k.endswith((".weight", "running_var")):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("running_mean"):
            v = rng.normal(0, 0.05, v.shape).astype(np.float32)
        sd[k] = v
    ref = JaxRetinanet(seed=0, **KW)
    ref.load_state_dict(sd)
    port.load_state_dict(ref.state_dict())
    return port, ref


@pytest.fixture(scope="module")
def blobs(twins):
    port, _ = twins
    return {wire: export_inference(port, 2, wire_dtype=wire) for wire in ("float32", "uint8")}


def _images(seed=0):
    u8 = np.random.default_rng(seed).integers(0, 256, (2, *BUCKET, 3), dtype=np.uint8)
    return u8, u8.astype(np.float32) / 255.0


def test_f32_artifact_matches_the_jax_artifact(twins, blobs):
    _, ref = twins
    _, images = _images()
    got = load_exported(blobs["float32"])(images, SIZES)
    want = jax_load_exported(jax_export_inference(ref, batch_size=2, bucket=BUCKET))(images, SIZES)
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)


def test_f32_artifact_equals_eager(twins, blobs):
    port, _ = twins
    _, images = _images(1)
    got = load_exported(blobs["float32"])(images, SIZES)
    want = port._predict_impl(torch.from_numpy(images), torch.from_numpy(SIZES))
    for k, v in zip(("boxes", "scores", "labels", "valid"), want):
        np.testing.assert_array_equal(got[k], v.numpy())


def test_uint8_artifact_matches_the_f32_artifact(blobs):
    infer8, infer32 = load_exported(blobs["uint8"]), load_exported(blobs["float32"])
    assert infer8.in_shapes[0].dtype == torch.uint8 and infer8.meta["wire_dtype"] == "uint8"
    u8, f32 = _images(2)
    out8, out32 = infer8(u8, SIZES), infer32(f32, SIZES)
    np.testing.assert_array_equal(out8["valid"], out32["valid"])
    for row in range(2):
        n = int(out8["valid"][row].sum())
        assert n > 0
        np.testing.assert_allclose(out8["boxes"][row, :n], out32["boxes"][row, :n], atol=0.1)
        np.testing.assert_allclose(out8["scores"][row, :n], out32["scores"][row, :n], atol=1e-3)


def test_saved_artifact_and_sidecar_round_trip(twins, tmp_path):
    port, _ = twins
    path = save_exported(port, str(tmp_path / "m" / "r18_96x64_b1.pt2"), 1, (96, 64), "uint8")
    sidecar = json.loads(Path(path + ".json").read_text())
    assert sidecar == {"min_size": 64, "max_size": 96, "batch_size": 1, "num_classes": 4,
                       "backbone": "resnet18", "score_thres": port.score_thres,
                       "nms_thres": port.nms_thres, "wire_dtype": "uint8", "device": "cpu"}
    infer = load_exported(path)
    assert infer.meta == sidecar == artifact_meta(Path(path).read_bytes())
    assert infer.in_shapes == ((( 1, 96, 64, 3), torch.uint8), ((1, 2), torch.float32))
    assert infer.device == torch.device("cpu")
    image = np.random.default_rng(3).integers(0, 256, (1, 96, 64, 3), dtype=np.uint8)
    sizes = np.array([[96, 60]], np.float32)
    out = infer(image, sizes)
    want = port._predict_impl(torch.from_numpy(image), torch.from_numpy(sizes))
    assert {k: v.shape for k, v in out.items()} == {
        "boxes": (1, 100, 4), "scores": (1, 100), "labels": (1, 100), "valid": (1, 100)}
    for k, v in zip(("boxes", "scores", "labels", "valid"), want):
        np.testing.assert_array_equal(out[k], v.numpy())


def test_default_bucket_is_the_landscape_one(blobs):
    infer = load_exported(blobs["float32"])
    assert infer.in_shapes[0].shape == (2, 64, 96, 3)
    assert infer.in_shapes[1].shape == (2, 2)


def test_dispatch_returns_what_infer_returns(blobs):
    infer = load_exported(blobs["uint8"])
    u8, _ = _images(4)
    dev = infer.dispatch(torch.from_numpy(u8), torch.from_numpy(SIZES))
    assert len(dev) == 4 and all(isinstance(t, torch.Tensor) for t in dev)
    host = infer(u8, SIZES)
    for k, t in zip(("boxes", "scores", "labels", "valid"), dev):
        np.testing.assert_array_equal(t.numpy(), host[k])


FRESH_SCRIPT = r"""
import json, sys
import numpy as np
from pytorch_retinanet_tpu_torch.export import load_exported

infer = load_exported(sys.argv[1])
out = infer(np.load(sys.argv[2]), np.array([[64, 96], [60, 90]], np.float32))
np.savez(sys.argv[3], **out)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
       or m == "pytorch_retinanet_tpu" or m.startswith("pytorch_retinanet_tpu.")]
print(json.dumps(bad))
"""


def test_a_fresh_process_loads_the_artifact_without_jax(blobs, tmp_path):
    art, imgs, res = tmp_path / "a.pt2", tmp_path / "x.npy", tmp_path / "out.npz"
    art.write_bytes(blobs["uint8"])
    u8, _ = _images(5)
    np.save(imgs, u8)
    out = subprocess.run([sys.executable, "-c", FRESH_SCRIPT, str(art), str(imgs), str(res)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    got, want = np.load(res), load_exported(blobs["uint8"])(u8, SIZES)
    for k in ("boxes", "scores", "labels", "valid"):
        np.testing.assert_array_equal(got[k], want[k])


def test_a_cuda_artifact_is_refused_without_cuda(blobs, monkeypatch):
    """The device check reads the artifact's own facts before its program loads."""
    src, dst = io.BytesIO(blobs["uint8"]), io.BytesIO()
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item)
            if item.filename.endswith("retinanet_meta.json"):
                data = json.dumps({**json.loads(data), "device": "cuda"}).encode()
            zout.writestr(item, data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported for CUDA"):
        load_exported(dst.getvalue())


def test_export_checks_its_arguments(twins):
    port, _ = twins
    with pytest.raises(ValueError, match="wire_dtype"):
        export_inference(port, 1, wire_dtype="float16")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("other/data.bin", b"0")
    with pytest.raises(ValueError, match="not an artifact"):
        artifact_meta(buf.getvalue())

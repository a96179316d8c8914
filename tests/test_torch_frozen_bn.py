"""Frozen batch norm under autograd (``kernels/frozen_bn.py``) on the CPU.

On the CPU the autograd Function computes its plain version, whose
operations the CUDA kernels repeat (``tests/test_torch_cuda.py`` holds them
to it on the card, at R-50's 53 BNs too). Held here against autograd through ``F.batch_norm``
(+``torch.relu``), the path frozen BN took before and still takes without
autograd, and against ``gradcheck`` in f64.

Tolerances against ``F.batch_norm``, whose CPU eval form is ``x * alpha +
beta`` with ``alpha = weight / sqrt(var + eps)`` and ``beta = bias - mean *
alpha`` where the Function computes ``(x - mean) * scale + bias``:

- f32: y and dx within 1e-5 of their scale (the two forms round a few f32
  ulp apart at values of order 1);
- bf16: y and dx within 1 bf16 ulp of the larger value (the f32 values that
  the two forms round into bf16 sit a few f32 ulp apart, and may straddle a
  bf16 rounding boundary);
- dweight and dbias within 1e-5 of the sum of their terms' magnitudes (the
  two sum in other orders).

Inputs keep every pre-activation at least 0.01 from 0, so that the ReLU's
mask is the same for both forms.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_retinanet_tpu_torch import KERNELS
from pytorch_retinanet_tpu_torch.kernels import frozen_batch_norm
from pytorch_retinanet_tpu_torch.models.backbone import ResNet
from pytorch_retinanet_tpu_torch.models.layers import BatchNorm2d
from pytorch_retinanet_tpu_torch.models.retinanet import Retinanet
from pytorch_retinanet_tpu_torch.utils import metrics

fb = importlib.import_module("pytorch_retinanet_tpu_torch.kernels.frozen_bn")

EPS = 1e-5
BN_COUNTS = {"resnet18": 20, "resnet50": 53, "resnet101": 104}


def _case(n, c, h, w, dtype, channels_last, seed=0):
    """x (in `dtype` and layout), dy, and [C] weight, bias, mean, var, with
    every pre-activation at least 0.01 from 0."""
    g = torch.Generator().manual_seed(seed)
    weight = 0.5 + torch.rand(c, generator=g)
    bias = 0.3 * torch.randn(c, generator=g)
    mean = 0.3 * torch.randn(c, generator=g)
    var = 0.2 + torch.rand(c, generator=g)
    x = torch.randn(n, c, h, w, generator=g, dtype=torch.float64)
    scale = (weight / torch.sqrt(var + EPS)).double()[None, :, None, None]
    pre = (x - mean.double()[None, :, None, None]) * scale + bias.double()[None, :, None, None]
    x = torch.where(pre.abs() < 0.01, x + 0.05 / scale, x).to(dtype)
    dy = torch.randn(n, c, h, w, generator=g).to(dtype)
    if channels_last:
        x, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
    return x, dy, (weight, bias, mean, var)


def _grads(fn, x, dy, weight, bias):
    xr, wr, br = (t.clone().requires_grad_() for t in (x, weight, bias))
    y = fn(xr, wr, br)
    y.backward(dy)
    return y.detach(), xr.grad, wr.grad, br.grad


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _assert_near(got, want, dtype, what):
    a, b = got.float(), want.float()
    if dtype == torch.bfloat16:
        bad = (a - b).abs() > _bf16_ulp(torch.maximum(a.abs(), b.abs()))
    else:
        bad = (a - b).abs() > 1e-5 * max(float(b.abs().max()), 1.0)
    assert not bool(bad.any()), f"{what}: {int(bad.sum())} of {bad.numel()} outside"


@pytest.mark.parametrize("c", [3, 64, 1024])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("channels_last", [True, False], ids=["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_and_gradients_match_batch_norm(dtype, channels_last, relu, c):
    x, dy, (weight, bias, mean, var) = _case(2, c, 5, 6, dtype, channels_last, seed=c)

    def reference(xr, wr, br):
        y = F.batch_norm(xr, mean, var, wr, br, False, 0.0, EPS)
        return torch.relu(y) if relu else y

    def function(xr, wr, br):
        return frozen_batch_norm(xr, wr, br, mean, var, EPS, relu)

    y, dx, dw, db = _grads(function, x, dy, weight, bias)
    y_ref, dx_ref, dw_ref, db_ref = _grads(reference, x, dy, weight, bias)
    assert y.dtype == dx.dtype == dtype and y.stride() == dx.stride() == x.stride()
    assert dw.dtype == db.dtype == torch.float32
    _assert_near(y, y_ref, dtype, "y")
    _assert_near(dx, dx_ref, dtype, "dx")
    g = dy.float()
    if relu:
        g = torch.where(y_ref <= 0, torch.zeros(()), g)
    xmu = (x.float() - mean[None, :, None, None]).abs()
    limit_w = 1e-5 * (g.abs() * xmu).sum((0, 2, 3)) / torch.sqrt(var + EPS) + 1e-12
    limit_b = 1e-5 * g.abs().sum((0, 2, 3)) + 1e-12
    assert bool(((dw - dw_ref).abs() <= limit_w).all()), (dw - dw_ref).abs().max()
    assert bool(((db - db_ref).abs() <= limit_b).all()), (db - db_ref).abs().max()


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("channels_last", [True, False], ids=["channels_last", "nchw"])
def test_gradcheck_in_f64(channels_last, relu):
    x, _, params = _case(2, 3, 4, 5, torch.float64, channels_last, seed=7)
    weight, bias, mean, var = (p.double() for p in params)
    inputs = (x.requires_grad_(), weight.requires_grad_(), bias.requires_grad_())
    assert torch.autograd.gradcheck(
        lambda xr, wr, br: frozen_batch_norm(xr, wr, br, mean, var, EPS, relu), inputs)


def test_plain_backward_is_autograd_through_the_plain_forward():
    """The plain backward's mask and sums are the gradient of the plain
    forward: f64, where the two agree to rounding."""
    x, dy, params = _case(3, 16, 7, 5, torch.float64, True, seed=3)
    weight, bias, mean, var = (p.double() for p in params)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, weight, bias))
    fb.frozen_bn_plain(xr, wr, br, mean, var, EPS, True).backward(dy)
    dx, dw, db = fb.frozen_bn_backward_plain(dy, x, weight, bias, mean, var, EPS, True)
    for got, want in ((dx, xr.grad), (dw, wr.grad), (db, br.grad)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_a_step_leaves_the_running_statistics_alone(mode):
    bn = BatchNorm2d(8)
    with torch.no_grad():
        bn.running_mean.uniform_(-0.5, 0.5)
        bn.running_var.uniform_(0.5, 1.5)
    bn.train(mode == "train")
    before = {k: b.clone() for k, b in bn.named_buffers()}
    params = {k: p.detach().clone() for k, p in bn.named_parameters()}
    opt = torch.optim.SGD(bn.parameters(), lr=0.1)
    x = torch.randn(2, 8, 5, 5, generator=torch.Generator().manual_seed(1)).requires_grad_()
    bn(x, relu=True).square().sum().backward()
    opt.step()
    for k, b in bn.named_buffers():
        assert torch.equal(b, before[k]), k
    assert int(bn.num_batches_tracked) == 0
    for k, p in bn.named_parameters():
        assert not torch.equal(p.detach(), params[k]), k


@pytest.mark.parametrize("how", ["no_grad", "inference_mode", "nothing_requires_grad"])
def test_without_autograd_the_module_calls_batch_norm(monkeypatch, how):
    calls = {"batch_norm": 0, "function": 0}
    real_bn, real_apply = F.batch_norm, fb._FrozenBatchNorm.apply

    def batch_norm(*a, **k):
        calls["batch_norm"] += 1
        return real_bn(*a, **k)

    def apply(*a, **k):
        calls["function"] += 1
        return real_apply(*a, **k)

    monkeypatch.setattr(F, "batch_norm", batch_norm)
    monkeypatch.setattr(fb._FrozenBatchNorm, "apply", apply)
    bn = BatchNorm2d(4)
    x = torch.randn(2, 4, 3, 3)
    context = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
               "nothing_requires_grad": contextlib.nullcontext}[how]
    if how == "nothing_requires_grad":
        bn.requires_grad_(False)
    launches = frozen_batch_norm.launches
    metrics.drain()
    with metrics.tracing(), context():
        want = torch.relu(real_bn(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                  False, 0.0, bn.eps))
        y = bn(x, relu=True)
    assert torch.equal(y, want)
    assert calls == {"batch_norm": 1, "function": 0}
    assert frozen_batch_norm.launches == launches
    assert metrics.drain()["counters"].get("frozen_bn.backward", 0) == 0


def test_with_autograd_the_module_takes_the_function(monkeypatch):
    calls = []
    real_apply = fb._FrozenBatchNorm.apply

    def apply(*a, **k):
        calls.append(a[-1])  # relu
        return real_apply(*a, **k)

    monkeypatch.setattr(fb._FrozenBatchNorm, "apply", apply)
    monkeypatch.setattr(F, "batch_norm", lambda *a, **k: pytest.fail("F.batch_norm called"))
    bn = BatchNorm2d(4).train()
    x = torch.randn(2, 4, 3, 3, requires_grad=True)
    bn(x, relu=True).sum().backward()
    bn.requires_grad_(False)
    bn(x).sum().backward()  # x alone requires grad
    assert calls == [True, False]


@pytest.mark.parametrize("kind", sorted(BN_COUNTS))
def test_the_counter_counts_each_frozen_bn_once_a_backward(kind):
    trunk = ResNet(kind).train()
    trunk.reset_parameters(torch.Generator().manual_seed(0))
    assert sum(isinstance(m, BatchNorm2d) for m in trunk.modules()) == BN_COUNTS[kind]
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    metrics.drain()
    with metrics.tracing():
        out = trunk(x)
        sum(v.float().sum() for v in out.values()).backward()
        counters = metrics.drain()["counters"]
    assert counters["frozen_bn.backward"] == BN_COUNTS[kind]


def test_the_counter_counts_a_detector_training_step():
    net = Retinanet(backbone_kind="resnet18", num_classes=4, min_size=64, max_size=96,
                    pretrained=False, prior=0.5, device="cpu", compute_dtype="float32")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((2, 64, 96, 3), dtype=np.float32))
    targets = {"boxes": torch.tensor([[[4.0, 6.0, 40.0, 50.0]], [[10.0, 10.0, 60.0, 40.0]]]),
               "labels": torch.tensor([[1], [2]]), "valid": torch.tensor([[True], [True]])}
    metrics.drain()
    with metrics.tracing():
        losses = net.forward(images, targets)
        (losses["classification_loss"] + losses["regression_loss"]).backward()
        counters = metrics.drain()["counters"]
    assert counters["frozen_bn.backward"] == BN_COUNTS["resnet18"]


def test_remat_gives_the_plain_steps_gradients():
    torch.manual_seed(0)
    plain, remat = ResNet("resnet18"), ResNet("resnet18", remat=True)
    plain.reset_parameters(torch.Generator().manual_seed(4))
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(5))
    counts = []
    for net in (plain, remat):
        net.train()
        metrics.drain()
        with metrics.tracing():
            out = net(x)
            sum((v * (i + 1)).sum() for i, v in enumerate(out.values())).backward()
            counts.append(metrics.drain()["counters"]["frozen_bn.backward"])
    assert counts == [BN_COUNTS["resnet18"]] * 2  # the recompute adds forwards, not backwards
    grads = dict(plain.named_parameters())
    for k, p in remat.named_parameters():
        assert torch.equal(p.grad, grads[k].grad), k


def test_kernels_names_the_frozen_bn_pair():
    entry = next(k for k in KERNELS if k.name == "frozen_bn")
    assert entry.wrapper is frozen_batch_norm and entry.route == "cuda"
    assert entry.source == "pytorch_retinanet_tpu_torch/csrc/frozen_bn.cu"
    assert entry.replaces.startswith("none")
    assert isinstance(frozen_batch_norm.launches, int)


@pytest.mark.parametrize("shape,dtype,channels_last,offset,want", [
    ((2, 64, 5, 7), torch.bfloat16, True, 0, 8),  # the main path: 16-byte vectors of channels
    ((2, 64, 5, 7), torch.float32, True, 0, 4),
    ((2, 3, 5, 7), torch.float32, True, 0, 1),  # channels not a vector
    ((2, 64, 4, 6), torch.bfloat16, False, 0, 8),  # NCHW: vectors along a plane
    ((2, 64, 5, 7), torch.bfloat16, False, 0, 1),  # a plane not a vector
    ((2, 64, 5, 7), torch.bfloat16, True, 1, 1),  # storage off 16-byte alignment
    ((1, 4096, 2, 2), torch.bfloat16, True, 0, 8),  # 512 vectors a row, the most
])
def test_launch_arguments(shape, dtype, channels_last, offset, want):
    n, c, h, w = shape
    flat = torch.zeros(n * c * h * w + offset, dtype=dtype)[offset:]
    x = (flat.view(n, h, w, c).permute(0, 3, 1, 2) if channels_last else flat.view(n, c, h, w))
    assert fb._launch_args(x) == (n, c, h * w, channels_last, want)


def test_launch_arguments_refuse_other_layouts_and_too_many_channels():
    with pytest.raises(ValueError, match="channels-last or NCHW"):
        fb._launch_args(torch.zeros(2, 8, 4, 6).transpose(2, 3))
    with pytest.raises(ValueError, match="at most 4096 channels"):
        fb._launch_args(torch.zeros(1, 8192, 1, 2, dtype=torch.bfloat16)
                        .contiguous(memory_format=torch.channels_last))


def test_wrapper_refuses_mismatched_parameters():
    x = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError, match="must be \\[4\\]"):
        frozen_batch_norm(x, torch.ones(3), torch.zeros(4), torch.zeros(4), torch.ones(4), EPS)
    with pytest.raises(ValueError, match="takes \\[N, C, H, W\\]"):
        frozen_batch_norm(x[0], torch.ones(4), torch.zeros(4), torch.zeros(4), torch.ones(4), EPS)

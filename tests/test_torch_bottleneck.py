"""Fused bottleneck of the PyTorch port vs the JAX package (CPU).

``bottleneck_plain`` (what ``fused_bottleneck`` computes for CPU tensors) is
held against ``bottleneck_reference_xla``, the composition the JAX kernel is
documented to fuse, and against that kernel, ``_fused_bottleneck``, run in
interpret mode, on the same numpy inputs.

Tolerances, per output element, with ``ulp(v)`` the bf16 spacing at |v| and
``M`` the largest |output| of the reference:
* against ``bottleneck_reference_xla``, on every row: ``ulp(v) + 2**-7 * M``.
  Both round the output to bf16 once (one ulp), and the reference also
  rounds each conv output to bf16 before its BN; those half-ulp steps of y1,
  y2 and y3 add up, through sums of hundreds of terms, to an error of the
  output's scale that does not shrink with the element (measured at most
  2**-8 * M on these inputs).
* against the Pallas kernel, on rows 1..H-2: ``ulp(v) + 2**-8 * M`` (the
  tolerance of the CUDA kernel against the plain version), and at least 90%
  of the outputs exactly equal. Same rounding points; only the order of the
  f32 sums differs, which now and then flips a bf16 rounding of y1 or y2 and
  moves an output by a term of the output's scale (measured at most
  2**-11 * M beyond one ulp here).
* gradients against ``jax.grad`` through the reference: the L2 norm of the
  difference within 10% of the reference gradient's (measured 2.6-5.4%).
  A ReLU whose input lies within a rounding of zero passes the cotangent on
  one side and not on the other, so single elements can differ by the
  cotangent itself; and JAX runs the backward convs in bf16, the port in f32.

The kernel's weight packing (``pack_bottleneck_weights``, a plain torch
function) is held to its layout exactly: every tile unpacks to its slice of
the GEMM-layout weight, and the tiles lie one after the other at 16-byte
aligned offsets, as the kernel's bulk copies need.

The Pallas kernel's rows 0 and H-1 are wrong: it zero-pads the block's
input rows and runs conv1 over them, so its 3x3 reads relu(b1), not zero,
above the first and below the last row. ``test_pallas_border_rows_deviate``
pins that, so that nobody moves the port toward it. The CUDA kernel itself
is tested on the card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.kernels.bottleneck_pallas import (
    _fused_bottleneck,
    bottleneck_reference_xla,
    fold_bn,
)
from pytorch_retinanet_tpu.kernels.bottleneck_pallas import (
    fused_bottleneck_supported as jax_supported,
)
from pytorch_retinanet_tpu_torch.kernels import (
    bottleneck_args,
    bottleneck_plain,
    bottleneck_weight_tiles,
    fused_bottleneck,
    fused_bottleneck_supported,
    pack_bottleneck_weights,
)
from pytorch_retinanet_tpu_torch.models.backbone import Bottleneck

REF_TOL, KERNEL_TOL, EQUAL_SHARE = 2.0**-7, 2.0**-8, 0.9
SHAPES = [(8, 16, 512, 128), (5, 12, 512, 128), (4, 7, 1024, 256)]
B1_RANGES = [(-0.2, 0.2), (0.5, 1.0)]


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def _case(h, w, c, mid, b1, seed=0, batch=1):
    """x (bf16 values) and the block's HWIO weights and folded BN, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (batch, h, w, c)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))

    def u(lo, hi, n):
        return rng.uniform(lo, hi, n).astype(np.float32)

    return x, [
        rng.normal(0, 0.05, (1, 1, c, mid)).astype(np.float32), u(0.5, 1.5, mid), u(*b1, mid),
        rng.normal(0, 0.05, (3, 3, mid, mid)).astype(np.float32), u(0.5, 1.5, mid), u(-0.2, 0.2, mid),
        rng.normal(0, 0.05, (1, 1, mid, c)).astype(np.float32), u(0.5, 1.5, c), u(-0.2, 0.2, c),
    ]


def _gemm_args(args, c, mid):
    """HWIO weights -> the port's GEMM layout: [C, mid], [9, mid, mid], [mid, C]."""
    t = [torch.from_numpy(a.copy()) for a in args]
    t[0], t[3], t[6] = t[0].reshape(c, mid), t[3].reshape(9, mid, mid), t[6].reshape(mid, c)
    return t


def _port(x, args):
    c, mid = args[0].shape[2:]
    out = bottleneck_plain(torch.from_numpy(x.copy()), *_gemm_args(args, c, mid))
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    return out.float().numpy()


def _reference(x, args):
    return np.asarray(bottleneck_reference_xla(jnp.asarray(x), *map(jnp.asarray, args)), np.float32)


def _pallas(x, args):
    return np.asarray(_fused_bottleneck(jnp.asarray(x), *map(jnp.asarray, args), True), np.float32)


def _excess(got, ref, tol):
    """Per image row, the largest |got - ref| beyond ``ulp + tol * M`` (<= 0 passes)."""
    d = np.abs(got - ref)
    bound = bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + tol * np.abs(ref).max()
    return (d - bound).max(axis=(0, 2, 3))


@pytest.mark.parametrize("b1", B1_RANGES)
@pytest.mark.parametrize("h,w,c,mid", SHAPES)
def test_plain_matches_reference_on_every_row(h, w, c, mid, b1):
    x, args = _case(h, w, c, mid, b1)
    got, ref = _port(x, args), _reference(x, args)
    assert got.shape == ref.shape == x.shape
    excess = _excess(got, ref, REF_TOL)
    assert (excess <= 0).all(), excess


@pytest.mark.parametrize("b1", B1_RANGES)
@pytest.mark.parametrize("h,w,c,mid", SHAPES)
def test_plain_matches_pallas_interior_rows(h, w, c, mid, b1):
    x, args = _case(h, w, c, mid, b1, seed=1)
    got, ker = _port(x, args)[:, 1:-1], _pallas(x, args)[:, 1:-1]
    excess = _excess(got, ker, KERNEL_TOL)
    assert (excess <= 0).all(), excess
    assert (got == ker).mean() >= EQUAL_SHARE


@pytest.mark.parametrize("b1", B1_RANGES)
def test_pallas_border_rows_deviate(b1):
    """Rows 0 and H-1 of the Pallas kernel are off the reference by more than
    the port's tolerance, its other rows are not, and the port's rows are all
    within it. ``pytest -s`` prints the largest difference per row: with b1
    in [-0.2, 0.2] 0.148 and 0.150 at the border against 0.016-0.031 inside
    (largest output 5.6); with b1 in [0.5, 1] 1.29 and 1.32 against 0.031
    (largest 6.9)."""
    x, args = _case(8, 16, 512, 128, b1)
    ref, ker, got = _reference(x, args), _pallas(x, args), _port(x, args)
    print(f"b1 in {b1}: largest |pallas - reference| per row "
          f"{np.abs(ker - ref).max(axis=(0, 2, 3)).round(4)}, largest |reference| "
          f"{np.abs(ref).max():.4g}")
    ker_excess, port_excess = _excess(ker, ref, REF_TOL), _excess(got, ref, REF_TOL)
    assert ker_excess[0] > 0 and ker_excess[-1] > 0
    assert (ker_excess[1:-1] <= 0).all()
    assert (port_excess <= 0).all()
    if b1[0] > 0:
        assert np.abs(ker - ref)[:, [0, -1]].max() > 0.1 * np.abs(ref).max()


def test_plain_gradients_match_jax():
    h, w, c, mid = 4, 6, 512, 128
    x, args = _case(h, w, c, mid, (0.5, 1.0), seed=2)
    cot = np.random.default_rng(3).normal(0, 1, x.shape).astype(np.float32)

    def loss(*a):
        return jnp.sum(bottleneck_reference_xla(*a).astype(jnp.float32) * cot)

    want = jax.grad(loss, argnums=tuple(range(10)))(jnp.asarray(x), *map(jnp.asarray, args))
    inputs = [torch.from_numpy(x.copy())] + _gemm_args(args, c, mid)
    for t in inputs:
        t.requires_grad_(True)
    (bottleneck_plain(*inputs).float() * torch.from_numpy(cot)).sum().backward()
    for i, (t, g) in enumerate(zip(inputs, want)):
        ref = np.asarray(g, np.float32).reshape(t.shape)
        got = t.grad.numpy()
        assert got.shape == ref.shape
        assert np.linalg.norm(got - ref) <= 0.1 * np.linalg.norm(ref), f"gradient of input {i}"


R50_STAGES = [  # (H, W, C, mid) of layers 1-4, landscape and portrait 800x1344 buckets
    (200, 336, 256, 64), (100, 168, 512, 128), (50, 84, 1024, 256), (25, 42, 2048, 512),
    (336, 200, 256, 64), (168, 100, 512, 128), (84, 50, 1024, 256), (42, 25, 2048, 512),
]


@pytest.mark.parametrize("shape,mid", [((32, *s[:3]), s[3]) for s in R50_STAGES] + [
    ((2, 16, 24, 512), 128), ((2, 16, 24, 256), 64), ((2, 16, 24, 512), 256),
    ((2, 16, 24), 128), ((1, 17, 9, 512), 128), ((1, 2, 3, 2048), 512), ((1, 200, 3000, 2048), 512),
    ((1, 8, 8, 640), 160), ((1, 8, 8, 576), 144),
])
def test_supported_equals_jax(shape, mid):
    assert fused_bottleneck_supported(shape, mid) == jax_supported(shape, mid)


def test_supported_takes_the_ten_r50_blocks_of_layers_2_to_4():
    taken = [fused_bottleneck_supported((32, h, w, c), mid) for h, w, c, mid in R50_STAGES]
    assert taken == [False, True, True, True] * 2


def test_wrapper_rejects_bad_shapes_and_a_device_mix():
    x, args = _case(4, 6, 512, 128, (0.5, 1.0))
    t = _gemm_args(args, 512, 128)
    xt = torch.from_numpy(x.copy())
    with pytest.raises(ValueError):
        fused_bottleneck(xt[..., :256], *t)  # C of x is not the weights' C
    with pytest.raises(ValueError):
        fused_bottleneck(xt, t[0], t[1][:64], *t[2:])
    with pytest.raises(ValueError):
        fused_bottleneck(xt, t[0], t[1], t[2], t[3].reshape(3, 3, 128, 128), *t[4:])
    with pytest.raises(ValueError):
        fused_bottleneck(xt[0], *t)
    with pytest.raises(ValueError):  # not every input on the CPU, and not on one CUDA device
        fused_bottleneck(xt.to("meta"), *t)


def test_fused_bottleneck_on_cpu_is_plain_and_differentiable():
    x, args = _case(3, 5, 512, 128, (-0.2, 0.2))
    t = _gemm_args(args, 512, 128)
    t[0].requires_grad_(True)
    out = fused_bottleneck(torch.from_numpy(x.copy()), *t)
    torch.testing.assert_close(out, bottleneck_plain(torch.from_numpy(x.copy()), *t), rtol=0, atol=0)
    out.float().sum().backward()
    assert t[0].grad is not None and torch.isfinite(t[0].grad).all()


def test_bottleneck_args_lay_out_a_port_block():
    """The kernel's arguments from a port ``Bottleneck`` give the JAX
    reference's output on the same block (HWIO weights, ``fold_bn``)."""
    mid, c = 128, 512
    block = Bottleneck(c, mid)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for conv in (block.conv1, block.conv2, block.conv3):
            conv.weight.copy_(torch.from_numpy(rng.normal(0, 0.05, conv.weight.shape).astype(np.float32)))
        for bn in (block.bn1, block.bn2, block.bn3):
            n = bn.weight.shape[0]
            for name, lo, hi in (("weight", 0.5, 1.5), ("bias", 0.5, 1.0), ("running_mean", -0.1, 0.1),
                                 ("running_var", 0.5, 1.5)):
                getattr(bn, name).copy_(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)))
    kargs = bottleneck_args(block)
    assert [tuple(a.shape) for a in kargs[::3]] == [(c, mid), (9, mid, mid), (mid, c)]
    assert all(a.dtype == torch.bfloat16 for a in kargs[::3])

    def bn_vars(bn):
        return ({"BatchNorm_0": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                                 "bias": jnp.asarray(bn.bias.detach().numpy())}},
                {"BatchNorm_0": {"mean": jnp.asarray(bn.running_mean.numpy()),
                                 "var": jnp.asarray(bn.running_var.numpy())}})

    params, stats = {}, {}
    for i, bn in enumerate((block.bn1, block.bn2, block.bn3), start=1):
        params[f"bn{i}"], stats[f"bn{i}"] = bn_vars(bn)
    jargs = []
    for i, conv in enumerate((block.conv1, block.conv2, block.conv3), start=1):
        jargs.append(jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 1, 0)))
        jargs.extend(fold_bn(params, stats, f"bn{i}"))
    x, _ = _case(5, 6, c, mid, (0.5, 1.0), seed=5)
    ref = np.asarray(bottleneck_reference_xla(jnp.asarray(x), *jargs), np.float32)
    with torch.no_grad():
        got = bottleneck_plain(torch.from_numpy(x.copy()), *kargs).float().numpy()
    excess = _excess(got, ref, REF_TOL)
    assert (excess <= 0).all(), excess


def _gemm_weights(mid, seed=0):
    c = 4 * mid
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(torch.bfloat16)
            for shape in ((c, mid), (9, mid, mid), (mid, c))]


@pytest.mark.parametrize("mid", [128, 256, 512])
def test_packed_tiles_unpack_to_the_gemm_weights(mid):
    """Tile (weight, tap, k0, n0, n) is n rows of 64 K values whose 16-byte
    chunk j sits at chunk j ^ (row % 8); undone here with numpy indexing."""
    w1, w2, w3 = _gemm_weights(mid)
    packed = pack_bottleneck_weights(w1, w2, w3).view(torch.int16).numpy()
    sources = {1: w1[None], 2: w2, 3: w3[None]}
    k = np.arange(64)
    offset = 0
    for which, tap, k0, n0, n in bottleneck_weight_tiles(mid):
        rows = packed[offset:offset + 64 * n].reshape(n, 64)
        r = np.arange(n)[:, None]
        logical = rows[r, ((k[None] // 8) ^ (r % 8)) * 8 + k[None] % 8]
        want = sources[which][tap, k0:k0 + 64, n0:n0 + n].t().contiguous().view(torch.int16).numpy()
        assert np.array_equal(logical, want), (which, tap, k0, n0)
        offset += 64 * n


@pytest.mark.parametrize("mid", [128, 256, 512])
def test_packed_tiles_are_contiguous_and_aligned(mid):
    w1, w2, w3 = _gemm_weights(mid, seed=1)
    packed = pack_bottleneck_weights(w1, w2, w3)
    assert packed.dtype == torch.bfloat16 and packed.dim() == 1
    tiles = bottleneck_weight_tiles(mid)
    sizes = [64 * n for *_, n in tiles]
    offsets = np.cumsum([0] + sizes)
    assert offsets[-1] == packed.numel() == 17 * mid * mid  # every weight element once
    assert all(o * 2 % 16 == 0 and s * 2 % 16 == 0 for o, s in zip(offsets, sizes))
    # Each weight is covered exactly once by its tiles.
    counts = {1: torch.zeros(1, 4 * mid, mid), 2: torch.zeros(9, mid, mid), 3: torch.zeros(1, mid, 4 * mid)}
    for which, tap, k0, n0, n in tiles:
        counts[which][tap, k0:k0 + 64, n0:n0 + n] += 1
    assert all(bool((t == 1).all()) for t in counts.values())

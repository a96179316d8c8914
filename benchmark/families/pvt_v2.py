"""The PVT v2 trunk family: PVTv2-B2 (Wang et al., arXiv:2106.13797;
whai362/PVT ``classification/pvt_v2.py``, ``pvt_v2_b2``), returning C3 /
C4 / C5, the ends of stages 2-4. The contract is ``resnet_fpn.py``'s.

Embed dims (64, 128, 320, 512), depths (3, 4, 6, 3), heads (1, 2, 5, 8)
of 64 channels, spatial-reduction ratios (8, 4, 2, 1), MLP ratios (8, 8,
4, 4). A stage embeds its input by an overlapping conv (7x7 stride 4 pad
3, then 3x3 stride 2 pad 1) and a LayerNorm (eps 1e-5), runs its blocks
and ends in a LayerNorm (eps 1e-6). A block:

- ``x + proj(softmax(q k^T / 8) v)`` on ``LN(x)`` (eps 1e-6): q from
  every token; k and v from the tokens after a ``sr x sr`` stride-``sr``
  conv and a LayerNorm (eps 1e-5), from every token where ``sr`` is 1;
- ``x + fc2(GELU(dwconv3x3(fc1(LN(x)))))`` (eps 1e-6, exact GELU).

Plain f32, written out: each linear as a 1x1 conv through
``reference.conv``, every other conv through :func:`conv2d`, both
attention matmuls through :func:`matmul`, each taking the quantizer `q`
as ``reference.conv`` takes it. Departures from the published model:
no drop path (the reference cannot draw the program's masks: the
configuration sets the rate to 0); the detector around the trunk is the
reference repository's FPN and head (``reference.py``), not
mmdetection's RetinaNet neck and head.

Draws: linears normal(0, 0.02); q and kv weights normal(0, 1/sqrt(dim)),
so that the scores spread by order one and a wrong key order or
reduction shows (at 0.02 the softmax is near uniform); convs He normal
over fan-out (per group for the depthwise); LayerNorm weights uniform(0.7,
1.3) and biases uniform(-0.1, 0.1); every other bias uniform(-0.02,
0.02). No buffers.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from rnbench.reference import Quant, conv
from rnbench.yardstick import bound_s

KINDS = ("pvt_v2_b2",)
EMBED_DIMS = (64, 128, 320, 512)
DEPTHS = (3, 4, 6, 3)
HEADS = (1, 2, 5, 8)
SR_RATIOS = (8, 4, 2, 1)
MLP_RATIOS = (8, 8, 4, 4)
BLOCK_EPS, EMBED_EPS = 1e-6, 1e-5
BUFFERS = frozenset()
LINEAR_STD = 0.02
LN_RANGES = {"ln.weight": (0.7, 1.3), "ln.bias": (-0.1, 0.1)}
BIAS_RANGE = (-0.02, 0.02)
P = "backbone.backbone"


def out_channels(m: Dict) -> Tuple[int, int, int]:
    return EMBED_DIMS[1], EMBED_DIMS[2], EMBED_DIMS[3]


def stages(h: int, w: int) -> Iterator[Tuple[int, int, int, int, int, int, int, int]]:
    """(stage, dim, depth, heads, sr, mlp ratio, H, W) of each stage's
    token map for an h x w image."""
    for i in range(4):
        k, s = (7, 4) if i == 0 else (3, 2)
        h, w = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
        yield i + 1, EMBED_DIMS[i], DEPTHS[i], HEADS[i], SR_RATIOS[i], MLP_RATIOS[i], h, w


def schema(m: Dict) -> List[Tuple[str, tuple, str]]:
    """Roles: ``conv`` (a dense conv weight), ``dwconv`` (the depthwise
    one), ``linear``, ``qk`` (the q and kv weights), ``ln.weight``,
    ``ln.bias`` and ``bias``."""
    out: List[Tuple[str, tuple, str]] = []

    def ln(p, c):
        out.extend([(f"{p}.weight", (c,), "ln.weight"), (f"{p}.bias", (c,), "ln.bias")])

    def lin(p, cout, cin, role="linear"):
        out.extend([(f"{p}.weight", (cout, cin), role), (f"{p}.bias", (cout,), "bias")])

    cin = 3
    for i, dim, depth, _, sr, ratio, _, _ in stages(0, 0):
        k = 7 if i == 1 else 3
        out.extend([(f"{P}.patch_embed{i}.proj.weight", (dim, cin, k, k), "conv"),
                    (f"{P}.patch_embed{i}.proj.bias", (dim,), "bias")])
        ln(f"{P}.patch_embed{i}.norm", dim)
        for j in range(depth):
            b = f"{P}.block{i}.{j}"
            ln(f"{b}.norm1", dim)
            lin(f"{b}.attn.q", dim, dim, "qk")
            lin(f"{b}.attn.kv", 2 * dim, dim, "qk")
            lin(f"{b}.attn.proj", dim, dim)
            if sr > 1:
                out.extend([(f"{b}.attn.sr.weight", (dim, dim, sr, sr), "conv"),
                            (f"{b}.attn.sr.bias", (dim,), "bias")])
                ln(f"{b}.attn.norm", dim)
            ln(f"{b}.norm2", dim)
            lin(f"{b}.mlp.fc1", dim * ratio, dim)
            out.extend([(f"{b}.mlp.dwconv.dwconv.weight", (dim * ratio, 1, 3, 3), "dwconv"),
                        (f"{b}.mlp.dwconv.dwconv.bias", (dim * ratio,), "bias")])
            lin(f"{b}.mlp.fc2", dim, dim * ratio)
        ln(f"{P}.norm{i}", dim)
        cin = dim
    return out


def draw(key: str, shape: tuple, role: str, m: Dict) -> tuple:
    if role in ("conv", "dwconv"):
        groups = shape[0] if role == "dwconv" else 1
        return ("normal", math.sqrt(2.0 / (shape[0] * shape[2] * shape[3] / groups)))
    if role == "linear":
        return ("normal", LINEAR_STD)
    if role == "qk":
        return ("normal", 1.0 / math.sqrt(shape[1]))
    if role == "bias":
        return ("uniform",) + BIAS_RANGE
    return ("uniform",) + LN_RANGES[role]


def _quantized(op, a: torch.Tensor, b: torch.Tensor, q: Quant) -> torch.Tensor:
    """``op(a, b)`` through `q` as ``reference.conv`` takes it: both inputs
    rounded, then the output and its gradient where `q` has steps for them."""
    if q is not None:
        a, b = q(a), q(b)
    y = op(a, b)
    for step in (getattr(q, "out", None), getattr(q, "grad", None)):
        if step is not None:
            y = step(y)
    return y


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, pad: int, groups: int,
           q: Quant = None) -> torch.Tensor:
    """A conv with its own padding and groups."""
    return _quantized(lambda x, w: F.conv2d(x, w, b, stride, pad, 1, groups), x, w, q)


def matmul(a: torch.Tensor, b: torch.Tensor, q: Quant = None) -> torch.Tensor:
    return _quantized(torch.matmul, a, b, q)


def _linear(sd: Dict[str, torch.Tensor], p: str, x: torch.Tensor, q: Quant) -> torch.Tensor:
    """A linear on an NCHW map, as a 1x1 conv."""
    w = sd[p + ".weight"]
    return conv(x, w[:, :, None, None], sd[p + ".bias"], q=q)


def _ln(sd: Dict[str, torch.Tensor], p: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW map."""
    y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), sd[p + ".weight"], sd[p + ".bias"], eps)
    return y.permute(0, 3, 1, 2)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, heads, H*W, C / heads] (channel = head * 64 + j)."""
    b, c = x.shape[:2]
    return x.reshape(b, heads, c // heads, -1).transpose(2, 3)


def attention(sd, p: str, x: torch.Tensor, heads: int, sr: int, q: Quant) -> torch.Tensor:
    """Spatial-reduction attention on the NCHW map `x` (already normed)."""
    b, c, h, w = x.shape
    qh = _heads(_linear(sd, p + ".q", x, q), heads)
    src = x
    if sr > 1:
        src = _ln(sd, p + ".norm", conv2d(x, sd[p + ".sr.weight"], sd[p + ".sr.bias"], sr, 0, 1, q),
                  EMBED_EPS)
    kv = _linear(sd, p + ".kv", src, q)
    k, v = _heads(kv[:, :c], heads), _heads(kv[:, c:], heads)
    scores = matmul(qh, k.transpose(2, 3), q) * (c // heads) ** -0.5
    o = matmul(torch.softmax(scores, -1), v, q)  # [B, heads, N, d]
    o = o.transpose(2, 3).reshape(b, c, h, w)
    return _linear(sd, p + ".proj", o, q)


def trunk(sd: Dict[str, torch.Tensor], x: torch.Tensor, m: Dict, q: Quant = None) -> List[torch.Tensor]:
    """Normalized NCHW f32 images -> [C3, C4, C5]."""
    feats = []
    for i, dim, depth, heads, sr, ratio, _, _ in stages(0, 0):
        k, s = (7, 4) if i == 1 else (3, 2)
        e = f"{P}.patch_embed{i}"
        x = conv2d(x, sd[e + ".proj.weight"], sd[e + ".proj.bias"], s, k // 2, 1, q)
        x = _ln(sd, e + ".norm", x, EMBED_EPS)
        for j in range(depth):
            b = f"{P}.block{i}.{j}"
            x = x + attention(sd, b + ".attn", _ln(sd, b + ".norm1", x, BLOCK_EPS), heads, sr, q)
            y = _linear(sd, b + ".mlp.fc1", _ln(sd, b + ".norm2", x, BLOCK_EPS), q)
            y = conv2d(y, sd[b + ".mlp.dwconv.dwconv.weight"], sd[b + ".mlp.dwconv.dwconv.bias"], 1, 1,
                       y.shape[1], q)
            x = x + _linear(sd, b + ".mlp.fc2", F.gelu(y), q)
        x = _ln(sd, f"{P}.norm{i}", x, BLOCK_EPS)
        if i >= 2:
            feats.append(x)
    return feats


def attention_layers(h: int, w: int) -> Iterator[Tuple[int, int, int, int]]:
    """(heads, queries, keys, dim) of each of the 16 attention cores of an
    h x w image."""
    for _, dim, depth, heads, sr, _, th, tw in stages(h, w):
        for _ in range(depth):
            yield heads, th * tw, (th // sr) * (tw // sr), dim


def score_elems(h: int, w: int, batch: int) -> int:
    """Attention scores of a forward over `batch` h x w images: B x heads x
    queries x keys, summed over the layers (the program's
    ``attention.score_elems``)."""
    return sum(batch * heads * nq * nk for heads, nq, nk, _ in attention_layers(h, w))


def trunk_flops(h: int, w: int, m: Dict) -> int:
    """Every conv (the depthwise at 9 MACs an output), every linear and
    both attention matmuls of one image, MACs x 2."""
    fl, cin = 0, 3
    for i, dim, depth, heads, sr, ratio, th, tw in stages(h, w):
        n, nk, hid = th * tw, (th // sr) * (tw // sr), dim * ratio
        k = 7 if i == 1 else 3
        fl += 2 * n * k * k * cin * dim
        per_block = 2 * n * dim * dim * 2 + 2 * nk * dim * 2 * dim  # q, proj; kv
        per_block += 2 * nk * sr * sr * dim * dim if sr > 1 else 0  # reduction conv
        per_block += 2 * 2 * n * nk * dim  # q k^T and the weighted sum of v, over the heads
        per_block += 2 * n * dim * hid * 2 + 2 * n * hid * 9  # fc1, fc2; depthwise
        fl += depth * per_block
        cin = dim
    return fl


def attention_bound(h: int, w: int, m: Dict, batch: int, peaks: Dict[str, float]) -> Tuple[float, str]:
    """The least time the card could take for the 16 attention cores of a
    forward over `batch` h x w images, whatever computes them: the larger
    of their FLOPs (4 B heads Nq Nkv 64, at the bf16 peak) and their bytes
    (bf16 Q, K and V read once and O written once, at HBM bandwidth)."""
    ops = bytes_ = 0
    for heads, nq, nk, dim in attention_layers(h, w):
        ops += 4 * batch * nq * nk * dim
        bytes_ += 2 * batch * dim * (2 * nq + 2 * nk)
    return bound_s(bytes_, ops, peaks["bf16_flops"], peaks["hbm_bytes_per_s"])

"""PVT v2 trunks (Wang et al., arXiv:2106.13797) returning C3/C4/C5.

Module and parameter names are those of whai362/PVT's
``classification/pvt_v2.py`` (``patch_embed{1-4}``, ``block{1-4}.{i}``,
``norm{1-4}``), so that a detector's ``backbone.backbone.*`` keys, and
that repository's ImageNet checkpoint without its ``head.*`` classifier,
load as they are. The JAX package has no such trunk.

Each stage embeds its input by an overlapping strided conv and a
LayerNorm, runs its blocks on the [B, N, C] tokens of the H x W map, and
ends in a LayerNorm. A block is

* ``x + SRA(LN(x))``: the queries from every token, the keys and values
  from the tokens after a ``sr x sr`` stride-``sr`` conv and a LayerNorm
  (``sr = 1``: from every token), over heads of 64 channels, through
  ``F.scaled_dot_product_attention`` in the compute dtype;
* ``x + MixFFN(LN(x))``: fc1, a depthwise 3x3 conv on the map, exact GELU,
  fc2;

each branch under per-sample drop path in training. Parameters are f32;
linears, convs and norms run in the compute dtype of the input, with the
parameters cast per call (:mod:`.layers`' convention). A conv sees the
tokens as a channels_last NCHW view of the map, so no layout pass sits
between a linear and a conv. C3-C5 are the ends of stages 2-4.

Traced (``utils.metrics``): ``pvt.attention`` (norm1 and the SRA branch)
with ``pvt.sdpa`` (the attention core) inside it, and ``pvt.ffn`` (norm2
and the MixFFN branch) in every block, on the device; the counter
``attention.score_elems`` adds B x heads x queries x keys a call.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.metrics import count, span
from .layers import conv

Tensor = torch.Tensor


class PVTSpec(NamedTuple):
    embed_dims: Tuple[int, int, int, int]
    depths: Tuple[int, int, int, int]
    heads: Tuple[int, int, int, int]
    sr_ratios: Tuple[int, int, int, int]
    mlp_ratios: Tuple[int, int, int, int]


PVT_SPECS: Dict[str, PVTSpec] = {
    "pvt_v2_b2": PVTSpec((64, 128, 320, 512), (3, 4, 6, 3), (1, 2, 5, 8), (8, 4, 2, 1), (8, 8, 4, 4)),
}
# The blocks' norms and each stage's closing norm (pvt_v2_b2's norm_layer),
# and nn.LayerNorm's default in the patch embeddings and the reduction.
BLOCK_EPS = 1e-6
EMBED_EPS = 1e-5
DROP_PATH_RATE = 0.1


def _to_map(x: Tensor, h: int, w: int) -> Tensor:
    """[B, H*W, C] tokens -> the NCHW map, a channels_last view."""
    return x.view(x.shape[0], h, w, x.shape[2]).permute(0, 3, 1, 2)


def _to_tokens(y: Tensor) -> Tensor:
    """An NCHW map -> [B, H*W, C] tokens (a view of a channels_last map)."""
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, y.shape[1])


class _Linear(nn.Linear):
    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class _LayerNorm(nn.LayerNorm):
    def forward(self, x: Tensor) -> Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def drop_path(x: Tensor, rate: float, training: bool) -> Tensor:
    """Stochastic depth: in training, each sample's `x` zeroed with
    probability `rate` and the rest scaled by 1 / (1 - rate); else `x`."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = x.new_empty((x.shape[0],) + (1,) * (x.dim() - 1)).bernoulli_(keep)
    return x * mask.div_(keep)


class OverlapPatchEmbed(nn.Module):
    """A k x k stride-s conv (padding k // 2) and a LayerNorm: NCHW map ->
    (tokens, H, W)."""

    def __init__(self, cin: int, dim: int, kernel: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, kernel, stride, kernel // 2)
        self.norm = _LayerNorm(dim, eps=EMBED_EPS)

    def forward(self, x: Tensor) -> Tuple[Tensor, int, int]:
        y = conv(self.proj, x)
        return self.norm(_to_tokens(y)), y.shape[2], y.shape[3]


class Attention(nn.Module):
    """Spatial-reduction attention: queries from every token, keys and
    values from the reduced map (every token where ``sr_ratio`` is 1)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = _Linear(dim, dim)
        self.kv = _Linear(dim, 2 * dim)
        self.proj = _Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = _LayerNorm(dim, eps=EMBED_EPS)

    def forward(self, x: Tensor, h: int, w: int) -> Tensor:
        b, n, c = x.shape
        d = c // self.num_heads
        q = self.q(x).view(b, n, self.num_heads, d).transpose(1, 2)
        if self.sr_ratio > 1:
            x = self.norm(_to_tokens(conv(self.sr, _to_map(x, h, w))))
        k, v = self.kv(x).view(b, -1, 2, self.num_heads, d).permute(2, 0, 3, 1, 4)
        count("attention.score_elems", b * self.num_heads * n * k.shape[2])
        with span("pvt.sdpa", q.device):
            o = F.scaled_dot_product_attention(q, k, v)  # scale d ** -0.5
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: Tensor, h: int, w: int) -> Tensor:
        return _to_tokens(conv(self.dwconv, _to_map(x, h, w)))


class Mlp(nn.Module):
    """MixFFN: fc1, the depthwise 3x3 conv, exact GELU, fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = _Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = _Linear(hidden, dim)

    def forward(self, x: Tensor, h: int, w: int) -> Tensor:
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), h, w)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int, drop_path_rate: float):
        super().__init__()
        self.norm1 = _LayerNorm(dim, eps=BLOCK_EPS)
        self.attn = Attention(dim, num_heads, sr_ratio)
        self.norm2 = _LayerNorm(dim, eps=BLOCK_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)
        self.drop_path_rate = drop_path_rate

    def forward(self, x: Tensor, h: int, w: int) -> Tensor:
        rate, training = self.drop_path_rate, self.training
        with span("pvt.attention", x.device):
            x = x + drop_path(self.attn(self.norm1(x), h, w), rate, training)
        with span("pvt.ffn", x.device):
            x = x + drop_path(self.mlp(self.norm2(x), h, w), rate, training)
        return x


class PyramidVisionTransformerV2(nn.Module):
    """A PVT v2 trunk: four stages, returning {"c3", "c4", "c5"} (stages
    2-4) as channels_last NCHW maps. Drop path rises linearly over the
    blocks from 0 to `drop_path_rate`."""

    def __init__(self, kind: str = "pvt_v2_b2", drop_path_rate: float = DROP_PATH_RATE):
        super().__init__()
        if kind not in PVT_SPECS:
            raise ValueError(f"PVT kind must be one of {sorted(PVT_SPECS)}, got {kind!r}")
        spec = PVT_SPECS[kind]
        rates = torch.linspace(0, drop_path_rate, sum(spec.depths)).tolist()
        cin, cur = 3, 0
        for i, (dim, depth, heads, sr, ratio) in enumerate(
                zip(spec.embed_dims, spec.depths, spec.heads, spec.sr_ratios, spec.mlp_ratios), start=1):
            setattr(self, f"patch_embed{i}",
                    OverlapPatchEmbed(cin, dim, 7 if i == 1 else 3, 4 if i == 1 else 2))
            setattr(self, f"block{i}", nn.ModuleList(
                [Block(dim, heads, sr, ratio, rates[cur + j]) for j in range(depth)]))
            setattr(self, f"norm{i}", _LayerNorm(dim, eps=BLOCK_EPS))
            cin, cur = dim, cur + depth

    def forward(self, x: Tensor, stem_in: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """`x` is the normalized NCHW image in the compute dtype."""
        if stem_in is not None:
            raise ValueError("a PVT trunk has no ResNet stem for the fused stem kernel to replace")
        out: Dict[str, Tensor] = {}
        for i in range(1, 5):
            x, h, w = getattr(self, f"patch_embed{i}")(x)
            for block in getattr(self, f"block{i}"):
                x = block(x, h, w)
            x = _to_map(getattr(self, f"norm{i}")(x), h, w)
            if i >= 2:
                out[f"c{i + 1}"] = x
        return out

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """PVT's init: linears truncated normal(0, 0.02), convs He normal
        over fan-out (per group), LayerNorm ones and zeros, biases zero."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                fan_out = m.kernel_size[0] * m.kernel_size[1] * m.out_channels // m.groups
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                m.bias.zero_()

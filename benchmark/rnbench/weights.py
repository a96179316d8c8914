"""Seeded weights in the reference detector's ``state_dict`` schema, made on
the device in a few large draws.

Trunk convs: He normal over fan-out (torchvision's init). FPN convs: He
uniform over fan-in, zero bias. Head convs: normal(0, 0.01), zero bias, the
class predictor's bias ``-log((1 - prior) / prior)`` (the paper's init);
`class_head_std`, where given, replaces 0.01 in the class subnet's convs.
Frozen batch norms get random running statistics and affine parameters, so
that none is the identity; the last norm of each residual branch gets a
small scale, so that activations stay of order one through 33 blocks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import reference as R

# (low, high) of the uniform draws of each batch-norm leaf.
BN_RANGES = {"weight": (0.7, 1.3), "bias": (-0.1, 0.1), "running_mean": (-0.1, 0.1),
             "running_var": (0.5, 1.5)}
BRANCH_END_BN_WEIGHT = (0.1, 0.3)
HEAD_STD = 0.01


def _last_bn_of_branch(key: str, kind: str) -> bool:
    last = "bn3" if R.DEPTHS[kind][0] == "bottleneck" else "bn2"
    return ".layer" in key and key.endswith(f".{last}.weight")


def make_state_dict(kind: str, num_classes: int, prior: float, seed: int, device,
                    class_head_std: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """The detector's weights for `seed`: f32 tensors on `device`."""
    entries = R.schema(kind, num_classes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal, uniform = [], []  # (key, shape, scale) / (key, shape, low, high)
    out: Dict[str, torch.Tensor] = {}
    for key, shape, role in entries:
        if role == "conv":
            normal.append((key, shape, math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))))
        elif role == "head":
            std = class_head_std if class_head_std and "classification_head" in key else HEAD_STD
            normal.append((key, shape, std))
        elif role == "fpn":
            bound = math.sqrt(6.0 / (shape[1] * shape[2] * shape[3]))
            uniform.append((key, shape, -bound, bound))
        elif role.startswith("bn."):
            lo, hi = (BRANCH_END_BN_WEIGHT if _last_bn_of_branch(key, kind)
                      else BN_RANGES[role.split(".")[1]])
            uniform.append((key, shape, lo, hi))
        elif role == "cls_out":
            out[key] = torch.full(shape, -math.log((1.0 - prior) / prior), device=device)
        else:  # FPN, head and box predictor biases
            out[key] = torch.zeros(shape, device=device)
    for draws, fn in ((normal, "normal"), (uniform, "uniform")):
        sizes = torch.tensor([math.prod(d[1]) for d in draws], device=device)
        total = int(sizes.sum())
        if fn == "normal":
            flat = torch.randn(total, generator=gen, device=device)
            flat *= torch.repeat_interleave(torch.tensor([d[2] for d in draws], device=device), sizes)
        else:
            flat = torch.rand(total, generator=gen, device=device)
            lo = torch.repeat_interleave(torch.tensor([d[2] for d in draws], device=device), sizes)
            hi = torch.repeat_interleave(torch.tensor([d[3] for d in draws], device=device), sizes)
            flat = lo + (hi - lo) * flat
        start = 0
        for d, n in zip(draws, sizes.tolist()):
            out[d[0]] = flat[start:start + n].view(d[1])
            start += n
    return {key: out[key] for key, _, _ in entries}

"""Seeded weights in the reference detector's ``state_dict`` schema, made on
the device in a few large draws.

The trunk's keys and draws are its family's (``benchmark/families/``).
FPN convs: He uniform over fan-in, zero bias. Head convs: normal(0, 0.01),
zero bias, the class predictor's bias ``-log((1 - prior) / prior)`` (the
paper's init); `class_head_std`, where given, replaces 0.01 in the class
subnet's convs. Every normal draw of the detector comes from one call of
the generator, then every uniform draw from one more, in schema order.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import reference as R

HEAD_STD = 0.01


def _draw(key: str, shape: tuple, role: str, prior: float, class_head_std: Optional[float]) -> tuple:
    """The draw of an FPN or head key."""
    if role == "head":
        return ("normal", class_head_std if class_head_std and "classification_head" in key else HEAD_STD)
    if role == "fpn":
        bound = math.sqrt(6.0 / (shape[1] * shape[2] * shape[3]))
        return ("uniform", -bound, bound)
    if role == "cls_out":
        return ("full", -math.log((1.0 - prior) / prior))
    return ("full", 0.0)  # FPN, head and box predictor biases


def make_state_dict(fam, m: Dict, prior: float, seed: int, device,
                    class_head_std: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """The detector's weights for `seed`, its trunk of the family `fam`:
    f32 tensors on `device`."""
    entries = R.schema(fam, m)
    trunk_keys = {key for key, _, _ in fam.schema(m)}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal, uniform = [], []  # (key, shape, scale) / (key, shape, low, high)
    out: Dict[str, torch.Tensor] = {}
    for key, shape, role in entries:
        d = (fam.draw(key, shape, role, m) if key in trunk_keys
             else _draw(key, shape, role, prior, class_head_std))
        if d[0] == "normal":
            normal.append((key, shape, d[1]))
        elif d[0] == "uniform":
            uniform.append((key, shape, d[1], d[2]))
        elif d[0] == "full":
            out[key] = torch.full(shape, d[1], device=device)
        else:
            raise ValueError(f"{key}: unknown draw {d!r}")
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

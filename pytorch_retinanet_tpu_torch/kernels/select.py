"""Per-row top-2 classes: the CUDA kernel (``csrc/top2.cu``) and its plain version.

Replaces ``pytorch_retinanet_tpu/kernels/select_pallas.py::pallas_top2_classes``:
for each row of [A, C] logits, the two largest values (f32) and their class
ids (int32), ties to the lower id, the second allowed to equal the first at
another id. The kernel reads each row once and is bound by bytes.

As in the JAX package, no production path calls it: the postprocess's
two-stage selection (``ops/nms.py``) stays as it is until a measurement on
the card shows that this pays.

:func:`top2_classes` is the wrapper: for a CPU tensor it computes the plain
version, for a CUDA tensor it launches the kernel (and counts the launch in
``top2_classes.launches``) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

Tensor = torch.Tensor

_NEG = -3.0e38  # below any logit: the first choice's slot in the second scan
_ROWS = 256  # rows per CTA of the kernel
_SMEM_LIMIT = 96 * 1024  # bytes of rows one CTA stages


def top2_classes_plain(logits: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``top2_reference_xla`` in PyTorch: max, lowest id at the max, then the
    same with that id set to -3e38. Returns (v1, c1, v2, c2), [A] each."""
    x = logits.float()
    lane = torch.arange(x.shape[1], device=x.device, dtype=torch.int32)
    big = torch.tensor(2**30, dtype=torch.int32, device=x.device)
    v1 = x.max(dim=1).values
    c1 = torch.where(x == v1[:, None], lane, big).min(dim=1).values
    x2 = torch.where(lane == c1[:, None], torch.tensor(_NEG, device=x.device), x)
    v2 = x2.max(dim=1).values
    c2 = torch.where(x2 == v2[:, None], lane, big).min(dim=1).values
    return v1, c1, v2, c2


def top2_classes(logits: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-row top-2 of [A, C] logits (bf16 or f32), A >= 8.

    Returns ``(v1, c1, v2, c2)``: [A] f32 values with ``v1 >= v2`` and [A]
    int32 class ids, ties broken toward the lower id.
    """
    if logits.dim() != 2:
        raise ValueError(f"top2_classes takes [A, C] logits, got {tuple(logits.shape)}")
    a, c = logits.shape
    if a < 8:
        raise ValueError(f"top2_classes needs A >= 8, got {a}")
    if c < 1:
        raise ValueError("top2_classes needs at least one class")
    if logits.device.type == "cpu":
        return top2_classes_plain(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"top2_classes: logits on {logits.device}")
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"top2_classes takes bf16 or f32 logits, got {logits.dtype}")
    row_bytes = c * logits.element_size()
    if row_bytes > _SMEM_LIMIT:
        raise ValueError(f"top2 kernel stages rows of at most {_SMEM_LIMIT} bytes, got {row_bytes}")
    from .build import load

    fn = load("top2").top2_classes
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x = logits.contiguous()
    dev = x.device
    v1 = torch.empty(a, dtype=torch.float32, device=dev)
    v2 = torch.empty(a, dtype=torch.float32, device=dev)
    c1 = torch.empty(a, dtype=torch.int32, device=dev)
    c2 = torch.empty(a, dtype=torch.int32, device=dev)
    rows = min(_ROWS, _SMEM_LIMIT // row_bytes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), v1.data_ptr(), c1.data_ptr(), v2.data_ptr(), c2.data_ptr(), a, c,
                 rows, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"top2 kernel launch failed with CUDA error {err}")
    top2_classes.launches += 1
    return v1, c1, v2, c2


top2_classes.launches = 0

"""Fused identity bottleneck: the CUDA kernel (``csrc/bottleneck.cu``) and its plain version.

Replaces ``pytorch_retinanet_tpu/kernels/bottleneck_pallas.py::fused_bottleneck``:
one stride-1 identity ResNet bottleneck, 1x1 (C -> mid) + BN + ReLU -> 3x3
pad 1 (mid -> mid) + BN + ReLU -> 1x1 (mid -> C) + BN -> + x -> ReLU, on
NHWC bf16 with frozen BN folded into per-channel ``scale`` and ``bias``. The
three GEMMs run on the tensor cores through ``wgmma`` (bf16 in, f32
accumulate), both intermediates stay in shared memory, and the weights
stream through a ring of shared-memory slots filled by bulk copies; the
source's header note gives the design and the bound.

Weights are in GEMM layout: ``w1`` [C, mid], ``w2`` tap-major [9, mid, mid]
(tap ``3 * dy + dx``, rows the input channel), ``w3`` [mid, C]. These are the
JAX kernel's HWIO weights reshaped; :func:`bottleneck_args` makes them from a
port :class:`~..models.backbone.Bottleneck`. Before each launch the wrapper
packs them with :func:`pack_bottleneck_weights` into the order and layout in
which the kernel copies them (:func:`bottleneck_weight_tiles`).

The JAX kernel zero-pads the block's INPUT rows and runs conv1 over them, so
its 3x3 reads ``relu(b1)`` instead of zero above the first and below the last
image row. The port computes what that kernel is documented to fuse,
``bottleneck_reference_xla`` (the 3x3 zero-pads y1), on every row.

:func:`fused_bottleneck` is the wrapper: for a CPU tensor it computes the
plain version, for a CUDA tensor it launches the kernel (and counts the
launch in ``fused_bottleneck.launches``) or raises. Its gradient recomputes
through the plain version, as the JAX kernel's custom VJP recomputes through
the XLA composition.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# The widths the kernel is built for: the three of the R50 identity blocks
# it fuses (layers 2, 3 and 4), one tile geometry each.
KERNEL_MIDS = (128, 256, 512)


def _pick_rows(
    h: int,
    width: int,
    cin: int,
    mid: int,
    cout_chunk: int = 0,
    budget: int = 10 * 2**20,
    max_rows: int = 16,
) -> int:
    """Largest row tile R with H % R == 0 whose working set fits the budget
    (the JAX kernel's row tiling, kept only for :func:`fused_bottleneck_supported`)."""
    acc3_c = cout_chunk or cin
    best = 1
    for r in range(1, min(h, max_rows) + 1):
        if h % r:
            continue
        need = (
            2 * (r + 2) * width * cin * 2          # double-buffered input
            + (r + 2) * width * mid * 2            # y1
            + r * width * mid * 4                  # conv2 f32 accumulator
            + r * width * acc3_c * 4               # conv3 f32 accumulator
            + r * width * cin * 2                  # output block
        )
        if need <= budget:
            best = r
    return best


def fused_bottleneck_supported(x_shape: Sequence[int], mid: int) -> bool:
    """Which identity blocks go through the fused formula: the JAX predicate.

    NHWC, ``C == 4 * mid``, ``mid >= 128``, ``C % 128 == 0``, and a row tile
    of at least 2 rows whose working set fits 10 MiB. That last test is the
    TPU's VMEM budget, not a limit of this port's kernel; it is kept so that
    both packages send the same blocks of a trunk through the fused formula.
    """
    if len(x_shape) != 4:
        return False
    _, h, w, c = x_shape
    if c != 4 * mid or mid < 128 or c % 128 != 0:
        return False
    return _pick_rows(h, w, c, mid) >= 2


def _bf16_f32(t: Tensor) -> Tensor:
    return t.to(torch.bfloat16).float()


def bottleneck_plain(x: Tensor, w1: Tensor, s1: Tensor, b1: Tensor, w2: Tensor, s2: Tensor,
                     b2: Tensor, w3: Tensor, s3: Tensor, b3: Tensor) -> Tensor:
    """The block in plain PyTorch, with the kernel's rounding points.

    f32 convs of the bf16-rounded input and weights; ``y * s + b`` and ReLU
    in f32; y1 and y2 rounded to bf16; the 3x3 zero-pads y1; then
    ``relu(y3 * s3 + b3 + x)`` in f32 with one bf16 rounding. [B, H, W, C]
    NHWC in, [B, H, W, C] bf16 NHWC (contiguous) out.
    """
    c, mid = w1.shape
    xf = _bf16_f32(x).permute(0, 3, 1, 2)

    def bn(y, s, b):
        return y * s.float()[:, None, None] + b.float()[:, None, None]

    w1k = _bf16_f32(w1).t().reshape(mid, c, 1, 1)
    w2k = _bf16_f32(w2).reshape(3, 3, mid, mid).permute(3, 2, 0, 1)
    w3k = _bf16_f32(w3).t().reshape(c, mid, 1, 1)
    y = _bf16_f32(torch.relu(bn(F.conv2d(xf, w1k), s1, b1)))
    y = _bf16_f32(torch.relu(bn(F.conv2d(y, w2k, padding=1), s2, b2)))
    y = bn(F.conv2d(y, w3k), s3, b3)
    return torch.relu(y + xf).to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def bottleneck_args(block) -> Tuple[Tensor, ...]:
    """The kernel's arguments from a port ``Bottleneck`` (stride 1, no downsample).

    Frozen BN folded with ``FrozenBatchNorm2d.folded()`` (f32), weights in
    GEMM layout as bf16: ``(w1 [C, mid], s1, b1, w2 [9, mid, mid], s2, b2,
    w3 [mid, C], s3, b3)``. Differentiable in the block's parameters.
    """
    mid, c = block.conv1.weight.shape[:2]

    def bf16(t):
        return t.to(torch.bfloat16, memory_format=torch.contiguous_format)

    w1 = bf16(block.conv1.weight.reshape(mid, c).t())
    w2 = bf16(block.conv2.weight.permute(2, 3, 1, 0).reshape(9, mid, mid))
    w3 = bf16(block.conv3.weight.reshape(c, mid).t())
    return (w1, *block.bn1.folded(), w2, *block.bn2.folded(), w3, *block.bn3.folded())


def bottleneck_weight_tiles(mid: int) -> List[Tuple[int, int, int, int, int]]:
    """The kernel's weight tiles in the order its producer copies them.

    Each is ``(weight, tap, k0, n0, n)``: rows ``k0 .. k0 + 63`` and columns
    ``n0 .. n0 + n - 1`` of ``w1`` [C, mid] (weight 1, tap 0), ``w2[tap]``
    [mid, mid] (weight 2) or ``w3`` [mid, C] (weight 3). conv1 takes 128 columns
    at a time over all of C; conv2 takes min(mid, 256) columns, tap by tap;
    conv3 256 columns at a time over all of mid.
    """
    c, n2 = 4 * mid, min(mid, 256)
    tiles = [(1, 0, k0, n0, 128) for n0 in range(0, mid, 128) for k0 in range(0, c, 64)]
    tiles += [(2, tap, k0, n0, n2) for tap in range(9) for k0 in range(0, mid, 64)
              for n0 in range(0, mid, n2)]
    tiles += [(3, 0, k0, n0, 256) for n0 in range(0, c, 256) for k0 in range(0, mid, 64)]
    return tiles


def _swizzle_tile(t: Tensor) -> Tensor:
    """[n, 64] rows of 128 bytes (bf16) with the 128-byte swizzle: the 16-byte
    chunk ``j`` of row ``r`` moves to chunk ``j ^ (r % 8)``. Its own inverse."""
    n = t.shape[0]
    idx = torch.arange(8, device=t.device)[None, :] ^ (torch.arange(n, device=t.device) % 8)[:, None]
    return torch.gather(t.reshape(n, 8, 8), 1, idx[..., None].expand(n, 8, 8)).reshape(n, 64)


@functools.lru_cache(maxsize=None)
def _pack_index(mid: int, device: torch.device) -> Tensor:
    """For each element of the packed weights, its index in ``cat(w1, w2, w3)``
    flattened: every tile of :func:`bottleneck_weight_tiles`, transposed to
    [n, 64] (N rows of 64 K values) and swizzled, one after the other."""
    c = 4 * mid
    flat = torch.arange(2 * c * mid + 9 * mid * mid, dtype=torch.int64)
    ws: Dict[int, Tensor] = {1: flat[:c * mid].view(1, c, mid),
                             2: flat[c * mid:c * mid + 9 * mid * mid].view(9, mid, mid),
                             3: flat[c * mid + 9 * mid * mid:].view(1, mid, c)}
    parts = [_swizzle_tile(ws[which][tap, k0:k0 + 64, n0:n0 + n].t())
             for which, tap, k0, n0, n in bottleneck_weight_tiles(mid)]
    return torch.cat([t.reshape(-1) for t in parts]).to(device)


def pack_bottleneck_weights(w1: Tensor, w2: Tensor, w3: Tensor) -> Tensor:
    """w1 [C, mid], w2 [9, mid, mid], w3 [mid, C] -> one flat bf16 tensor of
    the kernel's weight tiles (:func:`bottleneck_weight_tiles`), each [n, 64]
    (K contiguous, 128 bytes a row) with the 128-byte swizzle applied, so that
    one bulk copy puts a tile in shared memory in the layout ``wgmma`` reads.
    A tile of width n starts 64 * n elements after the one before it."""
    mid = w1.shape[1]
    flat = torch.cat([w.detach().reshape(-1).to(torch.bfloat16) for w in (w1, w2, w3)])
    return flat[_pack_index(mid, flat.device)]


def _aligned(t: Tensor, dtype: torch.dtype) -> Tensor:
    """Contiguous in `dtype`, 16-byte aligned for the kernel's 16-byte copies."""
    t = t.detach().to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x: Tensor, w1: Tensor, s1: Tensor, b1: Tensor, w2: Tensor, s2: Tensor,
            b2: Tensor, w3: Tensor, s3: Tensor, b3: Tensor, trace: Tensor = None) -> Tensor:
    from .build import load

    fn = load("bottleneck").bottleneck_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    b, h, w, c = x.shape
    mid = w1.shape[1]
    xk = _aligned(x, torch.bfloat16)
    wpack = _aligned(pack_bottleneck_weights(w1, w2, w3), torch.bfloat16)
    vecs = [_aligned(t, torch.float32) for t in (s1, b1, s2, b2, s3, b3)]
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xk.data_ptr(), wpack.data_ptr(), *(t.data_ptr() for t in vecs),
                 out.data_ptr(), b, h, w, c, mid, None if trace is None else trace.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"bottleneck kernel launch failed with CUDA error {err}")
    fused_bottleneck.launches += 1
    return out


def bottleneck_launch_config(mid: int, h: int, w: int, batch: int) -> Dict[str, int]:
    """The kernel's launch at [batch, h, w, 4 mid] on the current card: its
    tile, cluster size (1), CTAs, dynamic shared memory, CTAs per SM (CUDA's
    occupancy calculator), ring slots and their bytes, threads per CTA."""
    from .build import load

    fn = load("bottleneck").bottleneck_config
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 9)()
    err = fn(mid, h, w, batch, out)
    if err != 0:
        raise RuntimeError(f"bottleneck_config failed with CUDA error {err}")
    keys = ("tile_h", "tile_w", "cluster", "ctas", "smem_bytes", "ctas_per_sm", "slots",
            "slot_bytes", "threads")
    return dict(zip(keys, list(out)))


BOTTLENECK_TRACE_FIELDS = ("start_ns", "conv1_done_ns", "conv2_wgmma_done_ns", "y2_written_ns",
                           "end_ns", "full_wait_cycles", "conv1_full_wait_cycles", "sm",
                           "conv3_epilogue_ns", "conv1_epilogue_ns", "cycles")


def bottleneck_phase_trace(*args: Tensor) -> Tensor:
    """Launch the kernel once on CUDA inputs (the arguments of
    :func:`fused_bottleneck`) with its phase trace on: [CTAs, 11] int64 on the
    CPU, one row per CTA of the grid, fields ``BOTTLENECK_TRACE_FIELDS``
    (global-timer ns stamps, cycles waited for weight slots, the SM)."""
    b, h, w, _ = args[0].shape
    ctas = bottleneck_launch_config(args[1].shape[1], h, w, b)["ctas"]
    trace = torch.zeros((ctas, len(BOTTLENECK_TRACE_FIELDS)), dtype=torch.int64,
                        device=args[0].device)
    with torch.no_grad():
        _launch(*args, trace=trace)
    return trace.cpu()


class _FusedBottleneck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _launch(*args)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = bottleneck_plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, grad) if wanted else [])
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_bottleneck(x: Tensor, w1: Tensor, s1: Tensor, b1: Tensor, w2: Tensor, s2: Tensor,
                     b2: Tensor, w3: Tensor, s3: Tensor, b3: Tensor) -> Tensor:
    """One stride-1 identity bottleneck in one kernel.

    Args:
      x: [B, H, W, C] NHWC (bf16 on the card), C = 4 * mid.
      w1, w2, w3: [C, mid], [9, mid, mid], [mid, C] GEMM-layout weights.
      s1, b1, s2, b2: [mid]; s3, b3: [C] frozen BN as ``y * s + b``.

    Returns:
      [B, H, W, C] bf16 NHWC.
    """
    args = (x, w1, s1, b1, w2, s2, b2, w3, s3, b3)
    if x.dim() != 4 or w1.dim() != 2:
        raise ValueError(f"fused bottleneck takes x [B, H, W, C] and w1 [C, mid], got "
                         f"{tuple(x.shape)} and {tuple(w1.shape)}")
    c, mid = w1.shape
    want = ((x.shape[0], x.shape[1], x.shape[2], c), (c, mid), (mid,), (mid,), (9, mid, mid),
            (mid,), (mid,), (mid, c), (c,), (c,))
    got = tuple(tuple(t.shape) for t in args)
    if got != want or c != 4 * mid:
        raise ValueError(f"fused bottleneck shapes {got} are not an identity block's {want} "
                         f"with C = 4 * mid")
    if all(t.device.type == "cpu" for t in args):
        return bottleneck_plain(*args)
    if x.device.type != "cuda" or any(t.device != x.device for t in args):
        raise ValueError("fused bottleneck: every input must lie on the same CUDA device, got "
                         f"{[str(t.device) for t in args]}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused bottleneck takes a bf16 activation on the card, got {x.dtype}")
    if mid not in KERNEL_MIDS:
        raise ValueError(f"the bottleneck kernel takes mid in {KERNEL_MIDS}, got {mid}")
    return _FusedBottleneck.apply(*args)


fused_bottleneck.launches = 0

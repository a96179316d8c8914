"""Spatial and tensor-parallel splits of the detector over ``torch.distributed`` ranks.

Counterpart of ``pytorch_retinanet_tpu/parallel/sharding.py``. JAX names a
``(data, spatial, model)`` device mesh and lets GSPMD insert the halo
exchanges and the channel collectives; here each rank is a process with
its place in a :class:`~pytorch_retinanet_tpu_torch.parallel.MeshPlan`, and
the exchanges are written out:

* **spatial** (image height). The trunk runs on this rank's rows, split in
  units of 32 input rows (the deepest stride, so that every stage's
  boundary falls on its stride), as evenly as possible, the larger shards
  first. Each conv and pool of the trunk runs with no height padding on its
  shard plus the rows it reads above and below it, which come from the
  neighbouring ranks (:class:`_Halo`); only the image's top and bottom are
  padded, with the op's own value. C3/C4/C5 are all-gathered along the
  height before the FPN and head, which every spatial rank computes in
  full, as JAX's split forward gathers them. In backward the halo rows'
  gradients go back to the ranks that sent them, and the gather returns
  each rank its rows of the gradient: the trunk's parameter gradients are
  partial sums over the spatial ranks (the ``Trainer`` sums them).
* **model** (conv output channels; inference, as in JAX). A conv whose
  weight :func:`shard_variables` splits computes this rank's output
  channels and all-gathers them over the model ranks before the next op.

The halo rows travel by ``dist.batch_isend_irecv``, except between gloo
ranks on CUDA tensors, which gloo's point-to-point does not take: those
exchange them through an all-gather over the spatial group.

Both splits take a ResNet trunk alone: a PVT trunk's attention reads the
whole map (its keys and values come from every row), and its linears are
no convs to split, so :func:`make_split_forward` and
:func:`build_sharded_forward` raise for it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import MeshPlan, mesh_plan
from ..models.backbone import require_resnet
from ..models.layers import splitting
from ..models.retinanet import fused_stem, fused_stem_applicable

Tensor = torch.Tensor

# JAX's name for the plan its inference meshes build.
InferenceMeshPlan = MeshPlan

# The deepest trunk stride: shard boundaries fall on multiples of it, so
# that each shard keeps whole rows at C5 and every stage's halo is aligned.
DEEPEST_STRIDE = 32
_FEATURE_STRIDES = {"c3": 8, "c4": 16, "c5": 32}
# 1-D per-channel vectors that split with their conv's output channels.
_CHANNEL_VECTORS = ("weight", "bias", "running_mean", "running_var")

__all__ = [
    "InferenceMeshPlan",
    "make_inference_mesh",
    "make_sharded_stem",
    "make_split_forward",
    "shard_variables",
    "sharded_stem_applicable",
    "build_sharded_forward",
]


def make_inference_mesh(
    devices: Optional[Sequence[Any]] = None,
    *,
    data: int = 1,
    spatial: int = 1,
    model: int = 1,
) -> Optional[MeshPlan]:
    """This rank's plan in a ``(data, spatial, model)`` mesh over the first
    ``data * spatial * model`` ranks, data outermost as in JAX. `devices`
    names one device per rank, as ``parallel.make_mesh`` takes them. Every
    rank of the world calls it; a rank past the mesh gets None. Raises when
    the world has fewer ranks than the mesh needs."""
    return mesh_plan(devices, data, spatial, model)


def shard_variables(module: nn.Module, plan: MeshPlan
                    ) -> Tuple[Dict[str, Tensor], Dict[str, Optional[int]]]:
    """This rank's shards of `module`'s state under tensor parallelism, and
    for each name the dim split over the ``model`` axis (None: replicated).

    JAX's rule in torch layouts: a 4-D conv weight ``[cout, cin, kh, kw]``
    splits ``cout`` when the model axis divides it, and the 1-D
    per-channel vectors (a conv's ``bias``; a batch norm's ``weight``,
    ``bias``, ``running_mean`` and ``running_var``) split with it;
    everything else is replicated, the head predictors whose A*K channels
    do not divide among them. A model axis of 1 replicates everything.
    """
    size, index = plan.model_size, plan.axis_index("model")
    shards, dims = {}, {}
    for name, t in module.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        split = size > 1 and (
            (t.dim() == 4 and leaf == "weight") or (t.dim() == 1 and leaf in _CHANNEL_VECTORS)
        ) and t.shape[0] % size == 0
        dims[name] = 0 if split else None
        shards[name] = t.chunk(size)[index] if split else t
    return shards, dims


def _check_height(height: int, spatial: int) -> None:
    if spatial > 1 and height // DEEPEST_STRIDE < spatial:
        raise ValueError(
            f"spatial axis {spatial} too large for H={height}: C5 has "
            f"{height // DEEPEST_STRIDE} rows and each spatial shard needs "
            f">= 1 (use spatial <= H/{DEEPEST_STRIDE})"
        )


def shard_rows(height: int, spatial: int) -> List[Tuple[int, int]]:
    """Each spatial rank's ``[start, stop)`` input rows: units of
    ``DEEPEST_STRIDE`` rows, as evenly as possible, the larger shards first,
    at least one unit each."""
    if height % DEEPEST_STRIDE:
        raise ValueError(f"a height split needs H divisible by {DEEPEST_STRIDE} (the bucket "
                         f"heights are), got H={height}")
    _check_height(height, spatial)
    base, extra = divmod(height // DEEPEST_STRIDE, spatial)
    bounds, start = [], 0
    for i in range(spatial):
        stop = start + (base + (i < extra)) * DEEPEST_STRIDE
        bounds.append((start, stop))
        start = stop
    return bounds


def _memory_format(x: Tensor) -> torch.memory_format:
    channels_last = torch.channels_last
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(memory_format=channels_last):
        return channels_last
    return torch.contiguous_format


def _exchange_p2p(rows: "_Rows", down: Tensor, up: Tensor):
    """:meth:`_Rows.exchange` by point-to-point sends and receives."""
    i, ops, above, below = rows.index, [], None, None
    if i > 0:
        above = torch.empty_like(down)
        if up.shape[2]:
            ops.append(dist.P2POp(dist.isend, up, rows.peers[i - 1], rows.group))
        if down.shape[2]:
            ops.append(dist.P2POp(dist.irecv, above, rows.peers[i - 1], rows.group))
    if i < rows.size - 1:
        below = torch.empty_like(up)
        if down.shape[2]:
            ops.append(dist.P2POp(dist.isend, down, rows.peers[i + 1], rows.group))
        if up.shape[2]:
            ops.append(dist.P2POp(dist.irecv, below, rows.peers[i + 1], rows.group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return above, below


def _exchange_gathered(rows: "_Rows", down: Tensor, up: Tensor):
    """:meth:`_Rows.exchange` through one all-gather of every rank's
    ``(down, up)`` over the spatial group."""
    packet = torch.cat([down.reshape(-1), up.reshape(-1)])
    parts = [torch.empty_like(packet) for _ in range(rows.size)]
    dist.all_gather(parts, packet, group=rows.group)
    i, k = rows.index, down.numel()
    above = parts[i - 1][:k].reshape(down.shape) if i > 0 else None
    below = parts[i + 1][k:].reshape(up.shape) if i < rows.size - 1 else None
    return above, below


class _Rows:
    """This rank's rows of a height split of `height` input rows over the
    spatial ranks of `plan`."""

    def __init__(self, plan: MeshPlan, height: int):
        self.group = plan.axis_group("spatial")
        self.index, self.size = plan.axis_index("spatial"), plan.spatial_size
        self.bounds = shard_rows(height, self.size)
        self.peers = [dist.get_global_rank(self.group, i) for i in range(self.size)]

    def exchange(self, down: Tensor, up: Tensor) -> Tuple[Optional[Tensor], Optional[Tensor]]:
        """Send `down` to the rank below and `up` to the rank above; return
        (what the rank above sent down, what the rank below sent up), None
        past the image's edge. Every spatial rank calls it at the same point
        with tensors of the same shapes."""
        gloo_cuda = down.is_cuda and dist.get_backend(self.group) != "nccl"
        return (_exchange_gathered if gloo_cuda else _exchange_p2p)(self, down, up)

    def halo(self, x: Tensor, top: int, bottom: int, fill: float) -> Tensor:
        return _Halo.apply(x, top, bottom, fill, self) if top or bottom else x


class _Halo(torch.autograd.Function):
    """This rank's rows ``[N, C, h, W]`` -> ``[N, C, top + h + bottom, W]``:
    the `top` rows above the shard and the `bottom` rows below it, from the
    neighbouring ranks, and `fill` past the image's top and bottom.
    Backward adds the halo rows' gradients into the rows they came from, on
    the ranks they came from."""

    @staticmethod
    def forward(ctx, x: Tensor, top: int, bottom: int, fill: float, rows: _Rows):
        ctx.top, ctx.bottom, ctx.rows = top, bottom, rows
        h = x.shape[2]
        above, below = rows.exchange(x[:, :, h - top:].contiguous(), x[:, :, :bottom].contiguous())

        def edge(k):
            return x.new_full((x.shape[0], x.shape[1], k, x.shape[3]), fill)

        fmt = _memory_format(x)
        parts = (edge(top) if above is None else above, x, edge(bottom) if below is None else below)
        return torch.cat([p.contiguous(memory_format=fmt) for p in parts], dim=2)

    @staticmethod
    def backward(ctx, g: Tensor):
        top, bottom, rows = ctx.top, ctx.bottom, ctx.rows
        h = g.shape[2] - top - bottom
        dx = g[:, :, top:top + h].clone()
        # The bottom halo's gradient goes to the rank below, the top halo's to
        # the rank above; what comes back belongs to this shard's edge rows.
        from_above, from_below = rows.exchange(g[:, :, top + h:].contiguous(),
                                               g[:, :, :top].contiguous())
        if from_above is not None:
            dx[:, :, :bottom] += from_above
        if from_below is not None:
            dx[:, :, h - top:] += from_below
        return dx, None, None, None, None


class _GatherRows(torch.autograd.Function):
    """This rank's rows of a feature map of `stride` -> the whole height,
    all-gathered over the spatial ranks (each shard padded to the largest
    for the collective). Backward returns this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x: Tensor, rows: _Rows, stride: int):
        bounds = [(a // stride, b // stride) for a, b in rows.bounds]
        most = max(b - a for a, b in bounds)
        padded = F.pad(x, (0, 0, 0, most - x.shape[2])).contiguous()
        parts = [torch.empty_like(padded) for _ in bounds]
        dist.all_gather(parts, padded, group=rows.group)
        ctx.start, ctx.stop = bounds[rows.index]
        out = torch.cat([p[:, :, :b - a] for p, (a, b) in zip(parts, bounds)], dim=2)
        return out.contiguous(memory_format=_memory_format(x))

    @staticmethod
    def backward(ctx, g: Tensor):
        return g[:, :, ctx.start:ctx.stop], None, None


class _GatherChannels(torch.autograd.Function):
    """This rank's output channels -> all of them, all-gathered over the
    model ranks in rank order. Backward returns this rank's channels."""

    @staticmethod
    def forward(ctx, y: Tensor, group: Any):
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        ctx.index, ctx.c = dist.get_rank(group), y.shape[1]
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g: Tensor):
        return g[:, ctx.index * ctx.c:(ctx.index + 1) * ctx.c], None


class _Split:
    """What ``layers.conv`` and ``layers.max_pool_torch`` do inside
    ``layers.splitting``: run on this rank's rows of the height (`rows`;
    None: the whole height), and compute this rank's output channels of the
    convs in `channels` (layer -> its (weight, bias) shards), all-gathered
    over `model_group`."""

    def __init__(self, rows: Optional[_Rows], channels: Dict[nn.Conv2d, tuple],
                 model_group: Any = None):
        self.rows, self.channels, self.model_group = rows, channels, model_group

    def conv(self, layer: nn.Conv2d, x: Tensor, pad=None) -> Tensor:
        (top, bottom), (left, right) = pad or ((layer.padding[0],) * 2, (layer.padding[1],) * 2)
        weight, bias = self.channels.get(layer, (layer.weight, layer.bias))
        if self.rows is not None:
            below = max(layer.kernel_size[0] - top - layer.stride[0], 0)
            x, top, bottom = self.rows.halo(x, top, below, 0.0), 0, 0
        if (top, left) != (bottom, right):
            x, top, left = F.pad(x, (left, right, top, bottom)), 0, 0
        y = F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                     layer.stride, (top, left))
        return _GatherChannels.apply(y, self.model_group) if layer in self.channels else y

    def max_pool(self, x: Tensor, window: int, stride: int) -> Tensor:
        pad = (window - 1) // 2
        if self.rows is None:
            return F.max_pool2d(x, window, stride, pad)
        x = self.rows.halo(x, pad, max(window - pad - stride, 0), float("-inf"))
        return F.max_pool2d(x, window, stride, (0, pad))


class SplitForward(nn.Module):
    """The height-split detector forward of :func:`make_split_forward`: a
    module holding the detector, so that ``DistributedDataParallel`` can
    wrap it (the ``Trainer`` does)."""

    def __init__(self, module: nn.Module, plan: MeshPlan,
                 channels: Optional[Dict[nn.Conv2d, tuple]] = None):
        super().__init__()
        require_resnet(module.backbone_kind, "the spatial split")
        self.module = module
        self.plan = plan
        self.channels = channels or {}

    def forward(self, images: Tensor, return_levels: bool = True):
        module, plan = self.module, self.plan
        rows = _Rows(plan, images.shape[1])
        start, stop = rows.bounds[rows.index]
        x = module.normalize(images[:, start:stop]).permute(0, 3, 1, 2).to(module.dtype)
        group = plan.axis_group("model") if self.channels else None
        with splitting(_Split(rows, self.channels, group)):
            feats = module.backbone(x)
        feats = {k: _GatherRows.apply(v, rows, _FEATURE_STRIDES[k]) for k, v in feats.items()}
        with splitting(_Split(None, self.channels, group) if self.channels else None):
            return module(images, return_levels, feats_in=feats)


def make_split_forward(module: nn.Module, plan: MeshPlan) -> SplitForward:
    """The spatial split forward, shared by every spatial caller
    (:func:`build_sharded_forward`, the ``Trainer``'s spatial steps):
    ``forward(images, return_levels=True)`` on this rank's data shard
    ``[B, H, W, 3]`` (f32 in [0, 1], or uint8 with /255 folded into the
    normalize constants) at full height.

    It runs the module's own trunk on this rank's rows of the height (see
    the module docstring), all-gathers C3/C4/C5 along the height over the
    spatial ranks, and runs the FPN and head on them:
    ``module(images, return_levels, feats_in=feats)``. Every spatial rank
    returns the same outputs. It is differentiable, and ``remat`` and
    ``stem_s2d`` work under it.
    """
    return SplitForward(module, plan)


def sharded_stem_applicable(module: nn.Module, image_shape: Sequence[int],
                            plan: MeshPlan) -> bool:
    """JAX's gate for :func:`make_sharded_stem`: the fused stem kernel runs
    on each rank's batch rows when the plan's device is CUDA (JAX: a TPU),
    there is no height split (the kernel takes whole image rows), the
    module is bf16 with the 7x7 stem on shapes the kernel takes, and the
    data axis divides the batch ``image_shape[0]``."""
    return (plan.spatial_size == 1 and plan.device.type == "cuda"
            and fused_stem_applicable(module, image_shape)
            and image_shape[0] % plan.data_size == 0)


def make_sharded_stem(module: nn.Module, plan: MeshPlan):
    """The stem sharded over the batch: ``stem(images) -> the pooled stem
    output`` (NHWC, bf16) of this rank's rows, which feeds
    ``module(images, stem_in=...)``. JAX wraps its kernel in ``shard_map``;
    a rank simply runs the kernel on the rows it holds. Callers gate with
    :func:`sharded_stem_applicable`."""
    if plan.spatial_size > 1:
        raise ValueError("the fused stem takes whole image rows: a height split runs the "
                         "module's own stem")
    return lambda images: fused_stem(module, images)


def build_sharded_forward(module: nn.Module, plan: MeshPlan, *, tensor_parallel: bool = True):
    """A mesh-sharded inference forward: ``(forward, place_images)``.

    ``place_images(images)`` takes the whole batch ``[B, H, W, 3]`` (the
    same on every rank, as JAX's global array), checks it against the mesh
    with JAX's messages, and returns this rank's data rows on the plan's
    device. ``forward(rows)`` returns the per-level ``(cls, box)`` outputs
    of those rows at full height, the same on every spatial and model rank
    of the data shard, on the module's running statistics and without
    gradients.

    At spatial 1 the stem is the fused kernel on the rank's rows where
    :func:`sharded_stem_applicable` holds; at spatial > 1 the forward is
    :func:`make_split_forward`'s. With ``tensor_parallel`` and a model axis
    > 1, the convs that :func:`shard_variables` splits compute this rank's
    output channels and gather the rest.
    """
    channels: Dict[nn.Conv2d, tuple] = {}
    if tensor_parallel and plan.model_size > 1:
        require_resnet(module.backbone_kind, "the tensor-parallel split")
        shards, dims = shard_variables(module, plan)
        for name, dim in dims.items():
            prefix, leaf = name.rsplit(".", 1)
            layer = module.get_submodule(prefix)
            if dim is not None and leaf == "weight" and isinstance(layer, nn.Conv2d):
                bias = None if layer.bias is None else shards[prefix + ".bias"]
                channels[layer] = (shards[name], bias)
    spatial, data = plan.spatial_size, plan.data_size
    split = SplitForward(module, plan, channels) if spatial > 1 else None
    tp = _Split(None, channels, plan.axis_group("model")) if channels else None

    @torch.inference_mode()
    def forward(images: Tensor):
        was = module.training
        module.eval()
        try:
            if split is not None:
                return split(images, return_levels=True)
            with splitting(tp):
                if sharded_stem_applicable(module, (images.shape[0] * data, *images.shape[1:]),
                                           plan):
                    return module(images, True, stem_in=make_sharded_stem(module, plan)(images))
                return module(images, True)
        finally:
            module.train(was)

    def place_images(images) -> Tensor:
        _check_height(images.shape[1], spatial)
        if images.shape[0] % data:
            raise ValueError(f"batch {images.shape[0]} not divisible by data axis {data}")
        rows = images.shape[0] // data
        start = plan.axis_index("data") * rows
        return torch.as_tensor(images[start:start + rows]).to(plan.device)

    return forward, place_images

"""Data parallelism on ``torch.distributed``: process groups, device plans, collectives.

Counterpart of the data-parallel half of ``pytorch_retinanet_tpu/parallel/__init__.py``
(the reference's ``utils/coco/detection_utils.py`` helpers). One process per
rank, each on one device: NCCL where the ranks' devices are CUDA, gloo
otherwise (the CPU tests, or several gloo ranks sharing one card). The
Trainer wraps the module in ``DistributedDataParallel`` over a
:class:`MeshPlan`'s group; live batch norm reduces its statistics over the
default group (``models/layers.py``); evaluation merges through
:func:`all_gather_objects`.

A plan may also split one image over ranks, as JAX's named meshes do: a
``(data, spatial, model)`` layout, one process group for each line of each
axis (:func:`make_train_mesh` for spatial training,
``parallel/sharding.py::make_inference_mesh`` for inference). The height
split, its halo exchange and the channel split are in ``parallel/sharding.py``.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the default process group (the reference's ``init_distributed_mode``).

    Arguments left None come from torchrun's environment: ``WORLD_SIZE``,
    ``RANK``, and ``MASTER_ADDR`` / ``MASTER_PORT``. ``coordinator_address``
    is ``host:port`` or an ``init_method`` URL (``tcp://...``, ``file://...``).
    A no-op, as JAX's is, when there is one process (or none is named) and
    no ``backend`` is asked for; an explicit ``backend`` makes a group even
    of one rank (on the loopback interface when no address is given).

    The backend defaults to NCCL where CUDA is available and gloo otherwise.
    Under NCCL the process takes CUDA device ``LOCAL_RANK`` (else its rank
    modulo the local device count) before the group is made, which the
    object collectives need.
    """
    if dist.is_initialized():
        raise RuntimeError("init_distributed: a default process group already exists")
    num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if backend is None and (num_processes is None or num_processes <= 1):
        return
    world = num_processes or 1
    rank = process_id if process_id is not None else (_env_int("RANK") or 0)
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside a world of {world}")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        if world > 1:
            raise ValueError("init_distributed: more than one process needs a coordinator_address "
                             "(or MASTER_ADDR / MASTER_PORT)")
        coordinator_address = f"127.0.0.1:{_free_port()}"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def get_world_size() -> int:
    """Reference get_world_size: 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    """Reference get_rank: 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Reference is_main_process: rank 0 writes the files."""
    return get_rank() == 0


AXES = ("data", "spatial", "model")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """This rank's place in a run: the default process group (None without
    one), the rank's device, and the mesh's axes.

    A mesh lays ranks out data-outermost, as JAX's ``make_inference_mesh``
    lays out devices: rank ``(d * spatial_size + s) * model_size + m`` sits
    at ``coords == (d, s, m)``. ``data_size`` ranks take their own rows of
    the batch; the ``spatial_size`` ranks of one data shard split each
    image's height; the ``model_size`` ranks of one spatial shard split the
    convolutions' output channels. A data-only plan (:func:`make_mesh`) has
    no ``axis_groups``: its data axis is ``group`` itself.
    """

    group: Any
    device: torch.device
    data_size: int
    spatial_size: int = 1
    model_size: int = 1
    coords: Tuple[int, int, int] = (0, 0, 0)
    axis_groups: Tuple[Any, ...] = dataclasses.field(default=(), compare=False)

    @property
    def num_devices(self) -> int:
        return self.data_size * self.spatial_size * self.model_size

    def axis_size(self, name: str) -> int:
        return (self.data_size, self.spatial_size, self.model_size)[AXES.index(name)]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along `name`."""
        return self.coords[AXES.index(name)]

    def axis_group(self, name: str) -> Any:
        """The process group of this rank's line along `name`: the ranks of
        the mesh whose other coordinates are this rank's (a group of one
        along an axis of size 1). A data-only plan's data axis is ``group``."""
        if not self.axis_groups:
            if name != "data":
                raise ValueError(f"a data-only plan has no {name!r} axis group")
            return self.group
        return self.axis_groups[AXES.index(name)]


def _as_device(d: Any) -> torch.device:
    """A CUDA index, a device string or a ``torch.device``."""
    return torch.device("cuda", d) if isinstance(d, int) else torch.device(d)


def _rank_device(devices: Optional[Sequence[Any]], world: int) -> torch.device:
    """This rank's entry of `devices` (one per rank), or the current CUDA
    device when `devices` is None."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no devices given and CUDA is not available; pass "
                               "devices=['cpu'] * world_size for CPU ranks")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"make_mesh: {len(devices)} devices for a world of {world} ranks "
                             "(one device per rank)")
        device = _as_device(devices[get_rank()])
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices: Optional[Sequence[Any]] = None) -> MeshPlan:
    """The data-parallel plan of this rank: rank r runs on ``devices[r]``
    (CUDA indices, device strings or ``torch.device``s, one per rank;
    several ranks may name one device), or on the current CUDA device when
    ``devices`` is None."""
    world = get_world_size()
    device = _rank_device(devices, world)
    group = dist.group.WORLD if dist.is_initialized() else None
    if group is not None and dist.get_backend(group) == "nccl" and device.type != "cuda":
        raise ValueError(f"make_mesh: an NCCL group needs CUDA devices, got {device}")
    return MeshPlan(group, device, world, coords=(get_rank(), 0, 0))


def mesh_plan(devices: Optional[Sequence[Any]], data: int, spatial: int,
              model: int) -> Optional[MeshPlan]:
    """The ``(data, spatial, model)`` plan of this rank over the first
    ``data * spatial * model`` ranks, with a process group for every line
    of every axis. Every rank of the world must call it (``dist.new_group``
    is collective, and every rank makes every group in the same order);
    a rank past the mesh gets None, as ``dist.new_group`` gives a rank
    outside a group none. Raises, as JAX's meshes do, when the world has
    fewer ranks than the mesh needs."""
    world = get_world_size()
    need = data * spatial * model
    if min(data, spatial, model) < 1 or world < need:
        raise ValueError(f"mesh {data}x{spatial}x{model} needs {need} devices, have {world}")
    if spatial == model == 1 and need == world:
        return make_mesh(devices)
    device = _rank_device(devices, world)
    if dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError(f"mesh_plan: an NCCL group needs CUDA devices, got {device}")
    sizes = (data, spatial, model)
    grid = np.arange(need).reshape(sizes)
    rank = get_rank()
    mine = [None, None, None]
    for axis in range(3):
        for line in np.moveaxis(grid, axis, -1).reshape(-1, sizes[axis]):
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                mine[axis] = group
    if rank >= need:
        return None
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    return MeshPlan(dist.group.WORLD, device, data, spatial, model, coords, tuple(mine))


def make_train_mesh(
    devices: Optional[Sequence[Any]] = None,
    *,
    spatial: int = 1,
    data: Optional[int] = None,
) -> Optional[MeshPlan]:
    """A ``(data, spatial)`` training plan, with JAX's signature and checks:
    batch rows over ``data`` ranks, each image's height over ``spatial``.

    At ``spatial=1`` it is :func:`make_mesh`'s plan, and ``data``, if given,
    must be the world size. At ``spatial > 1``, ``data`` defaults to the
    world size over ``spatial``, the mesh takes the first ``data * spatial``
    ranks (a rank past them gets None) and raises where there are fewer.
    Spatial training spreads one image's trunk FLOPs and activation memory
    over the spatial ranks; it needs frozen batch norm, which the
    ``Trainer`` enforces.
    """
    world = get_world_size()
    if spatial <= 1:
        if data is not None and data != world:
            raise ValueError(f"make_train_mesh: data axis {data} != world size {world} (one "
                             "rank per device along the batch)")
        return make_mesh(devices)
    if data is None:
        data = world // spatial
    if data < 1 or world < data * spatial:
        raise ValueError(f"mesh {data}x{spatial} needs {data * spatial} devices, have {world}")
    return mesh_plan(devices, data, spatial, 1)


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order (reference
    ``all_gather``: pickle over the default group); ``[obj]`` without a
    group."""
    if not dist.is_initialized():
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _host_mean(v: Any) -> float:
    if isinstance(v, Tensor):
        return float(v.detach().double().mean())
    return float(np.asarray(v, np.float64).mean())


def reduce_dict(metrics: dict, average: bool = True) -> dict:
    """Average (or sum) a dict of scalars across ranks (reference
    ``reduce_dict``), summed in rank order so that every rank gets the same
    floats; a plain ``{k: float}`` without a group."""
    local = {k: _host_mean(v) for k, v in metrics.items()}
    if not dist.is_initialized():
        return local
    shards = all_gather_objects(local)
    out = {}
    for k in local:
        total = sum(s[k] for s in shards)
        out[k] = total / len(shards) if average else total
    return out


_HOST_GROUPS: dict = {}


def _host_group():
    """A gloo group over the default group's ranks, for host flags: an NCCL
    all-reduce of one would wait for the work queued on the device. The
    default group itself when it is gloo. Made on first use, which every
    rank reaches at the same point."""
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if world not in _HOST_GROUPS:
        _HOST_GROUPS[world] = dist.new_group(backend="gloo")
    return _HOST_GROUPS[world]


def any_rank(flags: Sequence[bool]) -> List[bool]:
    """Each flag true on every rank when it is true on any (a max all-reduce
    of one int per flag, on the host), so that ranks leave a loop together."""
    if get_world_size() == 1:
        return [bool(f) for f in flags]
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group())
    return [bool(v) for v in t.tolist()]


def average_gradients(parameters, group=None) -> None:
    """Average ``.grad`` over the ranks in place (what DDP's all-reduce
    does), for gradients DDP did not reduce."""
    world = dist.get_world_size(group)
    for p in parameters:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)
            p.grad.div_(world)


__all__ = [
    "MeshPlan",
    "all_gather_objects",
    "any_rank",
    "average_gradients",
    "get_rank",
    "get_world_size",
    "init_distributed",
    "is_main_process",
    "make_mesh",
    "make_train_mesh",
    "reduce_dict",
]

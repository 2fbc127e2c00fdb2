"""Device meshes of the port (counterpart of ``repro.launch.mesh``).

Two kinds of mesh answer the same questions (``shape``, ``axis_names``,
``size``, ``device``, ``MeshAxes.for_mesh``), and every model path takes
either:

* :class:`Mesh`, the one-process mesh: ``data x model`` shards that all
  live on ONE device (the card, or the CPU when the caller asks), the
  counterpart of the reference's single-controller mesh of devices forced
  onto one host. The DataFrame engine row-shards every table over its data
  axes and runs its operators shard by shard, merging the partials with
  the list-of-partials collectives of ``engine/distributed.py``; the model
  paths split a batch over the data axes and experts or the decode cache
  over "model" (``models/sharding.py``). Nothing is placed: every shard
  holds every weight.
* :class:`RankMesh`, a mesh of ``torch.distributed`` ranks, one process
  each (:func:`init_rank_mesh`, under ``torchrun`` or any launcher that
  sets the rendezvous): NCCL with one rank a card, or gloo on the CPU
  when the caller asks for it. ``models/sharding.place_params`` places
  the weights by the reference's rule table (FSDP over the data axes, TP
  and experts over "model"), so each rank holds only its shard of every
  weight the table shards; the collectives of ``engine/distributed.py``
  then take this rank's own part and run over the axis's process group.
  The DataFrame engine row-shards every table over the data axes with
  each rank holding only its own shard (``Table.shard``), and merges its
  operators' partials over the data axes' group (``engine/distributed.py``).

Axis convention (as the reference):
  single-pod : (16, 16)    over ("data", "model")            — 256 shards
  multi-pod  : (2, 16, 16) over ("pod", "data", "model")     — 512 shards
  local      : ``make_local_mesh(data, model)`` over ("data", "model").
  ranks      : ``init_rank_mesh(data, model[, pod=])``, the same orders.
The engine row-shards tables over the data axes (("pod", "data") on the
multi-pod mesh); the model paths split a batch over them. The dry-run
(``launch/dryrun.py``) runs its cells on the pod meshes of the "meta"
device.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``shape`` maps each axis name to its extent (in axis order);
    ``devices`` is an object ndarray of ``torch.device`` with those
    extents — one entry per shard, all the same device here."""

    shape: dict
    devices: np.ndarray

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self):
        """The one device every shard of this mesh lives on."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _mesh(shape: dict, device) -> Mesh:
    dev = resolve_device(device)
    devices = np.empty(tuple(shape.values()), dtype=object)
    for idx in np.ndindex(devices.shape):
        devices[idx] = dev
    return Mesh(dict(shape), devices)


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A mesh of ``data * model`` shards, every one on ``device`` (None:
    the CUDA card, and without one this raises; ``device="cpu"`` asks for
    the CPU, as the tests do)."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh extents must be >= 1, got data={data}, "
                         f"model={model}")
    return _mesh({"data": data, "model": model}, device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's pod mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model") under ``multi_pod``, every
    shard on ``device`` (None: the card, raising without one; "cpu" and
    "meta" when asked for — the dry-run's is on "meta")."""
    if multi_pod:
        return _mesh({"pod": 2, "data": 16, "model": 16}, device)
    return _mesh({"data": 16, "model": 16}, device)


def launcher_mesh(n: int, device=None, multi_pod: bool = False) -> Mesh:
    """The launchers' mesh over ``n`` devices (``--local-devices``), as the
    reference's launchers build it: the pod mesh under ``multi_pod`` or
    from 512 devices (the multi-pod one only under ``multi_pod``), else
    ``make_local_mesh(data=n // mp, model=mp)`` with mp = 2 when n is even
    and above 1; every shard on ``device``."""
    if multi_pod or n >= 512:
        return make_production_mesh(multi_pod=multi_pod, device=device)
    mp = 2 if n % 2 == 0 and n > 1 else 1
    return make_local_mesh(data=n // mp, model=mp, device=device)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Names of the mesh axes a program shards over; ``data`` may be a
    multi-axis tuple (("pod", "data") on a multi-pod mesh)."""

    data: tuple[str, ...] = ("data",)
    model: str = "model"

    @staticmethod
    def for_mesh(mesh) -> "MeshAxes":
        names = mesh.axis_names
        if "pod" in names:
            return MeshAxes(data=("pod", "data"), model="model")
        if "model" in names:
            return MeshAxes(data=("data",), model="model")
        return MeshAxes(data=tuple(names), model=names[-1])

    def data_size(self, mesh) -> int:
        return math.prod(mesh.shape[a] for a in self.data)

    def model_size(self, mesh) -> int:
        return mesh.shape[self.model] if self.model in mesh.shape else 1


# -- meshes of torch.distributed ranks -----------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """This process's view of a mesh of ``torch.distributed`` ranks.
    ``shape`` maps each axis name to its extent (the reference's order);
    ``device`` is this rank's device; ``coords`` this rank's index along
    each axis; ``device_mesh`` the ``DeviceMesh`` over the ranks;
    ``groups`` the process group of each axis, keyed by its name, of
    the data-axis tuple ("pod", "data") on the multi-pod layout, and of
    every rank, keyed by ``axis_names``."""

    shape: dict
    device: torch.device
    rank: int
    coords: dict
    device_mesh: Any
    groups: dict
    backend: str

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axes):
        """The process group over ``axes``: an axis name, or a tuple of
        names (a one-name tuple reads as the name)."""
        if isinstance(axes, tuple) and len(axes) == 1:
            axes = axes[0]
        return self.groups[axes]

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over a tuple, as a
        tensor dim sharded over several axes is split)."""
        names = axes if isinstance(axes, tuple) else (axes,)
        i = 0
        for nm in names:
            i = i * self.shape[nm] + self.coords[nm]
        return i

    def extent(self, axes) -> int:
        names = axes if isinstance(axes, tuple) else (axes,)
        return math.prod(self.shape[nm] for nm in names)

    def __repr__(self) -> str:
        return (f"RankMesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device}, "
                f"backend={self.backend})")


def is_rank_mesh(mesh) -> bool:
    """True for a mesh of ``torch.distributed`` ranks: each process holds
    only its own shard, and a merge is a collective over a process group."""
    return isinstance(mesh, RankMesh)


WRITER = 0   # the global rank that holds a durable store's files


def is_writer(mesh) -> bool:
    """True where a durable store's files are written: off a rank mesh, or
    on its global rank :data:`WRITER` (``runtime/durable.py``)."""
    return not is_rank_mesh(mesh) or mesh.rank == WRITER


def broadcast_object(mesh, obj: Any = None) -> Any:
    """The writer's ``obj``, on every rank of ``mesh`` (a pickled broadcast
    over the group of every axis, ``broadcast_object_list``); ``obj``
    itself off a rank mesh. Every rank calls it at the same point; the
    others pass nothing."""
    if not is_rank_mesh(mesh):
        return obj
    import torch.distributed as dist

    box = [obj if mesh.rank == WRITER else None]
    dist.broadcast_object_list(box, src=WRITER, group=mesh.group(mesh.axis_names),
                               device=mesh.device if mesh.backend == "nccl"
                               else None)
    return box[0]


def agree(mesh, code: int, data_axes=("data",)) -> int:
    """The least of every rank's ``code`` over the process group of
    ``data_axes`` (a MIN all-reduce of one int): the vote an engine publish
    takes on a ``RankMesh`` before it swaps a manifest, so that it commits
    on every rank or on none (a durable store votes over every axis,
    ``mesh.axis_names``). ``code`` itself off a rank mesh."""
    if not is_rank_mesh(mesh):
        return int(code)
    import torch.distributed as dist

    t = torch.tensor([int(code)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group(tuple(data_axes)))
    return int(t.item())


def twin_mesh(mesh: "RankMesh") -> "RankMesh":
    """The same mesh over process groups of its own, made collectively
    (every rank of the world calls it, in the same order): a thread that
    issues collectives beside the caller's (the background compactor's
    builds) runs them on these groups, so the two streams of collectives
    never interleave on one group."""
    import torch.distributed as dist

    groups = {}
    world = dist.get_world_size()
    for key, g in mesh.groups.items():
        every: list = [None] * world
        dist.all_gather_object(every, dist.get_process_group_ranks(g))
        layout = sorted({tuple(r) for r in every})
        mine, _ = dist.new_subgroups_by_enumeration([list(r) for r in layout])
        groups[key] = mine
    return dataclasses.replace(mesh, groups=groups)


def _env_int(name: str, given):
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise RuntimeError(f"init_rank_mesh: {name} is not set; launch under "
                           "torchrun or pass it")
    return int(os.environ[name])


def init_rank_mesh(data: int = 1, model: int = 1, device=None, *,
                   pod: int = 0, rank: int | None = None,
                   world_size: int | None = None,
                   local_rank: int | None = None,
                   init_method: str | None = None,
                   backend: str | None = None) -> RankMesh:
    """A mesh of ``(pod x) data x model`` ranks, this process one of them.

    The rendezvous is ``torchrun``'s: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and, through ``init_method="env://"``, ``MASTER_ADDR``
    and ``MASTER_PORT``; each may be passed instead. ``device=None`` means
    the card ``cuda:LOCAL_RANK`` and the ``nccl`` backend, and raises
    without a card; ``device="cpu"`` asks for ``gloo`` on the CPU. Nothing
    falls back from one to the other; ``backend="gloo"`` on the card must
    be asked for (several ranks sharing one card, which NCCL refuses).
    The process group is initialised
    once per process; a later call builds another mesh over the same
    ranks (an elastic restore onto another layout). NCCL needs one rank a
    card."""
    if data < 1 or model < 1 or pod < 0:
        raise ValueError(f"mesh extents must be >= 1, got pod={pod}, "
                         f"data={data}, model={model}")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = {"pod": pod} if pod else {}
    shape.update(data=data, model=model)
    n = math.prod(shape.values())
    if device is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", local_rank))
        if not torch.cuda.is_available():
            raise RuntimeError("init_rank_mesh: no CUDA device for nccl; "
                               "pass device='cpu' for gloo on the CPU")
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    else:
        dev = torch.device(device)
        if dev.type != "cpu" or backend not in (None, "gloo"):
            raise ValueError(f"init_rank_mesh: device {device!r}, backend "
                             f"{backend!r}: None (the card) or 'cpu' (gloo)")
        backend = "gloo"
    if not dist.is_initialized():
        # NCCL binds this rank to its card (it guesses from the rank else)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=_env_int("RANK", rank),
                                world_size=_env_int("WORLD_SIZE", world_size),
                                device_id=dev if backend == "nccl" else None)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"init_rank_mesh: the process group runs "
                           f"{dist.get_backend()}, not {backend}")
    if dist.get_world_size() != n:
        raise ValueError(f"init_rank_mesh: {dist.get_world_size()} ranks "
                         f"for a mesh of {n} ({shape})")
    names = tuple(shape)
    dm = init_device_mesh(dev.type, tuple(shape.values()),
                          mesh_dim_names=names)
    groups = {nm: dm.get_group(nm) for nm in names}
    coords = {nm: dm.get_local_rank(nm) for nm in names}
    if pod:
        # the data-axis tuple's group: every rank of one model index
        grid = np.arange(n).reshape(pod, data, model)
        mine, _ = dist.new_subgroups_by_enumeration(
            [grid[:, :, m].reshape(-1).tolist() for m in range(model)])
        groups[("pod", "data")] = mine
    groups[names] = dist.group.WORLD   # every rank: a durable store's votes
    return RankMesh(shape, dev, dist.get_rank(), coords, dm, groups, backend)


def rank_launcher_mesh(n: int, device=None) -> RankMesh:
    """The launchers' mesh over ``n`` ranks under ``torchrun``, by
    :func:`launcher_mesh`'s rule: data n // mp x model mp, mp = 2 when n
    is even and above 1."""
    mp = 2 if n % 2 == 0 and n > 1 else 1
    return init_rank_mesh(n // mp, mp, device)


def _quiet(*args, **kwargs) -> None:
    """``print`` on the ranks that do not report."""


def reporter(mesh):
    """``print`` where a launcher reports (rank 0 of a rank mesh, or any
    other mesh or none), else a function that prints nothing."""
    return _quiet if isinstance(mesh, RankMesh) and mesh.rank else print


def close_rank_mesh() -> None:
    """Tear the process group down (every rank calls it)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()

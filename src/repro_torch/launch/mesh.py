"""Device meshes of the port (counterpart of ``repro.launch.mesh``).

The DataFrame engine row-shards every table over the mesh's data axes and
runs its operators shard by shard, merging the partials through the
collectives of ``engine/distributed.py``; the model paths split a batch
over the data axes and experts or the decode cache over "model"
(``models/sharding.py``). Every shard lives on ONE device: a mesh of
shards on the card (or, when the caller asks, on the CPU), the
counterpart of the reference's single-controller mesh of devices forced
onto one host. Placement over several cards and ``torch.distributed``
across processes wait for ROADMAP A9b.

Axis convention (as the reference):
  single-pod : (16, 16)    over ("data", "model")            — 256 shards
  multi-pod  : (2, 16, 16) over ("pod", "data", "model")     — 512 shards
  local      : ``make_local_mesh(data, model)`` over ("data", "model").
The engine row-shards tables over the data axes (("pod", "data") on the
multi-pod mesh); the model paths split a batch over them. The dry-run
(``launch/dryrun.py``) runs its cells on the pod meshes of the "meta"
device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

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
    def for_mesh(mesh: Mesh) -> "MeshAxes":
        names = mesh.axis_names
        if "pod" in names:
            return MeshAxes(data=("pod", "data"), model="model")
        if "model" in names:
            return MeshAxes(data=("data",), model="model")
        return MeshAxes(data=tuple(names), model=names[-1])

    def data_size(self, mesh: Mesh) -> int:
        return math.prod(mesh.shape[a] for a in self.data)

    def model_size(self, mesh: Mesh) -> int:
        return mesh.shape[self.model] if self.model in mesh.shape else 1

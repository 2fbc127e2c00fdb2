"""Checkpointing (port of ``repro.runtime.checkpoint``): atomic, async,
CRC-verified, keep-N, and a restore onto a named device.

Layout (the reference's, byte for byte)::

    <dir>/step_<n>/
        meta.json        {"step", "num_leaves", "crc" (one per leaf), "treedef"}
        leaf_<i>.npy     the full array of the tree's i-th leaf

The leaves are numbered in the reference's pytree order (``runtime/tree.py``:
dict keys sorted), and each CRC is ``zlib.crc32`` of the array's bytes, so a
checkpoint written by either package restores in the other.
``meta["treedef"]`` is the reference's text for the structure; no restore
reads it.

A save copies every tensor leaf to the host before it returns (a
consistent snapshot: the train step then overwrites the parameters and
moments in place); CRCs, ``np.save`` and the publishing rename run on a
background thread, one save at a time. Numpy leaves are written as they
are given, without a copy: hand over arrays nothing changes until the
write is done (``convert.train_state_tree`` makes fresh ones). The leaves
of one save, and of one restore, are written and read (CRC included) by
``IO_THREADS`` threads: ``np.save``, ``np.load`` and ``zlib.crc32``
release the interpreter lock.

``spans`` records each save's host copy, each wait for the writer, each
write (``background`` says on which thread) and each restore's read, with
host-clock stamps and bytes, for the callers that time them.

Across ``torch.distributed`` ranks (every rank calls ``save``, ``wait``
and ``restore`` in the same order, as the train loop does): a DTensor
leaf is gathered whole on every rank (``full_tensor``), rank 0 alone
writes the full tensors (the format stays the reference's, byte for
byte), and ``wait`` ends with a barrier, so no rank reads a step before
it is published. A restore reads every leaf; under a ``NamedSharding``
over a rank mesh each rank keeps only its block, as a DTensor over that
mesh: the saved layout does not matter (the reference's elastic
restore).
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import RankMesh
from repro_torch.runtime.tree import flatten, unflatten

IO_THREADS = 4


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _host(x) -> np.ndarray:
    """A leaf as a host array: a tensor copied (synchronously, whatever its
    device; a DTensor gathered whole first, a collective), a numpy array as
    it is. A tensor of a dtype numpy cannot hold (bf16) raises
    ``TypeError``: nothing is cast."""
    if isinstance(x, torch.Tensor):
        if _is_dtensor(x):
            x = x.full_tensor()
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _ranks() -> tuple[int, int]:
    """(this process's rank, the world size) of the ``torch.distributed``
    process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def crc32(a: np.ndarray) -> int:
    """``zlib.crc32`` of the array's bytes (the reference's
    ``crc32(a.tobytes())``, without the copy)."""
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8)) \
        & 0xFFFFFFFF


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.spans: list[dict] = []

    def _span(self, name: str, step, t0: float, nbytes: int = 0,
              **kw) -> None:
        self.spans.append({"span": name, "step": step, "t0": t0,
                           "t1": time.perf_counter(), "bytes": nbytes, **kw})

    # -- save -------------------------------------------------------------------
    def save(self, step: int, tree: Any, wait: bool = False) -> None:
        t0 = time.perf_counter()
        leaves, treedef = flatten(tree)
        host_leaves = [_host(x) for x in leaves]
        nbytes = sum(a.nbytes for a in host_leaves)
        self._span("copy", step, t0, nbytes)
        self.wait()  # one in-flight save at a time
        if _ranks()[0] != 0:
            return  # rank 0 writes

        def _write(background: bool):
            t1 = time.perf_counter()
            tmp = self.dir / f".tmp_step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)

            def leaf(i: int) -> int:
                np.save(tmp / f"leaf_{i}.npy", host_leaves[i])
                return crc32(host_leaves[i])

            with ThreadPoolExecutor(IO_THREADS) as pool:
                crcs = list(pool.map(leaf, range(len(host_leaves))))
            meta = {"step": step, "num_leaves": len(host_leaves), "crc": crcs,
                    "treedef": str(treedef)}
            (tmp / "meta.json").write_text(json.dumps(meta))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic publish
            self._gc()
            self._span("write", step, t1, nbytes, background=background)

        if self.async_save and not wait:
            def _run():
                try:
                    _write(True)
                except BaseException as e:  # handed to the caller by wait()
                    self._error = e
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        else:
            _write(False)

    def wait(self) -> None:
        """Block until the save in flight is published; a failure of its
        write is raised here. Across ranks every rank waits for rank 0's
        write (a barrier)."""
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self._thread = None
            self._span("wait", None, t0)
        if _ranks()[1] > 1:
            import torch.distributed as dist
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_", 1)[1]) for p in self.dir.glob("step_*"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: Optional[int], like: Any, device=None,
                shardings: Any = None) -> tuple[int, Any]:
        """Restore into the structure of ``like`` (the latest step when
        ``step`` is None, once the save in flight is published) as tensors
        on ``device``: ``None`` means the CUDA card (and raises without
        one), ``"cpu"`` keeps the loaded arrays without a copy. The leaves
        are full arrays whatever produced them. A CRC mismatch raises
        ``IOError``; where a leaf of ``like`` has a shape and a dtype, the
        saved leaf must have the same ones (``ValueError``: nothing is
        cast).

        ``shardings`` (the reference's elastic restore) is a tree of
        ``sharding.NamedSharding`` over ``like``, or a prefix of it: a
        sharding, or ``None``, at a node covers its subtree. A leaf under
        a sharding of the one-process mesh goes whole to its mesh's
        device, where every shard lives; under one of a rank mesh this
        rank keeps its block, a DTensor over the mesh (an extent that does
        not divide its dim raises ``ValueError``). A spec longer than the
        leaf's rank raises ``ValueError``, as jax's placement does; a leaf
        under ``None`` goes to ``device``. The saved layout does not
        matter."""
        # the save in flight first: it may publish the latest step (the
        # reference picks the latest step before it waits)
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        t0 = time.perf_counter()
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "meta.json").read_text())
        like_leaves, treedef = flatten(like)
        if meta["num_leaves"] != len(like_leaves):
            raise ValueError(f"checkpoint step {step} holds {meta['num_leaves']} "
                             f"leaves, {treedef} {len(like_leaves)}")
        places = []
        _leaf_shardings(shardings, like, places)
        devs = []
        for i, (sh, ref) in enumerate(zip(places, like_leaves)):
            if sh is None:
                devs.append(resolve_device(device))
                continue
            if hasattr(ref, "shape") and len(sh.spec) > len(ref.shape):
                raise ValueError(f"checkpoint leaf {i}: spec {sh.spec} "
                                 f"longer than its shape {tuple(ref.shape)}")
            devs.append(torch.device(sh.device))

        def leaf(i: int) -> np.ndarray:
            a = np.load(d / f"leaf_{i}.npy")
            crc = crc32(a)
            if crc != meta["crc"][i]:
                raise IOError(f"checkpoint corruption: leaf {i} crc mismatch "
                              f"({crc:#x} != {meta['crc'][i]:#x})")
            return a

        with ThreadPoolExecutor(IO_THREADS) as pool:
            futures = [pool.submit(leaf, i) for i in range(len(like_leaves))]
            try:
                arrays = [f.result() for f in futures]
            except BaseException:
                for f in futures:
                    f.cancel()
                raise
        out, nbytes = [], 0
        for i, (a, ref, dev) in enumerate(zip(arrays, like_leaves, devs)):
            t = torch.from_numpy(a)
            if hasattr(ref, "shape") and hasattr(ref, "dtype") and (
                    tuple(ref.shape) != tuple(t.shape)
                    or _torch_dtype(ref.dtype) != t.dtype):
                raise ValueError(f"checkpoint step {step} leaf {i}: {t.dtype} "
                                 f"{tuple(t.shape)}, the tree wants {ref.dtype} "
                                 f"{tuple(ref.shape)}")
            if places[i] is not None and isinstance(places[i].mesh, RankMesh):
                out.append(_rank_block(t, places[i], i))
            else:
                out.append(t if dev.type == "cpu" else t.to(dev))
            nbytes += a.nbytes
        self._span("read", step, t0, nbytes)
        return step, unflatten(treedef, out)


def _rank_block(t: torch.Tensor, sh, i: int):
    """This rank's block of the whole leaf ``t`` under ``sh`` (a
    ``NamedSharding`` over a rank mesh), as a DTensor over the mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import local_slice, sanitize_pspec

    if sanitize_pspec(sh.spec, t.shape, sh.mesh) != sh.spec:
        raise ValueError(f"checkpoint leaf {i}: spec {sh.spec} does not split "
                         f"{tuple(t.shape)} over {sh.mesh.shape} evenly")
    local = local_slice(t, sh.spec, sh.mesh).contiguous().to(sh.mesh.device)
    return DTensor.from_local(local, sh.mesh.device_mesh, sh.placements,
                              run_check=False, shape=t.shape, stride=t.stride())


def _leaf_shardings(shardings, like, out: list, inherited=None) -> None:
    """Append, in ``runtime/tree.py``'s leaf order of ``like``, the
    sharding that covers each leaf (``None``: none)."""
    if shardings is not None and not isinstance(shardings, (dict, list, tuple)):
        inherited, shardings = shardings, None
    if like is None:
        return
    if isinstance(like, dict):
        for k in sorted(like):
            _leaf_shardings(None if shardings is None else shardings[k],
                            like[k], out, inherited)
    elif isinstance(like, (list, tuple)):
        for i, v in enumerate(like):
            _leaf_shardings(None if shardings is None else shardings[i], v,
                            out, inherited)
    else:
        out.append(inherited)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype

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
from repro_torch.runtime.tree import flatten, unflatten

IO_THREADS = 4


def _host(x) -> np.ndarray:
    """A leaf as a host array: a tensor copied (synchronously, whatever its
    device), a numpy array as it is. A tensor of a dtype numpy cannot hold
    (bf16) raises ``TypeError``: nothing is cast."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


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
        write is raised here."""
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self._thread = None
            self._span("wait", None, t0)
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

    def restore(self, step: Optional[int], like: Any,
                device=None) -> tuple[int, Any]:
        """Restore into the structure of ``like`` (the latest step when
        ``step`` is None, once the save in flight is published) as tensors
        on ``device``: ``None`` means the CUDA card (and raises without
        one), ``"cpu"`` keeps the loaded arrays without a copy. The leaves
        are full arrays whatever produced them (the reference's elastic
        restore). A CRC mismatch raises ``IOError``; where a leaf of
        ``like`` has a shape and a dtype, the saved leaf must have the
        same ones (``ValueError``: nothing is cast)."""
        dev = resolve_device(device)
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
        for i, (a, ref) in enumerate(zip(arrays, like_leaves)):
            t = torch.from_numpy(a)
            if hasattr(ref, "shape") and hasattr(ref, "dtype") and (
                    tuple(ref.shape) != tuple(t.shape)
                    or _torch_dtype(ref.dtype) != t.dtype):
                raise ValueError(f"checkpoint step {step} leaf {i}: {t.dtype} "
                                 f"{tuple(t.shape)}, the tree wants {ref.dtype} "
                                 f"{tuple(ref.shape)}")
            out.append(t if dev.type == "cpu" else t.to(dev))
            nbytes += a.nbytes
        self._span("read", step, t0, nbytes)
        return step, unflatten(treedef, out)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype

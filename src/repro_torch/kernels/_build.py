"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library lives
under ``build/repro_torch_kernels/<hash of the sources>/`` at the root of
the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), so an edit to any
source builds anew and an unchanged tree loads the cached library.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception. A failed build
raises: there is no fallback.

``LAUNCHES`` counts, per kernel, the launches its wrapper made — the proof
that a run went through the hand kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: dict[str, int] = {"filter_count": 0, "segment_agg": 0,
                            "block_topk": 0, "topk_merge": 0,
                            "merge_join_count": 0, "flash_mha_fwd": 0,
                            "flash_decode": 0, "flash_attention_bwd": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_LOG: str = ""


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global BUILD_LOG
    out = build_dir() / source_hash() / LIB_NAME
    if out.is_file():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            log, _ = p.communicate()
            logs.append(f"== {src.name}\n{log}")
            if p.returncode != 0:
                failed.append(src.name)
        BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp_lib), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            handle.rt_error_string.argtypes = [ctypes.c_int]
            handle.rt_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def function(name: str, argtypes: list, restype=ctypes.c_int):
    """One C entry point of the library, with its argument and result types
    set (every pointer and the stream as ``c_void_p``, or ctypes truncates
    them)."""
    fn = getattr(lib(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().rt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


@functools.cache
def sm_count(device) -> int:
    """The card's streaming multiprocessors (persistent grids size by it)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Wrappers call this on their CUDA path: every operand on one CUDA
    device and contiguous, or raise — a kernel never sees a bad pointer."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: operands must all lie on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")

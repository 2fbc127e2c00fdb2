"""Causal / non-causal GQA flash-attention forward (the model zoo's
attention kernel, run by ``attention_core`` when ``cfg.attn_impl ==
"flash"``).

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py:flash_mha_fwd`` with the hand-written
CUDA kernel ``csrc/flash_attention.cu``: one thread block per (b, h, 64-row
q tile), the KV walk a loop inside it with K/V tiles in shared memory and
the online softmax (m, l, acc) in float32 registers. Both products are the
kernel's own float32 FMAs. See the source's header for its bound on the
H100 and what it leaves for later.

``flash_mha_fwd`` launches the kernel for CUDA tensors and runs
``flash_mha_fwd_plain`` for CPU tensors; it never runs the plain version on
the card. The plain version is the reference's jnp twin
(``repro.kernels.ops._xla_flash_fwd``) in PyTorch: a float32 masked
softmax per q chunk of ``bq`` rows (a memory bound only: rows are
independent), emitting the same (out, lse).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

DEFAULT_BQ = 512
HEAD_DIMS = (16, 32, 64, 128)
NEG = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def flash_mha_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, bq: int = DEFAULT_BQ
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B,H,Sq,D); k, v: (B,KV,Skv,D) -> (out (B,H,Sq,D) in q's dtype,
    lse (B,H,Sq) float32). Causal means qpos >= kpos, both from 0."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(Skv, device=q.device)
    outs, lses = [], []
    for s0 in range(0, Sq, min(bq, Sq)):
        qc = q[:, :, s0:s0 + bq]
        n = qc.shape[2]
        qq = qc.reshape(B, KV, G, n, D).float() * scale
        s = torch.einsum("bkgqd,bksd->bkgqs", qq, kf)
        if causal:
            qpos = torch.arange(s0, s0 + n, device=q.device)
            s = torch.where((qpos[:, None] >= kpos[None, :]), s, NEG)
        mx = s.amax(dim=-1)
        p = torch.exp(s - mx[..., None])
        l = p.sum(dim=-1).clamp_min(1e-30)
        o = torch.einsum("bkgqs,bksd->bkgqd", p, vf) / l[..., None]
        outs.append(o.reshape(B, H, n, D))
        lses.append((mx + torch.log(l)).reshape(B, H, n))
    return torch.cat(outs, dim=2).to(q.dtype), torch.cat(lses, dim=2)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_mha_fwd: q (B,H,Sq,D), k and v (B,KV,Skv,D)")
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"flash_mha_fwd: shapes q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)} do not form GQA")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_mha_fwd: q, k, v all float32 or all bfloat16")
    if Skv == 0:
        raise ValueError("flash_mha_fwd: an empty key sequence")


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel wrapper: same contract as :func:`flash_mha_fwd_plain`.
    The kernel has no q-chunk parameter (its q tile is fixed at 64 rows);
    CPU tensors go through the plain version at its default chunk."""
    _check(q, k, v)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash_mha_fwd: unsupported device {q.device}")
        return flash_mha_fwd_plain(q, k, v, causal=causal)
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_mha_fwd: head dim {D} not in {HEAD_DIMS}")
    if -(-Sq // 64) > 65535:
        raise ValueError(f"flash_mha_fwd: {Sq} queries exceed the grid's "
                         "65535 tiles of 64")
    _build.require_cuda("flash_mha_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.function("fa_flash_fwd", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sq, Skv, D,
            1.0 / math.sqrt(D), int(causal), _build.stream_of(q))
    _build.check(rc, "flash_mha_fwd")
    _build.count_launch("flash_mha_fwd")
    return out, lse

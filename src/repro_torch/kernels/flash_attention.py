"""Causal / non-causal GQA flash-attention forward (the model zoo's
attention kernel, run by ``attention_core`` when ``cfg.attn_impl ==
"flash"``).

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py:flash_mha_fwd`` with the hand-written
CUDA kernels of ``csrc/flash_attention.cu``: one thread block per (b, h,
64-row q tile), the KV walk a loop inside it and the online softmax (m, l,
acc) in float32 registers. bf16 inputs run both products on the tensor
cores (mma.sync over bf16 fragments, float32 accumulators); float32 inputs
run the kernel's own float32 FMAs. See the source's header for its bound on
the H100 and its design.

The kernels take strides: q, k and v may be any views whose last dimension
has stride 1 and whose other strides and base addresses are 16-byte
aligned (:func:`check_layout`), such as the transposed (B,S,H,D)
projections of ``attention_core``. The output is written into a (B,S,H,D)
buffer and returned as its (B,H,S,D) view, so a caller that transposes it
back holds contiguous memory. The wrapper never copies an operand to make
it fit: a layout the kernel cannot take raises.

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
Q_TILE = 64          # q rows per thread block
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


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


def check_layout(*tensors: torch.Tensor, name: str = "flash_mha_fwd") -> None:
    """Raise unless the kernel can read each tensor in place: all on the
    first one's device, a head dim in ``HEAD_DIMS``, a unit last stride,
    and every other stride (of a dim longer than 1) and the base address a
    multiple of 16 bytes (its rows arrive by 16-byte copies). ``name``
    heads the message (the decode kernel takes the same layouts)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands must all lie on {dev}")
        if t.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"{name}: head dim {t.shape[-1]} not in "
                             f"{HEAD_DIMS}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must have stride 1, "
                             f"not {t.stride(-1)}")
        size = t.element_size()
        if any(st * size % 16 for st, n in zip(t.stride()[:-1], t.shape)
               if n > 1):
            raise ValueError(f"{name}: strides {t.stride()} are not "
                             "multiples of 16 bytes")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: base address not 16-byte aligned")


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel wrapper: same contract as :func:`flash_mha_fwd_plain`.
    The kernel has no q-chunk parameter (its q tile is fixed at 64 rows);
    CPU tensors go through the plain version at its default chunk. On the
    card ``out`` is the (B,H,Sq,D) view of a (B,Sq,H,D) buffer."""
    _check(q, k, v)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash_mha_fwd: unsupported device {q.device}")
        return flash_mha_fwd_plain(q, k, v, causal=causal)
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    n_qt = -(-Sq // Q_TILE)
    if q.dtype == torch.float32 and n_qt > 65535:
        raise ValueError(f"flash_mha_fwd: {Sq} float32 queries exceed the "
                         "grid's 65535 tiles of 64")
    if B * H * n_qt >= 2 ** 31:
        raise ValueError(f"flash_mha_fwd: {B * H * n_qt} q tiles exceed the grid")
    check_layout(q, k, v)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    fn = _build.function("fa_flash_fwd", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sq, Skv, D,
            ctypes.addressof(strides), 1.0 / math.sqrt(D), int(causal),
            _build.stream_of(q))
    _build.check(rc, "flash_mha_fwd")
    _build.count_launch("flash_mha_fwd")
    return out, lse

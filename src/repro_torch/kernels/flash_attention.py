"""Causal / non-causal GQA flash attention (the model zoo's attention
kernel, run by ``attention_core`` when ``cfg.attn_impl == "flash"``): the
forward, and the backward ``flash_attention_bwd`` (B7, the gradients the
autograd function ``ops._FlashAttention`` returns in training).

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
independent), emitting the same (out, lse). On "meta" tensors (the
dry-run, ``launch/dryrun.py``) both wrappers return empty meta outputs
with the kernel's shapes, dtypes and strides and launch nothing.
:func:`flash_mha_fwd_cost` and :func:`flash_attention_bwd_cost` give the
operations and the bytes each kernel's work needs: the bound of its row
in ``chip_smoke.py``'s ``kernels`` line and its charge in the cost model
(``launch/hlocost.py``).

The backward's kernels (``csrc/flash_attention_bwd.cu``) recompute the
probabilities from the forward's lse, with no (Sq x Skv) residual. In bf16
they are warp-specialised Hopper kernels: per block one TMA producer
warpgroup streams 64-row tiles through a ring of shared-memory stages and
two consumer warpgroups run every product on ``wgmma``, dq per 128-row q
tile and dk/dv per 128-key tile (no atomics). Its plain version is the
reference's VJP (``repro.kernels.ops._flash_bwd_rule``) in PyTorch,
chunked over q the same way.
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
BWD_TILE = 128       # q rows of a bf16 dq block, keys of a bf16 dk/dv block
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


def flash_mha_fwd_cost(q: torch.Tensor, k: torch.Tensor, *,
                       causal: bool = True) -> dict:
    """The forward's work: 2 products of 2 flops a (q row, key, head dim)
    element, half the pairs under ``causal``; q, k and v read once, out
    (q's bytes) and the float32 lse written once."""
    B, H, Sq, D = q.shape
    pairs = B * H * Sq * k.shape[2] / (2 if causal else 1)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + B * H * Sq * 4
    return {"flops": 2 * 2 * pairs * D, "bytes": nbytes}


def flash_attention_bwd_cost(q: torch.Tensor, k: torch.Tensor, *,
                             causal: bool = True) -> dict:
    """The backward's work: 5 products (S recomputed, dP, dV, dK, dQ), 2.5x
    the forward's flops; q, k, v, out, dO and lse read once, dq, dk and dv
    written once."""
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + q.shape[0] * q.shape[1] * q.shape[2] * 4
    return {"flops": 2.5 * flash_mha_fwd_cost(q, k, causal=causal)["flops"],
            "bytes": nbytes}


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


def layout_problem(t: torch.Tensor) -> str | None:
    """Why the kernels cannot read ``t`` in place, or None: the head dim
    must be in ``HEAD_DIMS`` with a unit stride, and every other stride
    (of a dim longer than 1) and the base address a multiple of 16 bytes
    (rows arrive by 16-byte copies)."""
    if t.shape[-1] not in HEAD_DIMS:
        return f"head dim {t.shape[-1]} not in {HEAD_DIMS}"
    if t.stride(-1) != 1:
        return f"the head dim must have stride 1, not {t.stride(-1)}"
    size = t.element_size()
    if any(st * size % 16 for st, n in zip(t.stride()[:-1], t.shape) if n > 1):
        return f"strides {t.stride()} are not multiples of 16 bytes"
    if t.data_ptr() % 16:
        return "base address not 16-byte aligned"
    return None


def check_layout(*tensors: torch.Tensor, name: str = "flash_mha_fwd") -> None:
    """Raise unless the kernel can read each tensor in place: all on the
    first one's device and no :func:`layout_problem`. ``name`` heads the
    message (the decode kernel takes the same layouts)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands must all lie on {dev}")
        problem = layout_problem(t)
        if problem is not None:
            raise ValueError(f"{name}: {problem}")


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel wrapper: same contract as :func:`flash_mha_fwd_plain`.
    The kernel has no q-chunk parameter (its q tile is fixed at 64 rows);
    CPU tensors go through the plain version at its default chunk. On the
    card ``out`` is the (B,H,Sq,D) view of a (B,Sq,H,D) buffer."""
    _check(q, k, v)
    meta = q.device.type == "meta"
    if not q.is_cuda and not meta:
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
    if meta:
        return out, lse
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


# -- the backward (B7) -------------------------------------------------------

_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, bq: int = DEFAULT_BQ
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The reference's VJP of the flash forward
    (``repro.kernels.ops._flash_bwd_rule``) in PyTorch: the probabilities
    recomputed from the saved ``lse`` per q chunk of ``bq`` rows, float32
    throughout, no (Sq x Skv) residual beyond one chunk's. q, out, do:
    (B,H,Sq,D); k, v: (B,KV,Skv,D); lse: (B,H,Sq) float32. Returns (dq,
    dk, dv) in the dtypes of q, k and v; dk and dv are summed over the
    q chunks and the G = H / KV heads of their KV head."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(Skv, device=q.device)
    dk = torch.zeros((B, KV, Skv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for s0 in range(0, Sq, min(bq, Sq)):
        n = min(bq, Sq - s0)

        def chunk(a):
            return a[:, :, s0:s0 + n].reshape(B, KV, G, n, -1).float()
        qf, of, df = chunk(q), chunk(out), chunk(do)
        lf = lse[:, :, s0:s0 + n].reshape(B, KV, G, n)
        s = torch.einsum("bkgqd,bksd->bkgqs", qf * scale, kf)
        if causal:
            qpos = torch.arange(s0, s0 + n, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG)
        p = torch.exp(s - lf[..., None])
        dp = torch.einsum("bkgqd,bksd->bkgqs", df, vf)
        delta = (df * of).sum(dim=-1)
        ds = p * (dp - delta[..., None])
        dqs.append((torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale)
                   .reshape(B, H, n, D))
        dk += torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
        dv += torch.einsum("bkgqs,bkgqd->bksd", p, df)
    return (torch.cat(dqs, dim=2).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's wrapper (B7), the contract of
    :func:`flash_attention_bwd_plain`: CPU tensors go through the plain
    version, CUDA tensors launch ``csrc/flash_attention_bwd.cu`` (three
    kernels: delta = rowsum(dO.O), dq per (b, h, 128-row q tile), dk and dv
    per (b, kv head, 128-key tile) over the G heads of the group; in bf16
    both on ``wgmma`` fed by TMA; no atomics, so the result is the same bit
    for bit from run to run). q, out, do, k and v are read in place through
    their strides, under the forward's layout rule (:func:`check_layout`);
    ``lse`` must be the contiguous, 16-byte aligned (B,H,Sq) float32 the
    forward wrote. dq is the (B,H,Sq,D)
    view of a (B,Sq,H,D) buffer, dk and dv the (B,KV,Skv,D) views of
    (B,Skv,KV,D) buffers: the layouts of the projections the forward
    read."""
    _check(q, k, v)
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if out.shape != q.shape or do.shape != q.shape or out.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: out and do must match q")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: lse (B,H,Sq) float32")
    meta = q.device.type == "meta"
    if not q.is_cuda and not meta:
        if q.device.type != "cpu":
            raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    check_layout(q, k, v, out, do, name="flash_attention_bwd")
    if lse.device != q.device or not lse.is_contiguous() \
            or lse.data_ptr() % 16:
        raise ValueError("flash_attention_bwd: lse must be contiguous and "
                         f"16-byte aligned, on {q.device}")
    n_qt, n_kt = -(-Sq // BWD_TILE), -(-Skv // BWD_TILE)
    if max(B * H * n_qt, B * KV * n_kt, B * H * Sq) >= 2 ** 31:
        raise ValueError("flash_attention_bwd: the problem exceeds the grid")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((B, Skv, KV, D), dtype=k.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty((B, Skv, KV, D), dtype=v.dtype,
                     device=q.device).transpose(1, 2)
    if meta:
        return dq, dk, dv
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(
        *(st for t in (q, k, v, out, do, dq, dk, dv) for st in t.stride()[:3]))
    fn = _build.function("fa_flash_bwd", _BWD_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sq,
            Skv, D, ctypes.addressof(strides), 1.0 / math.sqrt(D),
            int(causal), _build.stream_of(q))
    _build.check(rc, "flash_attention_bwd")
    _build.count_launch("flash_attention_bwd")
    return dq, dk, dv

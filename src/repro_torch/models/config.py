"""Architecture configuration (a copy of ``repro.models.config``: pure
data, kept here so the port never imports the JAX package).

One frozen dataclass describes every assigned architecture; the per-arch
modules in ``src/repro_torch/configs/`` instantiate it with the exact
published numbers. ``reduced()`` derives the small same-family config used
by the CPU tests. The execution fields below name the reference's XLA
choices; the port reads ``attn_impl``, ``chunk_q`` and the shape fields.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int = 64
    top_k: int = 6
    num_shared: int = 2
    d_ff_expert: int = 1408
    capacity_factor: float = 1.25
    first_dense_layers: int = 1  # DeepSeek-MoE: layer 0 keeps a dense FFN
    aux_loss_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sliding_window: int = 0  # 0 = full attention

    moe: Optional[MoESpec] = None

    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_lora: int = 64  # decay-LoRA rank (data-dependent decay, Finch)

    # mamba2 / zamba2 hybrid
    ssm_state: int = 0  # N; 0 = no SSM blocks
    ssm_head_dim: int = 64  # P
    ssm_expand: int = 2
    attn_every: int = 0  # zamba2: shared attention block every k SSM blocks

    # whisper (enc-dec): encoder layers + fixed frame count (stub frontend)
    enc_layers: int = 0
    enc_len: int = 1500

    # llava (vlm): projected patch-embedding prefix (stub anyres frontend)
    num_patches: int = 0
    patch_dim: int = 1024

    # execution
    chunk_q: int = 512  # query-block size for the memory-blocked attention
    loss_chunk: int = 2048  # sequence-chunked cross entropy
    scan_layers: bool = True
    remat: bool = True
    # 0 = flat layer scan (one remat per layer: saves L carries). N>0 = nested
    # scan of N checkpointed segments × L/N inner layers: saves N + L/N
    # carries at ~ one extra forward of recompute (§Perf memory-peak fix)
    remat_segments: int = 0
    # Megatron-style sequence parallelism: residual-stream activations (and
    # therefore every remat carry) shard their sequence dim over "model" —
    # ÷TP on activation memory; GSPMD turns the TP psum into
    # reduce-scatter + all-gather around each block (§Perf)
    seq_parallel: bool = False
    # attention implementation: "blocked" (baseline: XLA chunked softmax,
    # prob residuals stacked for backward) | "flash" (kernels/ops custom_vjp:
    # O(S) residuals, probs recomputed in backward — §Perf iteration)
    attn_impl: str = "blocked"
    # decode KV-cache write: "onehot" (baseline: masked elementwise rewrite of
    # the whole cache — sharding-trivial but 2 extra full-cache passes) |
    # "dus" (in-place dynamic_update_slice on the donated cache — §Perf)
    decode_cache_update: str = "onehot"
    # dtype the FSDP all-gather moves MoE expert weights in: "f32" (baseline,
    # params' storage dtype on the wire) | "bf16" (cast before gather; halves
    # the dominant EP collective — §Perf)
    moe_gather_dtype: str = "f32"
    # cast f32 master params to bf16 ONCE at step entry (on the local shard)
    # so every FSDP weight all-gather moves bf16, not f32 — vs the baseline's
    # per-use .astype, which GSPMD places after the gather (§Perf)
    cast_params_once: bool = False
    # dtype served weights are STORED in ("f32" | "bf16"): serving from a
    # bf16 checkpoint halves the per-token parameter read — the dominant
    # decode-cell traffic (§Perf iteration C2)
    serve_params_dtype: str = "f32"
    # which cache dim the TP axis shards at decode: "seq" (baseline) |
    # "head" (in-place DUS cache writes; see registry.cache_pspecs — §Perf)
    cache_shard_dim: str = "seq"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))

    # -- derived -------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "rwkv"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §6)."""
        return self.family in ("rwkv", "hybrid")

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    def n_params(self) -> int:
        """Total parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hq = self.n_heads * self.d_head
        hkv = self.n_kv_heads * self.d_head
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "rwkv":
            # r/k/v/g/o projections + decay LoRA + channel-mix (ffn)
            per_layer = 5 * d * d + d * self.rwkv_lora * 2 + 2 * d * f + 2 * d
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            H = di // self.ssm_head_dim
            n_inv = (L + self.attn_every - 1) // max(self.attn_every, 1)
            per_layer = d * (2 * di + 2 * self.ssm_state + H) + di * d
            shared = (2 * d) * (hq + 2 * hkv) + hq * d  # concat(h, emb) input
            shared += 3 * d * f + n_inv * d * d          # shared MLP + inv projs
            return emb + L * per_layer + shared + d
        else:
            attn = d * (hq + 2 * hkv) + hq * d
            if self.moe is not None:
                fe = self.moe.d_ff_expert
                ffn = self.moe.num_experts * 3 * d * fe + self.moe.num_shared * 3 * d * fe
                ffn += d * self.moe.num_experts  # router
                dense_ffn = 3 * d * f
                per_layer = attn + ffn
                extra = self.moe.first_dense_layers * (dense_ffn - ffn)
                return emb + L * per_layer + extra + d
            ffn = 3 * d * f if self.family != "encdec" else 2 * d * f
            per_layer = attn + ffn
            if self.family == "encdec":
                per_layer += attn  # decoder cross-attention
        total = emb + L * per_layer + d
        if self.family == "encdec":
            total += self.enc_layers * (d * (hq + 2 * hkv) + hq * d + 2 * d * f)
        if self.family == "vlm":
            total += self.patch_dim * d  # patch projector
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: 6·N_active·D)."""
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        fe = self.moe.d_ff_expert
        hq = self.n_heads * self.d_head
        hkv = self.n_kv_heads * self.d_head
        attn = d * (hq + 2 * hkv) + hq * d
        active_ffn = (self.moe.top_k + self.moe.num_shared) * 3 * d * fe + d * self.moe.num_experts
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + active_ffn) + d

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-smoke",
            family=self.family,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            d_head=16,
            qkv_bias=self.qkv_bias,
            qk_norm=self.qk_norm,
            tie_embeddings=self.tie_embeddings,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            rwkv_head_dim=16,
            rwkv_lora=8,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_expand=self.ssm_expand,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_len=8 if self.enc_layers else 1500,
            num_patches=4 if self.num_patches else 0,
            patch_dim=32 if self.num_patches else 1024,
            chunk_q=8,
            loss_chunk=16,
        )
        if self.moe is not None:
            # capacity_factor=8: dropless at smoke scale so serve-consistency
            # tests are exact (capacity drops vary with batch composition)
            kw["moe"] = MoESpec(num_experts=4, top_k=2, num_shared=1, d_ff_expert=32,
                                first_dense_layers=self.moe.first_dense_layers,
                                capacity_factor=8.0)
        return ArchConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason when skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention; this arch is full-attention (skip noted in DESIGN.md)"
    return True, ""

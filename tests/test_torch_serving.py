"""Serving on the port against the JAX reference, at the reduced configs:
replays of tests/test_serving_paths.py on the port and against the
reference's numbers, the kernels each family's prefill and decode reach
under ``attn_impl="flash"``, the greedy steps of ``models/steps.py``, and
``launch/serve.py`` end to end. (The recurrences, the MoE dispatch,
``decode_attention`` and the layers: tests/test_torch_recurrences.py.)

Inputs are drawn with numpy and handed to both packages; weights are the
ones ``test_torch_families.ref_params`` draws (the reference's pytree
layout, carried into the port by ``from_jax``). Tolerances, each stated
where it is used: bf16 paths 5e-2 (XLA and PyTorch round bf16 at other
places), float32 recurrences 1e-4 (the reference's own bound between
chunked and sequential forms), the one-hot and slice cache writes bit for
bit (both put the same values in the same slots).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_api as jget_api
from repro.models.registry import prefill_cache_len as jprefill_cache_len
from repro.models.steps import make_prefill_step as jmake_prefill_step
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import steps
from repro_torch.models.convert import from_jax
from repro_torch.models.registry import get_api, prefill_cache_len
from test_torch_families import (FAMILY_ARCH, TOL, batches, cfgs, close,
                                 ref_params)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16 = TOL["bfloat16"]


def _both(arch: str, **kw):
    """(jcfg, tcfg, reference params as jnp, port model) for ``arch``."""
    jcfg, tcfg = cfgs(arch, **kw)
    params = ref_params(jcfg)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, params),
            from_jax(params, tcfg, device="cpu"))


def _jit_api(jcfg):
    api = jget_api(jcfg)
    return (jax.jit(lambda p, b, n: api.prefill(p, b, jcfg, n), static_argnums=2),
            jax.jit(lambda p, c, t: api.decode(p, c, t, jcfg)))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


# -- replays of tests/test_serving_paths.py ----------------------------------------


def test_hybrid_ring_buffer_wraps_correctly():
    """W = 8 and 21 tokens: prefill 12, then 9 teacher-forced decode steps
    (positions 12..20 overwrite ring slots) give prefill(21)'s last logits
    (the reference's bound, 0.1), and the port's decode logits and wrapped
    ring equal the reference's (bf16, 5e-2)."""
    jcfg, tcfg, jp, model = _both("zamba2-1.2b", sliding_window=8)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (1, 21)).astype(np.int32)
    tt = torch.from_numpy(toks)
    api = get_api(tcfg)
    with torch.no_grad():
        _, full = api.prefill(model, {"tokens": tt}, tcfg, 24)
        cache, _ = api.prefill(model, {"tokens": tt[:, :12]}, tcfg, 24)
        for t in range(12, 21):
            cache, dec = api.decode(model, cache, tt[:, t:t + 1], tcfg)
    assert float((full[:, -1] - dec[:, -1]).abs().max()) < 0.1
    jpre, jdec = _jit_api(jcfg)
    jc, _ = jpre(jp, {"tokens": jnp.asarray(toks[:, :12])}, 24)
    for t in range(12, 21):
        jc, jlog = jdec(jp, jc, jnp.asarray(toks[:, t:t + 1]))
    close(dec, jlog, BF16, what="logits after the wrap")
    for key in ("attn_k", "attn_v", "conv", "state"):
        close(cache[key], _np(jc[key]), BF16, what=key)
    assert int(cache["pos"]) == int(jc["pos"]) == 21


def test_rwkv_long_decode_state_stable():
    """50 greedy decode steps: the port's logits stay finite and its state
    bounded (< 1e4, the reference's bound); teacher-forced on the
    reference's 50 tokens, the port's last logits and state equal the
    reference's (bf16 compute, 5e-2)."""
    jcfg, tcfg, jp, model = _both("rwkv6-1.6b")
    api = get_api(tcfg)
    cache = api.make_cache(tcfg, 1, 8, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    forced = api.make_cache(tcfg, 1, 8, device="cpu")
    _, jdec = _jit_api(jcfg)
    jc = jget_api(jcfg).make_cache(jcfg, 1, 8)
    jtok = jnp.zeros((1, 1), jnp.int32)
    with torch.no_grad():
        for _ in range(50):
            cache, logits = api.decode(model, cache, tok, tcfg)
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            forced, flog = api.decode(model, forced,
                                      torch.from_numpy(np.array(jtok)), tcfg)
            jc, jlog = jdec(jp, jc, jtok)
            jtok = jnp.argmax(jlog[:, -1:], -1).astype(jnp.int32)
    assert bool(torch.isfinite(logits).all())
    assert float(cache["att_state"].abs().max()) < 1e4
    close(flog, jlog, BF16, what="logits after 50 steps")
    close(forced["att_state"], _np(jc["att_state"]), BF16, what="state")


def test_moe_decode_capacity_floor_no_crash():
    """A decode batch of one token (T*k << E): the capacity floor keeps it
    finite, and its logits equal the reference's."""
    jcfg, tcfg, jp, model = _both("deepseek-moe-16b")
    api = get_api(tcfg)
    with torch.no_grad():
        cache, _ = api.prefill(model, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                               tcfg, 8)
        cache, logits = api.decode(model, cache, torch.zeros((1, 1), dtype=torch.int32),
                                   tcfg)
    assert bool(torch.isfinite(logits).all())
    jpre, jdec = _jit_api(jcfg)
    jc, _ = jpre(jp, {"tokens": jnp.zeros((1, 4), jnp.int32)}, 8)
    _, jlog = jdec(jp, jc, jnp.zeros((1, 1), jnp.int32))
    close(logits, jlog, BF16)


def test_whisper_cross_attention_consistency():
    """Decode's cross-attention over the cached encoder K / V gives
    prefill's (0.1, the reference's bound), and the port's decode logits
    equal the reference's (5e-2)."""
    jcfg, tcfg, jp, model = _both("whisper-base")
    jb, tb = batches(jcfg, 2, 9)
    api = get_api(tcfg)
    with torch.no_grad():
        _, full = api.prefill(model, tb, tcfg, 12)
        cache, _ = api.prefill(model, dict(tb, tokens=tb["tokens"][:, :8]), tcfg, 12)
        cache, dec = api.decode(model, cache, tb["tokens"][:, 8:9], tcfg)
    assert float((full[:, -1] - dec[:, -1]).abs().max()) < 0.1
    jpre, jdec = _jit_api(jcfg)
    jc, _ = jpre(jp, dict(jb, tokens=jb["tokens"][:, :8]), 12)
    _, jlog = jdec(jp, jc, jb["tokens"][:, 8:9])
    close(dec, jlog, BF16)


@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_decode_cache_update_variants_agree(impl):
    """The one-hot rewrite and the slice write give the same caches and
    logits bit for bit over three decode steps (under flash too); the
    one-hot path's logits equal the reference's (5e-2)."""
    outs = {}
    for mode in ("onehot", "dus"):
        jcfg, tcfg, jp, model = _both("qwen3-1.7b", attn_impl=impl,
                                      decode_cache_update=mode)
        _, tb = batches(tcfg, 2, 12)
        api = get_api(tcfg)
        logs = []
        with torch.no_grad():
            cache, _ = api.prefill(model, tb, tcfg, 16)
            for step in range(3):
                cache, logits = api.decode(
                    model, cache, torch.full((2, 1), step + 1, dtype=torch.int32), tcfg)
                logs.append(logits)
        outs[mode] = (torch.stack(logs), cache)
    assert torch.equal(outs["onehot"][0], outs["dus"][0])
    for key in ("k", "v", "pos"):
        assert torch.equal(outs["onehot"][1][key], outs["dus"][1][key]), key
    jcfg, _, jp, _ = _both("qwen3-1.7b", attn_impl=impl)
    jb, _ = batches(jcfg, 2, 12)
    jpre, jdec = _jit_api(jcfg)
    jc, _ = jpre(jp, jb, 16)
    jc, jlog = jdec(jp, jc, jnp.ones((2, 1), jnp.int32))
    close(outs["onehot"][0][0], jlog, BF16)


def test_flash_impl_serve_matches_blocked():
    """The port's flash prefill (the kernel's plain version here) gives the
    blocked path's logits (5e-2, the reference's bound) and the
    reference's flash prefill's."""
    jcfg, tcfg, jp, model = _both("qwen3-1.7b", attn_impl="flash")
    jb, tb = batches(jcfg, 2, 16)
    api = get_api(tcfg)
    with torch.no_grad():
        _, l_f = api.prefill(model, tb, tcfg, 16)
        _, l_b = api.prefill(model, tb, dataclasses.replace(tcfg, attn_impl="blocked"), 16)
    close(l_f, l_b.numpy(), BF16)
    jpre, _ = _jit_api(jcfg)
    _, jl_f = jpre(jp, jb, 16)
    close(l_f, jl_f, BF16)


@pytest.mark.parametrize("family,prefill,decode", [
    ("dense", "n_layers", "n_layers"), ("moe", "n_layers", "n_layers"),
    ("vlm", "n_layers", "n_layers"), ("encdec", "enc+self", "n_layers"),
    ("hybrid", "invocations", 0), ("rwkv", 0, 0)])
def test_flash_dispatches_per_step(family, prefill, decode):
    """Under ``attn_impl="flash"`` a prefill calls ``flash_attention`` once
    per attention layer that is aligned (whisper's encoder and decoder
    self-attention, not its cross-attention; the hybrid's shared block
    once per invocation) and a decode step ``flash_decode`` once per layer
    that reaches ``decode_attention`` (none for the hybrid's ring or
    RWKV)."""
    _, tcfg = cfgs(FAMILY_ARCH[family], attn_impl="flash")
    want_pre = {"n_layers": tcfg.n_layers, "enc+self": tcfg.enc_layers + tcfg.n_layers,
                "invocations": -(-tcfg.n_layers // max(tcfg.attn_every, 1)),
                0: 0}[prefill]
    want_dec = tcfg.n_layers if decode else 0
    model = from_jax(ref_params(cfgs(FAMILY_ARCH[family])[0]), tcfg, device="cpu")
    _, tb = batches(tcfg, 2, 6)  # whisper: 6 tokens, not aligned with enc_len 8
    api = get_api(tcfg)
    ops.reset_dispatch_counts()
    with torch.no_grad():
        cache, _ = api.prefill(model, tb, tcfg, 12)
        assert ops.DISPATCH_COUNTS.get("flash_attention", 0) == want_pre
        for step in range(2):
            ops.reset_dispatch_counts()
            cache, _ = api.decode(model, cache, tb["tokens"][:, :1], tcfg)
            assert ops.DISPATCH_COUNTS.get("flash_decode", 0) == want_dec


# -- models/steps.py and launch/serve.py -------------------------------------------


@pytest.mark.parametrize("family", ["dense", "moe", "encdec"])
def test_greedy_steps_match_reference(family):
    """``make_prefill_step`` then 7 ``make_decode_step`` calls, teacher-
    forced on the reference's greedy tokens: the port picks the
    reference's token at every step whose top-2 logit margin (in the
    reference) is above 5e-2, the bf16 tolerance; nearer ties may go
    either way."""
    jcfg, tcfg, jp, model = _both(FAMILY_ARCH[family])
    jb, tb = batches(jcfg, 2, 8)
    api = jget_api(jcfg)
    jpre = jax.jit(lambda p, b: api.prefill(p, b, jcfg, 16))
    jdec = jax.jit(lambda p, c, t: api.decode(p, c, t, jcfg))
    jref_pre = jax.jit(jmake_prefill_step(jcfg, api, max_len=16))
    jc, jlog = jpre(jp, jb)
    ref_toks, margins = [], []
    for step in range(8):
        top2 = np.sort(np.asarray(jlog[:, -1]), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(jlog[:, -1], -1).astype(jnp.int32)[:, None]
        ref_toks.append(np.array(tok))
        if step < 7:
            jc, jlog = jdec(jp, jc, tok)
    np.testing.assert_array_equal(np.asarray(jref_pre(jp, jb)[1]), ref_toks[0])
    prefill = steps.make_prefill_step(tcfg, max_len=16)
    decode = steps.make_decode_step(tcfg)
    cache, tok = prefill(model, tb)
    got = [tok.numpy()]
    for step in range(7):
        assert tok.dtype == torch.int32 and tuple(tok.shape) == (2, 1)
        cache, tok = decode(model, cache, torch.from_numpy(ref_toks[step]))
        got.append(tok.numpy())
    got, want, margins = np.stack(got), np.stack(ref_toks), np.stack(margins)
    differ = got[..., 0] != want[..., 0]
    assert not np.any(differ & (margins > BF16)), (got[..., 0], want[..., 0], margins)


def test_registry_helpers_match_reference():
    for arch in FAMILY_ARCH.values():
        jcfg, tcfg = cfgs(arch)
        assert prefill_cache_len(tcfg, 64) == jprefill_cache_len(jcfg, 64)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-base"])
def test_serve_launcher_runs_on_the_cpu(arch):
    """``python -m repro_torch.launch.serve --reduced --device cpu`` for a
    dense model and for whisper: exit 0, the reference's three report
    lines, a continuation of --new-tokens ints."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt", "8",
         "--new-tokens", "4"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert any(l.startswith("prefill 2×8: ") for l in lines), out.stdout
    assert any(l.startswith("decode 3 steps: ") and "tok/s" in l for l in lines)
    cont = [l for l in lines if l.startswith("request 0 continuation: ")]
    assert len(eval(cont[0].split(": ", 1)[1])) == 4


def test_serve_needs_the_card_and_reduces_large_configs_off_it(monkeypatch, capsys):
    """No --device means the card, and without one serve raises; on the
    CPU a config above 5e8 parameters is reduced, as the reference reduces
    it off a TPU. ``generate`` equals driving the steps by hand."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])
    assert serve.main(["--arch", "qwen3-1.7b", "--device", "cpu", "--batch", "1",
                       "--prompt", "4", "--new-tokens", "2"]) == 0
    assert "using reduced config qwen3-1.7b-smoke" in capsys.readouterr().out
    _, tcfg = cfgs("llava-next-mistral-7b")
    model = get_api(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    batch = serve.make_batch(tcfg, 2, 5, np.random.default_rng(0), "cpu")
    out = serve.generate(tcfg, model, batch, 3)
    assert int(out["cache"]["pos"]) == prefill_cache_len(tcfg, 5) + 2
    assert out["cache"]["k"].shape[2] == prefill_cache_len(tcfg, 5) + 3
    cache, tok = steps.make_prefill_step(tcfg, max_len=prefill_cache_len(tcfg, 5) + 3)(
        model, batch)
    toks = [tok]
    for _ in range(2):
        cache, tok = steps.make_decode_step(tcfg)(model, cache, tok)
        toks.append(tok)
    assert torch.equal(out["tokens"], torch.cat(toks, dim=1))



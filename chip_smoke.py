#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # Wisconsin at 5,000,000 rows; the
                                     # model UDF over 32,768 x 128 tokens

Phases (any mismatch raises; nothing is caught):
  1. header — the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (build time is set-up);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths launch, plus block-id lists, -1-padded per-shard
     id lists through the ops (pads mid-list and trailing, pads only),
     segment_agg at an n that is not a multiple of 4, off 16-byte alignment
     and with G x C past shared memory, deliberate ties, duplicate-heavy
     join keys, one join run longer than any shared-memory window, join
     prefixes stopping inside runs, and for the attention kernels (unit-scale
     inputs, a tolerance per row, planted faults refused) the reference's
     sweep shapes (bf16 flash on the model path's strided (B,S,H,D) views
     and on contiguous inputs, D 16-128), GQA at S=1024, a ragged S, B*H
     past 65,535, and decode lengths 0, 1, each side of a slice edge, S,
     and every length = S;
  3. the first slice: the paper's 12 Wisconsin expressions through AFrame →
     Session(mode="kernel"), 3 rounds of randomized literals, held against
     the port's gspmd mode and a numpy oracle (dtypes included), plus two
     clustered ``unique2`` range queries that run the block-skipping paths;
     every relational kernel's launch counter must have moved in this phase;
  4. the second slice: the paper's model-UDF pipeline (Figs. 4-6) with
     paper-lm at full width (attn_impl="flash") registered as a sentiment
     UDF over a 32,768-row token column, in kernel mode: head, count of one
     class, persist + group-by. Held against the direct application of the
     model, numpy, and the port's blocked attention (the reference's
     default); flash_mha_fwd must launch 8 layers x 16 microbatches per
     full pass, segment_agg on the group-by. Then flash_decode's own entry
     point (``ops.flash_decode``, on no model path yet) once;
  5. timings — per expression and per UDF query: host-clock wall time and
     the device time of a torch.profiler trace (the device-busy share);
     rows/s and tokens/s of the UDF count, and its device time per kernel;
     per kernel, the device time of the kernel alone (by name in a profiler
     trace) and of a one-call PyTorch yardstick where one exists (every
     kernel of it in the same kind of trace), each checked by CUDA events
     over back-to-back calls, beside the CUDA-event time of one call of its
     plain version, and the bytes / operations bound (the relational
     kernels on copies of their operands in turn, so that their reads come
     from device memory and not from the L2); segment_agg also at the e8
     shape (G = 20, max), merge_join_count also on the duplicate-heavy
     keys, flash also on contiguous inputs, decode also at the mixed
     lengths (bound on the slots they walk).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the rest of the repository beside it, the script exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor float32 peak (data sheet)
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak (data sheet)
ROUNDS = 3
ROWS = 5_000_000            # the paper's XL size (src/repro/data/wisconsin.py)
RELATIONAL = ("filter_count", "segment_agg", "block_topk", "merge_join_count")
UDF_ROWS = 32_768           # tweets in demo.Tweets
UDF_SEQ = 128               # tokens per tweet: the usual cap for sentence
                            # classification
UDF_MICROBATCH = 2_048      # rows per model call
UDF_LAYERS = 8              # paper-lm (src/repro_torch/configs/paper_lm.py)
# Flash (the CUDA kernel) vs blocked (the plain path) logits of the 3
# classes differ by bf16 rounding in other places — up to a few 1e-2 over
# 8 layers; a row whose top-2 margin is within this may flip its argmax.
MARGIN = 0.1
DECODE_SHAPE = (32, 8, 4096, 64)   # B, H, S, D of the flash_decode checks


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` back-to-back calls: the
    larger of the host's issue time and the device's time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _profile(fn, iters: int) -> list[tuple[str, float, int]]:
    """(name, device µs, records) of every CUDA kernel and copy in a
    torch.profiler trace of ``iters`` calls of ``fn``, after one call in the
    profiler's warm-up step. The trace may miss records: on the H100 one of
    20 calls of a kernel held 15-18 of them, so a per-call time is taken
    per record, and a sum of records is a lower bound. The schedule's
    ``ProfilerStep`` annotation carries the device time of everything in
    its step and is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


def _per_call_ms(fn, kernels: tuple[str, ...] | None = None,
                 iters: int = 20) -> tuple[float, int, dict]:
    """Device ms per call of ``fn`` from a profiler trace of ``iters``
    calls, the fewest records any kernel held, and (given ``kernels``) the
    ms of each named kernel. Each kernel or copy
    (given ``kernels``, those whose name holds one of them) adds the mean of
    its records times its launches per call, its records ÷ ``iters`` rounded
    up: the trace may miss records but adds none, so a kernel launched once
    per call counts once however many records the trace lost. A trace on
    the H100 has held no record at all of a named kernel, so a trace that
    lacks one is taken again; raises if the third still lacks it."""
    for _ in range(3):
        rows = _profile(fn, iters)
        missing = [name for name in kernels or ()
                   if not any(name in key for key, _, _ in rows)]
        if not missing:
            break
    else:
        raise AssertionError(f"no {missing} in 3 profiler traces")
    def per_call(rows):
        return sum(us / n * math.ceil(n / iters) for _, us, n in rows) / 1e3

    parts = {name: per_call([r for r in rows if name in r[0]])
             for name in kernels or ()}
    if kernels is not None:
        rows = [r for r in rows if any(name in r[0] for name in kernels)]
    return per_call(rows), min((n for _, _, n in rows), default=0), parts


def device_ms(fn) -> float | None:
    """Device time of one call of ``fn``: every kernel and copy in its
    profiler trace (a lower bound where the trace misses records). Host
    issue time and idle gaps are not in it. None when the trace holds no
    such event."""
    ms = _per_call_ms(fn, None, 1)[0]
    return ms if ms > 0 else None


def single_call_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of one call of ``fn`` with the stream idle
    before and after it (launch latency included)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def smi_clocks() -> str:
    """The card's SM clock (now / max), power draw and temperature."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                          "power.draw,temperature.gpu", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def same(got, want, label: str) -> None:
    """Equal values and dtypes (dict results), or equal Python scalars."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}: columns {sorted(got)} != {sorted(want)}")
        for k in want:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            if a.dtype != b.dtype:
                raise AssertionError(f"{label}:{k} dtype {a.dtype} != {b.dtype}")
            np.testing.assert_array_equal(a, b, err_msg=f"{label}:{k}")
    elif type(got) is not type(want) or got != want:
        raise AssertionError(f"{label}: {got!r} != {want!r}")


# -- the paper's 12 expressions (literals drawn from rng) ---------------------

def _e3(df, x):
    return len(df[(df["ten"] == x) & (df["twentyPercent"] == x % 5)
                  & (df["two"] == x % 2)])


def _e11(df, a, b):
    return len(df[(df["onePercent"] >= min(a, b)) & (df["onePercent"] <= max(a, b))])


EXPRESSIONS = {
    "1_count": lambda df, dr, rng: len(df),
    "2_project_head": lambda df, dr, rng: df[["two", "four"]].head(),
    "3_filter_count": lambda df, dr, rng: _e3(df, int(rng.integers(10))),
    "4_group_count": lambda df, dr, rng: df.groupby("oddOnePercent").agg("count"),
    "5_map_head": lambda df, dr, rng: df["stringu1"].map(str.upper).head(),
    "6_max": lambda df, dr, rng: df["unique1"].max(),
    "7_min": lambda df, dr, rng: df["unique1"].min(),
    "8_group_max": lambda df, dr, rng: df.groupby("twenty")["four"].agg("max"),
    "9_sort_head": lambda df, dr, rng: df.sort_values("unique1", ascending=False).head(),
    "10_select_head": lambda df, dr, rng: df[df["ten"] == int(rng.integers(10))].head(),
    "11_range_count": lambda df, dr, rng: _e11(df, int(rng.integers(100)),
                                               int(rng.integers(100))),
    "12_join_count": lambda df, dr, rng: len(df.merge(dr, left_on="unique1",
                                                      right_on="unique1")),
}


def _groups(keys: np.ndarray, vals: np.ndarray | None, op: str) -> tuple:
    k, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    if op == "count":
        return k, counts.astype(np.int32)
    out = np.full(len(k), np.iinfo(vals.dtype).min, vals.dtype)
    np.maximum.at(out, inv, vals)
    return k, out


def oracle(raw: dict, name: str, rng):
    """numpy answers in the engine's result form (as the benchmark's
    NumpyEager variant computes them, benchmarks/wisconsin_bench.py)."""
    if name == "1_count":
        return len(raw["unique1"])
    if name == "2_project_head":
        return {k: raw[k][:5] for k in ("two", "four")}
    if name == "3_filter_count":
        x = int(rng.integers(10))
        return int(((raw["ten"] == x) & (raw["twentyPercent"] == x % 5)
                    & (raw["two"] == x % 2)).sum())
    if name == "4_group_count":
        k, c = _groups(raw["oddOnePercent"], None, "count")
        return {"oddOnePercent": k, "count": c}
    if name == "5_map_head":
        col = raw["stringu1"][:5]
        return {"stringu1": np.where((col >= 97) & (col <= 122), col - 32, col)
                .astype(np.uint8)}
    if name == "6_max":
        return int(raw["unique1"].max())
    if name == "7_min":
        return int(raw["unique1"].min())
    if name == "8_group_max":
        k, m = _groups(raw["twenty"], raw["four"], "max")
        return {"twenty": k, "max_four": m}
    if name == "9_sort_head":
        order = np.argsort(-raw["unique1"].astype(np.int64), kind="stable")[:5]
        return {k: v[order] for k, v in raw.items()}
    if name == "10_select_head":
        rows = np.nonzero(raw["ten"] == int(rng.integers(10)))[0][:5]
        return {k: v[rows] for k, v in raw.items()}
    if name == "11_range_count":
        a, b = int(rng.integers(100)), int(rng.integers(100))
        lo, hi = min(a, b), max(a, b)
        return int(((raw["onePercent"] >= lo) & (raw["onePercent"] <= hi)).sum())
    if name == "12_join_count":
        r = np.sort(raw["unique1"])
        lk = raw["unique1"]
        return int((np.searchsorted(r, lk, "right") - np.searchsorted(r, lk, "left")).sum())
    raise KeyError(name)


# -- phase 2: kernels against their plain versions ------------------------------

def check_kernels(raw: dict, dev) -> dict:
    """Every kernel vs its plain version on the card; returns per-kernel
    inputs at the main-path shape plus the largest error seen."""
    import torch

    from repro_torch.kernels import filter_count as fc
    from repro_torch.kernels import merge_join as mj
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import topk_mask as tk

    t = {k: torch.from_numpy(v).to(dev) for k, v in raw.items() if v.ndim == 1}
    n = len(raw["unique1"])
    rng = np.random.default_rng(7)
    cases: dict = {}

    def exact(label, got, want):
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"{label}: kernel {g} != plain {w}")
        print(f"  {label}: exact", flush=True)

    # filter_count: expression 3 (3 columns), expression 11 (1 column), and a
    # clustered unique2 range with its surviving block list
    mat3 = torch.stack([t["ten"], t["twentyPercent"], t["two"]])
    b3 = torch.tensor([[4, 4], [4, 4], [0, 0]], dtype=torch.int32, device=dev)
    exact("filter_count e3", fc.filter_count(mat3, b3, n),
          fc.filter_count_plain(mat3, b3, n))
    mat1 = t["onePercent"][None].contiguous()
    b1 = torch.tensor([[17, 58]], dtype=torch.int32, device=dev)
    exact("filter_count e11", fc.filter_count(mat1, b1, n),
          fc.filter_count_plain(mat1, b1, n))
    lo2, hi2 = n // 3, n // 3 + min(50_000, n // 10)
    ids = tuple(range(lo2 // fc.BLOCK, hi2 // fc.BLOCK + 1))
    mat2 = t["unique2"][None].contiguous()
    b2 = torch.tensor([[lo2, hi2]], dtype=torch.int32, device=dev)
    exact("filter_count block_ids", fc.filter_count(mat2, b2, n, block_ids=ids),
          fc.filter_count_plain(mat2, b2, n, block_ids=ids))
    cases["filter_count"] = dict(args=(mat3, b3, n), k=3, n=n)

    # segment_agg: expression 4 (count over 199 groups), expression 8 (count
    # and max over 20 groups), block ids, and non-integer data
    gid4 = (t["oddOnePercent"] - 1).to(torch.int32)
    ones = torch.ones((n, 1), dtype=torch.float32, device=dev)
    exact("segment_agg e4 sum", sa.segment_agg(ones, gid4, 199, n),
          sa.segment_agg_plain(ones, gid4, 199, n))
    gid8 = t["twenty"].to(torch.int32)
    four = t["four"].to(torch.float32)[:, None].contiguous()
    exact("segment_agg e8 max", sa.segment_agg(four, gid8, 20, n, op="max"),
          sa.segment_agg_plain(four, gid8, 20, n, op="max"))
    exact("segment_agg min", sa.segment_agg(four, gid8, 20, n - 999, op="min"),
          sa.segment_agg_plain(four, gid8, 20, n - 999, op="min"))
    multi = torch.stack([torch.ones(n, device=dev), t["four"].float(),
                         t["twenty"].float()], dim=1)
    gid10 = torch.where(t["unique2"] % 7 == 0, -1, t["ten"]).to(torch.int32)
    sids = ops._expand_block_ids(ids, ops.ZONE_BLOCK_ROWS, sa.BLOCK, n)
    exact("segment_agg multi-column, dead rows, block_ids",
          sa.segment_agg(multi, gid10, 10, n, block_ids=sids),
          sa.segment_agg_plain(multi, gid10, 10, n, block_ids=sids))
    normal = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32)).to(dev)
    got = sa.segment_agg(normal, gid4, 199, n)
    want = sa.segment_agg_plain(normal, gid4, 199, n)
    # float32 sums in two orders: within 1e-5 of each group's sum of |x|
    sum_abs = sa.segment_agg_plain(normal.abs(), gid4, 199, n)
    sa_err = float((got - want).abs().max())
    if not bool(((got - want).abs() <= 1e-5 * sum_abs + 1e-3).all()):
        raise AssertionError(f"segment_agg normal data: max abs err {sa_err}")
    print(f"  segment_agg normal data: max abs err {sa_err} "
          f"(tolerance 1e-5 * group sum|x| + 1e-3)", flush=True)
    # the ragged tail (n not a multiple of 4), operands off 16-byte
    # alignment (4-byte loads), G x C past a copy per lane (a copy per warp)
    # and past shared memory (the global path)
    m = n - 3
    exact(f"segment_agg n={m}, max", sa.segment_agg(four[:m], gid8[:m], 20, m, op="max"),
          sa.segment_agg_plain(four[:m], gid8[:m], 20, m, op="max"))
    exact("segment_agg off 16-byte alignment",
          sa.segment_agg(ones[1:], gid4[1:], 199, n - 1),
          sa.segment_agg_plain(ones[1:], gid4[1:], 199, n - 1))
    for G, where in ((1_000, "a copy per warp"), (100_000, "past shared memory")):
        gid_g = (t["unique1"] % G).to(torch.int32)
        for op in ("sum", "max"):
            exact(f"segment_agg G={G:,} x C=3 ({where}), {op}",
                  sa.segment_agg(multi, gid_g, G, n, op=op),
                  sa.segment_agg_plain(multi, gid_g, G, n, op=op))
    # -1-padded per-shard id lists through the ops (their only entry point
    # until the multi-device layer): pads mid-list and trailing, pads only
    pads = torch.full((3,), -1, dtype=torch.int32, device=dev)
    farr = torch.tensor([ids[0], -1, *ids[1:], -1, -1], dtype=torch.int32, device=dev)
    sarr = torch.tensor([sids[0], -1, *sids[1:], -1, -1], dtype=torch.int32, device=dev)
    for label, fa_, sa_ in (("pads mid-list and trailing", farr, sarr),
                            ("pads only", pads, pads)):
        exact(f"ops.filter_count block_ids_arr, {label}",
              ops.filter_count(mat2, b2, n, block_ids_arr=fa_),
              fc.filter_count_plain(mat2, b2, n, block_ids_arr=fa_))
        for op in ("sum", "max", "min"):
            exact(f"ops.segment_agg block_ids_arr, {label}, {op}",
                  ops.segment_agg(multi, gid10, 10, n - 5, op, block_ids_arr=sa_),
                  sa.segment_agg_plain(multi, gid10, 10, n - 5, op,
                                       block_ids_arr=sa_))
    cases["segment_agg"] = dict(args=(ones, gid4, 199, n), op="sum")
    cases["segment_agg_e8"] = dict(args=(four, gid8, 20, n), op="max")

    # block_topk: expression 9 (unique1, all live), deliberate ties with a
    # random mask, and a block with fewer than k live rows
    s9 = t["unique1"].to(torch.float32)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    sparse = torch.zeros(n, dtype=torch.bool, device=dev)
    sparse[::5000] = True
    ties = t["ten"].to(torch.float32)
    tmask = torch.from_numpy(rng.random(n) > 0.3).to(dev)
    for label, args in [("e9", (s9, live, n, 5)),
                        ("ties", (ties, tmask, n - 77, 8)),
                        ("<k live rows", (s9, sparse, n, 5))]:
        v, i = tk.block_topk(*args)
        pv, pi = tk.block_topk_plain(*args)
        exact(f"block_topk {label} values", v, pv)
        exact(f"block_topk {label} indices", i, pi)
    cases["block_topk"] = dict(args=(s9, live, n, 5), n=n, k=5)

    # merge_join_count: expression 12 (unique keys; each side sorted into a
    # buffer of its own, as the compiler does) and duplicate-heavy keys
    ls = ops.sort_join_keys(t["unique1"], live)
    rs = ops.sort_join_keys(t["unique1"], live)
    nl = live.sum(dtype=torch.int32)
    exact("merge_join_count e12", mj.merge_join_count(ls, rs, nl, nl),
          mj.merge_join_count_plain(ls, rs, nl, nl))
    dup = ops.sort_join_keys(t["unique1"] % 50_000, live)
    dmask = torch.from_numpy(rng.random(n) > 0.5).to(dev)
    dup_r = ops.sort_join_keys(t["unique2"] % 40_000, dmask)
    nr = dmask.sum(dtype=torch.int32)
    exact("merge_join_count duplicates", mj.merge_join_count(dup, dup_r, nl, nr),
          mj.merge_join_count_plain(dup, dup_r, nl, nr))
    # one run longer than any shared-memory window (7e10 pairs: the int32
    # result wraps, as the plain version's int32 sum does), and prefixes
    # that stop inside runs and inside a left tile
    eq = torch.full((1_000_000,), 5, dtype=torch.int32, device=dev)
    exact("merge_join_count all keys equal", mj.merge_join_count(eq, eq[:70_000], 1_000_000, 70_000),
          mj.merge_join_count_plain(eq, eq[:70_000], 1_000_000, 70_000))
    runs = torch.sort(t["unique1"] % 300).values.to(torch.int32)
    cut_l, cut_r = n - 12_345, n // 5 + 3
    if cut_l % mj.tile() == 0 or runs[cut_l - 1] != runs[cut_l] \
            or runs[cut_r - 1] != runs[cut_r]:
        raise AssertionError("the prefixes must stop inside runs and a tile")
    exact("merge_join_count prefixes cutting runs",
          mj.merge_join_count(runs, runs, cut_l, cut_r),
          mj.merge_join_count_plain(runs, runs, cut_l, cut_r))
    cases["merge_join_count"] = dict(args=(ls, rs, nl, nl), n=n)
    cases["merge_join_dup"] = dict(args=(dup, dup_r, nl, nr), n=n)
    torch.cuda.synchronize()
    return cases


# -- phase 3: the slice ----------------------------------------------------------

def run_slice(table, raw: dict, dev) -> dict:
    import torch

    from repro_torch.core import physical as PH
    from repro_torch.core.catalog import Catalog
    from repro_torch.core.frame import AFrame
    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build

    catalog = Catalog()
    sessions = {m: Session(mode=m, device=dev, catalog=catalog)
                for m in ("kernel", "gspmd")}
    t0 = time.perf_counter()
    for name in ("data", "data_r"):
        sessions["kernel"].create_dataset(name, table, dataverse="bench")
    torch.cuda.synchronize()
    print(f"  datasets placed on {dev} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    def frames(m):
        s = sessions[m]
        return AFrame("bench", "data", session=s), AFrame("bench", "data_r", session=s)

    _build.reset_launches()
    physical, per_expr = {}, {}
    for name, fn in EXPRESSIONS.items():
        before = dict(_build.LAUNCHES)
        for r in range(ROUNDS):
            want = oracle(raw, name, np.random.default_rng(100 + r))
            for m in ("kernel", "gspmd"):
                got = fn(*frames(m), np.random.default_rng(100 + r))
                same(got, want, f"{name}[{m}] round {r}")
        physical[name] = type(sessions["kernel"].last_physical).__name__
        per_expr[name] = {k: (v - before[k]) // ROUNDS
                          for k, v in _build.LAUNCHES.items() if v > before[k]}
        print(f"  {name}: kernel == gspmd == numpy over {ROUNDS} rounds "
              f"({physical[name]}; kernel launches per run {per_expr[name]})",
              flush=True)

    # clustered unique2 ranges: the block-skipping kernel grids
    n = len(raw["unique2"])
    for r in range(ROUNDS):
        rng = np.random.default_rng(200 + r)
        width = min(300_000, n // 10)
        a = int(rng.integers(n - width))
        b = a + int(rng.integers(1, width))
        sel = (raw["unique2"] >= a) & (raw["unique2"] <= b)
        k_ten, c_ten = _groups(raw["ten"][sel], None, "count")
        plans = {}
        for m in ("kernel", "gspmd"):
            df, _ = frames(m)
            rows = df[(df["unique2"] >= a) & (df["unique2"] <= b)]
            same(len(rows), int(sel.sum()), f"unique2 range count[{m}] {r}")
            plans[m] = [sessions[m].last_physical]
            same(rows.groupby("ten").agg("count"), {"ten": k_ten, "count": c_ten},
                 f"unique2 range group count[{m}] {r}")
            plans[m].append(sessions[m].last_physical)
        cnt_plan, grp_plan = plans["kernel"]
        if not (isinstance(cnt_plan, PH.KernelRangeCount) and cnt_plan.block_ids
                and isinstance(grp_plan, PH.KernelSegmentAgg)
                and grp_plan.comp_blocks[0] is not None):
            raise AssertionError("clustered ranges did not take the block-skipping "
                                 "kernel paths")
    print(f"  unique2 ranges: block-skipping filter_count and segment_agg "
          f"({cnt_plan.blocks_scanned}/{cnt_plan.blocks_total} blocks in the "
          f"last round)", flush=True)
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in RELATIONAL}
    print(f"  kernel launches on the main path: {launches}", flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    def runner(fn, m):
        return lambda: fn(*frames(m), np.random.default_rng(1))

    # every wall time first: a profiler session left behind must not slow
    # the host clock runs
    times = {name: {m: {"wall_ms": host_ms(runner(fn, m))}
                    for m in ("kernel", "gspmd")}
             for name, fn in EXPRESSIONS.items()}
    for name, fn in EXPRESSIONS.items():
        for m, t in times[name].items():
            t["device_ms"] = device_ms(runner(fn, m))
            t["busy"] = None if t["device_ms"] is None \
                else t["device_ms"] / t["wall_ms"]
    return {"launches": launches, "per_expr": per_expr, "physical": physical,
            "expr_ms": times}


# -- phase 2 (attention): the model zoo's kernels against their plain versions --

def check_attention_kernels(dev) -> dict:
    """flash_mha_fwd and flash_decode vs their plain versions on the card:
    at the model-UDF path's shape, the reference's sweep shapes, GQA at
    S=1024, a ragged S, and decode at B=32, S=4096 with lengths 0, 1, S.
    Returns the main-shape inputs and the largest error seen per kernel."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(8)
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    errs = {"flash_mha_fwd": 0.0, "flash_decode": 0.0}

    # unit-variance inputs, as the projections give after RMS norm: the
    # scores (std 1 after the 1/sqrt(D) scale) then matter to the output
    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def row_close(got, want, t) -> bool:
        """|got - want| <= t * (|want| + the row's largest |want|): an
        attention output is a weighted mean of V, its scale falls with the
        length, so each row is held to its own."""
        g, w = got.float(), want.float()
        bound = t * (w.abs() + w.abs().amax(dim=-1, keepdim=True))
        return bool(torch.isfinite(g).all()) and bool(((g - w).abs() <= bound).all())

    def close(name, label, got, want, t, plain):
        """Kernel vs plain within ``t``; and the same check must refuse the
        plain version run on planted faults — q taken from the neighbouring
        head, and q = 0 (scores skipped) — or it could not see such a
        kernel fault."""
        err = float((got.float() - want.float()).abs().max())
        if not row_close(got, want, t):
            raise AssertionError(f"{name} {label}: kernel vs plain max abs err "
                                 f"{err} beyond {t} x row scale")
        for fault, bad in (("wrong q head", plain(lambda q: q.roll(1, dims=1))),
                           ("q = 0", plain(torch.zeros_like))):
            if row_close(bad, want, t):
                raise AssertionError(f"{name} {label}: the check passes a planted "
                                     f"fault ({fault})")
        errs[name] = max(errs[name], err)
        print(f"  {name} {label}: max abs err {err:.3g} (tolerance {t} x row "
              f"scale; planted faults refused)", flush=True)

    def flash(label, B, H, KV, S, D, dtype, causal, strided=False):
        if strided:  # the model path's layout: (B,H,S,D) views of (B,S,H,D)
            q = rand((B, S, H, D), dtype).transpose(1, 2)
            k, v = (rand((B, S, KV, D), dtype).transpose(1, 2) for _ in range(2))
        else:
            q = rand((B, H, S, D), dtype)
            k, v = rand((B, KV, S, D), dtype), rand((B, KV, S, D), dtype)
        out, lse = fa.flash_mha_fwd(q, k, v, causal=causal)
        pout, plse = fa.flash_mha_fwd_plain(q, k, v, causal=causal)
        close("flash_mha_fwd", f"{label} out", out, pout, tol[dtype],
              lambda f: fa.flash_mha_fwd_plain(f(q), k, v, causal=causal)[0])
        err = float((lse - plse).abs().max())
        if not bool(torch.isclose(lse, plse, rtol=tol[dtype], atol=tol[dtype]).all()):
            raise AssertionError(f"flash_mha_fwd {label} lse: max abs err {err}")
        errs["flash_mha_fwd"] = max(errs["flash_mha_fwd"], err)
        return q, k, v

    # the model-UDF path: one call per layer and microbatch, on the layout
    # attention_core hands over, then on contiguous inputs
    main = flash(f"main path ({UDF_MICROBATCH}, 8, {UDF_SEQ}, 64) bf16 causal, "
                 "strided (B,S,H,D) views", UDF_MICROBATCH, 8, 8, UDF_SEQ, 64,
                 torch.bfloat16, True, strided=True)
    contiguous = flash(f"main shape ({UDF_MICROBATCH}, 8, {UDF_SEQ}, 64) bf16 "
                       "causal, contiguous", UDF_MICROBATCH, 8, 8, UDF_SEQ, 64,
                       torch.bfloat16, True)
    for B, H, KV, S, D in [(1, 2, 2, 128, 16), (2, 4, 2, 256, 32),
                           (1, 8, 1, 64, 64), (2, 4, 2, 192, 128)]:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                flash(f"sweep ({B},{H},{KV},{S},{D}) {str(dtype)[6:]} "
                      f"causal={causal}", B, H, KV, S, D, dtype, causal)
        flash(f"sweep ({B},{H},{KV},{S},{D}) bf16 causal, strided", B, H, KV,
              S, D, torch.bfloat16, True, strided=True)
    flash("GQA S=1024 bf16 causal", 4, 8, 2, 1024, 64, torch.bfloat16, True)
    flash("GQA S=1024 D=128 f32", 2, 8, 2, 1024, 128, torch.float32, False)
    flash("ragged S=1000 bf16 causal, strided", 3, 8, 8, 1000, 64,
          torch.bfloat16, True, strided=True)
    flash("ragged S=77 D=128 bf16, strided", 2, 4, 2, 77, 128, torch.bfloat16,
          False, strided=True)
    flash("ragged S=77 f32", 2, 4, 2, 77, 32, torch.float32, False)
    flash("B*H = 65,600 (past one grid dimension), strided", 8200, 8, 8, 16,
          16, torch.bfloat16, True, strided=True)

    B, H, S, D = DECODE_SHAPE
    decode = {}
    for KV in (8, 2):
        split = da.split_size(B, KV, S)
        for dtype in (torch.bfloat16, torch.float32):
            q = rand((B, H, D), dtype)
            k, v = rand((B, KV, S, D), dtype), rand((B, KV, S, D), dtype)
            mixed = torch.randint(2, S, (B,), generator=gen, device=dev,
                                  dtype=torch.int32)
            edges = [0, 1, split - 1, split, split + 1, S - 1, S, 2 * split + 1]
            mixed[:len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)
            full = torch.full((B,), S, dtype=torch.int32, device=dev)
            for label, lens in (("0/1/slice edges/S/random", mixed),
                                ("all S", full)):
                got = da.flash_decode(q, k, v, lens)
                close("flash_decode", f"(B={B}, H={H}, KV={KV}, S={S}, D={D}) "
                      f"{str(dtype)[6:]}, slices of {split}, lengths {label}",
                      got, da.flash_decode_plain(q, k, v, lens), tol[dtype],
                      lambda f, lens=lens: da.flash_decode_plain(f(q), k, v, lens))
            if KV == 8 and dtype == torch.bfloat16:
                decode = {"flash_decode": (q, k, v, full),
                          "flash_decode_mixed": (q, k, v, mixed)}
    torch.cuda.synchronize()
    return {"flash_mha_fwd": main, "flash_mha_fwd_contiguous": contiguous,
            **decode, "errs": errs}


# -- phase 4: the model-UDF slice ----------------------------------------------------

def _persist_groupby(df):
    neg = df[df["sentiment"] == 0][["id", "hour", "sentiment"]]
    saved = neg.persist("negTweets")
    return saved, saved.groupby("hour").agg("count")


def run_udf_slice(dev, seed: int) -> dict:
    """The paper's Figs. 4-6 on the port: paper-lm at full width with
    flash attention, registered as a 3-class sentiment UDF, applied inside
    kernel-mode queries over demo.Tweets."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import physical as PH
    from repro_torch.core import plan as P
    from repro_torch.core.frame import AFrame
    from repro_torch.engine.session import Session
    from repro_torch.engine.table import Table
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as ttf
    from repro_torch.udf import model_udf

    cfg = dataclasses.replace(get_config("paper-lm"), attn_impl="flash")
    if cfg.n_layers != UDF_LAYERS:
        raise AssertionError(f"paper-lm has {cfg.n_layers} layers")
    t0 = time.perf_counter()
    model = ttf.init_lm(cfg, torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed)
    cols = {"id": np.arange(UDF_ROWS, dtype=np.int32),
            "text_tokens": rng.integers(0, cfg.vocab, (UDF_ROWS, UDF_SEQ),
                                        dtype=np.int32),
            "hour": rng.integers(0, 24, UDF_ROWS, dtype=np.int32)}
    model_udf.clear_registry()
    model_udf.register_model("sentiment", model, cfg, classes=3,
                             microbatch=UDF_MICROBATCH)
    sess = Session(mode="kernel", device=dev)
    sess.create_dataset("Tweets", Table(cols), dataverse="demo")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  paper-lm ({n_params:,} parameters, attn_impl=flash) and "
          f"{UDF_ROWS} x {UDF_SEQ} tokens on {dev} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def frame():
        df = AFrame("demo", "Tweets", session=sess)
        df["sentiment"] = df["text_tokens"].map("sentiment")
        return df

    def count_negative():
        df = frame()
        return len(df[df["sentiment"] == 0])

    queries = {"1_map_head": lambda: frame().head(5),
               "2_count_negative": count_negative,
               "3_persist_groupby": lambda: _persist_groupby(frame())}

    passes = UDF_LAYERS * -(-UDF_ROWS // UDF_MICROBATCH)
    _build.reset_launches()
    head = queries["1_map_head"]()
    opt = sess.last_optimized
    flash_q1 = _build.LAUNCHES["flash_mha_fwd"]
    n_neg = queries["2_count_negative"]()
    flash_q2 = _build.LAUNCHES["flash_mha_fwd"] - flash_q1
    seg_before = _build.LAUNCHES["segment_agg"]
    saved, by_hour = queries["3_persist_groupby"]()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    grp_plan = sess.last_physical
    print(f"  kernel launches on the model-UDF path: "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if not (isinstance(opt, P.Project) and isinstance(opt.children[0], P.Limit)):
        raise AssertionError("head(5) did not put the model above the limit")
    if flash_q1 != UDF_LAYERS or flash_q2 != passes:
        raise AssertionError(f"flash_mha_fwd launches: head {flash_q1} (want "
                             f"{UDF_LAYERS}), full pass {flash_q2} (want {passes})")
    if launches["segment_agg"] == seg_before or not isinstance(
            grp_plan, PH.KernelSegmentAgg):
        raise AssertionError("the group-by on the persisted set did not run "
                             "segment_agg")

    # checks, outside the counted run
    tokens = sess.catalog.get("demo", "Tweets").table.columns["text_tokens"]
    direct = model_udf.get_udf("sentiment")(tokens).cpu().numpy()
    same({"sentiment": head["sentiment"]}, {"sentiment": direct[:5]},
         "head(5) predictions")
    if not np.all((direct >= 0) & (direct < 3)):
        raise AssertionError("predictions outside [0, 3)")
    same(n_neg, int((direct == 0).sum()), "count of sentiment == 0")
    got = saved.collect()
    same(got, {"id": np.nonzero(direct == 0)[0].astype(np.int32),
               "hour": cols["hour"][direct == 0],
               "sentiment": np.zeros(n_neg, np.int32)}, "persisted negTweets")
    k, c = np.unique(cols["hour"][direct == 0], return_counts=True)
    same(by_hour, {"hour": k.astype(np.int32), "count": c.astype(np.int32)},
         "group-by count of negTweets")
    print(f"  {n_neg} of {UDF_ROWS} rows predicted class 0; persisted count, "
          f"ids and per-hour counts equal the direct application and numpy",
          flush=True)

    # flash (CUDA kernel) vs blocked (the plain path, the reference's default)
    blocked = dataclasses.replace(cfg, attn_impl="blocked")
    with torch.no_grad():
        logits = torch.cat([
            ttf.lm_prefill(model, {"tokens": tokens[s:s + UDF_MICROBATCH]},
                           blocked, cache=False)[1][:, -1, :3]
            for s in range(0, UDF_ROWS, UDF_MICROBATCH)]).cpu().numpy()
    if not np.isfinite(logits).all():
        raise AssertionError("blocked-attention logits not finite")
    top = np.sort(logits, axis=1)
    margin = top[:, 2] - top[:, 1]
    pred_blocked = logits.argmax(axis=1).astype(np.int32)
    differ = direct != pred_blocked
    near = margin <= MARGIN
    if np.any(differ & ~near):
        raise AssertionError(f"flash vs blocked: {int((differ & ~near).sum())} "
                             f"rows differ with a margin above {MARGIN}")
    print(f"  flash vs blocked attention: {int(differ.sum())} of {UDF_ROWS} "
          f"predictions differ, all among the {int(near.sum())} rows whose "
          f"top-2 margin is within {MARGIN}", flush=True)
    return {"queries": queries, "launches": launches, "n_neg": n_neg,
            "flash_per_pass": flash_q2, "rows_near_margin": int(near.sum()),
            "rows_differ": int(differ.sum())}


def run_decode_op(case) -> int:
    """flash_decode's entry point, ``ops.flash_decode`` (no model path
    reaches it yet), once at phase 2's main decode shape; returns its
    launch count."""
    import torch

    from repro_torch.kernels import _build, ops

    _build.reset_launches()
    out = ops.flash_decode(*case)
    torch.cuda.synchronize()
    n = _build.LAUNCHES["flash_decode"]
    if n == 0 or not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("ops.flash_decode did not launch its kernel")
    print(f"  ops.flash_decode {tuple(out.shape)}: {n} launch", flush=True)
    return n


def device_breakdown(fn, top: int = 12) -> list:
    """Device time (ms) and records of one profiled call of ``fn`` per
    kernel name, the ``top`` largest (names cut to 200 characters, enough to
    show the functor of PyTorch's generic elementwise kernels)."""
    rows = sorted(_profile(fn, 1), key=lambda r: -r[1])
    return [[key[:200], us / 1e3, n] for key, us, n in rows[:top]]


def time_udf(queries: dict) -> dict:
    times = {name: {"wall_ms": host_ms(fn)} for name, fn in queries.items()}
    for name, fn in queries.items():
        t = times[name]
        t["device_ms"] = device_ms(fn)
        t["busy"] = None if t["device_ms"] is None else t["device_ms"] / t["wall_ms"]
    q2 = times["2_count_negative"]
    wall_s = q2["wall_ms"] / 1e3
    q2["rows_per_s"] = UDF_ROWS / wall_s
    q2["tokens_per_s"] = UDF_ROWS * UDF_SEQ / wall_s
    q2["breakdown"] = device_breakdown(queries["2_count_negative"])
    return times


def time_attention(cases: dict, launches: dict) -> tuple[list[dict], dict]:
    """The two attention rows of the ``kernels`` line — flash on the model
    path's strided layout, decode with every length = S — and, beside
    them, flash on contiguous inputs and decode at phase 2's mixed lengths
    (bound on the slots those lengths walk)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    out = []
    q, k, v = cases["flash_mha_fwd"]
    qc, kc, vc = cases["flash_mha_fwd_contiguous"]
    B, H, S, D = q.shape
    io = 4 * q.numel() * q.element_size() + B * H * S * 4
    flash_row = _timed("flash_mha_fwd", "flash_fwd_bf16_kernel",
                       lambda: fa.flash_mha_fwd(q, k, v, causal=True),
                       lambda: fa.flash_mha_fwd_plain(q, k, v, causal=True),
                       lambda: F.scaled_dot_product_attention(qc, kc, vc,
                                                              is_causal=True),
                       io, 2 * 2 * B * H * S * S * D / 2,
                       cases["errs"]["flash_mha_fwd"], launches["flash_mha_fwd"],
                       f"q, k, v ({B}, {H}, {S}, {D}) bf16 causal, (B,H,S,D) "
                       "views of (B,S,H,D)", ops_per_s=BF16_OPS_PER_S)
    flash_row["contiguous_ms"], _, _ = _per_call_ms(
        lambda: fa.flash_mha_fwd(qc, kc, vc, causal=True),
        ("flash_fwd_bf16_kernel",), 20)
    out.append(flash_row)

    def decode_row(name, case):
        q, k, v, lens = case
        B, H, D = q.shape
        KV, S = k.shape[1], k.shape[2]
        mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, None]
        walked = int(torch.where(lens > 0, lens.clamp(max=S), S).sum())
        io = (2 * walked * KV * D + 2 * q.numel()) * q.element_size() + B * 4
        row = _timed(name, ("flash_decode_split_kernel", "flash_decode_merge_kernel"),
                     lambda: da.flash_decode(q, k, v, lens),
                     lambda: da.flash_decode_plain(q, k, v, lens),
                     lambda: F.scaled_dot_product_attention(
                         q[:, :, None], k, v, attn_mask=mask),
                     io, 2 * 2 * walked * H * D, cases["errs"]["flash_decode"],
                     launches["flash_decode"],
                     f"q ({B}, {H}, {D}), cache ({B}, {KV}, {S}, {D}) bf16, "
                     f"{walked} of {B * S} slots walked, slices of "
                     f"{da.split_size(B, KV, S)}", ops_per_s=BF16_OPS_PER_S)
        return row

    out.append(decode_row("flash_decode", cases["flash_decode"]))
    mixed = decode_row("flash_decode", cases["flash_decode_mixed"])
    return out, mixed


# -- phase 5: kernel timings --------------------------------------------------------

def _timed(name: str, kernel: str | tuple[str, ...], wrapper, plain, library,
           nbytes: float, ops: float, err: float, launches: int, shape: str,
           ops_per_s: float = FP32_OPS_PER_S) -> dict:
    """One entry of the ``kernels`` line. ``ms`` is the device time of the
    kernel alone: the mean of its records (by name) in a profiler trace of
    20 wrapper calls, ``kernel_records`` of them (the trace may miss some);
    where one call launches several kernels (a tuple of names), the sum of
    their means. ``library_ms`` is measured the same way: every kernel and
    copy of 20 library calls in one trace, each its mean per record times
    its launches per call. ``event_ms`` and ``library_event_ms`` check the
    two: CUDA events over 20 back-to-back calls, host issue included.
    ``plain_ms`` is the CUDA-event time of one call of the plain version on
    an idle stream (median of 5; launch latency included). ``parts_ms``,
    where one call launches several kernels: each one's share of ``ms``."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    ms, n_records, parts = _per_call_ms(wrapper, names, 20)
    bms, by = bound_ms(nbytes, ops, ops_per_s)
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{SOURCES[name]}",
                replaces=REPLACES[name], launches=launches, max_abs_err=err,
                ms=ms, plain_ms=single_call_ms(plain),
                bound_ms=bms, bound_by=by,
                library_ms=None if library is None else _per_call_ms(library)[0],
                event_ms=cuda_ms(wrapper),
                library_event_ms=None if library is None else cuda_ms(library),
                kernel_records=n_records, shape=shape,
                **({"parts_ms": parts} if len(names) > 1 else {}))


SOURCES = {"filter_count": "filter_count.cu", "segment_agg": "segment_agg.cu",
           "block_topk": "topk_mask.cu", "merge_join_count": "merge_join.cu",
           "flash_mha_fwd": "flash_attention.cu",
           "flash_decode": "decode_attention.cu"}
REPLACES = {"filter_count": "src/repro/kernels/filter_count.py:97",
            "segment_agg": "src/repro/kernels/segment_agg.py:103",
            "block_topk": "src/repro/kernels/topk_mask.py:39",
            "merge_join_count": "src/repro/kernels/merge_join.py:46",
            "flash_mha_fwd": "src/repro/kernels/flash_attention.py:73",
            "flash_decode": "src/repro/kernels/decode_attention.py:61"}


SEGMENT_AGG_KERNELS = ("segment_agg_partial_kernel", "segment_agg_merge_kernel")
MERGE_JOIN_KERNELS = ("merge_join_window_kernel", "merge_join_kernel")


def rotating(fn, args: tuple, nbytes: float):
    """A call of ``fn`` on copies of ``args`` in turn: enough copies that
    the others move at least twice the card's L2 between two calls on one,
    so that each call reads its operands from device memory, as the main
    path does its fresh columns, and not from the L2 the last call left."""
    import itertools

    import torch

    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    copies = 1 + math.ceil(2 * l2 / nbytes)
    sets = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(copies - 1)]
    turn = itertools.cycle(sets)
    return lambda: fn(*next(turn))


def time_kernels(cases: dict, launches: dict) -> tuple[list[dict], list[dict]]:
    """The four relational rows of the ``kernels`` line and, for the other
    line, segment_agg at the e8 shape (G = 20, max: the most lanes per
    group) and merge_join_count on the duplicate-heavy keys. Kernel, plain
    version and library call each rotate over copies of their operands
    (``rotating``): their working sets (25-60 MB) would otherwise sit in
    the H100's 50 MB L2 from one timed call to the next."""
    import torch

    from repro_torch.kernels import filter_count as fc
    from repro_torch.kernels import merge_join as mj
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import topk_mask as tk

    out = []
    c = cases["filter_count"]
    args, k, n = c["args"], c["k"], c["n"]
    err = float((fc.filter_count(*args) - fc.filter_count_plain(*args)).abs())
    nbytes = k * n * 4 + k * 8 + 4
    out.append(_timed("filter_count", "filter_count_kernel",
                      rotating(fc.filter_count, args, nbytes),
                      rotating(fc.filter_count_plain, args, nbytes), None,
                      nbytes, 2 * k * n, err,
                      launches["filter_count"], f"cols ({k}, {n}) int32"))

    def segment_row(case, label):
        args, op = case["args"], case["op"]
        vals, gids, G, n = args
        got = sa.segment_agg(*args, op=op)
        err = float((got - sa.segment_agg_plain(*args, op=op)).abs().max())
        if op == "sum":
            def library(vals, gl):
                return torch.zeros((G, 1), device=vals.device).index_add_(0, gl, vals)
        else:
            def library(vals, gl):
                return torch.full((G, 1), -math.inf, device=vals.device) \
                    .scatter_reduce_(0, gl[:, None], vals, "amax")
        nbytes = n * 4 * 2 + G * 4
        return _timed("segment_agg", SEGMENT_AGG_KERNELS,
                      rotating(lambda *a: sa.segment_agg(*a, op=op), args, nbytes),
                      rotating(lambda *a: sa.segment_agg_plain(*a, op=op), args,
                               nbytes),
                      rotating(library, (vals, gids.long()), nbytes),
                      nbytes, n, err, launches["segment_agg"],
                      f"values ({n}, 1) f32, G={G}, {op} ({label})")

    out.append(segment_row(cases["segment_agg"], "e4"))
    variants = [segment_row(cases["segment_agg_e8"], "e8")]

    c = cases["block_topk"]
    targs = c["args"]
    s, live, n, k = targs
    nb = -(-n // tk.BLOCK)
    v, i = tk.block_topk(*targs)
    pv, pi = tk.block_topk_plain(*targs)
    err = max(float((v - pv).abs().max()), float((i - pi).abs().max()))
    padded = torch.nn.functional.pad(s, (0, nb * tk.BLOCK - n),
                                     value=float("-inf")).view(nb, tk.BLOCK)
    nbytes = n * 5 + nb * k * 8
    out.append(_timed("block_topk", "block_topk_kernel",
                      rotating(tk.block_topk, targs, nbytes),
                      rotating(tk.block_topk_plain, targs, nbytes),
                      rotating(lambda p: torch.topk(p, k, dim=1), (padded,),
                               nbytes),
                      nbytes, n, err, launches["block_topk"],
                      f"scores ({n},) f32, k={k}"))

    def join_row(case, label):
        args, n = case["args"], case["n"]
        err = float((mj.merge_join_count(*args)
                     - mj.merge_join_count_plain(*args)).abs())
        keys = int(args[2]) + int(args[3])  # the valid prefixes, read once
        nbytes = keys * 4 + 8 + 4
        return _timed("merge_join_count", MERGE_JOIN_KERNELS,
                      rotating(mj.merge_join_count, args, nbytes),
                      rotating(mj.merge_join_count_plain, args, nbytes), None,
                      nbytes, keys, err,
                      launches["merge_join_count"],
                      f"keys ({n},) + ({n},) int32, prefixes {int(args[2])} + "
                      f"{int(args[3])}, {label}")

    out.append(join_row(cases["merge_join_count"], "unique (e12)"))
    variants.append(join_row(cases["merge_join_dup"], "duplicate-heavy"))
    return out, variants


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.data import wisconsin
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    print(f"  {lib_path.relative_to(ROOT)} in {build_s:.1f} s", flush=True)
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    t0 = time.perf_counter()
    table = wisconsin.generate(ROWS, seed=args.seed)
    raw = {k: v.numpy() for k, v in table.columns.items()}
    print(f"  generated {ROWS} rows in {time.perf_counter() - t0:.2f} s",
          flush=True)

    print("phase 2: kernels vs plain versions on the card", flush=True)
    cases = check_kernels(raw, dev)
    attn_cases = check_attention_kernels(dev)

    print(f"phase 3: the 12 Wisconsin expressions at {ROWS} rows", flush=True)
    res = run_slice(table, raw, dev)

    print(f"phase 4: the model-UDF pipeline, paper-lm over {UDF_ROWS} x "
          f"{UDF_SEQ} tokens", flush=True)
    udf = run_udf_slice(dev, args.seed)
    decode_launches = run_decode_op(attn_cases["flash_decode"])

    print("phase 5: timings", flush=True)
    print(f"  card clocks.sm, max, power, temperature: {smi_clocks()}",
          flush=True)
    def fmt(t):
        dev = "not measured" if t["device_ms"] is None else \
            f"device {t['device_ms']:.3f} ms, busy {t['busy']:.0%}"
        return f"{t['wall_ms']:8.3f} ms ({dev})"
    for name, t in res["expr_ms"].items():
        print(f"  {name:16s} kernel {fmt(t['kernel'])}   gspmd {fmt(t['gspmd'])}",
              flush=True)
    udf_ms = time_udf(udf["queries"])
    for name, t in udf_ms.items():
        rate = "" if "rows_per_s" not in t else \
            f"  {t['rows_per_s']:.0f} rows/s, {t['tokens_per_s']:.0f} tokens/s"
        print(f"  udf {name:18s} {fmt(t)}{rate}", flush=True)
    print("  udf 2_count_negative device time by kernel (largest first):",
          flush=True)
    for key, ms, n in udf_ms["2_count_negative"]["breakdown"]:
        print(f"    {ms:9.1f} ms {n:5d} records  {key}", flush=True)
    print("  (wall: median of 7 host-clock runs, result on the host; device: "
          "one profiled run)", flush=True)
    attn_rows, decode_mixed = time_attention(
        attn_cases, {"flash_mha_fwd": udf["launches"]["flash_mha_fwd"],
                     "flash_decode": decode_launches})
    relational, variants = time_kernels(cases, res["launches"])
    kernels = relational + attn_rows
    for k in kernels + variants + [decode_mixed]:
        lib = "none" if k["library_ms"] is None else \
            f"{k['library_ms']:.4f} ms (events {k['library_event_ms']:.4f} ms)"
        print(f"  {k['name']:17s} kernel {k['ms']:.4f} ms "
              f"({k['kernel_records']} records / 20 calls)  "
              f"events {k['event_ms']:.4f} ms  "
              f"plain {k['plain_ms']:.4f} ms  bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})  library {lib}  [{k['shape']}]",
              flush=True)
        if "parts_ms" in k:
            print("    of which " + ", ".join(
                f"{n} {t:.4f} ms" for n, t in k["parts_ms"].items()), flush=True)
    print(f"  flash_mha_fwd on contiguous (B,H,S,D) inputs: kernel "
          f"{attn_rows[0]['contiguous_ms']:.4f} ms (the library call above runs "
          "on these)", flush=True)
    print("  (kernel, library: device time per call, the mean of each "
          "kernel's records in a profiler trace of 20 calls times its "
          "launches per call; events: CUDA events over 20 back-to-back "
          "calls, host issue included; plain: CUDA events around one call on "
          "an idle stream, median of 5)", flush=True)
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("non-finite kernel time")
    print(json.dumps({"expressions": res["expr_ms"], "launches_per_run":
                      res["per_expr"], "rows": ROWS, "card": card,
                      "build_s": build_s,
                      "udf": {"queries": udf_ms, "rows": UDF_ROWS,
                              "seq": UDF_SEQ, "microbatch": UDF_MICROBATCH,
                              "n_negative": udf["n_neg"],
                              "flash_launches_per_pass": udf["flash_per_pass"],
                              "rows_within_margin": udf["rows_near_margin"],
                              "rows_flash_vs_blocked_differ": udf["rows_differ"]},
                      "flash_decode_mixed_lengths": {
                          k: v for k, v in decode_mixed.items() if k != "shape"},
                      "relational_variants": variants}))
    print(json.dumps({"kernels": [{k: v for k, v in d.items() if k != "shape"}
                                  for d in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

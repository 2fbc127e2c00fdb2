#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # the paper's XL size: 5,000,000 rows

Phases (any mismatch raises; nothing is caught):
  1. header — the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (build time is set-up);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main path launches, plus block-id lists, deliberate ties
     and duplicate-heavy join keys;
  3. the slice: the paper's 12 Wisconsin expressions through AFrame →
     Session(mode="kernel"), 3 rounds of randomized literals, held against
     the port's gspmd mode and a numpy oracle (dtypes included), plus two
     clustered ``unique2`` range queries that run the block-skipping paths;
     every kernel's launch counter must have moved in this phase;
  4. timings — per expression, kernel vs gspmd mode: host-clock wall time
     and the device time of a torch.profiler trace (the device-busy share);
     per kernel, the device time of the kernel alone (by name in a profiler
     trace) beside its wrapper's, its plain version's, a one-call PyTorch
     yardstick's where one exists, the CUDA-event time of back-to-back
     wrapper calls, and the bytes / operations bound.

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
ROUNDS = 3
ROWS = 5_000_000            # the paper's XL size (src/repro/data/wisconsin.py)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
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


def device_ms(fn, kernel: str | None = None, iters: int = 1) -> float | None:
    """Device time per call of ``fn`` from a torch.profiler trace of
    ``iters`` calls, after one untraced call: of every CUDA kernel and copy,
    or, given ``kernel``, only of the kernels whose name holds it. Host issue
    time and idle gaps are not in it. None when the trace holds no such
    event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (kernel is None or kernel in e.key))
    return us / iters / 1e3 if us > 0 else None


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
    cases["segment_agg"] = dict(args=(ones, gid4, 199, n), C=1, G=199, n=n)

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

    # merge_join_count: expression 12 (unique keys) and duplicate-heavy keys
    ls = ops.sort_join_keys(t["unique1"], live)
    nl = live.sum(dtype=torch.int32)
    exact("merge_join_count e12", mj.merge_join_count(ls, ls, nl, nl),
          mj.merge_join_count_plain(ls, ls, nl, nl))
    dup = ops.sort_join_keys(t["unique1"] % 50_000, live)
    dmask = torch.from_numpy(rng.random(n) > 0.5).to(dev)
    dup_r = ops.sort_join_keys(t["unique2"] % 40_000, dmask)
    nr = dmask.sum(dtype=torch.int32)
    exact("merge_join_count duplicates", mj.merge_join_count(dup, dup_r, nl, nr),
          mj.merge_join_count_plain(dup, dup_r, nl, nr))
    cases["merge_join_count"] = dict(args=(ls, ls, nl, nl), n=n)
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
    launches = dict(_build.LAUNCHES)
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


# -- phase 4: kernel timings --------------------------------------------------------

def _timed(name: str, kernel: str, wrapper, plain, library, nbytes: float,
           ops: float, err: float, launches: int, shape: str) -> dict:
    """One entry of the ``kernels`` line. ``ms`` is the device time of the
    kernel alone (by its name in a profiler trace); ``plain_ms`` and
    ``library_ms`` are the device time of every kernel and copy of one call
    of the plain version and of the library call; ``wrapper_device_ms`` adds
    the wrapper's output fill to ``ms``; ``event_ms`` is the CUDA-event time
    of back-to-back wrapper calls, host issue included."""
    ms = device_ms(wrapper, kernel, iters=20)
    if ms is None:
        raise AssertionError(f"{name}: no {kernel} in the profiler trace")
    bms, by = bound_ms(nbytes, ops)
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{SOURCES[name]}",
                replaces=REPLACES[name], launches=launches, max_abs_err=err,
                ms=ms, plain_ms=device_ms(plain, iters=5),
                bound_ms=bms, bound_by=by,
                library_ms=None if library is None else device_ms(library, iters=20),
                wrapper_device_ms=device_ms(wrapper, iters=20),
                event_ms=cuda_ms(wrapper), shape=shape)


SOURCES = {"filter_count": "filter_count.cu", "segment_agg": "segment_agg.cu",
           "block_topk": "topk_mask.cu", "merge_join_count": "merge_join.cu"}
REPLACES = {"filter_count": "src/repro/kernels/filter_count.py:97",
            "segment_agg": "src/repro/kernels/segment_agg.py:103",
            "block_topk": "src/repro/kernels/topk_mask.py:39",
            "merge_join_count": "src/repro/kernels/merge_join.py:46"}


def time_kernels(cases: dict, launches: dict) -> list[dict]:
    import torch

    from repro_torch.kernels import filter_count as fc
    from repro_torch.kernels import merge_join as mj
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import topk_mask as tk

    out = []
    c = cases["filter_count"]
    args, k, n = c["args"], c["k"], c["n"]
    err = float((fc.filter_count(*args) - fc.filter_count_plain(*args)).abs())
    out.append(_timed("filter_count", "filter_count_kernel",
                      lambda: fc.filter_count(*args),
                      lambda: fc.filter_count_plain(*args), None,
                      k * n * 4 + k * 8 + 4, 2 * k * n, err,
                      launches["filter_count"], f"cols ({k}, {n}) int32"))

    c = cases["segment_agg"]
    sargs = c["args"]
    vals, gids, G, n = sargs
    gl = gids.long()
    err = float((sa.segment_agg(*sargs) - sa.segment_agg_plain(*sargs)).abs().max())
    out.append(_timed("segment_agg", "segment_agg_kernel",
                      lambda: sa.segment_agg(*sargs),
                      lambda: sa.segment_agg_plain(*sargs),
                      lambda: torch.zeros((G, 1), device=vals.device)
                      .index_add_(0, gl, vals),
                      n * 4 * 2 + G * 4, n, err, launches["segment_agg"],
                      f"values ({n}, 1) f32, G={G}, sum"))

    c = cases["block_topk"]
    targs = c["args"]
    s, live, n, k = targs
    nb = -(-n // tk.BLOCK)
    v, i = tk.block_topk(*targs)
    pv, pi = tk.block_topk_plain(*targs)
    err = max(float((v - pv).abs().max()), float((i - pi).abs().max()))
    padded = torch.nn.functional.pad(s, (0, nb * tk.BLOCK - n),
                                     value=float("-inf")).view(nb, tk.BLOCK)
    out.append(_timed("block_topk", "block_topk_kernel",
                      lambda: tk.block_topk(*targs),
                      lambda: tk.block_topk_plain(*targs),
                      lambda: torch.topk(padded, k, dim=1),
                      n * 5 + nb * k * 8, n, err, launches["block_topk"],
                      f"scores ({n},) f32, k={k}"))

    c = cases["merge_join_count"]
    jargs, n = c["args"], c["n"]
    err = float((mj.merge_join_count(*jargs)
                 - mj.merge_join_count_plain(*jargs)).abs())
    out.append(_timed("merge_join_count", "merge_join_kernel",
                      lambda: mj.merge_join_count(*jargs),
                      lambda: mj.merge_join_count_plain(*jargs), None,
                      2 * n * 4 + 8 + 4, 2 * n, err, launches["merge_join_count"],
                      f"keys ({n},) + ({n},) int32, unique"))
    return out


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

    print(f"phase 3: the 12 Wisconsin expressions at {ROWS} rows", flush=True)
    res = run_slice(table, raw, dev)

    print("phase 4: timings", flush=True)
    def fmt(t):
        dev = "not measured" if t["device_ms"] is None else \
            f"device {t['device_ms']:.3f} ms, busy {t['busy']:.0%}"
        return f"{t['wall_ms']:8.3f} ms ({dev})"
    for name, t in res["expr_ms"].items():
        print(f"  {name:16s} kernel {fmt(t['kernel'])}   gspmd {fmt(t['gspmd'])}",
              flush=True)
    print("  (wall: median of 7 host-clock runs, result on the host; device: "
          "one profiled run)", flush=True)
    kernels = time_kernels(cases, res["launches"])
    for k in kernels:
        lib = k["library_ms"]
        print(f"  {k['name']:17s} kernel {k['ms']:.4f} ms  wrapper "
              f"{k['wrapper_device_ms']:.4f} ms  events {k['event_ms']:.4f} ms  "
              f"plain {k['plain_ms']:.4f} ms  bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})  library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}  [{k['shape']}]",
              flush=True)
    print("  (kernel: the kernel alone; wrapper, plain, library: every kernel "
          "and copy of one call — device time from a profiler trace of 20 calls, "
          "5 for plain; events: CUDA events over 20 back-to-back wrapper calls, "
          "host issue included)", flush=True)
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("non-finite kernel time")
    print(json.dumps({"expressions": res["expr_ms"], "launches_per_run":
                      res["per_expr"], "rows": ROWS, "card": card,
                      "build_s": build_s}))
    print(json.dumps({"kernels": [{k: v for k, v in d.items() if k != "shape"}
                                  for d in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

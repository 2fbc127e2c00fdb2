"""Window functions (port of ``repro.core.window``) — the paper's §VI
future-work item.

``Window`` is a plan node computing per-row analytic functions over an
optional bounded-domain partition and a sort order:

    row_number()           ROW_NUMBER() OVER (PARTITION BY p ORDER BY o)
    rank()                 RANK()        (ties share rank)
    cumsum(col)            SUM(col)      with UNBOUNDED PRECEDING frame
    moving_avg(col, k)     AVG(col)      over a k-row trailing frame

Execution is vectorized with no per-group loop: two stable argsorts give
the (partition, order) permutation, a running max finds each row's
partition start, prefix operations compute the function, and an inverse
permutation puts the results back in storage order — rows keep their
original positions (Pandas alignment semantics). Plain torch operators
throughout, as the reference uses jnp ones (no kernel).

Order and partition keys are float32, as the reference's: an integer
column past 2^24 loses precision in the key. ``cumsum`` and ``moving_avg``
take differences of ONE global float32 prefix sum, the reference's
formula, so they are exact only while every prefix sum is an integer
below 2^24.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import plan as P

WINDOW_FUNCS = ("row_number", "rank", "cumsum", "moving_avg")

_DEAD_KEY = 3e38  # dead rows sort to the end (and form their own partition)
_SCAN_ROW = 2048  # row length of the two-level running max


class Window(P.Plan):
    """Appends one window column to the child's output."""

    def __init__(self, child: P.Plan, out_name: str, func: str,
                 order_by: str, partition_by: Optional[str] = None,
                 value_col: Optional[str] = None, frame: int = 0,
                 ascending: bool = True):
        assert func in WINDOW_FUNCS, func
        self.children = (child,)
        self.out_name, self.func = out_name, func
        self.order_by, self.partition_by = order_by, partition_by
        self.value_col, self.frame, self.ascending = value_col, frame, ascending

    def fingerprint(self):
        return (f"window({self.out_name},{self.func},{self.order_by},"
                f"{self.partition_by},{self.value_col},{self.frame},"
                f"{self.ascending},{self.children[0].fingerprint()})")

    def required_columns(self):
        cols = {self.order_by}
        if self.partition_by:
            cols.add(self.partition_by)
        if self.value_col:
            cols.add(self.value_col)
        return cols

    def to_sql(self):
        over = []
        if self.partition_by:
            over.append(f"PARTITION BY t.{self.partition_by}")
        over.append(f"ORDER BY t.{self.order_by}"
                    f"{'' if self.ascending else ' DESC'}")
        if self.func == "row_number":
            fn = "ROW_NUMBER()"
        elif self.func == "rank":
            fn = "RANK()"
        elif self.func == "cumsum":
            fn = f"SUM(t.{self.value_col})"
            over.append("ROWS UNBOUNDED PRECEDING")
        else:
            fn = f"AVG(t.{self.value_col})"
            over.append(f"ROWS {self.frame - 1} PRECEDING")
        return (f"SELECT t.*, {fn} OVER ({' '.join(over)}) AS {self.out_name} "
                f"FROM ({self.children[0].to_sql()}) t")


def _starts(keys: torch.Tensor) -> torch.Tensor:
    """True where a sorted key differs from its predecessor (and at 0)."""
    head = torch.ones((1,), dtype=torch.bool, device=keys.device)
    return torch.cat([head, keys[1:] != keys[:-1]])


def _cummax(x: torch.Tensor) -> torch.Tensor:
    """``torch.cummax(x, 0).values`` of a 1-D tensor as a two-level scan:
    rows of ``_SCAN_ROW`` scanned side by side, then each row lifted by the
    largest value of the rows before it. A maximum is exact in any order, so
    the result is the one-pass scan's bit for bit; torch's own 1-D cummax on
    CUDA walks the whole column in one block (about 14 ms at 5M rows on an
    H100, against a fraction of a millisecond for this)."""
    n = x.shape[0]
    rows = -(-n // _SCAN_ROW)
    low = float("-inf") if x.dtype.is_floating_point \
        else torch.iinfo(x.dtype).min
    grid = torch.cat([x, x.new_full((rows * _SCAN_ROW - n,), low)]) \
        .view(rows, _SCAN_ROW)
    within = torch.cummax(grid, dim=1).values
    before = torch.cummax(within[:-1, -1], dim=0).values
    lifted = torch.cat([within[:1],
                        torch.maximum(within[1:], before[:, None])])
    return lifted.reshape(-1)[:n]


def _running_anchor(flags: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Position of the last flagged row at or before each row."""
    return _cummax(torch.where(flags, pos, 0))


def execute_window(env: dict, mask: torch.Tensor,
                   node: Window) -> tuple[dict, torch.Tensor]:
    """Vectorized window evaluation, aligned with storage order. Results
    come back with the reference's dtypes: int32 ranks, float32 sums and
    averages."""
    n = mask.shape[0]
    dev = mask.device
    okey = env[node.order_by].to(torch.float32)
    if not node.ascending:
        okey = -okey
    okey = torch.where(mask, okey, _DEAD_KEY)
    perm = torch.argsort(okey, stable=True)
    if node.partition_by is not None:
        pkey = torch.where(mask, env[node.partition_by].to(torch.float32),
                           _DEAD_KEY)
        # lexicographic (partition, order) via two stable sorts
        perm = perm[torch.argsort(pkey[perm], stable=True)]
        starts_mask = _starts(pkey[perm])
    else:
        starts_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
        starts_mask[:1] = True

    pos = torch.arange(n, device=dev)
    start_idx = _running_anchor(starts_mask, pos)

    if node.func in ("row_number", "rank"):
        anchor = pos
        if node.func == "rank":  # ties (equal f32 keys) share the first row's
            anchor = _running_anchor(_starts(okey[perm]) | starts_mask, pos)
        out_sorted = (anchor - start_idx + 1).to(torch.int32)
    else:
        v = torch.where(mask, env[node.value_col], 0)[perm].to(torch.float32)
        cs = torch.cumsum(v, dim=0)
        if node.func == "cumsum":
            seg_base = _cummax(torch.where(starts_mask, cs - v, float("-inf")))
            out_sorted = cs - seg_base
        else:  # moving_avg over the trailing `frame` rows of the partition
            k = max(int(node.frame), 1)
            cs = torch.cat([torch.zeros((1,), dtype=torch.float32, device=dev),
                            cs])
            lo = torch.maximum(pos - k + 1, start_idx)
            wsum = cs[pos + 1] - cs[lo]
            out_sorted = wsum / (pos - lo + 1).clamp(min=1)

    out = torch.empty((n,), dtype=out_sorted.dtype, device=dev)
    out[perm] = out_sorted
    new_env = dict(env)
    new_env[node.out_name] = out
    return new_env, mask

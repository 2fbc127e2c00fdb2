"""Session: the client's connection to the engine (port of
``repro.engine.session``). Owns the catalog, the device, and the plan
caches.

The device rule: ``Session()`` runs on the CUDA card (``device=None`` means
``"cuda"``) and raises when there is none — it never falls back to the CPU
quietly. ``Session(device="cpu")`` runs every operator, and in kernel mode
every relational kernel's plain PyTorch version, on the CPU (the tests do).
In kernel mode on the card, the relational operators launch the
hand-written CUDA kernels.

Not in this slice (each raises, naming its ROADMAP item): durable storage
and ``Session.open`` (A8), feeds and views (A6), point lookups, indexes and
open datasets (A2/A5 leftovers), ``explain(analyze=True)``, meshes and
``shard_map`` (A9).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections.abc import Mapping
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import physical as PH
from repro_torch.core import plan as P
from repro_torch.core.catalog import INTERNAL_COLUMNS, Catalog, Dataset
from repro_torch.core.compiler import CompiledQuery, ExecContext, compile_physical
from repro_torch.core.expr import encode_param, ordered_lits
from repro_torch.core.optimizer import optimize
from repro_torch.core.physical_planner import build_pruner, plan_physical
from repro_torch.core.stats import harvest_block_zones
from repro_torch.engine.table import (DICT_THRESHOLD, ColumnMeta, Table,
                                      decode_strings, dict_lane_name,
                                      is_lane_column, numpy_dtype,
                                      pack_prefix, prefix_lane_name)
from repro_torch.runtime import telemetry as tel

_SESSION_IDS = itertools.count()


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one, raise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: Session() runs on the card; pass device='cpu' "
            "to run on the CPU")
    return dev


class _StatsView(Mapping):
    """``Session.stats`` as a read-only view over the telemetry registry;
    ``hits`` sums the variant- and executable-level plan-cache hits."""

    _KEYS = ("compiles", "hits", "optimizes", "plans")

    def __init__(self, sid: str):
        self._sid = sid

    def _value(self, key: str):
        if key == "hits":
            return (tel.counter_value("session.plan_cache.hits_total",
                                      level="variant", sid=self._sid)
                    + tel.counter_value("session.plan_cache.hits_total",
                                        level="executable", sid=self._sid))
        return tel.counter_value(f"session.{key}_total", sid=self._sid)

    def __getitem__(self, key: str):
        if key not in self._KEYS:
            raise KeyError(key)
        return self._value(key)

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self) -> int:
        return len(self._KEYS)

    def __repr__(self) -> str:
        return repr({k: self._value(k) for k in self._KEYS})


@dataclasses.dataclass
class _PlanEntry:
    """One raw-fingerprint plan-cache entry, valid for one (stats epoch,
    manifest LSN) pair. ``variants`` is the third level: prune signature →
    (compiled query, literal binding)."""

    epoch: int
    lsn: int
    opt: P.Plan
    raw_lits0: list
    pruner: object
    variants: dict = dataclasses.field(default_factory=dict)


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} waits for ROADMAP {item}")


class Session:
    def __init__(self, mode: str = "auto", device=None,
                 catalog: Optional[Catalog] = None, mesh=None, storage=None):
        """mode: 'auto' (= 'gspmd' on one device), 'gspmd', or 'kernel' (the
        planner lowers fusable plan shapes onto the relational kernels;
        anything uncovered runs the generic operators). ``catalog`` shares
        another session's datasets (each session keeps its own plan
        caches)."""
        if mesh is not None:
            raise _later("a device mesh", "A9 (multi-device)")
        if storage is not None:
            raise _later("durable storage", "A8 (durability)")
        if mode == "auto":
            mode = "gspmd"
        if mode == "shard_map":
            raise _later("mode='shard_map'", "A9 (multi-device)")
        if mode not in ("gspmd", "kernel"):
            raise ValueError(f"unknown mode {mode!r}: expected auto | gspmd | kernel")
        self.mode = mode
        self.device = resolve_device(device)
        self.catalog = catalog if catalog is not None else Catalog()
        # Three-level plan cache:
        #   1. raw (pre-optimization) fingerprint → _PlanEntry for one
        #      (stats epoch, LSN): repeated query shapes skip the optimizer;
        #   2. per entry, prune signature → (compiled query, literal
        #      binding): new literals with the same surviving blocks rebind
        #      into the cached query;
        #   3. (physical fingerprint, epoch, LSN) → compiled query, shared
        #      across logical shapes.
        self._plans: dict[str, _PlanEntry] = {}
        self._compiled: dict[tuple, CompiledQuery] = {}
        self.sid = str(next(_SESSION_IDS))
        for key in _StatsView._KEYS:
            if key == "hits":
                for level in ("entry", "variant", "executable"):
                    tel.inc("session.plan_cache.hits_total", 0,
                            level=level, sid=self.sid)
            else:
                tel.inc(f"session.{key}_total", 0, sid=self.sid)
        self.stats = _StatsView(self.sid)

    @classmethod
    def open(cls, path, **kwargs) -> "Session":
        raise _later("Session.open (cold-start recovery)", "A8 (durability)")

    # -- DDL ----------------------------------------------------------------

    def create_dataset(self, name: str, table: Table, dataverse: str = "Default",
                       closed: bool = True, indexes: Sequence[str] = (),
                       primary: Optional[str] = None) -> Dataset:
        """Register a closed dataset: place its columns on the session
        device, collect statistics and derived string lanes, and harvest the
        per-block zone maps."""
        if not closed:
            raise _later("open (schema-on-read) datasets", "A5 leftovers")
        if indexes or primary is not None:
            raise _later("indexes", "A2 (engine/index.py)")
        t0 = time.perf_counter()
        with tel.span("session.create_dataset", sid=self.sid,
                      dataset=f"{dataverse}.{name}"):
            table = _collect_stats(table.to(self.device))
            ds = Dataset(name=name, dataverse=dataverse, table=table,
                         closed=True, block_zones=harvest_block_zones(table))
            self.catalog.register(ds)
            self._plans.clear()
            self._compiled.clear()
        tel.set_gauge("session.last_create_seconds",
                      time.perf_counter() - t0, sid=self.sid)
        return ds

    def create_view(self, *a, **kw):
        raise _later("materialized views", "A6 (LSM ingest, views)")

    def point_lookup(self, *a, **kw):
        raise _later("point lookups", "A5 leftovers (needs A2 indexes)")

    # -- query execution -------------------------------------------------------

    def exec_context(self, catalog=None) -> ExecContext:
        return ExecContext(catalog=catalog if catalog is not None else self.catalog,
                           mode=self.mode, device=self.device)

    def _plan_entry(self, plan: P.Plan, raw_fp: str, raw_lits: list,
                    snap) -> _PlanEntry:
        """Level 1: optimized plan + pruner per (raw fingerprint, epoch, LSN)."""
        e = self._plans.get(raw_fp)
        if e is not None and (e.epoch, e.lsn) == (snap.stats_epoch, snap.lsn):
            tel.inc("session.plan_cache.hits_total", level="entry", sid=self.sid)
            return e
        tel.inc("session.plan_cache.misses_total", level="entry", sid=self.sid)
        if e is not None:  # stale epoch/LSN: sweep dead queries with it
            self._compiled = {k: v for k, v in self._compiled.items()
                              if k[1:] == (snap.stats_epoch, snap.lsn)}
        tel.inc("session.optimizes_total", sid=self.sid)
        with tel.span("session.optimize", sid=self.sid):
            opt = optimize(plan, snap)
        with tel.span("session.prune_build", sid=self.sid):
            pruner = build_pruner(opt, snap, raw_lits)
        e = _PlanEntry(snap.stats_epoch, snap.lsn, opt, list(raw_lits), pruner)
        self._plans[raw_fp] = e
        return e

    def _variant(self, e: _PlanEntry, raw_lits: list, snap):
        """Levels 2+3: prune signature → (compiled query, binding); compiled
        queries are shared across logical shapes by physical fingerprint."""
        with tel.span("session.prune", sid=self.sid):
            decisions = e.pruner.decide([l.value for l in raw_lits])
        var = e.variants.get(decisions.signature)
        if var is not None:
            tel.inc("session.plan_cache.hits_total", level="variant", sid=self.sid)
            return var
        tel.inc("session.plan_cache.misses_total", level="variant", sid=self.sid)
        with tel.span("session.plan", sid=self.sid):
            phys = plan_physical(e.opt, snap, mode=self.mode, decisions=decisions)
        tel.inc("session.plans_total", sid=self.sid)
        key = (phys.fingerprint(), e.epoch, e.lsn)
        cq = self._compiled.get(key)
        if cq is None:
            with tel.span("session.compile", sid=self.sid):
                cq = compile_physical(phys, self.exec_context(snap))
            self._compiled[key] = cq
            tel.inc("session.compiles_total", sid=self.sid)
        else:
            tel.inc("session.plan_cache.hits_total", level="executable",
                    sid=self.sid)
            cq = dataclasses.replace(cq, physical=phys)
        # bind against THIS entry's physical-plan literals: a query shared
        # with another logical shape has the same slot order, but its Lit
        # objects chain to the other raw plan
        binding = _literal_binding(e.raw_lits0, ordered_lits(PH.all_exprs(phys)))
        var = (cq, binding)
        e.variants[decisions.signature] = var
        return var

    def execute(self, plan: P.Plan):
        """Optimize → cost-plan (block skipping decided at bind time) →
        compile (cached) → run → numpy. Scalar results come back as Python
        numbers, tables as ``{column: np.ndarray}`` of the live rows."""
        t0 = time.perf_counter()
        raw_fp = plan.fingerprint()
        raw_lits = ordered_lits(P.all_exprs(plan))
        with self.catalog.snapshot() as snap:
            with tel.span("session.execute", sid=self.sid, mode=self.mode):
                e = self._plan_entry(plan, raw_fp, raw_lits, snap)
                cq, binding = self._variant(e, raw_lits, snap)
                params = _bind_params(binding, raw_lits, self.device)
                with tel.span("session.execute.run", sid=self.sid):
                    out = cq.run(snap, params=params)
                    if cq.kind == "scalar":
                        vals = {k: v.item() for k, v in out.items()}
                        result = vals if len(vals) > 1 else next(iter(vals.values()))
                    else:
                        result = _materialize(*out)
        dt = time.perf_counter() - t0
        tel.inc("session.executes_total", sid=self.sid, mode=self.mode)
        tel.set_gauge("session.last_execute_seconds", dt, sid=self.sid)
        self.last_optimized = e.opt
        self.last_physical = cq.physical
        self.last_prune_report = PH.prune_report(cq.physical)
        return result

    def explain(self, plan: P.Plan, analyze: bool = False) -> str:
        """The costed physical plan for ``plan``; compiles and runs nothing."""
        if analyze:
            raise _later("explain(analyze=True)", "A5 leftovers")
        raw_lits = ordered_lits(P.all_exprs(plan))
        with self.catalog.snapshot() as snap:
            e = self._plan_entry(plan, plan.fingerprint(), raw_lits, snap)
            phys = plan_physical(e.opt, snap, mode=self.mode,
                                 decisions=e.pruner.decide(
                                     [l.value for l in raw_lits]))
        return PH.format_plan(phys)


def _literal_binding(raw_lits, opt_lits) -> list[tuple[str, object]]:
    """Map each physical-plan param slot back to the raw plan's literals:
    a user literal (or one the optimizer mirrored from it, via ``source``)
    rebinds to the fresh raw value; anything else is a plan constant."""
    index = {id(l): j for j, l in enumerate(raw_lits)}
    binding: list[tuple[str, object]] = []
    for lit in opt_lits:
        src = lit
        while id(src) not in index and getattr(src, "source", None) is not None:
            src = src.source
        binding.append(("raw", index[id(src)]) if id(src) in index
                       else ("const", lit.value))
    return binding


def _bind_params(binding, raw_lits, device):
    return [encode_param(raw_lits[v].value if kind == "raw" else v, device)
            for kind, v in binding]


def _collect_stats(table: Table) -> Table:
    """Fill missing lo/hi/distinct for numeric columns, and grow every
    string column's derived integer lanes: the order-preserving
    ``__pfx_<col>`` prefix lane, and the sorted dictionary-id lane
    ``__dict_<col>`` when the distinct count stays under DICT_THRESHOLD
    (dead rows carry id -1). Runs on the table's device; the lanes and
    metadata equal the reference's."""
    meta = dict(table.meta)
    cols = dict(table.columns)
    live = table.valid
    for name, col in table.columns.items():
        if name in INTERNAL_COLUMNS or is_lane_column(name):
            continue
        m = meta.get(name)
        if col.ndim == 2 and col.dtype == torch.uint8:
            pfx = prefix_lane_name(name)
            if pfx not in cols:
                packed = pack_prefix(col)
                lp = packed[live]
                plo, phi = ((int(lp.min()), int(lp.max())) if lp.numel()
                            else (None, None))
                cols[pfx] = packed
                meta[pfx] = ColumnMeta(np.dtype(np.int32), plo, phi)
            dname = dict_lane_name(name)
            if dname not in cols:
                uniq, inv = torch.unique(col[live], dim=0, return_inverse=True)
                new = m if m is not None else ColumnMeta(np.dtype(np.uint8),
                                                         is_string=True)
                new = dataclasses.replace(new, distinct=int(uniq.shape[0]))
                if uniq.shape[0] <= DICT_THRESHOLD:
                    ids = torch.full((col.shape[0],), -1, dtype=torch.int32,
                                     device=col.device)
                    ids[live] = inv.to(torch.int32)
                    cols[dname] = ids
                    g = int(uniq.shape[0])
                    meta[dname] = ColumnMeta(np.dtype(np.int32),
                                             0 if g else None,
                                             g - 1 if g else None, g)
                    new = dataclasses.replace(
                        new, dict_values=tuple(decode_strings(uniq)))
                meta[name] = new
            continue
        if m is not None and m.lo is not None:
            continue
        if col.ndim != 1 or not col.numel():
            continue
        if col.dtype.is_floating_point:
            known = col[~torch.isnan(col)]
            if known.numel():
                meta[name] = ColumnMeta(numpy_dtype(col.dtype),
                                        float(known.min()), float(known.max()))
        elif col.dtype != torch.bool:
            lo, hi = int(col.min()), int(col.max())
            meta[name] = ColumnMeta(numpy_dtype(col.dtype), lo, hi,
                                    min(hi - lo + 1, col.numel()))
    return Table(cols, meta, table.num_rows)


def _materialize(env: dict, mask) -> dict[str, np.ndarray]:
    """Compact to live rows on the host (the result delivery boundary);
    derived string lanes are storage internals, never delivered."""
    m = mask.cpu().numpy()
    return {k: v.cpu().numpy()[m] for k, v in env.items() if not is_lane_column(k)}

"""Session: the client's connection to the engine (port of
``repro.engine.session``). Owns the catalog, the device, the plan caches and
the materialized views.

The device rule: ``Session()`` runs on the CUDA card (``device=None`` means
``"cuda"``) and raises when there is none — it never falls back to the CPU
quietly. ``Session(device="cpu")`` runs every operator, and in kernel mode
every relational kernel's plain PyTorch version, on the CPU (the tests do).
In kernel mode on the card, the relational operators launch the
hand-written CUDA kernels.

Datasets may be clustered by a primary key and carry sorted secondary
indexes; ``repro_torch.engine.ingest.Feed`` streams pushes, upserts and
deletes into LSM runs, and views over a fed dataset refresh from each
flush. ``Session(storage=dir)`` makes the catalog durable (checksummed
segments, manifest generations, the feed WAL; ``runtime/durable.py``) and
``Session.open(dir)`` recovers such a directory onto the session device.

``Session(mesh=make_local_mesh(data=S))`` row-shards every table over the
mesh's S shards (``launch/mesh.py``; every shard on the one device) and,
in ``shard_map`` and ``kernel`` mode, runs each operator shard by shard
with explicit merges (``engine/distributed.py``); zone maps, block lists
and indexes follow the per-shard layout, and point lookups are routed to
the owning shard.
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
from repro_torch.core.catalog import (INTERNAL_COLUMNS, Catalog, Dataset,
                                      IndexInfo, open_widen)
from repro_torch.core.compiler import (CompiledQuery, ExecContext,
                                       compile_physical, profile_physical)
from repro_torch.core.expr import encode_param, ordered_lits
from repro_torch.core.optimizer import optimize
from repro_torch.core.physical_planner import (NO_PRUNE, build_pruner,
                                               plan_physical)
from repro_torch.core.stats import harvest_block_zones, mesh_shards
from repro_torch.device import resolve_device
from repro_torch.engine.table import (DICT_THRESHOLD, ColumnMeta, Table,
                                      decode_strings, dict_lane_name,
                                      is_lane_column, numpy_dtype,
                                      pack_prefix, prefix_lane_name)
from repro_torch.runtime import telemetry as tel

_SESSION_IDS = itertools.count()


class _StatsView(Mapping):
    """``Session.stats`` as a read-only view over the telemetry registry;
    ``hits`` sums the variant- and executable-level plan-cache hits."""

    _KEYS = ("compiles", "hits", "optimizes", "plans",
             "pruned_components", "point_lookups")

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


class _TimingsView(Mapping):
    """``Session.timings``: a read-only view over this session's last-*
    gauges (the reference's ``_TimingsView``). A gauge not yet set is not
    a key: reading it raises ``KeyError``."""

    _GAUGES = {
        "last_execute": "session.last_execute_seconds",
        "last_point_lookup": "session.last_point_lookup_seconds",
        "last_create": "session.last_create_seconds",
        "last_view_recompute": "session.last_view_recompute_seconds",
    }

    def __init__(self, sid: str):
        self._sid = sid

    def __getitem__(self, key: str):
        name = self._GAUGES.get(key)
        v = tel.gauge_value(name, sid=self._sid) if name else None
        if v is None:
            raise KeyError(key)
        return v

    def __iter__(self):
        for key, name in self._GAUGES.items():
            if tel.gauge_value(name, sid=self._sid) is not None:
                yield key

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __repr__(self) -> str:
        return repr({k: self[k] for k in self})


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


class Session:
    def __init__(self, mode: str = "auto", device=None,
                 catalog: Optional[Catalog] = None, mesh=None, storage=None,
                 enable_index: bool = True, enable_pushdown: bool = True,
                 enable_prune: bool = True, enable_block_skip: bool = True,
                 fault_plan=None, data_axes: tuple[str, ...] = ("data",)):
        """mode: 'auto' (``shard_map`` on a mesh of more than one shard,
        else 'gspmd'), 'gspmd', 'shard_map' (each operator runs shard by
        shard over the mesh's row shards and merges with explicit
        collectives), or 'kernel' (the planner lowers fusable plan shapes
        onto the relational kernels — once per shard on a mesh; anything
        uncovered runs the generic operators). ``mesh``
        (``launch.mesh.make_local_mesh``) row-shards every table over its
        ``data_axes``; its device is the session device. ``catalog``
        shares another session's datasets (reader sessions: each keeps its
        own plan caches).

        The reference's ablation switches, each answering alike on or off:
        ``enable_index=False`` leaves index access paths out of the
        planner's candidates; ``enable_pushdown=False`` skips the
        optimizer's rewrites (a fed dataset still expands into base ∪
        runs); ``enable_prune=False`` turns bind-time zone-map run pruning
        off; ``enable_block_skip=False`` does the same for the blocks inside
        a component.

        ``fault_plan`` arms the storage fault points
        (``runtime/fault.py`` FaultPlan) for crash-consistency tests.
        ``storage`` attaches a durable store (``runtime/durable.py``): a
        DurableStore or a path to open one at. Every manifest publish then
        commits checksummed component segments and an atomically renamed
        manifest generation, and feeds write an fsynced WAL; ``open``
        recovers such a directory."""
        if mode == "auto":
            mode = "shard_map" if mesh is not None and mesh.size > 1 \
                else "gspmd"
        if mode not in ("gspmd", "shard_map", "kernel"):
            raise ValueError(f"unknown mode {mode!r}: "
                             "expected auto | gspmd | shard_map | kernel")
        self.mode = mode
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        if mesh is not None:
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r} differs from the "
                                 f"mesh's {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.catalog = catalog if catalog is not None else Catalog()
        self.fault_plan = fault_plan
        self.storage = None
        if storage is not None:
            from repro_torch.engine import lsm
            from repro_torch.runtime.durable import DurableStore

            store = storage if isinstance(storage, DurableStore) \
                else DurableStore(storage)
            # the store's crash points consult THIS session's FaultPlan: one
            # fault source for in-memory and I/O points alike
            store._fault = lambda point: lsm._fault(self, point)
            self.catalog.attach_store(store)
            self.storage = store
        self.recovery_report: Optional[dict] = None
        self.enable_index = enable_index
        self.enable_pushdown = enable_pushdown
        self.enable_prune = enable_prune
        self.enable_block_skip = enable_block_skip
        # Three-level plan cache:
        #   1. raw (pre-optimization) fingerprint → _PlanEntry for one
        #      (stats epoch, LSN): repeated query shapes skip the optimizer;
        #   2. per entry, prune signature → (compiled query, literal
        #      binding): new literals with the same surviving runs and
        #      blocks rebind into the cached query;
        #   3. (physical fingerprint, epoch, LSN) → compiled query, shared
        #      across logical shapes.
        # Every flush, compaction and DDL bumps the epoch and the LSN, so a
        # stale query (which bakes in the component set) is unreachable.
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
        self.timings = _TimingsView(self.sid)
        # incrementally-maintained materialized views (engine/lsm.py),
        # refreshed from each feed flush's delta batch
        self.views: dict[str, object] = {}

    # -- durable cold start --------------------------------------------------

    @classmethod
    def open(cls, path, lazy: bool = True, **kwargs) -> "Session":
        """Cold-start crash recovery: open a durable storage directory
        (``Session(storage=...)``'s layout) and rebuild the catalog —

          1. load each dataset's newest checksum-valid manifest generation
             (a corrupt manifest or segment is quarantined and the previous
             generation serves — ``storage.corruption_total``);
          2. mount the component segments on the session device and
             republish them (the catalog LSN resumes past the recovered
             high-water mark, run uids past the highest mounted uid);
          3. mark soft state for the rebuild at first bind
             (``lazy=False`` rebuilds indexes and zone maps now);
          4. replay the WAL tail — acked batches whose covering flush never
             committed — through the normal flush path, in order, skipping
             batches at or below the manifest's ``wal_upto``.

        Returns the session with ``recovery_report`` filled. Raises
        ``StorageLockError`` if a live process holds the directory."""
        from repro_torch.engine import ingest, lsm
        from repro_torch.runtime.durable import DurableStore

        t0 = time.perf_counter()
        store = path if isinstance(path, DurableStore) else DurableStore(path)
        corrupt0 = tel.counter_value("storage.corruption_total") or 0
        report: dict = {"datasets": {}, "seconds": 0.0,
                        "corruption_events": 0, "wal_replayed_batches": 0}
        try:
            sess = cls(storage=store, **kwargs)
            cat = sess.catalog
            loads = [(dv, name) + store.load_dataset(dv, name)
                     for dv, name in store.list_datasets()]
            # restore the LSN high-water mark BEFORE any publish, so every
            # mounted generation commits with a strictly newer LSN than
            # anything already on disk
            with cat.lock:
                for dv, name, record, _, _ in loads:
                    cat.lsn = max(cat.lsn, int(record["lsn"]))
            for dv, name, record, segments, ds_report in loads:
                base = _mount_component(
                    sess, dv, record["base"]["seg"],
                    *segments[record["base"]["seg"]])
                runs = tuple(
                    _mount_component(sess, dv, r["seg"], *segments[r["seg"]])
                    for r in record["runs"])
                with cat.lock:
                    key = (dv, name)
                    max_uid = max((r.uid for r in runs), default=-1)
                    cat._run_uids[key] = max(cat._run_uids.get(key, 0),
                                             max_uid + 1)
                    cat.publish(dv, name, base, runs)
                lsm.recover(sess, dv, name, lazy=lazy)
                tail = store.wal_tail(dv, name)
                replayed = 0
                if tail:
                    # the replay feed IS the normal ingest path: validate,
                    # buffer, flush, publish — only WAL appends are off
                    lsm.ensure_soft(sess, dv, name)
                    feed = ingest.Feed(
                        sess, name, dv, flush_rows=1 << 62,
                        policy=lsm.CompactionPolicy(
                            size_ratio=float("inf"), max_runs=1 << 30))
                    feed._replay = True
                    for seq, kind, payload in tail:
                        lsm._fault(sess, "mid-replay")
                        if kind == "delete":
                            feed.delete(payload["__keys__"])
                        else:
                            getattr(feed, kind)(payload)
                        replayed += 1
                    feed.flush()
                    tel.inc("storage.wal_replayed_batches_total", replayed)
                report["wal_replayed_batches"] += replayed
                report["datasets"][f"{dv}.{name}"] = {
                    "lsn": int(record["lsn"]),
                    "components": 1 + len(runs),
                    "wal_replayed_batches": replayed,
                    "manifest_fallbacks": ds_report["fallbacks"],
                    "quarantined": ds_report["quarantined"],
                }
        except BaseException:
            store.close()
            raise
        report["seconds"] = time.perf_counter() - t0
        report["corruption_events"] = int(
            (tel.counter_value("storage.corruption_total") or 0) - corrupt0)
        tel.observe("storage.recovery_seconds", report["seconds"])
        sess.recovery_report = report
        return sess

    def close(self) -> None:
        """Release the durable store (directory lock + WAL handles); a
        memory-only session does nothing. Crash tests call it to simulate
        process death before reopening the same directory."""
        if self.storage is not None:
            self.storage.close()

    def _ensure_bound(self, plan: P.Plan) -> None:
        """The lazy-rebuild hook of the query path: before binding, rebuild
        the soft state of any scanned dataset still stale from a cold-start
        mount. One set probe when nothing is stale."""
        if not self.catalog.stale:
            return
        from repro_torch.engine import lsm

        for node in P.walk(plan):
            if isinstance(node, P.Scan):
                lsm.ensure_soft(self, node.dataverse,
                                node.dataset.partition("@")[0])

    # -- DDL ----------------------------------------------------------------

    def create_dataset(self, name: str, table: Table, dataverse: str = "Default",
                       closed: bool = True, indexes: Sequence[str] = (),
                       primary: Optional[str] = None) -> Dataset:
        """Register a dataset on the session device. ``primary`` sorts the
        stored table by that column (clustered); ``indexes`` build sorted
        secondary indexes; ``closed=False`` stores integer columns widened
        to float32 (schema-on-read)."""
        t0 = time.perf_counter()
        with tel.span("session.create_dataset", sid=self.sid,
                      dataset=f"{dataverse}.{name}"):
            ds = self._build_dataset(name, table, dataverse=dataverse,
                                     closed=closed, indexes=indexes,
                                     primary=primary)
            self.catalog.register(ds)
            self._plans.clear()
            self._compiled.clear()
        tel.set_gauge("session.last_create_seconds",
                      time.perf_counter() - t0, sid=self.sid)
        return ds

    def _build_dataset(self, name: str, table: Table, dataverse: str = "Default",
                       closed: bool = True, indexes: Sequence[str] = (),
                       primary: Optional[str] = None,
                       stats_like: Optional[Mapping] = None) -> Dataset:
        """Build (cluster → place → stats → widen → shard → index) WITHOUT
        touching the catalog: compaction builds replacement bases off the
        hot path and publishes them with one manifest swap. The clustering
        sort runs on the host (numpy), before the table moves to the device
        once. ``stats_like`` (compaction: the retiring base's meta) keeps
        the string dict-lane decision sticky across components. On a mesh
        the table is row-sharded (``Table.shard``) and its zone maps and
        indexes follow the per-shard layout."""
        host_keys = None
        if primary is not None:
            keys = table.columns[primary].cpu().numpy()
            if not closed:  # cluster in the widened dtype the table stores
                keys = keys.astype(np.float32)
            order = torch.from_numpy(np.argsort(keys, kind="stable"))
            table = Table({k: v[order.to(v.device)]
                           for k, v in table.columns.items()},
                          table.meta, table.num_rows)
        table = _collect_stats(table.to(self.device), like=stats_like)
        if not closed:
            table = open_widen(table)
        if primary is not None:
            meta = dict(table.meta)
            meta[primary] = dataclasses.replace(meta[primary],
                                                sorted_ascending=True)
            table = Table(table.columns, meta, table.num_rows)
            # host copy of the clustered key order: annihilation bookkeeping
            # and point lookups binary-search it
            host_keys = table.columns[primary].cpu().numpy()
        if self.mesh is not None:
            table = table.shard(self.mesh, self.data_axes)
        ds = Dataset(name=name, dataverse=dataverse, table=table, closed=closed,
                     host_keys=host_keys,
                     block_zones=harvest_block_zones(table, self.n_shards))
        if primary is not None:
            ds.indexes["primary"] = self._build_index(table, primary, "primary")
        for col in indexes:
            ds.indexes[f"ix_{col}"] = self._build_index(table, col, "secondary")
        return ds

    def _build_index(self, table: Table, column: str, kind: str) -> IndexInfo:
        """A sorted index, built per shard on a mesh (pad rows sort to each
        shard's +inf tail)."""
        from repro_torch.engine.index import build_index

        ix = build_index(table.columns[column], table.valid, column, kind,
                         self.n_shards)
        return IndexInfo(name=f"{kind}:{column}", column=column, kind=kind,
                         sorted_keys=ix.sorted_keys, row_ids=ix.row_ids,
                         zone_min=ix.zone_min, zone_max=ix.zone_max)

    # -- materialized views (continuous queries over fed datasets) ----------

    def create_view(self, name: str, frame_or_plan):
        """Register a continuously-maintained group-by aggregate:
        ``frame_or_plan`` is an AFrame (or its plan) of shape
        ``groupby(key).agg(...)`` over an optionally filtered dataset scan.
        Seeded from the dataset's visible rows (base ∪ runs), then refreshed
        incrementally from each flush's delta batch."""
        from repro_torch.engine.lsm import MaterializedView

        from repro_torch.engine import lsm

        plan = getattr(frame_or_plan, "_plan", frame_or_plan)
        view = MaterializedView.from_plan(name, plan, self.device)
        lsm.ensure_soft(self, view.dataverse, view.dataset)
        with self.catalog.snapshot() as snap:
            self._seed_view(view, snap.components(view.dataverse,
                                                  view.dataset))
        self.views[name] = view
        return view

    def _seed_view(self, view, comps) -> None:
        """Seed (or reseed) one view from a pinned component tuple."""
        from repro_torch.engine.lsm import host_visible_mask

        base = comps[0]
        key_col = base.primary_index.column \
            if base.primary_index is not None else None
        for comp in comps:
            cols = {k: v.cpu().numpy() for k, v in comp.table.columns.items()
                    if k not in INTERNAL_COLUMNS and not is_lane_column(k)}
            # visible rows only: anti rows and annihilated matter never count
            view.apply_delta(cols, host_visible_mask(comp, key_col))

    def reseed_views(self, dataverse: str, dataset: str) -> None:
        """Rebuild every view over the dataset from scratch (view partials
        are soft state)."""
        targets = [v for v in self.views.values()
                   if (v.dataverse, v.dataset) == (dataverse, dataset)]
        if not targets:
            return
        with self.catalog.snapshot() as snap:
            comps = snap.components(dataverse, dataset)
            for view in targets:
                view.reset()
                self._seed_view(view, comps)

    def read_view(self, name: str) -> dict:
        """The materialized result — no query execution."""
        return self.views[name].result()

    def drop_view(self, name: str) -> None:
        self.views.pop(name, None)

    def refresh_views(self, dataverse: str, dataset: str,
                      delta_cols: dict, retracted: Optional[dict] = None) -> None:
        """Apply one flushed delta batch to every view over the dataset
        (called by Feed.flush). ``retracted`` carries the OLD rows this
        flush's anti-matter annihilated."""
        for view in self.views.values():
            if (view.dataverse, view.dataset) == (dataverse, dataset):
                view.apply_delta(delta_cols)
                if retracted is not None:
                    view.apply_retraction(retracted,
                                          recompute=self._view_recompute(view))

    def _view_recompute(self, view):
        """The exact extremum-repair fallback: host-scan the dataset's
        visible rows and recompute ``op(column)`` for exactly the affected
        groups. Runs only when a retraction removed a group's current
        max/min."""
        from repro_torch.engine.lsm import host_visible_mask

        def recompute(op: str, column: str, group_keys: np.ndarray) -> np.ndarray:
            t0 = time.perf_counter()
            tel.inc("session.view_recomputes_total", sid=self.sid,
                    view=getattr(view, "name", "?"))
            with self.catalog.snapshot() as snap:
                comps = snap.components(view.dataverse, view.dataset)
                ds = comps[0]
                key_col = ds.primary_index.column \
                    if ds.primary_index is not None else None
                keys_parts, vals_parts = [], []
                for comp in comps:
                    mask = host_visible_mask(comp, key_col)
                    cols = comp.table.columns
                    if view.predicate is not None:
                        mask &= view._predicate_mask(
                            {k: v.cpu().numpy() for k, v in cols.items()})
                    keys_parts.append(cols[view.key].cpu().numpy()[mask])
                    vals_parts.append(cols[column].cpu().numpy()[mask])
            keys = np.concatenate(keys_parts)
            vals = np.concatenate(vals_parts).astype(np.float64)
            # one sort, then a binary-searched slice per affected group
            order = np.argsort(keys, kind="stable")
            ks, vs = keys[order], vals[order]
            lo = np.searchsorted(ks, group_keys, side="left")
            hi = np.searchsorted(ks, group_keys, side="right")
            identity = -np.inf if op == "max" else np.inf
            out = np.full(len(group_keys), identity, np.float64)
            for i, (l, h) in enumerate(zip(lo, hi)):
                if h > l:
                    sel = vs[l:h]
                    out[i] = sel.max() if op == "max" else sel.min()
            dt = time.perf_counter() - t0
            tel.observe("session.view_recompute_seconds", dt, sid=self.sid)
            tel.set_gauge("session.last_view_recompute_seconds", dt,
                          sid=self.sid)
            return out

        return recompute

    # -- point lookups (the one path that bypasses compilation) -------------

    def point_lookup(self, dataverse: str, dataset: str, key):
        """Primary-key point lookup: per-component host binary searches over
        the clustered key copies, walked newest → oldest — the first
        component owning the key decides (fresh matter wins, a tombstone
        kills every older occurrence; an upsert run's matter is checked
        before its anti set, which applies to older components only). No
        kernel launch, no compile, no plan-cache traffic.

        Returns the matching row(s) as ``{column: np.ndarray}`` or None;
        ``last_physical`` holds the PointLookup node."""
        from repro_torch.engine import lsm

        lsm.ensure_soft(self, dataverse, dataset)
        t0 = time.perf_counter()
        with self.catalog.snapshot() as snap:
            comps = list(snap.components(dataverse, dataset))
        primary = comps[0].primary_index
        if primary is None:
            raise ValueError(
                f"point lookup needs a primary key on {dataverse}.{dataset} "
                "(create the dataset with primary=<column>)")
        probed = skipped = 0
        shards, shard_probes = 1, 0
        found_in = tombstoned_by = None
        result = None
        for comp in reversed(comps):  # newest component wins
            hk = comp.host_keys
            if hk is not None and len(hk):
                # the clustered copy is sorted: its ends are the key span
                if key < hk[0] or key > hk[-1]:
                    skipped += 1
                else:
                    # shard routing: the per-shard key zone spans name the
                    # owning row partition(s); only their window of the
                    # clustered copy is searched
                    wlo, whi, owners, comp_shards = _route_key(
                        comp, primary.column, key, len(hk))
                    shards = max(shards, comp_shards)
                    if owners == 0:
                        # the key falls between shard spans; the component's
                        # own tombstones are still checked below
                        skipped += 1
                    else:
                        probed += 1
                        shard_probes += owners
                        lo = wlo + int(np.searchsorted(hk[wlo:whi], key,
                                                       side="left"))
                        hi = wlo + int(np.searchsorted(hk[wlo:whi], key,
                                                       side="right"))
                        if hi > lo:
                            # the matter prefix is clustered by the primary
                            # key: index positions are table row positions
                            result = {c: v[lo:hi].cpu().numpy()
                                      for c, v in comp.table.columns.items()
                                      if c not in INTERNAL_COLUMNS
                                      and not c.startswith("__ix")
                                      and not is_lane_column(c)}
                            found_in = f"{comp.dataverse}.{comp.name}"
                            break
            if comp.anti_rows:
                ak = comp.host_anti_keys
                pos = int(np.searchsorted(ak, key))
                if pos < len(ak) and ak[pos] == key:
                    tombstoned_by = f"{comp.dataverse}.{comp.name}"
                    break  # deleted: nothing older is visible
        node = PH.PointLookup(dataverse, dataset, primary.column,
                              components=len(comps), probed=probed,
                              skipped=skipped, found_in=found_in,
                              tombstoned_by=tombstoned_by,
                              shards=shards, shard_probes=shard_probes)
        node.est_rows = 0 if result is None else len(next(iter(result.values())))
        node.cost = probed * 2.0  # binary-search pairs; never a scan
        if tombstoned_by is not None:
            node.note = (f"key is anti-matter in {tombstoned_by} — deleted, "
                         f"older occurrences invisible")
        elif found_in is not None:
            node.note = f"resolved in {found_in} (newest component with the key)"
        else:
            node.note = "key absent from every component span"
        self.last_physical = node
        self.last_prune_report = PH.prune_report(node)
        dt = time.perf_counter() - t0
        tel.inc("session.point_lookups_total", sid=self.sid)
        tel.observe("session.point_lookup_seconds", dt, sid=self.sid)
        tel.set_gauge("session.last_point_lookup_seconds", dt, sid=self.sid)
        return result

    def explain_lookup(self, dataverse: str, dataset: str, key) -> str:
        """The PointLookup plan for ``get(key)``, rendered like explain()."""
        self.point_lookup(dataverse, dataset, key)
        return PH.format_plan(self.last_physical)

    # -- query execution -------------------------------------------------------

    def exec_context(self, catalog=None) -> ExecContext:
        return ExecContext(catalog=catalog if catalog is not None else self.catalog,
                           mode=self.mode, device=self.device, mesh=self.mesh,
                           data_axes=self.data_axes)

    @property
    def n_shards(self) -> int:
        """Row-partition count of the session mesh (1 when meshless): the
        layout zone maps are harvested over and block lists re-base to."""
        return mesh_shards(self.mesh, self.data_axes)

    def _decide(self, e: "_PlanEntry", raw_lits: list):
        with tel.span("session.prune", sid=self.sid):
            if not self.enable_prune:
                return NO_PRUNE
            return e.pruner.decide([l.value for l in raw_lits],
                                   block_skip=self.enable_block_skip)

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
        e = self._new_entry(plan, raw_lits, snap)
        self._plans[raw_fp] = e
        return e

    def _new_entry(self, plan: P.Plan, raw_lits: list, snap) -> _PlanEntry:
        tel.inc("session.optimizes_total", sid=self.sid)
        with tel.span("session.optimize", sid=self.sid):
            opt = optimize(plan, snap, enable_pushdown=self.enable_pushdown)
        with tel.span("session.prune_build", sid=self.sid):
            pruner = build_pruner(opt, snap, raw_lits,
                                  n_shards=self.n_shards)
        return _PlanEntry(snap.stats_epoch, snap.lsn, opt, list(raw_lits), pruner)

    def _variant(self, e: _PlanEntry, raw_lits: list, snap):
        """Levels 2+3: prune signature → (compiled query, binding); compiled
        queries are shared across logical shapes by physical fingerprint."""
        decisions = self._decide(e, raw_lits)
        var = e.variants.get(decisions.signature)
        if var is not None:
            tel.inc("session.plan_cache.hits_total", level="variant", sid=self.sid)
            return var
        tel.inc("session.plan_cache.misses_total", level="variant", sid=self.sid)
        with tel.span("session.plan", sid=self.sid):
            phys = plan_physical(e.opt, snap, mode=self.mode, decisions=decisions,
                                 enable_index=self.enable_index)
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

    def _finish(self, e: _PlanEntry, cq: CompiledQuery, out):
        self.last_optimized = e.opt
        self.last_physical = cq.physical
        self.last_prune_report = PH.prune_report(cq.physical)
        if cq.kind == "scalar":
            vals = {k: v.item() for k, v in out.items()}
            return vals if len(vals) > 1 else next(iter(vals.values()))
        return _materialize(*out)

    def execute(self, plan: P.Plan):
        """Optimize → cost-plan (run pruning and block skipping decided at
        bind time) → compile (cached) → run → numpy. Scalar results come
        back as Python numbers, tables as ``{column: np.ndarray}`` of the
        live rows. The query pins one catalog snapshot and runs entirely
        against it: a concurrent flush or compaction binds the NEXT query."""
        t0 = time.perf_counter()
        raw_fp = plan.fingerprint()
        raw_lits = ordered_lits(P.all_exprs(plan))
        self._ensure_bound(plan)
        with self.catalog.snapshot() as snap:
            with tel.span("session.execute", sid=self.sid, mode=self.mode):
                e = self._plan_entry(plan, raw_fp, raw_lits, snap)
                cq, binding = self._variant(e, raw_lits, snap)
                params = _bind_params(binding, raw_lits, self.device)
                with tel.span("session.execute.run", sid=self.sid):
                    out = cq.run(snap, params=params)
                    result = self._finish(e, cq, out)
        dt = time.perf_counter() - t0
        tel.inc("session.executes_total", sid=self.sid, mode=self.mode)
        tel.set_gauge("session.last_execute_seconds", dt, sid=self.sid)
        tel.inc("session.pruned_components_total",
                self.last_prune_report["pruned"], sid=self.sid)
        return result

    def persist(self, plan: P.Plan, name: str,
                dataverse: str = "Default") -> Dataset:
        """CREATE DATASET AS <query> (paper Input 15): the result stays on
        the session's device — its rows, with the query's live-row mask as
        ``__valid__`` — as a new closed single-component dataset with fresh
        statistics and zone maps."""
        raw_lits = ordered_lits(P.all_exprs(plan))
        self._ensure_bound(plan)
        with self.catalog.snapshot() as snap:
            # as the reference's: optimized (counted), then planned and
            # compiled once outside the plan cache (neither kept nor counted)
            e = self._new_entry(plan, raw_lits, snap)
            phys = plan_physical(e.opt, snap, mode=self.mode,
                                 decisions=self._decide(e, raw_lits),
                                 enable_index=self.enable_index)
            cq = compile_physical(phys, self.exec_context(snap))
            binding = _literal_binding(e.raw_lits0,
                                       ordered_lits(PH.all_exprs(phys)))
            out = cq.run(snap, params=_bind_params(binding, raw_lits,
                                                   self.device))
        if cq.kind == "scalar":
            raise ValueError("cannot persist a scalar result")
        env, mask = out
        # per-component dict lanes do not share a dictionary: stats rebuild
        cols = {k: v for k, v in env.items() if not is_lane_column(k)}
        cols["__valid__"] = mask
        return self.create_dataset(name, Table(cols, num_rows=int(mask.shape[0])),
                                   dataverse)

    def explain(self, plan: P.Plan, analyze: bool = False) -> str:
        """The costed physical plan for ``plan`` with the pruning rationale;
        compiles and runs nothing. ``analyze=True`` also EXECUTES the query
        (``profile``) and annotates every operator with measured time and
        actual rows."""
        if analyze:
            return self.profile(plan)["text"]
        raw_lits = ordered_lits(P.all_exprs(plan))
        self._ensure_bound(plan)
        with self.catalog.snapshot() as snap:
            e = self._plan_entry(plan, plan.fingerprint(), raw_lits, snap)
            phys = plan_physical(e.opt, snap, mode=self.mode,
                                 decisions=self._decide(e, raw_lits),
                                 enable_index=self.enable_index)
        return PH.format_plan(phys)

    def profile(self, plan: P.Plan) -> dict:
        """``explain(analyze=True)``'s engine: run ``plan`` through the
        cached pipeline, time the whole run, then measure every operator's
        subtree standalone (``compiler.profile_physical``).

        Returns ``{"text", "result", "measures", "prune_report"}`` —
        ``result`` is exactly what ``execute(plan)`` returns."""
        tel.inc("session.profiles_total", sid=self.sid)
        raw_lits = ordered_lits(P.all_exprs(plan))
        self._ensure_bound(plan)
        with self.catalog.snapshot() as snap:
            with tel.span("session.profile", sid=self.sid, mode=self.mode):
                e = self._plan_entry(plan, plan.fingerprint(), raw_lits, snap)
                cq, binding = self._variant(e, raw_lits, snap)
                params = _bind_params(binding, raw_lits, self.device)
                tables = cq.gather_tables(snap)
                t0 = time.perf_counter()
                out = cq.fn(tables, params)
                result = self._finish(e, cq, out)
                run_seconds = time.perf_counter() - t0
                measures = profile_physical(cq.lowered,
                                            self.exec_context(snap),
                                            tables, params)
        # measured on the query's own lowered copy; keyed back onto this
        # binding's plan, which has the same shape
        measures["nodes"] = {
            id(node): measures["nodes"][id(low)]
            for low, node in zip(PH.walk(cq.lowered), PH.walk(cq.physical))
            if id(low) in measures["nodes"]}
        measures["jit_seconds"] = run_seconds
        return {"text": PH.format_plan(cq.physical, analyze=measures),
                "result": result, "measures": measures,
                "prune_report": self.last_prune_report}


def _literal_binding(raw_lits, opt_lits) -> list[tuple[str, object]]:
    """Map each physical-plan param slot back to the raw plan's literals:
    a user literal (or one the optimizer mirrored from it, via ``source``)
    rebinds to the fresh raw value; anything else is a plan constant.

    A literal the planner derived through a value TRANSFORM (the dict-id
    bounds of a string predicate) carries a ``binder`` callable and the user
    ``sources`` it derives from: the binding records both, so a rebind maps
    the fresh string literals through the same dictionary."""
    index = {id(l): j for j, l in enumerate(raw_lits)}

    def resolve(lit):
        src = lit
        while id(src) not in index and getattr(src, "source", None) is not None:
            src = src.source
        return ("raw", index[id(src)]) if id(src) in index \
            else ("const", lit.value)

    binding: list[tuple[str, object]] = []
    for lit in opt_lits:
        binder = getattr(lit, "binder", None)
        if binder is not None:
            binding.append(("xform", (binder, tuple(resolve(s)
                                                    for s in lit.sources))))
        else:
            binding.append(resolve(lit))
    return binding


def _bind_params(binding, raw_lits, device):
    def value(kind, v):
        if kind == "xform":
            binder, refs = v
            return binder(*[value(k, r) for k, r in refs])
        return raw_lits[v].value if kind == "raw" else v

    return [encode_param(value(kind, v), device) for kind, v in binding]


def _mount_component(session: Session, dataverse: str, seg: str,
                     arrays: Mapping, meta: Mapping) -> Dataset:
    """Rehydrate one LSM component from its durable segment: hard state
    only — the table columns, placed on the session device once in the
    segment's column order (and row-sharded onto the session's mesh),
    their metadata, and the index *inventory* (payloads stay None until
    the soft-state rebuild at first bind)."""
    from repro_torch.runtime.durable import _meta_from_json

    cols, cmeta = {}, {}
    for cname, mjson in meta["columns"]:
        cols[cname] = torch.from_numpy(arrays[cname]).to(session.device)
        cmeta[cname] = _meta_from_json(mjson)
    table = Table(cols, cmeta, int(meta["num_rows"]))
    if session.mesh is not None:
        table = table.shard(session.mesh, session.data_axes)
    ds = Dataset(name=meta["name"], dataverse=dataverse, table=table,
                 closed=bool(meta["closed"]), live_rows=meta["live_rows"],
                 anti_rows=int(meta["anti_rows"]), level=int(meta["level"]),
                 uid=int(meta["uid"]), engine_owned=True, seg_name=seg,
                 soft_stale=True)
    for key, ix_name, column, kind in meta["indexes"]:
        ds.indexes[key] = IndexInfo(name=ix_name, column=column, kind=kind)
    return ds


def _route_key(comp, key_col: str, key, n_keys: int):
    """Shard-route a point lookup inside one component: fold the clustered
    key column's per-shard zone spans into one [lo, hi] per row partition
    and return the ``host_keys`` window covering the owning shard(s) —
    ``(window_lo, window_hi, owning_shards, n_shards)``. The matter prefix
    is clustered, so the owners are a contiguous run and the window one
    slice (a duplicate key across a shard boundary is found whole). A
    component without a sharded zone layout searches its full window."""
    bz = comp.block_zones
    if bz is None or bz.n_shards <= 1 or not bz.rows_per_shard:
        return 0, n_keys, 1, 1
    span = bz.span_of(key_col)
    if span is None:
        return 0, n_keys, 1, bz.n_shards
    per = span.reshape(bz.n_shards, bz.blocks_per_shard, 2)
    owners = np.nonzero((per[:, :, 0].min(axis=1) <= key)
                        & (key <= per[:, :, 1].max(axis=1)))[0]
    if not len(owners):
        return 0, 0, 0, bz.n_shards
    wlo = min(int(owners[0]) * bz.rows_per_shard, n_keys)
    whi = min((int(owners[-1]) + 1) * bz.rows_per_shard, n_keys)
    return wlo, whi, len(owners), bz.n_shards


def _collect_stats(table: Table, like: Optional[Mapping] = None) -> Table:
    """Fill missing lo/hi/distinct for numeric columns, and grow every
    string column's derived integer lanes: the order-preserving
    ``__pfx_<col>`` prefix lane, and the sorted dictionary-id lane
    ``__dict_<col>`` when the distinct count stays under DICT_THRESHOLD
    (dead rows carry id -1). ``like`` is the base's meta when building an
    LSM run or a compacted base: dict-lane presence then follows it, so the
    column set stays uniform across a dataset's components. Runs on the
    table's device; the lanes and metadata equal the reference's."""
    meta = dict(table.meta)
    cols = dict(table.columns)
    live = table.valid
    anti = cols.get("__antimatter__")
    if anti is not None:
        live = live & ~anti
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
                hint = getattr(like.get(name), "dict_values", None) \
                    if like is not None else None
                want_dict = (hint is not None) if like is not None \
                    else uniq.shape[0] <= DICT_THRESHOLD
                new = m if m is not None else ColumnMeta(np.dtype(np.uint8),
                                                         is_string=True)
                new = dataclasses.replace(new, distinct=int(uniq.shape[0]))
                if want_dict:
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

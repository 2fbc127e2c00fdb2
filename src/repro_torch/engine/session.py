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

``Session(mesh=init_rank_mesh(data=S, ...))`` runs the same engine over a
mesh of ``torch.distributed`` ranks, one process each (every rank builds
its own session and makes the same calls). The invariants:

* I1, only a rank's own rows on its device: each rank keeps rows ``[i *
  rps, (i + 1) * rps)`` of every table (rps = ceil(n / S), ``Table.shard``)
  plus its ``__valid__`` mask; what else it holds is small and
  replicated (column stats, zone maps, index zones, merged results). The
  statistics are computed per shard and merged over the data axes, so the
  whole table never reaches the device, not even while registering.
  Through ingest too: after every flush, merge and compaction each rank
  holds ``ceil(rows / S)`` rows of each run and base, laid out as
  ``Table.shard`` lays them out, plus small replicated state (stats, zone
  maps, index zones, anti-key arrays, view state). A compaction's rows may
  pass through a rank's HOST (the merge is a host merge, as the
  reference's); the gather that brings them there moves at most
  ``distributed.GATHER_CHUNK_ROWS`` (2^18) rows a rank per collective,
  each chunk copied to the host before the next, so they never sit whole
  on a device.
* I2, every rank plans alike: the stats, the gathered zone maps and so
  the plans, prune reports and ``explain`` texts are the same on every
  rank, and equal the one-process S-shard mesh's (a rank whose plan
  differed would issue other collectives, and the group would hang). At
  every query, point lookup and flush each rank holds the same manifest:
  the same components in the same order, the same LSN and kill-sets. A
  publish (flush, merge or compaction) commits on every rank or on none:
  before the swap the ranks take a MIN vote over the data group
  (``launch.mesh.agree``, ``lsm._vote``), and a fault or a lost CAS on
  one rank aborts the swap on all of them.
* I3, every rank answers alike: each operator merges over the data axes'
  process group (``engine/distributed.py``, in every mode: there is no
  GSPMD in torch, so ``gspmd`` lowers to the same explicit collectives),
  row streams are gathered before delivery (a union of components in
  component order), and point lookups gather the owning rank's rows; the
  answers, dtypes, explain texts and prune reports equal the one-process
  mesh's, and the answers and dtypes the meshless session's.

On a rank mesh every rank makes its session calls from one thread (the
one that made the session), in the same order; a call from another
thread raises ``NotImplementedError`` (reader threads on a rank mesh,
ROADMAP A9b-2f). The feed, LSM runs, full, leveled and background
compaction, views, ``persist`` and the durable store (``storage=``,
``Session.open``, ``lsm.recover``) run there. The ranks share one store
in the format a meshless session writes (``runtime/durable.py``): global
rank 0 writes it, every rank votes on each of its writes, and at open
every rank reads the segments the writer chose and keeps its own rows.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
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
from repro_torch.launch.mesh import is_rank_mesh
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
        (``launch.mesh.make_local_mesh``, or ``init_rank_mesh`` for a mesh
        of ranks, where 'auto' is always 'shard_map') row-shards every
        table over its ``data_axes``; its device is the session device
        (this rank's on a rank mesh). ``catalog``
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
        recovers such a directory. On a rank mesh pass the path (every
        rank does): each rank makes its view of the ranks' one store."""
        if mode == "auto":
            mode = "shard_map" if mesh is not None and (
                mesh.size > 1 or is_rank_mesh(mesh)) else "gspmd"
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
        # the thread a rank session's calls must come from (see _on_owner)
        self._owner = threading.get_ident() if is_rank_mesh(mesh) else None
        self.storage = None
        if storage is not None:
            from repro_torch.engine import lsm
            from repro_torch.runtime.durable import DurableStore

            store = storage if isinstance(storage, DurableStore) \
                else DurableStore(storage, mesh=mesh)
            if is_rank_mesh(mesh) and store.mesh is None:
                raise ValueError("a rank session's store is made on the "
                                 "mesh: pass its path")
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
        # background compactors on a rank mesh: each query is a point where
        # the ranks agree to publish what they have all built
        self._compactors: list = []

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
        ``StorageLockError`` if a live process holds the directory.

        On a rank mesh (``mesh=init_rank_mesh(...)``, every rank calls it)
        the writer rank alone takes the lock, chooses each generation and
        reads each WAL tail, and broadcasts them; every rank reads the
        chosen segments from the one host's disk and keeps only its own
        rows of each (sliced on the host, ``_mount_component``); the
        rebuild and the replay are the engine's collective paths, and a
        fault at any step raises on every rank."""
        from repro_torch.engine import ingest, lsm
        from repro_torch.runtime.durable import DurableStore

        t0 = time.perf_counter()
        store = path if isinstance(path, DurableStore) \
            else DurableStore(path, mesh=kwargs.get("mesh"))
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
                        lsm._agreed_fault(sess, "mid-replay")
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
        # each fallback is one corrupt manifest or segment quarantined
        # (``storage.corruption_total``), the same count on every rank
        report["corruption_events"] = sum(
            d["manifest_fallbacks"] for d in report["datasets"].values())
        tel.observe("storage.recovery_seconds", report["seconds"])
        sess.recovery_report = report
        return sess

    def close(self) -> None:
        """Release the durable store (directory lock + WAL handles); a
        memory-only session does nothing. Crash tests call it to simulate
        process death before reopening the same directory. On a rank mesh
        every rank calls it (the writer's releases the files)."""
        if self.storage is not None:
            self.storage.close()

    def _on_owner(self) -> None:
        """A rank session's entry points run on the thread that made it:
        every rank issues its collectives from one thread in one order,
        and a call from another thread would interleave its collectives
        with the owner's. The background compactor's worker builds on
        groups of its own (``lsm._RankCompactor``)."""
        if self._owner is not None and threading.get_ident() != self._owner:
            raise NotImplementedError(
                "a rank session is entered from a thread other than the one "
                "that made it: reader threads on a rank mesh are ROADMAP "
                "A9b-2f; call it from its own thread")

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
        self._on_owner()
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
        indexes follow the per-shard layout.

        On a rank mesh (I1) the shard comes first: this rank's rows alone
        move to the device, and the statistics, string lanes, zone maps
        and index zones are computed over the shard and merged over the
        data axes (:func:`_collect_stats_on_ranks`,
        ``harvest_block_zones``, ``build_index_on_ranks``), equal on every
        rank and to what the one-process mesh builds. The source table
        (every rank is given the same one) stays where it is; the
        clustering sort and ``host_keys`` come from it. A table that is
        already this rank's shard (``persist``) is taken as it is."""
        on_ranks = is_rank_mesh(self.mesh)
        host_keys = None
        if primary is not None:
            keys = table.columns[primary].cpu().numpy()
            if not closed:  # cluster in the widened dtype the table stores
                keys = keys.astype(np.float32)
            order = torch.from_numpy(np.argsort(keys, kind="stable"))
            table = Table({k: v[order.to(v.device)]
                           for k, v in table.columns.items()},
                          table.meta, table.num_rows)
        source = table
        if on_ranks and table.mesh is not None:
            # already this rank's shard (persist): every row is real
            table = _collect_stats_on_ranks(table, table.global_rows,
                                            like=stats_like)
        elif on_ranks:
            table = _collect_stats_on_ranks(
                table.shard(self.mesh, self.data_axes), table.num_rows,
                like=stats_like)
        else:
            table = _collect_stats(table.to(self.device), like=stats_like)
        if not closed:
            table = open_widen(table)
        if primary is not None:
            meta = dict(table.meta)
            meta[primary] = dataclasses.replace(meta[primary],
                                                sorted_ascending=True)
            table = table.with_columns(table.columns, meta)
            # host copy of the clustered key order (whole, on a rank mesh
            # too): annihilation bookkeeping and point lookups search it
            keys = (source if on_ranks else table).columns[primary]
            host_keys = keys.cpu().numpy().astype(
                numpy_dtype(table.columns[primary].dtype), copy=False)
        if self.mesh is not None and not on_ranks:
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
        shard's +inf tail; on a rank mesh each rank sorts its own shard)."""
        from repro_torch.engine.index import build_index, build_index_on_ranks

        if table.mesh is not None:
            ix = build_index_on_ranks(table.columns[column], table.valid,
                                      column, kind, table.mesh, table.data_axes)
        else:
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

        self._on_owner()
        plan = getattr(frame_or_plan, "_plan", frame_or_plan)
        view = MaterializedView.from_plan(name, plan, self.device)
        lsm.ensure_soft(self, view.dataverse, view.dataset)
        with self.catalog.snapshot() as snap:
            self._seed_view(view, snap.components(view.dataverse,
                                                  view.dataset))
        self.views[name] = view
        return view

    def _seed_view(self, view, comps) -> None:
        """Seed (or reseed) one view from a pinned component tuple. On a
        rank mesh from each component's visible rows of the view's own
        columns, gathered to every rank's host in global row order, so its
        sums add in the one-process mesh's order (the kernel gate charged
        the component's rows, as there)."""
        from repro_torch.engine.lsm import _visible_columns, host_visible_mask

        base = comps[0]
        key_col = base.primary_index.column \
            if base.primary_index is not None else None
        if is_rank_mesh(self.mesh):
            for comp in comps:
                view.apply_delta(_visible_columns(comp, key_col,
                                                  names=view.columns()),
                                 rows=comp.table.global_rows)
            return
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
        from repro_torch.engine.lsm import _visible_columns, host_visible_mask

        names = view.columns()

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
                    if is_rank_mesh(self.mesh):
                        # the visible rows of the view's columns, gathered
                        cols = _visible_columns(comp, key_col, names=names)
                        mask = np.ones(len(cols[view.key]), bool)
                    else:
                        mask = host_visible_mask(comp, key_col)
                        cols = {k: v.cpu().numpy()
                                for k, v in comp.table.columns.items()}
                    if view.predicate is not None:
                        mask &= view._predicate_mask(cols)
                    keys_parts.append(cols[view.key][mask])
                    vals_parts.append(cols[column][mask])
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

        self._on_owner()
        lsm.ensure_soft(self, dataverse, dataset)
        self._agreed_point()
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
                            result = _table_rows(comp.table,
                                                 np.arange(lo, hi))
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

    def _agreed_point(self) -> None:
        """On a rank mesh, publish what every rank's background compactor
        has built (each is polled alike on every rank)."""
        for c in list(self._compactors):
            c.poll()

    def execute(self, plan: P.Plan):
        """Optimize → cost-plan (run pruning and block skipping decided at
        bind time) → compile (cached) → run → numpy. Scalar results come
        back as Python numbers, tables as ``{column: np.ndarray}`` of the
        live rows. The query pins one catalog snapshot and runs entirely
        against it: a concurrent flush or compaction binds the NEXT query."""
        self._on_owner()
        t0 = time.perf_counter()
        raw_fp = plan.fingerprint()
        raw_lits = ordered_lits(P.all_exprs(plan))
        self._ensure_bound(plan)
        self._agreed_point()
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
        statistics and zone maps.

        On a rank mesh the result is not gathered: a stream that is this
        rank's rows of one component, of equal length on every rank, stays
        where it is as this rank's shard of the new dataset (no rows move;
        its stats merge over the ranks). A union's stream, or one whose
        block gathers left the ranks unequal, comes to every rank's host
        in component order (``distributed.gather_to_host``, in chunks) and
        is sharded again; a merged result (a group-by, a sort) is whole on
        every rank already."""
        from repro_torch.core.compiler import _replicated, _union_below

        self._on_owner()
        raw_lits = ordered_lits(P.all_exprs(plan))
        self._ensure_bound(plan)
        on_ranks = is_rank_mesh(self.mesh)
        with self.catalog.snapshot() as snap:
            # as the reference's: optimized (counted), then planned and
            # compiled once outside the plan cache (neither kept nor counted)
            e = self._new_entry(plan, raw_lits, snap)
            phys = plan_physical(e.opt, snap, mode=self.mode,
                                 decisions=self._decide(e, raw_lits),
                                 enable_index=self.enable_index)
            cq = compile_physical(phys, self.exec_context(snap),
                                  gathered=not on_ranks)
            binding = _literal_binding(e.raw_lits0,
                                       ordered_lits(PH.all_exprs(phys)))
            tables = cq.gather_tables(snap)
            out = cq.fn(tables, _bind_params(binding, raw_lits, self.device))
        if cq.kind == "scalar":
            raise ValueError("cannot persist a scalar result")
        env, mask = out
        # per-component dict lanes do not share a dictionary: stats rebuild
        cols = {k: v for k, v in env.items() if not is_lane_column(k)}
        cols["__valid__"] = mask
        if on_ranks and cq.kind == "table" and not _replicated(cq.lowered):
            union = _union_below(cq.lowered)
            lens = None if union is None else tables[("union", id(union))]
            table = self._rank_result(cols, lens)
        else:
            table = Table(cols, num_rows=int(mask.shape[0]))
        return self.create_dataset(name, table, dataverse)

    def _rank_result(self, cols: dict, lens: Optional[list]) -> Table:
        """A persisted stream on a rank mesh: this rank's shard of it (see
        ``persist``)."""
        from repro_torch.engine import distributed as D

        sh = D.Shards(self.mesh, self.data_axes)
        n = next(iter(cols.values())).shape[0]
        mine = torch.tensor(n, dtype=torch.int64, device=self.device)
        if lens is None and int(sh.merge("min", [mine])) == \
                int(sh.merge("max", [mine])):
            return Table(cols, num_rows=n, mesh=self.mesh,
                         data_axes=self.data_axes, global_rows=sh.n * n,
                         row_offset=sh.index * n)
        names, parts, at = list(cols), [], 0
        for seg in (lens or [n]):
            keep = np.zeros(n, bool)
            keep[at:at + seg] = True
            parts.append(D.gather_to_host(self.mesh, self.data_axes,
                                          [cols[k] for k in names], keep))
            at += seg
        return Table({k: np.concatenate([p[i] for p in parts])
                      for i, k in enumerate(names)})

    def explain(self, plan: P.Plan, analyze: bool = False) -> str:
        """The costed physical plan for ``plan`` with the pruning rationale;
        compiles and runs nothing. ``analyze=True`` also EXECUTES the query
        (``profile``) and annotates every operator with measured time and
        actual rows."""
        if analyze:
            return self.profile(plan)["text"]
        self._on_owner()
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
        self._on_owner()
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
    the soft-state rebuild at first bind). On a mesh the columns are
    sharded on the host: a rank's own rows alone reach its device."""
    from repro_torch.runtime.durable import _meta_from_json

    cols, cmeta = {}, {}
    for cname, mjson in meta["columns"]:
        cols[cname] = torch.from_numpy(arrays[cname])
        cmeta[cname] = _meta_from_json(mjson)
    table = Table(cols, cmeta, int(meta["num_rows"]))
    if session.mesh is not None:
        table = table.shard(session.mesh, session.data_axes)
    else:
        table = table.to(session.device)
    ds = Dataset(name=meta["name"], dataverse=dataverse, table=table,
                 closed=bool(meta["closed"]), live_rows=meta["live_rows"],
                 anti_rows=int(meta["anti_rows"]), level=int(meta["level"]),
                 uid=int(meta["uid"]), engine_owned=True, seg_name=seg,
                 soft_stale=True)
    for key, ix_name, column, kind in meta["indexes"]:
        ds.indexes[key] = IndexInfo(name=ix_name, column=column, kind=kind)
    return ds


def _table_rows(table: Table, idx: np.ndarray) -> dict[str, np.ndarray]:
    """Rows ``idx`` (table row ids, global ones on a rank's shard) of the
    table's user columns, as numpy. On a rank's shard each rank fills the
    rows it owns and the ranks all-gather them (every rank takes part; the
    host key copies told them all the same rows), each row taken from its
    owner — the same answer on every rank. At most
    ``distributed.GATHER_CHUNK_ROWS`` rows go per all-gather, so a large
    set (the rows a tombstone batch retracts) is never staged whole."""
    names = [c for c in table.columns if c not in INTERNAL_COLUMNS
             and not c.startswith("__ix") and not is_lane_column(c)]
    if table.mesh is None:
        at = torch.from_numpy(np.asarray(idx, np.int64))
        return {c: table.columns[c][at.to(table.columns[c].device)].cpu().numpy()
                for c in names}
    from repro_torch.engine import distributed as D

    sh = D.Shards(table.mesh, table.data_axes)
    off, rps = table.row_offset, table.num_rows
    out: dict[str, list] = {c: [] for c in names}
    for lo in range(0, len(idx), D.GATHER_CHUNK_ROWS):
        rows = np.asarray(idx[lo:lo + D.GATHER_CHUNK_ROWS], np.int64)
        width = len(rows)
        mine = (rows >= off) & (rows < off + rps)     # the rows this rank owns
        at = torch.from_numpy(np.flatnonzero(mine))
        local = torch.from_numpy(rows[mine] - off)
        pick = torch.from_numpy(rows // rps * width + np.arange(width))
        parts = []
        for c in names:
            v = table.columns[c]
            part = v.new_zeros((width,) + tuple(v.shape[1:]))
            part[at.to(v.device)] = v[local.to(v.device)]
            parts.append(part)
        for c, g in zip(names, sh.gather_rows(parts, width)):
            out[c].append(g.cpu()[pick].numpy())
    return {c: np.concatenate(v) for c, v in out.items()}


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


def _span(sh, x: torch.Tensor, mask: torch.Tensor):
    """(min, max) of ``x`` over the masked rows of every shard, as Python
    numbers, or (None, None) where no shard has such a row."""
    if not int(sh.psum([mask.sum(dtype=torch.int64)])):
        return None, None
    big = torch.finfo(x.dtype) if x.dtype.is_floating_point \
        else torch.iinfo(x.dtype)
    lo = sh.merge("min", [torch.where(mask, x, big.max).min()])
    hi = sh.merge("max", [torch.where(mask, x, big.min).max()])
    return lo.item(), hi.item()


def _distinct_rows(sh, uniq: torch.Tensor) -> int:
    """How many distinct rows the shards' deduplicated (u, w) uint8 rows
    hold together: each row goes to the shard a hash of its bytes names
    (an all-to-all into fixed-capacity buckets), so equal rows meet on one
    shard; their distinct counts psum. No shard sees more than its
    bucket."""
    dev, nsh = uniq.device, sh.n
    weights = torch.arange(uniq.shape[1], dtype=torch.int64,
                           device=dev) * 2654435761 + 1
    dest = torch.remainder((uniq.to(torch.int64) * weights).sum(1), nsh)
    order = torch.argsort(dest, stable=True)
    ds, rows = dest[order], uniq[order]
    counts = torch.bincount(dest, minlength=nsh)
    cap = max(int(sh.merge("max", [counts.max()])), 1)
    slot = ds * cap + torch.arange(ds.shape[0], device=dev) \
        - (torch.cumsum(counts, 0) - counts)[ds]
    buf = uniq.new_zeros((nsh * cap, uniq.shape[1]))
    buf[slot] = rows
    have = torch.zeros(nsh * cap, dtype=torch.uint8, device=dev)
    have[slot] = 1
    got = sh.all_to_all([buf.view(nsh, cap, -1)])[0]
    kept = sh.all_to_all([have.view(nsh, cap)])[0].bool()
    mine = torch.unique(got[kept], dim=0).shape[0]
    return int(sh.psum([torch.tensor(mine, dtype=torch.int64, device=dev)]))


def _string_dictionary(sh, col: torch.Tensor, live: torch.Tensor,
                       want: Optional[bool] = None):
    """A string column's sorted dictionary over the live rows of every
    shard, its distinct count and this shard's dict-lane ids (the sorted
    dictionary's positions; dead rows -1), as ``torch.unique`` over the
    whole column gives them; (None, distinct, None) past DICT_THRESHOLD.
    The shards' own dictionaries are gathered only while every one is
    within the threshold; beyond it only the count is merged. ``want``
    (a run or a compacted base: the dict lane follows the base's) forces
    the lane on (True) or off (False) whatever the count."""
    uniq, inv = torch.unique(col[live], dim=0, return_inverse=True)
    most = sh.longest(uniq)
    if most > DICT_THRESHOLD and not want:
        return None, _distinct_rows(sh, uniq), None
    rows = max(most, 1)
    have = torch.ones(uniq.shape[0], dtype=torch.bool, device=col.device)
    every = sh.gather([uniq], rows)[sh.gather([have], rows)]
    dictionary = torch.unique(every, dim=0)
    g = int(dictionary.shape[0])
    if want is False or (want is None and g > DICT_THRESHOLD):
        return None, g, None
    ids = torch.full((col.shape[0],), -1, dtype=torch.int32, device=col.device)
    if uniq.shape[0]:   # a shard with no live row (a delete-only run) keeps -1
        pos = (uniq[:, None, :] == dictionary[None]).all(-1).to(torch.int32) \
            .argmax(1).to(torch.int32)
        ids[live] = pos[inv]
    return dictionary, g, ids


def _collect_stats_on_ranks(table: Table, n: int,
                            like: Optional[Mapping] = None) -> Table:
    """:func:`_collect_stats` over a rank's row shard of a table whose
    first ``n`` rows are real (``Table.shard`` on a RankMesh; a run's
    matter prefix, its anti rows and block padding after it): every bound,
    distinct count, prefix lane span and string dictionary is computed
    over the shard and merged over the data axes (pmin / pmax / psum, a
    gather of the shards' small dictionaries, a hash all-to-all for a
    large distinct count), so the meta is the same on every rank and equal
    to the meshless session's, and the lanes hold this shard's rows of the
    meshless lanes (rows past ``n`` zero, as the one-process mesh pads
    them). ``like`` as :func:`_collect_stats`'s."""
    from repro_torch.engine import distributed as D

    sh = D.Shards(table.mesh, table.data_axes)
    meta = dict(table.meta)
    cols = dict(table.columns)
    live = table.valid
    anti = cols.get("__antimatter__")
    if anti is not None:
        live = live & ~anti
    dev = live.device
    real = torch.arange(table.num_rows, device=dev) + table.row_offset < n
    for name, col in table.columns.items():
        if name in INTERNAL_COLUMNS or is_lane_column(name):
            continue
        m = meta.get(name)
        if col.ndim == 2 and col.dtype == torch.uint8:
            pfx = prefix_lane_name(name)
            if pfx not in cols:
                packed = pack_prefix(col)
                cols[pfx] = packed
                meta[pfx] = ColumnMeta(np.dtype(np.int32),
                                       *_span(sh, packed, live))
            dname = dict_lane_name(name)
            if dname not in cols:
                want = None if like is None else \
                    getattr(like.get(name), "dict_values", None) is not None
                dictionary, g, ids = _string_dictionary(sh, col, live, want)
                new = m if m is not None else ColumnMeta(np.dtype(np.uint8),
                                                         is_string=True)
                new = dataclasses.replace(new, distinct=g)
                if dictionary is not None:
                    cols[dname] = torch.where(real, ids, 0)
                    meta[dname] = ColumnMeta(np.dtype(np.int32),
                                             0 if g else None,
                                             g - 1 if g else None, g)
                    new = dataclasses.replace(
                        new, dict_values=tuple(decode_strings(dictionary)))
                meta[name] = new
            continue
        if m is not None and m.lo is not None:
            continue
        if col.ndim != 1 or not n:
            continue
        if col.dtype.is_floating_point:
            lo, hi = _span(sh, col, real & ~torch.isnan(col))
            if lo is not None:
                meta[name] = ColumnMeta(numpy_dtype(col.dtype), float(lo),
                                        float(hi))
        elif col.dtype != torch.bool:
            lo, hi = _span(sh, col, real)
            meta[name] = ColumnMeta(numpy_dtype(col.dtype), int(lo), int(hi),
                                    min(int(hi) - int(lo) + 1, n))
    # the internal columns last, as the meshless build appends them after
    # the lanes
    for d in (cols, meta):
        for k in INTERNAL_COLUMNS[::-1]:
            if k in d:
                d[k] = d.pop(k)
    return table.with_columns(cols, meta)


def _materialize(env: dict, mask) -> dict[str, np.ndarray]:
    """Compact to live rows on the host (the result delivery boundary);
    derived string lanes are storage internals, never delivered."""
    m = mask.cpu().numpy()
    return {k: v.cpu().numpy()[m] for k, v in env.items() if not is_lane_column(k)}

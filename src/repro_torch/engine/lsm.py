"""LSM storage for streaming ingestion (port of ``repro.engine.lsm``; the
paper's §III-A feed path).

  * a **flush** turns the host buffer into a *run*: a block-padded columnar
    Table on the session device with its own sorted indexes and zone maps,
    registered beside the base. The batch is sorted on the host (numpy, by
    the base's primary key) and placed on the device once; flush cost is
    O(batch), never O(base).
  * **mutations** follow AsterixDB's anti-matter design: a delete/upsert
    buffers an anti-matter record; the flushed run carries per-row
    ``__antimatter__`` flags (anti rows are ``__valid__`` False, after the
    matter prefix) plus a sorted anti-key tensor for query-time visibility
    probes. Anti-matter annihilates all matter with its key in strictly
    older components — newest component wins.
  * queries over a fed dataset run as **base ∪ runs** (``UnionRuns``):
    per-component index probes and kernel launches, one final merge —
    identical to querying the compacted dataset, mutations included.
  * **compaction** is deferred until a size-ratio policy fires, then folds
    every component into the base with a key-ordered newest-wins merge
    (annihilated matter and every tombstone drop). The leveled variant
    merges same-level run groups into the next level.
  * **materialized views** are group-by aggregates maintained
    incrementally: each flush runs only the delta batch through
    ``segment_agg`` (gated by the same f32-exactness reasoning as kernel
    mode) and merges partials into int64/float64 host state; deletes and
    upserts feed retraction deltas.

Crash recovery splits hard state (component tables, the manifest, the
index inventory) from soft state (index payloads, zone maps, host key
copies, annihilation bookkeeping, view partials): ``recover`` rebuilds the
soft state on the session device from the hard state, and after a
cold-start mount ``ensure_soft`` does so lazily at the first bind. With a
durable store (``runtime/durable.py``) flush- and compaction-built
components are written to their segments off the catalog lock, before the
publish that links them. ``_fault`` consults the session's ``fault_plan``
(``runtime/fault.py``) at the named crash points. On a rank mesh a
segment write is collective (the component's rows gathered to the
store's writer rank, the write voted on), and the soft-state rebuild
merges each shard's counts, keys and zones over the ranks.

On a mesh of ``torch.distributed`` ranks (``launch.mesh.RankMesh``) every
rank makes the same calls with the same batches and keeps only its own
rows of every component: a run is sorted and block-padded on the host,
then sharded (``Table.shard``), its statistics merged over the ranks. The
kill-sets, host key copies and anti keys are host state, the same on every
rank. A compaction brings each component's visible rows to every rank's
host (``distributed.gather_to_host``, in chunks), runs the same host merge
there, and shards the result again; the rows a tombstone retracts from a
view come from their owners the same way. Every publish takes a vote of
the ranks before its swap (``_vote``): a fault or a lost CAS on one rank
aborts it on all of them, so every rank holds the same manifest (the same
components in the same order, the same LSN and kill-sets). Fault points
that precede collectives are agreed the same way.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import plan as P
from repro_torch.core.catalog import INTERNAL_COLUMNS, Dataset, Manifest, open_widen
from repro_torch.device import resolve_device
from repro_torch.engine.table import (ColumnMeta, Table, is_lane_column,
                                      pad_to_block)
from repro_torch.launch.mesh import agree, is_rank_mesh, twin_mesh
from repro_torch.runtime import telemetry as tel
from repro_torch.runtime.fault import StorageFault

RUN_BLOCK = 1024      # runs are padded to this row multiple
_F32_EXACT = 1 << 24  # every int in [-2^24, 2^24] is exactly representable


class ManifestConflict(RuntimeError):
    """A merge built off one manifest lost the CAS at publish time: a
    concurrent publish invalidated the component segment it planned against.
    The built components are discarded; the caller replans and retries."""


def _fault(session, point: str) -> None:
    """Consult the session's storage fault plan at one named crash point
    (raises on a scheduled arrival)."""
    plan = getattr(session, "fault_plan", None)
    if plan is not None:
        plan.check(point)


_VOTE_FAULT, _VOTE_CONFLICT, _VOTE_OK = 0, 1, 2


def _vote(session, err: Optional[BaseException]) -> None:
    """Raise ``err`` if this rank failed; on a rank mesh first agree every
    rank's outcome (a MIN all-reduce, ``launch.mesh.agree``), so that a
    rank whose own step succeeded raises too when a peer's failed: a
    ``ManifestConflict`` for a peer's lost CAS, a ``StorageFault`` for its
    fault. Every rank then goes on, or stops, together."""
    if is_rank_mesh(session.mesh):
        code = _VOTE_OK if err is None else _VOTE_CONFLICT \
            if isinstance(err, ManifestConflict) else _VOTE_FAULT
        least = agree(session.mesh, code, session.data_axes)
        if err is None and least == _VOTE_CONFLICT:
            err = ManifestConflict("a peer rank lost its CAS: the publish "
                                   "is aborted on every rank")
        elif err is None and least == _VOTE_FAULT:
            err = StorageFault("a peer rank faulted: the step is aborted on "
                               "every rank")
    if err is not None:
        raise err


def _agreed_fault(session, point: str) -> None:
    """``_fault`` at a point that collectives follow: on a rank mesh a fault
    on one rank raises on every rank (``_vote``)."""
    err = None
    try:
        _fault(session, point)
    except StorageFault as e:
        err = e
    _vote(session, err)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _settle(session) -> None:
    """Wait for the device work this thread queued (the tensors of a merge
    about to be published) — a publish never exposes unfinished tensors."""
    dev = torch.device(session.device)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class _ManifestView:
    """A Dataset proxy bound to one captured manifest: ``runs`` is the
    pinned run list, every other attribute delegates to the base, so a
    policy's decision and the CAS-validated merge see one component set."""

    def __init__(self, base: Dataset, manifest: Manifest):
        self._base = base
        self.runs = list(manifest.runs)

    def __getattr__(self, item):
        return getattr(self._base, item)


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Deferred-compaction trigger (size-ratio merge policy): compact when
    the run burden — visible matter plus tombstones plus rows the tombstones
    annihilated — reaches ``size_ratio`` × visible base rows, or when more
    than ``max_runs`` runs pile up. ``size_ratio=0`` compacts every flush."""

    size_ratio: float = 1.0
    max_runs: int = 8

    def plan(self, ds: Dataset) -> list[tuple]:
        """Actions to run after a flush: ``("full",)`` folds everything."""
        return [("full",)] if should_compact(ds, self) else []


@dataclasses.dataclass(frozen=True)
class LeveledCompactionPolicy(CompactionPolicy):
    """Leveled variant: flushes land in level 0; ``fanin`` runs of one level
    merge into ONE run of the next (O(level)); the inherited size-ratio
    trigger still forces the full fold."""

    level0_runs: int = 4    # runs tolerated at level 0 before a level merge
    level_ratio: int = 4    # fanin of every level above 0

    def fanin(self, level: int) -> int:
        return max(self.level0_runs if level == 0 else self.level_ratio, 2)

    def plan(self, ds: Dataset) -> list[tuple]:
        if should_compact(ds, self):
            return [("full",)]
        by_level: dict[int, list[int]] = {}
        for i, r in enumerate(ds.runs):
            by_level.setdefault(r.level, []).append(i)
        for level in sorted(by_level):
            idxs = by_level[level]
            if len(idxs) >= self.fanin(level):
                # same-level runs are contiguous (levels never increase
                # along the run list)
                return [("merge", idxs[0], idxs[-1] + 1, level + 1)]
        return []


def should_compact(ds: Dataset, policy: CompactionPolicy) -> bool:
    if not ds.runs:
        return False
    if len(ds.runs) > policy.max_runs:
        return True
    # the burden charges tombstones and every component's shadowed matter:
    # all of it is storage a compaction would reclaim
    burden = sum(r.num_live_rows + r.anti_rows + r.annihilated_rows
                 for r in ds.runs)
    burden += ds.annihilated_rows
    return burden >= policy.size_ratio * max(ds.num_live_rows, 1)


# -- runs -------------------------------------------------------------------


def make_run(session, base: Dataset, table: Table,
             anti_keys: Optional[np.ndarray] = None, uid: bool = True) -> Dataset:
    """Build one run from a flush batch (host columns): sort by the base's
    primary on the host → place on the session device → stats (matter only)
    → (optional) open-widen → append anti-matter rows → block-pad (+ shard
    on a mesh) → sorted indexes and block zone maps, per shard on a mesh.
    O(batch) throughout. On a rank mesh the anti rows are appended and the
    block padding made on the host, then the run is sharded (this rank's
    rows alone reach the device) and its statistics merged over the ranks
    (``_collect_stats_on_ranks``, the matter rows only): the same layout,
    zones and meta as the one-process mesh's.

    ``anti_keys`` are the primary keys this run's anti-matter annihilates in
    older components: table rows flagged ``__antimatter__`` (``__valid__``
    False) and the sorted ``anti_keys_arr`` tensor visibility probes
    search. ``uid=False`` leaves the run's uid to its publish
    (``_assign_uid``; the background compactor on a rank mesh)."""
    from repro_torch.core.stats import harvest_block_zones
    from repro_torch.engine.session import (_collect_stats,
                                            _collect_stats_on_ranks)

    t0 = time.perf_counter()
    live = table.num_rows
    primary = base.primary_index
    host_keys = anti_sorted = None
    if primary is not None:
        keys = _host(table.columns[primary.column])
        if not base.closed:  # sort in the widened dtype the run stores
            keys = keys.astype(np.float32)
        order = np.argsort(keys, kind="stable")
        host_keys = keys[order]   # the matter keys as the run stores them
        at = torch.from_numpy(order)
        table = Table({k: v[at] for k, v in table.columns.items()},
                      table.meta, table.num_rows)
    n_anti = 0 if anti_keys is None else len(anti_keys)
    if n_anti:
        anti_sorted = np.sort(np.asarray(anti_keys).astype(host_keys.dtype))
    if is_rank_mesh(session.mesh):
        if n_anti:
            table = _append_anti_rows(table, primary.column, anti_sorted)
        table = _collect_stats_on_ranks(
            pad_to_block(table, RUN_BLOCK).shard(session.mesh,
                                                 session.data_axes),
            live, like=base.table.meta)
        if not base.closed:
            table = open_widen(table)
    else:
        # `like`: a run's dict-lane presence follows the base's, so the
        # column set stays uniform across every component of the union
        table = _collect_stats(table.to(session.device), like=base.table.meta)
        if not base.closed:
            table = open_widen(table)
        if n_anti:
            table = _append_anti_rows(table, primary.column, anti_sorted)
        table = pad_to_block(table, RUN_BLOCK)
        if session.mesh is not None:
            table = table.shard(session.mesh, session.data_axes)
    if primary is not None:
        meta = dict(table.meta)
        meta[primary.column] = dataclasses.replace(meta[primary.column],
                                                   sorted_ascending=True)
        table = table.with_columns(table.columns, meta)
    # stable component id: a per-dataset monotone uid, never reused
    run_uid = session.catalog.next_run_uid(base.dataverse, base.name) \
        if uid else -1
    run = Dataset(name=f"{base.name}@run{run_uid}", uid=run_uid,
                  dataverse=base.dataverse, table=table, closed=base.closed,
                  engine_owned=True,
                  live_rows=live, anti_rows=n_anti,
                  anti_keys_arr=None if anti_sorted is None
                  else torch.from_numpy(anti_sorted).to(session.device),
                  host_anti_keys=anti_sorted,
                  host_keys=host_keys,
                  # matter rows only: anti rows and padding are not valid;
                  # a mesh session harvests the per-shard layout
                  block_zones=harvest_block_zones(table, session.n_shards))
    if primary is not None:
        run.indexes["primary"] = session._build_index(table, primary.column,
                                                      "primary")
    for ix in base.indexes.values():
        if ix.kind == "secondary":
            run.indexes[f"ix_{ix.column}"] = session._build_index(
                table, ix.column, "secondary")
    ds_label = f"{base.dataverse}.{base.name}"
    tel.inc("lsm.runs_built_total", dataset=ds_label)
    tel.observe("lsm.run_build_seconds", time.perf_counter() - t0,
                dataset=ds_label)
    tel.observe("lsm.run_build_rows", live, dataset=ds_label)
    return run


def _assign_uid(session, run: Dataset) -> None:
    """Give a run built with ``uid=False`` its uid, at its publish."""
    base_name = run.name.partition("@")[0]
    run.uid = session.catalog.next_run_uid(run.dataverse, base_name)
    run.name = f"{base_name}@run{run.uid}"


def _append_anti_rows(table: Table, key_col: str,
                      anti_sorted: np.ndarray) -> Table:
    """Anti-matter rows ride after the matter prefix: the key column carries
    the annihilated key, every other column is zero, ``__antimatter__``
    True and ``__valid__`` False."""
    m = table.num_rows
    t = len(anti_sorted)
    dev = table.device
    cols: dict[str, torch.Tensor] = {}
    for k, v in table.columns.items():
        if k == key_col:
            pad = torch.from_numpy(anti_sorted).to(dev, v.dtype)
        else:
            pad = v.new_zeros((t,) + tuple(v.shape[1:]))
        cols[k] = torch.cat([v, pad], dim=0)
    flags = torch.arange(m + t, device=dev) >= m
    cols["__antimatter__"] = flags
    cols["__valid__"] = ~flags
    return Table(cols, dict(table.meta), m + t)  # matter-only stats survive


def register_run(session, base: Dataset, run: Dataset) -> Optional[dict]:
    """Publish the run: one atomic manifest swap under the catalog lock (it
    bumps the LSN and the stats epoch, so every plan-cache level rebinds).
    Then the soft-state bookkeeping: with anti-matter, every older
    component's annihilation sets update; with a view registered over the
    dataset, the newly annihilated rows are gathered and returned for its
    retraction. With a durable store the run's segment is written first,
    off the catalog lock (the heavy host copy and write); the publish's
    durable commit only links it."""
    cat = session.catalog
    if cat.store is not None:
        cat.store.write_component(base.dataverse, base.name, run)
    with cat.lock:
        # re-read the CURRENT manifest: a concurrent compaction may have
        # swapped the base the caller fetched
        cur = cat.manifest(base.dataverse, base.name)
        older = cur.components
        _agreed_fault(session, "pre-swap")     # on ranks: the publish vote
        cat.publish(base.dataverse, base.name, cur.base,
                    tuple(cur.runs) + (run,))
        _agreed_fault(session, "post-swap")
        retracted = None
        if run.anti_rows:
            gather = any((v.dataverse, v.dataset) == (base.dataverse, base.name)
                         for v in getattr(session, "views", {}).values())
            retracted = _annihilate_older(older, run, gather=gather)
    return retracted


def _annihilate_older(older, run: Dataset,
                      gather: bool = True) -> Optional[dict]:
    """Apply one new run's anti-key set to the strictly older components:
    count (and, with ``gather``, collect) the matter rows it newly shadows.
    A key a previous tombstone already covered is skipped, so nothing
    double-subtracts. Callers hold the catalog lock."""
    anti_set = set(run.host_anti_keys.tolist())
    gathered: list[dict[str, np.ndarray]] = []
    for comp in older:
        new = anti_set - comp.annihilated_keys
        if not new or comp.host_keys is None or not len(comp.host_keys):
            continue
        ak = np.sort(np.fromiter(new, dtype=comp.host_keys.dtype,
                                 count=len(new)))
        lo = np.searchsorted(comp.host_keys, ak, side="left")
        hi = np.searchsorted(comp.host_keys, ak, side="right")
        occ = hi - lo
        total = int(occ.sum())
        if not total:
            continue
        # record only keys that actually hit matter
        comp.annihilated_keys |= set(ak[occ > 0].tolist())
        comp.annihilated_rows += total
        if not gather:
            continue
        # the matter prefix is clustered by the primary key, so index-space
        # positions ARE table row positions (global ones on a rank's
        # shard): gather the dying rows, from their owners on a rank mesh
        from repro_torch.engine.session import _table_rows

        gathered.append(_table_rows(comp.table, np.concatenate(
            [np.arange(l, h) for l, h in zip(lo, hi) if h > l])))
    if not gathered:
        return None
    return {k: np.concatenate([g[k] for g in gathered], axis=0)
            for k in gathered[0]}


def host_visible_mask(comp: Dataset, key_col: Optional[str],
                      annihilated: Optional[set] = None) -> np.ndarray:
    """Host-side visibility of one component's physical rows: valid matter
    minus rows newer anti-matter annihilated. ``annihilated`` overrides the
    live kill-set with a copy captured under the catalog lock. On a rank's
    shard: the visibility of the rows this rank holds."""
    mask = _host(comp.table.valid).copy()
    anti = comp.table.columns.get("__antimatter__")
    if anti is not None:
        mask &= ~_host(anti)
    kill_set = comp.annihilated_keys if annihilated is None else annihilated
    if kill_set and key_col is not None:
        keys = _host(comp.table.columns[key_col])
        kill = np.fromiter(kill_set, dtype=keys.dtype, count=len(kill_set))
        mask &= ~np.isin(keys, kill)
    return mask


def _visible_columns(comp: Dataset, key_col: Optional[str],
                     annihilated: Optional[set] = None, names=None,
                     mesh=None) -> dict[str, np.ndarray]:
    """The component's visible rows of its user columns (or of ``names``),
    on the host. On a rank mesh every rank's visible rows, in global row
    order, gathered over ``mesh`` (the component's own by default; the
    background compactor's worker passes its twin; a component of the
    one-process mesh needs none)."""
    mask = host_visible_mask(comp, key_col, annihilated)
    # per-component dict lanes drop: merged outputs rebuild coherent lanes
    if names is None:
        names = [k for k in comp.table.columns
                 if k not in INTERNAL_COLUMNS and not is_lane_column(k)]
    if comp.table.mesh is None:
        return {k: _host(comp.table.columns[k])[mask] for k in names}
    from repro_torch.engine import distributed as D

    mesh = mesh if mesh is not None else comp.table.mesh
    return dict(zip(names, D.gather_to_host(
        mesh, comp.table.data_axes, [comp.table.columns[k] for k in names],
        mask)))


def _merge_meta(metas: list[ColumnMeta], total_rows: int) -> ColumnMeta:
    base = metas[0]
    lo = hi = distinct = None
    bounded = all(m.lo is not None and m.hi is not None for m in metas)
    if bounded:
        lo = min(m.lo for m in metas)
        hi = max(m.hi for m in metas)
    if all(m.distinct is not None for m in metas):
        # summed distincts are a true distinct count only for pairwise
        # disjoint ranges; with possible overlap only the max is provable
        spans = sorted((m.lo, m.hi) for m in metas) if bounded else []
        disjoint = bool(spans) and all(
            spans[i][1] < spans[i + 1][0] for i in range(len(spans) - 1))
        if len(metas) == 1 or disjoint:
            distinct = min(sum(m.distinct for m in metas), total_rows)
        else:
            distinct = max(m.distinct for m in metas)
    return ColumnMeta(base.dtype, lo, hi, distinct, base.is_string, False)


@dataclasses.dataclass
class _Merge:
    """One merge, planned against one manifest: ``("full",)`` folds every
    component into a fresh base; ``("merge", start, end, level)`` folds
    ``runs[start:end]`` into one run at ``level``. ``kills`` are the
    members' kill-set copies, taken under the catalog lock."""

    dataverse: str
    name: str
    action: tuple
    manifest: Manifest
    kills: list

    @property
    def members(self) -> tuple:
        if self.action[0] == "full":
            return self.manifest.components
        _, start, end, _ = self.action
        return tuple(self.manifest.runs[start:end])


def _plan_merge(session, ds: Dataset, action: tuple,
                manifest: Optional[Manifest] = None) -> _Merge:
    cat = session.catalog
    dv, name = ds.dataverse, ds.name
    ensure_soft(session, dv, name)  # kill-sets and host keys must be live
    with cat.lock:
        m0 = manifest if manifest is not None else cat.manifest(dv, name)
        job = _Merge(dv, name, action, m0, [])
        # kill-set copies: a concurrent flush mutates the live sets
        job.kills = [set(c.annihilated_keys) for c in job.members]
    return job


def _build_merge(session, job: _Merge, uid: bool = True) -> Dataset:
    """Build a planned merge's component OFF the catalog lock (nothing is
    published): the members' visible rows on the host, one host merge,
    then a fresh base (``_build_dataset``) or run (``make_run``)."""
    m0 = job.manifest
    key_col = m0.base.primary_index.column \
        if m0.base.primary_index is not None else None
    parts = [_visible_columns(c, key_col, job.kills[i], mesh=session.mesh)
             for i, c in enumerate(job.members)]
    names = list(parts[0])
    merged = {k: np.concatenate([p[k] for p in parts], axis=0) for k in names}
    _agreed_fault(session, "mid-merge")
    if job.action[0] == "full":
        total = len(next(iter(merged.values()))) if names else 0
        metas = [c.table.meta for c in job.members]
        meta = {k: _merge_meta([mm[k] for mm in metas], total) for k in names}
        secondary = [ix.column for ix in m0.base.indexes.values()
                     if ix.kind == "secondary"]
        built = session._build_dataset(job.name, Table(merged, meta),
                                       dataverse=job.dataverse,
                                       closed=m0.base.closed,
                                       indexes=secondary, primary=key_col,
                                       stats_like=m0.base.table.meta)
        built.engine_owned = True  # merged copies, never a caller's tensors
    else:
        anti_parts = [m.host_anti_keys for m in job.members if m.anti_rows]
        anti_union = np.unique(np.concatenate(anti_parts)) if anti_parts \
            else None
        built = make_run(session, m0.base, Table(merged), anti_keys=anti_union,
                         uid=uid)
        built.level = job.action[3]
    _settle(session)
    if session.catalog.store is not None:  # off-lock, pre-CAS
        session.catalog.store.write_component(job.dataverse, job.name, built)
    return built


def _publish_merge(session, job: _Merge, built: Dataset) -> Dataset:
    """Commit a built merge with one CAS-validated swap under the catalog
    lock (``ManifestConflict`` when its members changed; on a rank mesh
    the CAS outcome and the "pre-swap" fault point are voted on, so the
    swap happens on every rank or on none). Runs flushed meanwhile
    survive, and their tombstones are reconciled against the new
    component."""
    cat = session.catalog
    dv, name, m0 = job.dataverse, job.name, job.manifest
    kind = "full" if job.action[0] == "full" else "level"
    try:
        with cat.lock:
            cur = cat.manifest(dv, name)
            err = None
            if kind == "full":
                if cur.base is not m0.base \
                        or tuple(cur.runs[:len(m0.runs)]) != tuple(m0.runs):
                    err = ManifestConflict(
                        f"{dv}.{name}: component set changed under a full "
                        f"compaction (planned at lsn {m0.lsn}, now {cur.lsn})")
            elif cur.base is not m0.base:
                err = ManifestConflict(
                    f"{dv}.{name}: base swapped under a level merge "
                    f"(planned at lsn {m0.lsn}, now {cur.lsn})")
            else:
                members = job.members
                try:
                    s = cur.runs.index(members[0])  # identity: id-based eq
                except ValueError:
                    s = -1
                if s < 0 or tuple(cur.runs[s:s + len(members)]) != members:
                    err = ManifestConflict(
                        f"{dv}.{name}: merged run segment no longer "
                        f"contiguous (planned at lsn {m0.lsn}, now {cur.lsn})")
            if isinstance(err, ManifestConflict):
                tel.inc("lsm.compaction.conflicts_total", kind=kind)
            else:
                try:
                    _fault(session, "pre-swap")
                except StorageFault as e:
                    err = e
            _vote(session, err)                  # on ranks: the publish vote
            if built.table.mesh is not None:     # built on a worker's twin
                built.table.mesh = session.mesh
            if kind == "full":
                newer = cur.runs[len(m0.runs):]  # flushed while it built
                cat.publish(dv, name, built, newer)
                _agreed_fault(session, "post-swap")
                for r in newer:  # their tombstones still shadow the new base
                    if r.anti_rows:
                        _annihilate_older((built,), r, gather=False)
            else:
                if built.uid < 0:
                    _assign_uid(session, built)
                tail = cur.runs[s + len(members):]
                # tombstones that landed mid-build replay here
                for newer in tail:
                    if newer.anti_rows:
                        _annihilate_older((built,), newer, gather=False)
                cat.publish(dv, name, cur.base, cur.runs[:s] + (built,) + tail)
                _agreed_fault(session, "post-swap")
    except ManifestConflict:
        if cat.store is not None:  # orphan segment: never committed
            cat.store.discard_component(dv, name, built)
        raise
    return built


def compact(session, ds: Dataset, manifest: Optional[Manifest] = None) -> Dataset:
    """Fold base ∪ runs into a fresh base with a key-ordered newest-wins
    merge: each component contributes only the matter no newer anti-matter
    annihilated, all tombstones drop, and the primary re-sort restores the
    clustered order. Builds OFF the catalog lock and commits with a
    CAS-validated swap (``ManifestConflict`` when the base or the merged
    segment changed); runs flushed meanwhile survive and their anti keys are
    reconciled against the fresh base at swap time. With a durable store
    the new base's segment is written off-lock before the CAS; a lost CAS
    unlinks it (never committed). On a rank mesh every rank merges the
    same host rows and keeps its shard of the new base."""
    t0 = time.perf_counter()
    tel.inc("lsm.compaction.attempts_total", kind="full")
    job = _plan_merge(session, ds, ("full",), manifest)
    new_base = _publish_merge(session, job, _build_merge(session, job))
    tel.inc("lsm.compactions_total", kind="full")
    tel.observe("lsm.compaction_seconds", time.perf_counter() - t0,
                kind="full")
    return new_base


def merge_runs(session, ds: Dataset, start: int, end: int, level: int,
               manifest: Optional[Manifest] = None) -> Dataset:
    """Leveled-compaction step: fold the contiguous run segment
    ``runs[start:end]`` into ONE run at ``level`` — O(segment), never
    touching the base. Each member drops the matter newer components
    annihilated; the merged run keeps the union of the members' anti keys
    (older components still need them). Concurrency and the segment write
    as :func:`compact`."""
    t0 = time.perf_counter()
    tel.inc("lsm.compaction.attempts_total", kind="level")
    job = _plan_merge(session, ds, ("merge", start, end, level), manifest)
    run = _publish_merge(session, job, _build_merge(session, job))
    tel.inc("lsm.compactions_total", kind="level")
    tel.observe("lsm.compaction_seconds", time.perf_counter() - t0,
                kind="level")
    return run


# -- background compaction ---------------------------------------------------


class BackgroundCompactor:
    """Runs the compaction policies on worker threads, off the ingest hot
    path: writers call :meth:`notify` after each flush; one worker per
    dataverse drains notified datasets to policy quiescence.

    Every merge builds fresh components off the catalog lock and commits
    with one CAS-validated swap: readers never block, and a lost CAS
    (:class:`ManifestConflict`) replans and retries with exponential
    backoff, bounded by ``max_retries``; an injected
    :class:`~repro_torch.runtime.fault.StorageFault` aborts the attempt
    alike (hard state is untouched, so the retry rebuilds from intact
    components). Before a merge publishes, the
    worker waits for the device work it queued, so the swap never exposes
    unfinished tensors; readers pinned to the old manifest keep its tensors
    until they release it.

    On a rank mesh (``launch.mesh.RankMesh``) every rank makes its session
    calls from ONE thread, in the same order; concurrent reader threads on
    a rank mesh are out of scope. A worker issuing collectives on the
    group the caller's queries use would interleave with them in a
    different order on each rank (gloo then mismatches, NCCL hangs), so
    there the compactor runs as :class:`_RankCompactor`: each merge and the
    manifest it merges are fixed on the caller's thread, in the same order
    on every rank; ONE worker builds them, in that order, on process
    groups of its own (``launch.mesh.twin_mesh``, made collectively here);
    and a built merge is published on the caller's thread at the next
    agreed point (a flush's notify, a query, ``wait_idle``,
    ``wait_below``), once every rank has built it, through the publish
    vote. No query on one rank sees a merge another rank has not
    published."""

    def __init__(self, session, policy: Optional[CompactionPolicy] = None,
                 max_retries: int = 5, backoff_s: float = 0.002):
        self.session = session
        self.policy = policy if policy is not None else CompactionPolicy()
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.stats = {"level_merges": 0, "compactions": 0, "conflicts": 0,
                      "retries": 0, "faults": 0, "giveups": 0, "errors": 0}
        for k in self.stats:  # seed the mirrored registry series
            tel.inc(f"lsm.compactor.{k}_total", 0)
        self._cv = threading.Condition()
        self._pending: dict[str, set[tuple[str, str]]] = {}
        self._inflight: dict[str, int] = {}
        self._threads: dict[str, threading.Thread] = {}
        self._stop = False
        self._ranks = _RankCompactor(self) if is_rank_mesh(session.mesh) \
            else None

    # -- control -----------------------------------------------------------

    def notify(self, dataverse: str, name: str) -> None:
        """Mark a dataset dirty (a flush just published); returns at once,
        spawning the dataverse's worker on first use."""
        if self._ranks is not None:
            self._ranks.notify(dataverse, name)
            return
        with self._cv:
            if self._stop:
                return
            self._pending.setdefault(dataverse, set()).add((dataverse, name))
            if dataverse not in self._threads:
                t = threading.Thread(
                    target=self._worker, args=(dataverse,), daemon=True,
                    name=f"lsm-compactor-{dataverse}")
                self._threads[dataverse] = t
                t.start()
                tel.set_gauge("lsm.compactor.workers", len(self._threads))
            self._cv.notify_all()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until every worker has drained its notifications."""
        if self._ranks is not None:
            return self._ranks.wait(timeout)
        deadline = time.perf_counter() + timeout
        with self._cv:
            while any(self._pending.values()) or any(self._inflight.values()):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.05))
        return True

    def wait_below(self, dataverse: str, name: str, cap: int,
                   timeout: float) -> float:
        """Write-stall backpressure: block until the dataset's run count
        drops below ``cap`` (or timeout). Returns seconds stalled."""
        t0 = time.perf_counter()
        if self._ranks is not None:
            self._ranks.wait(timeout, below=(dataverse, name, cap))
            return time.perf_counter() - t0
        with self._cv:
            while not self._stop:
                try:
                    n = len(self.session.catalog.manifest(dataverse, name).runs)
                except KeyError:
                    break
                if n < cap:
                    break
                remaining = timeout - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                self._cv.wait(min(remaining, 0.05))
        return time.perf_counter() - t0

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            threads = list(self._threads.values())
        if self._ranks is not None:
            threads = [self._ranks.close()]
        for t in threads:
            t.join(timeout=30.0)

    def __enter__(self) -> "BackgroundCompactor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- workers (one per dataverse) ---------------------------------------

    def _worker(self, dataverse: str) -> None:
        while True:
            with self._cv:
                while not self._pending.get(dataverse) and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                key = self._pending[dataverse].pop()
                self._inflight[dataverse] = \
                    self._inflight.get(dataverse, 0) + 1
            try:
                self._drain(key)
            finally:
                with self._cv:
                    self._inflight[dataverse] -= 1
                    self._cv.notify_all()

    def _drain(self, key: tuple[str, str]) -> None:
        """Run the policy to quiescence for one dataset, replanning against
        the CURRENT manifest each iteration."""
        cat = self.session.catalog
        failures = 0
        delay = self.backoff_s
        while not self._stop:
            try:
                base = cat.get(*key)
            except KeyError:
                return  # dataset dropped
            m = base.manifest
            actions = self.policy.plan(_ManifestView(base, m))
            if not actions:
                return
            act = actions[0]
            try:
                if act[0] == "full":
                    compact(self.session, base, manifest=m)
                    self._bump("compactions")
                else:
                    _, s, e, level = act
                    merge_runs(self.session, base, s, e, level, manifest=m)
                    self._bump("level_merges")
                failures = 0
                delay = self.backoff_s
            except ManifestConflict:
                self._bump("conflicts")
                failures += 1
            except StorageFault:
                self._bump("faults")
                failures += 1
            except Exception:  # pragma: no cover - defensive: keep serving
                self._bump("errors")
                return
            finally:
                with self._cv:
                    self._cv.notify_all()  # progress signal for stalled writers
            if failures:
                if failures > self.max_retries:
                    self._bump("giveups")
                    return  # dataset stays serveable, just under-compacted
                self._bump("retries")
                time.sleep(delay)
                delay *= 2

    def _bump(self, key: str) -> None:
        self.stats[key] += 1
        tel.inc(f"lsm.compactor.{key}_total")


class _RankCompactor:
    """:class:`BackgroundCompactor` on a rank mesh (its docstring gives the
    design). ``_inflight`` holds the planned merges in plan order, at most
    one a dataset; the worker builds them in that order on a copy of the
    session whose mesh is the twin (``_worker``); :meth:`poll`, the agreed
    point, publishes the oldest once every rank has built it (a MIN vote
    over the data axes) and replans its dataset from the new manifest."""

    def __init__(self, owner: BackgroundCompactor):
        import queue

        self.owner = owner
        self.session = owner.session
        self.worker_session = copy.copy(owner.session)
        self.worker_session.mesh = twin_mesh(owner.session.mesh)
        self._inflight: dict = {}       # (dv, name) -> [job, built, done]
        self._queue: "queue.Queue" = queue.Queue()
        self._done = threading.Condition()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="lsm-compactor-ranks")
        self._thread.start()
        tel.set_gauge("lsm.compactor.workers", 1)
        self.session._compactors.append(self)

    def notify(self, dataverse: str, name: str) -> None:
        self.poll()
        if (dataverse, name) not in self._inflight:
            self._plan((dataverse, name))

    def _plan(self, key) -> None:
        """Fix the dataset's next merge against its current manifest (the
        caller's thread, the same on every rank) and queue its build."""
        try:
            base = self.session.catalog.get(*key)
        except KeyError:
            return  # dataset dropped
        m = base.manifest
        actions = self.owner.policy.plan(_ManifestView(base, m))
        if not actions:
            return
        job = _plan_merge(self.session, base, actions[0], m)
        tel.inc("lsm.compaction.attempts_total",
                kind="full" if actions[0][0] == "full" else "level")
        entry = [job, None, False]
        self._inflight[key] = entry
        self._queue.put(entry)

    def _worker(self) -> None:
        self.worker_session._owner = threading.get_ident()
        while True:
            entry = self._queue.get()
            if entry is None:
                return
            failures, delay = 0, self.owner.backoff_s
            while True:
                try:
                    entry[1] = _build_merge(self.worker_session, entry[0],
                                            uid=False)
                    break
                except StorageFault:
                    # agreed: every rank's worker aborts the attempt alike
                    self.owner._bump("faults")
                    failures += 1
                except Exception:  # pragma: no cover - defensive
                    self.owner._bump("errors")
                    break
                if failures > self.owner.max_retries:
                    self.owner._bump("giveups")
                    break
                self.owner._bump("retries")
                time.sleep(delay)
                delay *= 2
            with self._done:
                entry[2] = True
                self._done.notify_all()

    def poll(self) -> bool:
        """The agreed point: publish, oldest first, every merge each rank
        has built, and replan its dataset. True while a merge is still in
        flight (the same answer on every rank)."""
        while self._inflight:
            key, entry = next(iter(self._inflight.items()))
            if not agree(self.session.mesh, int(entry[2]),
                         self.session.data_axes):
                return True
            del self._inflight[key]
            job, built = entry[0], entry[1]
            if built is None:
                continue  # given up: the dataset stays under-compacted
            full = job.action[0] == "full"
            try:
                _publish_merge(self.session, job, built)
                self.owner._bump("compactions" if full else "level_merges")
                tel.inc("lsm.compactions_total",
                        kind="full" if full else "level")
            except ManifestConflict:
                self.owner._bump("conflicts")
            except StorageFault:
                self.owner._bump("faults")
            self._plan(key)
        return False

    def wait(self, timeout: float, below=None) -> bool:
        """Publish what every rank has built until nothing is in flight (or,
        with ``below = (dv, name, cap)``, until the dataset holds fewer than
        ``cap`` runs); False once the timeout has run out on any rank."""
        deadline = time.perf_counter() + timeout
        while True:
            busy = self.poll()
            if below is not None:
                dv, name, cap = below
                try:
                    if len(self.session.catalog.manifest(dv, name).runs) < cap:
                        return True
                except KeyError:
                    return True
            if not busy:
                return True
            expired = time.perf_counter() > deadline
            if not agree(self.session.mesh, int(not expired),
                         self.session.data_axes):
                return False
            with self._done:
                entry = next(iter(self._inflight.values()))
                if not entry[2]:
                    self._done.wait(0.01)

    def close(self) -> threading.Thread:
        """Stop the worker after the build in hand (an unpublished merge is
        dropped); the caller joins the thread returned."""
        self._queue.put(None)
        if self in self.session._compactors:
            self.session._compactors.remove(self)
        return self._thread


# -- crash recovery: rebuild soft state from hard state -----------------------


def recover(session, dataverse: str, name: str, lazy: bool = False) -> None:
    """Crash recovery: rebuild every component's SOFT state from its HARD
    state.

    Hard state (survives an injected crash at any fault point): each
    component's table — matter rows, anti-matter rows with the
    ``__antimatter__`` flag and the key column, the ``__valid__`` mask —
    plus the manifest itself (swapped atomically) and the index inventory.

    Soft state (rebuilt here, on the session device): index payloads, block
    zone maps, host clustered-key and anti-key copies, the annihilation
    bookkeeping (replayed newest-wins in manifest order), and materialized
    view partials (reseeded from visible rows).

    With ``lazy`` the rebuild is only MARKED: each component flips
    ``soft_stale`` and the dataset joins ``catalog.stale``; the first bind
    (query, point lookup, flush, compaction, view seed) pays it through
    :func:`ensure_soft`. On a rank mesh every rank calls it at the same
    point (the rebuild is collective, :func:`_rebuild_soft`)."""
    cat = session.catalog
    if lazy:
        with cat.lock:
            m = cat.manifest(dataverse, name)
            for comp in m.components:
                comp.soft_stale = True
            cat.stale.add((dataverse, name))
        return
    with cat.lock:
        m = cat.manifest(dataverse, name)
    for comp in m.components:
        _rebuild_soft(session, comp)
        comp.soft_stale = False
    with cat.lock:
        _replay_annihilation(m)
        cat.stale.discard((dataverse, name))
        cat.bump_stats_epoch()
    session.reseed_views(dataverse, name)


def ensure_soft(session, dataverse: str, name: str) -> None:
    """First-bind hook of the lazy rebuild: if the dataset carries
    soft-stale components (cold-start mounts), rebuild their soft state now
    and replay the annihilation bookkeeping across the whole chain. One
    set-membership probe when nothing is stale, so every bind site calls
    it unconditionally."""
    cat = session.catalog
    if (dataverse, name) not in cat.stale:
        return
    with cat.lock:
        if (dataverse, name) not in cat.stale:
            return  # another binder won the race
        try:
            m = cat.manifest(dataverse, name)
        except KeyError:
            cat.stale.discard((dataverse, name))
            return
        t0 = time.perf_counter()
        for comp in m.components:
            if comp.soft_stale:
                _rebuild_soft(session, comp)
                comp.soft_stale = False
        _replay_annihilation(m)
        cat.stale.discard((dataverse, name))
        cat.bump_stats_epoch()
    tel.inc("storage.lazy_rebuilds_total")
    tel.observe("storage.lazy_rebuild_seconds", time.perf_counter() - t0)


def _replay_annihilation(m: Manifest) -> None:
    """The cross-component bookkeeping, replayed newest-wins in manifest
    order over freshly zeroed sets. Callers hold the catalog lock."""
    for i, run in enumerate(m.runs):
        if run.anti_rows:
            _annihilate_older((m.base,) + tuple(m.runs[:i]), run,
                              gather=False)


def _rebuild_soft(session, comp: Dataset) -> None:
    """Rebuild one component's soft state from its table columns, through
    the passes create_dataset and make_run run (``session._build_index``,
    ``harvest_block_zones``) on the table's device, so the rebuilt state is
    the state before the crash, bit for bit. On a rank's shard the counts
    are summed over the ranks and the host key copies gathered whole
    (``distributed.gather_to_host``), as ``make_run`` keeps them; the zone
    maps and index zones take the rank paths of ``_build_dataset``."""
    from repro_torch.core.stats import harvest_block_zones

    t = comp.table
    valid = t.valid
    anti_col = t.columns.get("__antimatter__")
    primary_col = None
    for ix in comp.indexes.values():
        if ix.kind == "primary":
            primary_col = ix.column
    if t.mesh is None:
        comp.live_rows = int(valid.sum())
        comp.anti_rows = 0 if anti_col is None else int(anti_col.sum())
    else:
        from repro_torch.engine import distributed as D

        sh = D.Shards(t.mesh, t.data_axes)
        counts = [valid.sum(dtype=torch.int64)] + (
            [] if anti_col is None else [anti_col.sum(dtype=torch.int64)])
        summed = sh.psum([torch.stack(counts)]).tolist()
        comp.live_rows = int(summed[0])
        comp.anti_rows = int(summed[1]) if anti_col is not None else 0
    comp.annihilated_rows = 0
    comp.annihilated_keys = set()

    def keys_where(mask: torch.Tensor) -> np.ndarray:
        """The key column's rows under ``mask``, in global row order."""
        col = t.columns[primary_col]
        if t.mesh is None:
            return _host(col[mask])
        from repro_torch.engine.distributed import gather_to_host

        return gather_to_host(t.mesh, t.data_axes, [col], _host(mask))[0]

    if comp.anti_rows and primary_col is not None:
        comp.host_anti_keys = np.sort(keys_where(anti_col))
        comp.anti_keys_arr = torch.from_numpy(comp.host_anti_keys).to(
            valid.device)
    else:
        comp.anti_keys_arr = None
        comp.host_anti_keys = None
    if primary_col is not None:
        # the matter prefix is clustered: masking keeps the sorted order
        comp.host_keys = keys_where(valid)
    comp.block_zones = harvest_block_zones(t, session.n_shards)
    for key, ix in list(comp.indexes.items()):
        comp.indexes[key] = session._build_index(t, ix.column, ix.kind)


# -- incrementally-maintained materialized views ----------------------------

_VIEW_OPS = ("count", "sum", "mean", "max", "min")


class MaterializedView:
    """A continuously-maintained group-by aggregate over a fed dataset (the
    paper's live dashboard). State is dense per-group host partials (int64
    counts, float64 sums and extremes) over a widening key domain; each
    flush applies only the delta batch. ``result()`` equals a from-scratch
    group-by query bit for bit for integer columns. ``device`` is where the
    kernel path runs its segment_agg launches (None: the card)."""

    def __init__(self, name: str, dataverse: str, dataset: str, key: str,
                 aggs, predicate=None, device=None):
        for s in aggs:
            if s.op not in _VIEW_OPS:
                raise ValueError(f"view aggregate {s.op!r} not in {_VIEW_OPS}")
        self.name = name
        self.dataverse, self.dataset = dataverse, dataset
        self.key = key
        self.aggs = list(aggs)
        self.device = resolve_device(device)
        self.predicate = None
        if predicate is not None:
            self.predicate = copy.deepcopy(predicate)
            for lit in self.predicate.literals():
                lit.slot = None  # evaluate un-parameterized on delta batches
        self._sum_cols = []
        self._max_cols, self._min_cols = [], []
        for s in self.aggs:
            if s.op in ("sum", "mean") and s.column not in self._sum_cols:
                self._sum_cols.append(s.column)
            elif s.op == "max" and s.column not in self._max_cols:
                self._max_cols.append(s.column)
            elif s.op == "min" and s.column not in self._min_cols:
                self._min_cols.append(s.column)
        self.lo: Optional[int] = None
        self._counts: Optional[np.ndarray] = None
        self._sums: dict[str, np.ndarray] = {}
        self._maxs: dict[str, np.ndarray] = {}
        self._mins: dict[str, np.ndarray] = {}
        self._key_dtype = None
        self._dtypes: dict[str, np.dtype] = {}
        self.stats = {"refreshes": 0, "rows_applied": 0,
                      "kernel_batches": 0, "exact_fallback_batches": 0,
                      "retractions": 0, "rows_retracted": 0,
                      "extremum_recomputes": 0}

    @classmethod
    def from_plan(cls, name: str, plan: P.Plan, device=None) -> "MaterializedView":
        """Accepts GroupAgg(keys=[k], aggs) over Scan or Filter(Scan)."""
        if not isinstance(plan, P.GroupAgg) or len(plan.keys) != 1:
            raise ValueError(
                "create_view needs a single-key group-by aggregate "
                "(df.groupby(key).agg(...)-shaped plan)")
        child = plan.children[0]
        predicate = None
        if isinstance(child, P.Filter):
            predicate = child.predicate
            child = child.children[0]
        if not isinstance(child, P.Scan) or "@" in child.dataset:
            raise ValueError(
                "create_view supports GroupAgg over a (optionally filtered) "
                "dataset scan")
        return cls(name, child.dataverse, child.dataset, plan.keys[0],
                   list(plan.aggs), predicate, device)

    def columns(self) -> list[str]:
        """The dataset columns the view reads: its key, its aggregates'
        columns and its predicate's."""
        names = [self.key] + self._sum_cols + self._max_cols + self._min_cols
        if self.predicate is not None:
            names += sorted(self.predicate.columns())
        return list(dict.fromkeys(names))

    # -- state ------------------------------------------------------------

    def reset(self) -> None:
        """Drop the materialized partials (soft state)."""
        self.lo = None
        self._counts = None
        self._sums, self._maxs, self._mins = {}, {}, {}
        self._key_dtype = None
        self._dtypes = {}

    def _ensure_domain(self, klo: int, khi: int) -> None:
        if self._counts is None:
            self.lo = klo
            g = khi - klo + 1
            self._counts = np.zeros(g, np.int64)
            self._sums = {c: np.zeros(g, np.float64) for c in self._sum_cols}
            self._maxs = {c: np.full(g, -np.inf) for c in self._max_cols}
            self._mins = {c: np.full(g, np.inf) for c in self._min_cols}
            return
        g = self._counts.shape[0]
        new_lo = min(self.lo, klo)
        new_hi = max(self.lo + g - 1, khi)
        if new_lo == self.lo and new_hi == self.lo + g - 1:
            return
        left, right = self.lo - new_lo, new_hi - (self.lo + g - 1)

        def grow(a, fill):
            return np.pad(a, (left, right), constant_values=fill)

        self._counts = grow(self._counts, 0)
        self._sums = {c: grow(a, 0.0) for c, a in self._sums.items()}
        self._maxs = {c: grow(a, -np.inf) for c, a in self._maxs.items()}
        self._mins = {c: grow(a, np.inf) for c, a in self._mins.items()}
        self.lo = new_lo

    def _predicate_mask(self, cols: dict[str, np.ndarray]) -> np.ndarray:
        env = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in cols.items()}
        return self.predicate.evaluate(env, []).numpy().astype(bool)

    def _delta_exact_for_kernel(self, n: int, cols: dict[str, np.ndarray],
                                live: np.ndarray) -> bool:
        """The kernel mode's group-agg exactness gate, against the actual
        delta batch: f32 partials are bit-exact when every per-group
        count/sum/extreme stays an integer below 2^24."""
        if n >= _F32_EXACT:
            return False
        for c in self._sum_cols + self._max_cols + self._min_cols:
            a = cols[c]
            if not np.issubdtype(a.dtype, np.integer):
                return False
            vals = a[live]
            maxabs = int(np.abs(vals).max()) if vals.size else 0
            bound = n * maxabs if c in self._sum_cols else maxabs
            if bound >= _F32_EXACT:
                return False
        return True

    def apply_delta(self, cols: dict[str, np.ndarray],
                    valid: Optional[np.ndarray] = None,
                    rows: Optional[int] = None) -> None:
        """Apply one delta batch (``valid`` masks its rows). ``rows`` is
        the row count the kernel-exactness gate charges when it differs
        from the batch's (a rank mesh seeds from a component's visible
        rows alone, and charges the component's rows, as the one-process
        mesh does)."""
        n = len(next(iter(cols.values())))
        self.stats["refreshes"] += 1
        if n == 0:
            return
        live = np.ones(n, bool) if valid is None else np.asarray(valid, bool).copy()
        if self.predicate is not None:
            live &= self._predicate_mask(cols)
        if not live.any():
            return
        keys = np.asarray(cols[self.key])
        self._key_dtype = keys.dtype
        for c in self._sum_cols + self._max_cols + self._min_cols:
            self._dtypes[c] = np.asarray(cols[c]).dtype
        kl = keys[live]
        self._ensure_domain(int(kl.min()), int(kl.max()))
        g = self._counts.shape[0]
        gid = np.where(live, keys.astype(np.int64) - self.lo, -1).astype(np.int32)
        self.stats["rows_applied"] += int(live.sum())
        if self._delta_exact_for_kernel(n if rows is None else rows, cols,
                                        live):
            self._apply_kernel(cols, gid, g, n)
        else:
            self._apply_exact(cols, gid, live, g)

    def _apply_kernel(self, cols, gid, g, n) -> None:
        """Delta partials through segment_agg on the view's device (one
        fused sum launch + one launch per extreme family), merged into the
        int64/float64 host state."""
        from repro_torch.kernels import ops

        self.stats["kernel_batches"] += 1
        dev = self.device
        gid_t = torch.from_numpy(gid).to(dev)

        def stack(names, ones=False):
            tiles = [torch.ones(n, dtype=torch.float32)] if ones else []
            tiles += [torch.from_numpy(np.asarray(cols[c]).astype(np.float32))
                      for c in names]
            return torch.stack(tiles, dim=1).to(dev)

        part = _host(ops.segment_agg(stack(self._sum_cols, ones=True), gid_t,
                                     g, n))
        self._counts += part[:, 0].astype(np.int64)
        for i, c in enumerate(self._sum_cols):
            self._sums[c] += part[:, 1 + i].astype(np.float64)
        if self._max_cols:
            part = _host(ops.segment_agg(stack(self._max_cols), gid_t, g, n,
                                         op="max"))
            for i, c in enumerate(self._max_cols):
                np.maximum(self._maxs[c], part[:, i].astype(np.float64),
                           out=self._maxs[c])
        if self._min_cols:
            part = _host(ops.segment_agg(stack(self._min_cols), gid_t, g, n,
                                         op="min"))
            for i, c in enumerate(self._min_cols):
                np.minimum(self._mins[c], part[:, i].astype(np.float64),
                           out=self._mins[c])

    def apply_retraction(self, cols: dict[str, np.ndarray],
                         recompute=None) -> None:
        """Retract rows previously applied (the OLD values a flush's
        anti-matter annihilated): counts and sums take exact negative
        deltas; a retracted value touching a group's stored extremum calls
        ``recompute(op, column, keys)`` (the session's exact host fallback)
        for exactly the affected groups; emptied groups reset to identity."""
        n = len(next(iter(cols.values()))) if cols else 0
        if n == 0 or self._counts is None:
            return
        self.stats["retractions"] += 1
        live = np.ones(n, bool)
        if self.predicate is not None:
            live &= self._predicate_mask(cols)
        if not live.any():
            return
        keys = np.asarray(cols[self.key])
        kl = keys[live]
        self._ensure_domain(int(kl.min()), int(kl.max()))
        g = self._counts.shape[0]
        ix = (kl.astype(np.int64) - self.lo).astype(np.int64)
        self.stats["rows_retracted"] += int(live.sum())
        self._counts -= np.bincount(ix, minlength=g).astype(np.int64)
        for c in self._sum_cols:
            vals = np.asarray(cols[c])[live].astype(np.float64)
            self._sums[c] -= np.bincount(ix, weights=vals, minlength=g)
        emptied = self._counts <= 0
        for c, op, state in [(c, "max", self._maxs) for c in self._max_cols] \
                + [(c, "min", self._mins) for c in self._min_cols]:
            vals = np.asarray(cols[c])[live].astype(np.float64)
            hit = np.zeros(g, bool)
            touched = vals >= state[c][ix] if op == "max" else vals <= state[c][ix]
            hit[ix[touched]] = True
            hit &= ~emptied  # empty groups just reset below
            if hit.any():
                if recompute is None:
                    raise ValueError(
                        f"view {self.name!r}: retraction touched a group "
                        f"{op} and no exact recompute fallback is available")
                self.stats["extremum_recomputes"] += 1
                group_keys = (self.lo + np.nonzero(hit)[0]).astype(np.int64)
                state[c][hit] = recompute(op, c, group_keys)
            state[c][emptied] = -np.inf if op == "max" else np.inf
        for c in self._sum_cols:
            self._sums[c][emptied] = 0.0
        self._counts[emptied] = 0

    def _apply_exact(self, cols, gid, live, g) -> None:
        """Native-dtype host fallback when f32 exactness cannot be proven:
        float64 bincount sums (exact to 2^53) and ufunc.at extremes."""
        self.stats["exact_fallback_batches"] += 1
        ix = gid[live]
        self._counts += np.bincount(ix, minlength=g).astype(np.int64)
        for c in self._sum_cols:
            vals = np.asarray(cols[c])[live].astype(np.float64)
            self._sums[c] += np.bincount(ix, weights=vals, minlength=g)
        for c in self._max_cols:
            np.maximum.at(self._maxs[c], ix, np.asarray(cols[c])[live])
        for c in self._min_cols:
            np.minimum.at(self._mins[c], ix, np.asarray(cols[c])[live])

    def result(self) -> dict[str, np.ndarray]:
        """The materialized group table (groups with at least one row), in
        the dtypes the equivalent group-by query returns."""
        if self._counts is None:
            return {self.key: np.array([], dtype=np.int64),
                    **{s.out_name: np.array([]) for s in self.aggs}}
        live = self._counts > 0
        g = self._counts.shape[0]
        out = {self.key: (self.lo + np.arange(g))[live].astype(self._key_dtype)}
        counts = self._counts[live]
        for s in self.aggs:
            if s.op == "count":
                out[s.out_name] = counts.astype(np.int32)
            elif s.op == "sum":
                out[s.out_name] = self._sums[s.column][live].astype(
                    self._dtypes[s.column])
            elif s.op == "mean":  # f32 sum / f32 count, as the query path
                out[s.out_name] = (self._sums[s.column][live].astype(np.float32)
                                   / counts.astype(np.float32))
            elif s.op == "max":
                out[s.out_name] = self._maxs[s.column][live].astype(
                    self._dtypes[s.column])
            else:
                out[s.out_name] = self._mins[s.column][live].astype(
                    self._dtypes[s.column])
        return out

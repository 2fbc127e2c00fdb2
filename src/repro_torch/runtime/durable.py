"""Durable storage: checksummed on-disk components, manifest generations,
and the per-dataset feed write-ahead log (port of
``repro.runtime.durable``; numpy and the port's telemetry only).

The LSM (engine/lsm.py) keeps *hard* state — matter rows, tombstone rows,
the manifest — on the session device; this module is the layer that makes
a process restart recoverable (AsterixDB's LSM disk format + transaction
log):

  * **Segment files** (``data/<dv>/<ds>/seg/*.seg``) hold one LSM
    component's full column tensors — matter, tombstone rows, derived
    string lanes — copied to the host, in a versioned, length-prefixed
    format with a CRC32 per array. Segments are written at publish time
    (off the catalog lock for flush/compaction-built components), via
    write-temp → fsync → atomic rename. Soft state (index payloads, zone
    maps, host key copies, annihilation bookkeeping) is never stored:
    ``lsm.recover`` rebuilds it from the columns on the device.
  * **Manifest generations** (``data/<dv>/<ds>/MANIFEST.<lsn>.json``) are
    the durable half of ``Catalog.publish``: each atomic in-memory swap
    commits one self-checksummed JSON manifest naming the component
    segments and the WAL sequence number the publish covers. The last
    ``keep_manifests`` generations are retained so a corrupted newest
    generation falls back to the previous one instead of failing cold
    start.
  * **The feed WAL** (``data/<dv>/<ds>/wal.log``) is append-only: every
    ``push``/``upsert``/``delete`` batch is appended and fsynced *before*
    the ack, and truncated only after the covering flush's manifest commit.
    Cold start replays the tail (records past the newest valid manifest's
    ``wal_upto``) through the normal flush path; a torn tail — the record a
    crash interrupted mid-write — is detected by CRC and dropped (that
    batch was never acked).

The format is the reference's byte for byte (magic, versions, header JSON
with sorted keys, array order and dtype strings, file names), so a store
written by either package opens in the other.

Crash points (``runtime/fault.py`` ``IO_FAULT_POINTS``) are threaded
through every write: ``torn-write`` (half a segment/WAL payload on disk),
``pre-rename`` (manifest tmp fully written + fsynced, not yet visible),
``pre-wal-truncate`` (manifest committed, WAL not yet truncated), and
``mid-replay`` (between replayed batches during ``Session.open``). Killing
at ANY of them and reopening yields visible rows bit-identical to a run
that applied exactly the acknowledged batches.

A corrupted segment or manifest (bad CRC, bad magic, truncation) is moved
to ``quarantine/`` and counted in ``storage.corruption_total``; reads fall
back to the previous manifest generation.

On a mesh of ``torch.distributed`` ranks (``launch.mesh.RankMesh``) the
ranks share ONE store, in this same format, on the one host's disk: a
store written on ranks opens without a mesh in either package, and a
store written without one opens on ranks. Global rank
``launch.mesh.WRITER`` is the writer, the only process that holds
``LOCK`` and the WAL handles and that writes, renames or unlinks a file;
every other rank holds a follower (``mesh``'s store with no file I/O but
the reads of the segments the writer chose at open). Every rank makes the
same calls in the same order; each piece of the writer's I/O is followed
by a vote of every rank (``launch.mesh.agree`` over every axis), so a
fault, a ``StorageLockError`` or a ``StorageCorruption`` on the writer
raises on every rank at the same call: a WAL append is acked on every
rank or on none, a manifest commit or a WAL truncate fails on all of them
alike. A segment holds a whole component: its rows come to the writer's
host in global order (``distributed.gather_to_host``, in chunks), cut
back to the rows before the shards' padding, so it holds exactly what a
meshless session writes. At open the writer alone takes the lock,
chooses each dataset's generation (quarantining and falling back as
above) and reads each WAL tail, and broadcasts what it chose
(``launch.mesh.broadcast_object``); each rank then reads the chosen
segments itself and keeps its own rows.
"""
from __future__ import annotations

import io
import json
import os
import pathlib
import struct
import threading
import zlib
from typing import Callable, Optional

import numpy as np

from repro_torch.launch.mesh import (WRITER, agree, broadcast_object,
                                     is_rank_mesh, is_writer)
from repro_torch.runtime import telemetry as tel

SEGMENT_MAGIC = b"RSEG\x01"      # segment format, version 1
WAL_MAGIC = b"RWAL"              # one per WAL record
_WAL_HEADER = struct.Struct("<4sQBQ")   # magic, seq, kind, payload_len
_WAL_CRC = struct.Struct("<I")
WAL_KINDS = ("push", "upsert", "delete")

MANIFEST_VERSION = 1
SEGMENT_VERSION = 1


class StorageCorruption(RuntimeError):
    """A checksummed on-disk structure (segment / manifest / WAL record)
    failed verification: bad magic, bad CRC, or truncation."""


class StorageLockError(RuntimeError):
    """The storage directory is already open by a live process — double
    opening would interleave two writers' segment/manifest/WAL streams."""


# a rank's outcome in a store vote (the least wins): the writer's error
# type, which every rank then raises, or none
_CORRUPT, _LOCKED, _FAILED, _OK = 0, 1, 2, 3


def _outcome(err: Optional[BaseException]) -> int:
    if err is None:
        return _OK
    if isinstance(err, StorageCorruption):
        return _CORRUPT
    return _LOCKED if isinstance(err, StorageLockError) else _FAILED


def _peer_error(code: int) -> BaseException:
    """The error a rank raises for a peer's failed step (``_outcome``)."""
    from repro_torch.runtime.fault import StorageFault

    what = {_CORRUPT: StorageCorruption, _LOCKED: StorageLockError}.get(
        code, StorageFault)
    return what("the store's writer rank failed this step: it is aborted on "
                "every rank")


def _fsync_dir(path: pathlib.Path) -> None:
    """fsync the directory entry so a rename/create survives power loss.
    Best-effort: some filesystems refuse O_RDONLY dir fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform-dependent
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def _num(x):
    """JSON-safe scalar: numpy ints/floats → python; None passes through."""
    if x is None:
        return None
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    return float(x)


def _meta_to_json(m) -> dict:
    return {"dtype": np.dtype(m.dtype).str, "lo": _num(m.lo),
            "hi": _num(m.hi), "distinct": _num(m.distinct),
            "is_string": bool(m.is_string),
            "sorted_ascending": bool(m.sorted_ascending),
            "dict_values": list(m.dict_values)
            if m.dict_values is not None else None}


def _meta_from_json(d):
    from repro_torch.engine.table import ColumnMeta

    return ColumnMeta(np.dtype(d["dtype"]), d["lo"], d["hi"], d["distinct"],
                      bool(d["is_string"]), bool(d["sorted_ascending"]),
                      tuple(d["dict_values"])
                      if d["dict_values"] is not None else None)


def _record_checksum(record: dict) -> int:
    """Self-checksum of a manifest record: CRC32 over the canonical JSON of
    everything except the checksum field itself."""
    body = {k: v for k, v in record.items() if k != "checksum"}
    return zlib.crc32(json.dumps(body, sort_keys=True).encode()) & 0xFFFFFFFF


# -- segment files -------------------------------------------------------------


def write_segment(path: pathlib.Path, arrays: dict[str, np.ndarray],
                  meta: dict, fault: Callable[[str], None]) -> None:
    """Write one component segment: magic | u32 header-length | header JSON
    | concatenated raw array bytes, committed via tmp → fsync → atomic
    rename. The header carries per-array dtype/shape/CRC32 plus the
    component metadata, so a reader verifies every tensor independently.
    The ``torn-write`` fault point fires after half the payload bytes are
    on disk — the torn file is only ever the tmp (never renamed), which is
    exactly the protocol's claim: a crashed segment write is invisible."""
    payloads = []
    descr = []
    for name, a in arrays.items():
        a = np.ascontiguousarray(np.asarray(a))
        raw = a.tobytes()
        descr.append({"name": name, "dtype": a.dtype.str,
                      "shape": list(a.shape), "nbytes": len(raw),
                      "crc32": zlib.crc32(raw) & 0xFFFFFFFF})
        payloads.append(raw)
    header = json.dumps({"version": SEGMENT_VERSION, "arrays": descr,
                         "meta": meta}, sort_keys=True).encode()
    body = b"".join(payloads)
    half = len(body) // 2
    tmp = path.with_suffix(path.suffix + ".tmp")
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(SEGMENT_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(body[:half])
        fault("torn-write")
        f.write(body[half:])
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path.parent)
    tel.inc("storage.segments_written_total")
    tel.inc("storage.segment_bytes_written_total",
            len(body) + len(header) + 10)


def read_segment(path: pathlib.Path) -> tuple[dict[str, np.ndarray], dict]:
    """Read + verify one segment. Raises :class:`StorageCorruption` on any
    mismatch (missing file, bad magic, short read, per-array CRC)."""
    try:
        blob = path.read_bytes()
    except OSError as e:
        raise StorageCorruption(f"segment {path}: unreadable ({e})") from e
    if blob[:len(SEGMENT_MAGIC)] != SEGMENT_MAGIC:
        raise StorageCorruption(f"segment {path}: bad magic")
    off = len(SEGMENT_MAGIC)
    if len(blob) < off + 4:
        raise StorageCorruption(f"segment {path}: truncated header length")
    (hlen,) = struct.unpack_from("<I", blob, off)
    off += 4
    if len(blob) < off + hlen:
        raise StorageCorruption(f"segment {path}: truncated header")
    try:
        header = json.loads(blob[off:off + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise StorageCorruption(f"segment {path}: unparseable header") from e
    off += hlen
    if header.get("version") != SEGMENT_VERSION:
        raise StorageCorruption(
            f"segment {path}: unsupported version {header.get('version')}")
    arrays: dict[str, np.ndarray] = {}
    for d in header["arrays"]:
        raw = blob[off:off + d["nbytes"]]
        if len(raw) != d["nbytes"]:
            raise StorageCorruption(
                f"segment {path}: array {d['name']!r} truncated")
        if (zlib.crc32(raw) & 0xFFFFFFFF) != d["crc32"]:
            raise StorageCorruption(
                f"segment {path}: array {d['name']!r} CRC mismatch")
        arrays[d["name"]] = np.frombuffer(raw, dtype=np.dtype(d["dtype"])) \
            .reshape(d["shape"]).copy()
        off += d["nbytes"]
    return arrays, header["meta"]


# -- the write-ahead log -------------------------------------------------------


class WriteAheadLog:
    """One dataset's append-only feed log. Records are individually CRC'd
    and length-prefixed; ``append`` fsyncs before returning (the ack), so
    an acked batch survives any later crash. A torn tail (a record a crash
    cut short) fails its CRC and is dropped at open — by definition it was
    never acked."""

    def __init__(self, path: pathlib.Path, fault: Callable[[str], None]):
        self.path = path
        self._fault = fault
        self._lock = threading.Lock()
        self.seq = 0          # last durably-appended sequence number
        path.parent.mkdir(parents=True, exist_ok=True)
        valid_end = 0
        for seq, _, _, end in self._scan():
            self.seq = seq
            valid_end = end
        size = path.stat().st_size if path.exists() else 0
        if size > valid_end:  # torn/corrupt tail: repair before appending
            with open(path, "r+b") as f:
                f.truncate(valid_end)
            tel.inc("storage.wal_torn_tail_total")
        self._fh = open(path, "ab")

    def _scan(self):
        """Yield (seq, kind, payload_bytes, end_offset) for every valid
        record, stopping at the first torn or corrupt one."""
        if not self.path.exists():
            return
        blob = self.path.read_bytes()
        off = 0
        while off + _WAL_HEADER.size <= len(blob):
            magic, seq, kind, plen = _WAL_HEADER.unpack_from(blob, off)
            if magic != WAL_MAGIC:
                return
            body_end = off + _WAL_HEADER.size + plen
            if body_end + _WAL_CRC.size > len(blob):
                return  # torn tail
            payload = blob[off + _WAL_HEADER.size:body_end]
            (crc,) = _WAL_CRC.unpack_from(blob, body_end)
            want = zlib.crc32(blob[off + 4:body_end]) & 0xFFFFFFFF
            if crc != want or kind >= len(WAL_KINDS):
                return
            yield seq, WAL_KINDS[kind], payload, body_end + _WAL_CRC.size
            off = body_end + _WAL_CRC.size

    def append(self, kind: str, payload: dict[str, np.ndarray]) -> int:
        """Append one batch and fsync BEFORE returning — the returned seq
        is the durability ack. The ``torn-write`` fault fires with half the
        payload written: the record fails its CRC on replay, modelling an
        un-acked batch lost to the crash."""
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in payload.items()})
        data = buf.getvalue()
        with self._lock:
            seq = self.seq + 1
            header = _WAL_HEADER.pack(WAL_MAGIC, seq, WAL_KINDS.index(kind),
                                      len(data))
            crc = zlib.crc32(header[4:] + data) & 0xFFFFFFFF
            half = len(data) // 2
            self._fh.write(header)
            self._fh.write(data[:half])
            self._fh.flush()
            self._fault("torn-write")
            self._fh.write(data[half:])
            self._fh.write(_WAL_CRC.pack(crc))
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.seq = seq
        tel.inc("storage.wal_appends_total")
        return seq

    def tail(self, after_seq: int) -> list[tuple[int, str, dict]]:
        """Decoded records with seq > ``after_seq`` (the replay set): the
        covering flush never committed, so these batches re-flush through
        the normal path. Records at or below ``after_seq`` are skipped —
        the idempotent-replay guarantee when a crash landed between the
        manifest commit and the WAL truncate."""
        with self._lock:
            out = []
            for seq, kind, payload, _ in self._scan():
                if seq <= after_seq:
                    continue
                with np.load(io.BytesIO(payload)) as z:
                    cols = {k: z[k] for k in z.files}
                out.append((seq, kind, cols))
            return out

    def truncate(self, upto_seq: int) -> None:
        """Drop every record with seq <= ``upto_seq`` (they are covered by
        a committed manifest). The common case — everything covered —
        truncates in place; a partial cover rewrites the survivors through
        a tmp + atomic rename."""
        with self._lock:
            survivors = [(s, k, p) for s, k, p, _ in self._scan()
                         if s > upto_seq]
            self._fh.close()
            if not survivors:
                with open(self.path, "wb") as f:
                    os.fsync(f.fileno())
            else:
                tmp = self.path.with_suffix(".log.tmp")
                with open(tmp, "wb") as f:
                    for seq, kind, payload in survivors:
                        header = _WAL_HEADER.pack(
                            WAL_MAGIC, seq, WAL_KINDS.index(kind),
                            len(payload))
                        crc = zlib.crc32(header[4:] + payload) & 0xFFFFFFFF
                        f.write(header + payload + _WAL_CRC.pack(crc))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
            self._fh = open(self.path, "ab")
        tel.inc("storage.wal_truncations_total")

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


# -- the store -----------------------------------------------------------------


class DurableStore:
    """One durable storage directory:

    .. code-block:: text

        <root>/LOCK                              single-writer guard (pid)
        <root>/data/<dv>/<ds>/seg/*.seg          component segments
        <root>/data/<dv>/<ds>/MANIFEST.<lsn>.json  manifest generations
        <root>/data/<dv>/<ds>/wal.log            feed write-ahead log
        <root>/quarantine/                       corrupt files, preserved

    The store is the durable half of ``Catalog.publish``: the catalog
    calls :meth:`commit` inside every publish, which persists any
    still-unwritten component segments and then atomically renames the new
    manifest generation into place. Crash ordering is the classic WAL
    protocol — segment writes and the manifest rename are atomic or
    invisible, the WAL covers everything newer than the last committed
    manifest, and truncation happens strictly after the commit."""

    def __init__(self, root, fault: Optional[Callable[[str], None]] = None,
                 keep_manifests: int = 3, mesh=None):
        """``mesh``: a ``RankMesh`` makes this rank's view of the ranks'
        one store (the writer's on ``launch.mesh.WRITER``, else a
        follower's); every rank constructs it at the same point."""
        self.root = pathlib.Path(root)
        self.keep_manifests = max(int(keep_manifests), 1)
        self._fault = fault if fault is not None else (lambda point: None)
        self.mesh = mesh if is_rank_mesh(mesh) else None
        self.writes = is_writer(mesh)
        self._locked = False
        self._wals: dict[tuple[str, str], WriteAheadLog] = {}
        # the last acked WAL sequence of each dataset, on every rank
        self._seqs: dict[tuple[str, str], int] = {}
        self._wal_covered: dict[tuple[str, str], int] = {}
        # segment files written but not yet referenced by a committed
        # manifest (flush/compaction builds persist off-lock, commit links)
        self._inflight: dict[tuple[str, str], set] = {}
        # (dv, ds) -> {lsn: manifest record} for the kept generations —
        # the reference set segment GC checks before unlinking
        self._records: dict[tuple[str, str], dict[int, dict]] = {}
        self._seg_counter: dict[tuple[str, str], int] = {}
        self._lock = threading.RLock()
        # seed the recovery-visible series so they exist (and read 0)
        # before the first corruption/replay ever happens
        tel.inc("storage.corruption_total", 0)
        tel.inc("storage.wal_replayed_batches_total", 0)
        self._agreed(self._open_root)

    # -- the ranks' agreement --------------------------------------------------

    def _vote(self, err: Optional[BaseException], mesh=None) -> None:
        """Raise ``err`` if this rank failed; on a rank mesh first agree
        every rank's outcome over every axis of ``mesh`` (the store's by
        default; the background compactor's worker passes its twin), so a
        rank whose own step succeeded raises the writer's error type too."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is not None:
            code = agree(mesh, _outcome(err), mesh.axis_names)
            if err is None and code != _OK:
                err = _peer_error(code)
        if err is not None:
            raise err

    def _agreed(self, io: Callable, mesh=None, value: bool = False):
        """Run ``io`` (file I/O) on the writer, then the vote; with
        ``value`` every rank returns the writer's result."""
        out = err = None
        if self.writes:
            try:
                out = io()
            except Exception as e:  # every rank raises at this call
                err = e
        self._vote(err, mesh)
        mesh = mesh if mesh is not None else self.mesh
        if value and mesh is not None:
            out = broadcast_object(mesh, out)
        return out

    # -- lock ------------------------------------------------------------------

    def _open_root(self) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        (self.root / "data").mkdir(exist_ok=True)
        (self.root / "quarantine").mkdir(exist_ok=True)
        self._acquire_lock()

    def _acquire_lock(self) -> None:
        lock = self.root / "LOCK"
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                try:
                    pid = int(lock.read_text().strip() or "-1")
                except (OSError, ValueError):
                    pid = -1
                if pid > 0 and _pid_alive(pid):
                    raise StorageLockError(
                        f"storage directory {self.root} is already open by "
                        f"pid {pid}; close that session (Session.close) "
                        "before reopening") from None
                # stale lock from a dead process: steal it
                try:
                    lock.unlink()
                except OSError:  # pragma: no cover - lost the race
                    pass
                continue
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            self._locked = True
            return

    def close(self) -> None:
        """Release the directory lock and the WAL handles (the writer's;
        a follower holds neither). Used both for clean shutdown and by
        crash tests to simulate process death before reopening the same
        directory."""
        for wal in self._wals.values():
            wal.close()
        self._wals.clear()
        if getattr(self, "_locked", False):
            try:
                (self.root / "LOCK").unlink()
            except OSError:  # pragma: no cover
                pass
            self._locked = False

    # -- paths -----------------------------------------------------------------

    def _ds_dir(self, dv: str, name: str) -> pathlib.Path:
        return self.root / "data" / dv / name

    def _seg_path(self, dv: str, name: str, seg: str) -> pathlib.Path:
        return self._ds_dir(dv, name) / "seg" / seg

    def _base_name(self, comp) -> str:
        return comp.name.partition("@")[0]

    # -- segments --------------------------------------------------------------

    def write_component(self, dv: str, name: str, comp) -> str:
        """Persist one LSM component's hard state (all table columns +
        column metadata + index inventory) as a segment file. Idempotent:
        a component already persisted (``comp.seg_name`` set) is a no-op.
        Runs are named by their stable uid; bases by a per-dataset monotone
        counter (never reused, like run uids).

        A rank's shard (``comp.table.mesh``, the compactor worker's twin
        while it builds) is collective: every rank's rows come to the
        writer's host (``gather_to_host``), cut back to ``real_rows`` and
        without the ``__valid__`` mask the shard added, and the write is
        voted on; every rank takes the writer's segment name."""
        if comp.seg_name is not None:
            return comp.seg_name
        key = (dv, name)
        t = comp.table
        names = [k for k in t.columns
                 if not (k == "__valid__" and t.shard_valid)]
        if t.mesh is None:
            # one host copy per column (the tensors live on the session
            # device), in the table's column order: the header lists
            # arrays in it
            arrays = {k: t.columns[k].cpu().numpy() for k in names}
        else:
            arrays = self._gathered(t, names)

        def write() -> str:
            if comp.uid >= 0:
                seg = f"run{comp.uid}.seg"
            else:
                with self._lock:
                    n = self._seg_counter.get(key)
                    if n is None:
                        n = _max_base_counter(self._ds_dir(dv, name) / "seg") + 1
                    self._seg_counter[key] = n + 1
                seg = f"base.{n}.seg"
            meta = {
                "name": comp.name, "uid": int(comp.uid),
                "level": int(comp.level), "closed": bool(comp.closed),
                "num_rows": int(t.real_rows), "live_rows": _num(comp.live_rows),
                "anti_rows": int(comp.anti_rows),
                "columns": [[k, _meta_to_json(t.meta[k])] for k in names],
                "indexes": [[key, ix.name, ix.column, ix.kind]
                            for key, ix in comp.indexes.items()],
            }
            write_segment(self._seg_path(dv, name, seg), arrays, meta,
                          self._fault)
            return seg

        seg = self._agreed(write, t.mesh, value=True)
        with self._lock:
            self._inflight.setdefault(key, set()).add(seg)
        comp.seg_name = seg
        return seg

    def _gathered(self, t, names: list) -> Optional[dict]:
        """A rank's shard's columns ``names``, whole on the writer's host
        (None elsewhere): the rows before the shards' padding, in global
        order, gathered to the writer alone in chunks of at most half a
        shard a rank, so no card ever holds the whole component. Ranks of
        the other model indices (replicas of the writer's data group) take
        no part: their rows are the same."""
        from repro_torch.engine.distributed import (GATHER_CHUNK_ROWS,
                                                    gather_to_host)

        mesh = t.mesh
        if any(mesh.coords[a] for a in mesh.axis_names
               if a not in t.data_axes):
            return None
        real = np.arange(t.num_rows) + t.row_offset < t.real_rows
        chunk = min(GATHER_CHUNK_ROWS, max(-(-t.num_rows // 2), 1))
        got = gather_to_host(mesh, t.data_axes, [t.columns[k] for k in names],
                             real, chunk, dst=WRITER)
        return None if got is None else dict(zip(names, got))

    def discard_component(self, dv: str, name: str, comp) -> None:
        """Unlink a segment written for a build that lost its CAS (manifest
        conflict): it was never referenced by a committed manifest."""
        seg = comp.seg_name
        if seg is None:
            return
        key = (dv, name)
        with self._lock:
            referenced = any(seg in _record_segs(r)
                             for r in self._records.get(key, {}).values())
            if referenced:  # pragma: no cover - defensive
                return
            self._inflight.get(key, set()).discard(seg)
        comp.seg_name = None
        if not self.writes:
            return
        try:
            self._seg_path(dv, name, seg).unlink()
            tel.inc("storage.segments_deleted_total")
        except OSError:  # pragma: no cover
            pass

    def maybe_unlink(self, dv: str, name: str, seg: str) -> None:
        """Retired-component GC hook (Catalog._reclaim): unlink a dead
        component's segment unless a kept manifest generation still
        references it or it is an in-flight (uncommitted) build. The
        writer's alone: a follower never touches the directory."""
        if not self.writes:
            return
        key = (dv, name)
        with self._lock:
            if seg in self._inflight.get(key, set()):
                return
            if any(seg in _record_segs(r)
                   for r in self._records.get(key, {}).values()):
                return
        try:
            self._seg_path(dv, name, seg).unlink()
            tel.inc("storage.segments_deleted_total")
        except OSError:
            pass

    # -- manifests -------------------------------------------------------------

    def commit(self, dv: str, name: str, manifest) -> None:
        """The durable half of ``Catalog.publish``: persist any missing
        component segments, then atomically commit the manifest generation
        (write-temp → fsync → rename, with the ``pre-rename`` crash point
        between). The record embeds ``wal_upto`` — the WAL sequence this
        publish covers — so cold start knows exactly which tail to replay.
        Old generations beyond ``keep_manifests`` are GC'd along with
        segments no kept generation references. On a rank mesh the
        segment writes and the rename are voted on (the commit vote): a
        crash before the rename stops the publish on every rank."""
        key = (dv, name)
        comps = (manifest.base,) + tuple(manifest.runs)
        for comp in comps:
            self.write_component(dv, name, comp)
        record = {
            "version": MANIFEST_VERSION, "lsn": int(manifest.lsn),
            "dataverse": dv, "dataset": name,
            "wal_upto": int(self._wal_covered.get(key, 0)),
            "base": {"seg": manifest.base.seg_name,
                     "uid": int(manifest.base.uid),
                     "level": int(manifest.base.level)},
            "runs": [{"seg": r.seg_name, "uid": int(r.uid),
                      "level": int(r.level)} for r in manifest.runs],
        }
        record["checksum"] = _record_checksum(record)
        d = self._ds_dir(dv, name)

        def rename() -> None:
            d.mkdir(parents=True, exist_ok=True)
            final = d / f"MANIFEST.{manifest.lsn}.json"
            tmp = d / f"MANIFEST.{manifest.lsn}.json.tmp"
            with open(tmp, "w") as f:
                json.dump(record, f)
                f.flush()
                os.fsync(f.fileno())
            self._fault("pre-rename")
            os.replace(tmp, final)
            _fsync_dir(d)

        self._agreed(rename)
        with self._lock:
            recs = self._records.setdefault(key, {})
            recs[int(manifest.lsn)] = record
            segs = _record_segs(record)
            infl = self._inflight.get(key, set())
            infl -= segs
        tel.inc("storage.manifest_commits_total")
        self._gc_dataset(dv, name)

    def _gc_dataset(self, dv: str, name: str) -> None:
        """Rotate manifest generations (keep the newest K) and unlink
        segment files no kept generation references and no in-flight build
        owns. Also sweeps orphaned tmp files."""
        key = (dv, name)
        d = self._ds_dir(dv, name)
        with self._lock:
            recs = self._records.setdefault(key, {})
            kept = sorted(recs)[-self.keep_manifests:]
            drop = [lsn for lsn in recs if lsn not in kept]
            for lsn in drop:
                recs.pop(lsn, None)
            referenced = set()
            for lsn in kept:
                referenced |= _record_segs(recs[lsn])
            referenced |= self._inflight.get(key, set())
        if not self.writes:
            return
        for lsn in drop:
            try:
                (d / f"MANIFEST.{lsn}.json").unlink()
            except OSError:  # pragma: no cover
                pass
        segdir = d / "seg"
        if segdir.is_dir():
            for p in segdir.iterdir():
                if p.suffix == ".tmp":
                    p.unlink(missing_ok=True)
                elif p.name.endswith(".seg") and p.name not in referenced:
                    p.unlink(missing_ok=True)
                    tel.inc("storage.segments_deleted_total")

    def quarantine(self, path: pathlib.Path) -> None:
        """Move a corrupt file aside (preserved for inspection, never read
        again) and count it."""
        qdir = self.root / "quarantine"
        target = qdir / path.name
        i = 0
        while target.exists():
            i += 1
            target = qdir / f"{path.name}.{i}"
        try:
            path.replace(target)
        except OSError:  # pragma: no cover
            return
        tel.inc("storage.quarantined_files_total")

    # -- cold-start loading ----------------------------------------------------

    def list_datasets(self) -> list[tuple[str, str]]:
        """The stored datasets (the writer's listing, on every rank)."""
        return self._agreed(self._list_datasets, value=True)

    def _list_datasets(self) -> list[tuple[str, str]]:
        out = []
        data = self.root / "data"
        if not data.is_dir():
            return out
        for dv in sorted(p for p in data.iterdir() if p.is_dir()):
            for ds in sorted(p for p in dv.iterdir() if p.is_dir()):
                if list(ds.glob("MANIFEST.*.json")):
                    out.append((dv.name, ds.name))
        return out

    def load_dataset(self, dv: str, name: str):
        """Load the newest checksum-valid manifest generation and every
        segment it references. A corrupt manifest or segment is
        quarantined (``storage.corruption_total``) and the previous
        generation is tried — cold start degrades to the last fully-valid
        publish instead of failing. Returns ``(record, segments, report)``
        where ``segments`` maps seg name → (arrays, meta).

        On a rank mesh the writer alone validates, quarantines and
        chooses; every rank gets its record and report, then reads the
        chosen segments itself (the writer keeps the ones it verified),
        and the reads are voted on."""
        if self.mesh is None:
            return self._load_dataset(dv, name)
        held: dict = {}

        def choose():
            record, held["segments"], report = self._load_dataset(dv, name)
            return record, report

        record, report = self._agreed(choose, value=True)
        segments, err = held.get("segments"), None
        if segments is None:
            try:
                segments = {ref["seg"]: read_segment(
                    self._seg_path(dv, name, ref["seg"]))
                    for ref in [record["base"]] + list(record["runs"])}
            except StorageCorruption as e:
                err = e
            with self._lock:
                self._records.setdefault((dv, name), {})[int(record["lsn"])] = \
                    record
                self._wal_covered[(dv, name)] = int(record["wal_upto"])
            tel.inc("storage.corruption_total", report["fallbacks"])
        self._vote(err)
        return record, segments, report

    def _load_dataset(self, dv: str, name: str):
        d = self._ds_dir(dv, name)
        gens = sorted((int(p.name.split(".")[1]) for p in
                       d.glob("MANIFEST.*.json")), reverse=True)
        report = {"generations": len(gens), "fallbacks": 0, "quarantined": []}
        key = (dv, name)
        for lsn in gens:
            path = d / f"MANIFEST.{lsn}.json"
            try:
                record = json.loads(path.read_text())
                if record.get("checksum") != _record_checksum(record) \
                        or record.get("version") != MANIFEST_VERSION:
                    raise StorageCorruption(
                        f"manifest {path}: checksum/version mismatch")
            except (OSError, json.JSONDecodeError, UnicodeDecodeError,
                    StorageCorruption):
                tel.inc("storage.corruption_total")
                report["quarantined"].append(path.name)
                report["fallbacks"] += 1
                self.quarantine(path)
                continue
            segments = {}
            bad = None
            for ref in [record["base"]] + list(record["runs"]):
                seg_path = self._seg_path(dv, name, ref["seg"])
                try:
                    segments[ref["seg"]] = read_segment(seg_path)
                except StorageCorruption:
                    bad = seg_path
                    break
            if bad is not None:
                tel.inc("storage.corruption_total")
                report["quarantined"].append(bad.name)
                report["fallbacks"] += 1
                self.quarantine(bad)
                # the generation referencing the corrupt segment is dead
                # too: quarantine it so the fallback is durable across
                # further reopens
                self.quarantine(path)
                continue
            with self._lock:
                self._records.setdefault(key, {})[int(record["lsn"])] = record
                self._wal_covered[key] = int(record["wal_upto"])
            return record, segments, report
        raise StorageCorruption(
            f"{dv}.{name}: no checksum-valid manifest generation "
            f"(tried {len(gens)})")

    def drop_dataset(self, dv: str, name: str) -> None:
        import shutil

        key = (dv, name)
        wal = self._wals.pop(key, None)
        if wal is not None:
            wal.close()
        with self._lock:
            self._records.pop(key, None)
            self._inflight.pop(key, None)
            self._wal_covered.pop(key, None)
            self._seqs.pop(key, None)
        if self.writes:
            shutil.rmtree(self._ds_dir(dv, name), ignore_errors=True)

    # -- WAL surface -----------------------------------------------------------

    def wal(self, dv: str, name: str) -> WriteAheadLog:
        """The dataset's log (the writer's: a follower holds none)."""
        key = (dv, name)
        w = self._wals.get(key)
        if w is None:
            w = WriteAheadLog(self._ds_dir(dv, name) / "wal.log",
                              self._fault)
            self._wals[key] = w
        return w

    def wal_append(self, dv: str, name: str, kind: str,
                   payload: dict[str, np.ndarray]) -> int:
        """The ack: append and fsync on the writer, then (on a rank mesh)
        the vote, so the batch is acked on every rank or on none."""
        seq = self.wal_seq(dv, name) + 1
        self._agreed(lambda: self.wal(dv, name).append(kind, payload))
        self._seqs[(dv, name)] = seq
        return seq

    def wal_seq(self, dv: str, name: str) -> int:
        """The last acked sequence number. The first call for a dataset
        opens its log on the writer (a torn tail is cut there) and gives
        every rank its sequence."""
        key = (dv, name)
        if key not in self._seqs:
            self._seqs[key] = self._agreed(lambda: self.wal(dv, name).seq,
                                           value=True)
        return self._seqs[key]

    def set_wal_coverage(self, dv: str, name: str, upto: int) -> None:
        """Record the WAL sequence the NEXT manifest commit covers — called
        by the flush path just before publish, so the committed record and
        the buffered batches agree exactly."""
        self._wal_covered[(dv, name)] = int(upto)

    def wal_covered(self, dv: str, name: str) -> int:
        return self._wal_covered.get((dv, name), 0)

    def wal_tail(self, dv: str, name: str) -> list[tuple[int, str, dict]]:
        """The replay set: records past the newest committed manifest's
        coverage (the writer's reading, on every rank)."""
        self.wal_seq(dv, name)
        return self._agreed(
            lambda: self.wal(dv, name).tail(self.wal_covered(dv, name)),
            value=True)

    def wal_truncate(self, dv: str, name: str) -> None:
        """Drop the covered WAL prefix — strictly AFTER the covering
        manifest commit (the ``pre-wal-truncate`` crash point sits between:
        a crash there leaves covered records in the log, and replay skips
        them by sequence number). Voted on, on a rank mesh."""
        def cut() -> None:
            self._fault("pre-wal-truncate")
            self.wal(dv, name).truncate(self.wal_covered(dv, name))

        self._agreed(cut)

    def __enter__(self) -> "DurableStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - exists, owned by another
        return True
    return True


def _record_segs(record: dict) -> set:
    return {record["base"]["seg"]} | {r["seg"] for r in record["runs"]}


def _max_base_counter(segdir: pathlib.Path) -> int:
    """Highest base.<n>.seg counter on disk — base names stay unique across
    reopen cycles the same way run uids do."""
    best = -1
    if segdir.is_dir():
        for p in segdir.glob("base.*.seg"):
            try:
                best = max(best, int(p.name.split(".")[1]))
            except ValueError:  # pragma: no cover
                continue
    return best

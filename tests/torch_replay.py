"""Shared helpers of the ``test_torch_*`` replays: one reference scenario
written once and driven through both packages in the same process.

``pkg("ref")`` and ``pkg("port")`` expose the same surface (plan nodes,
AFrame, Session, Feed, lsm, Table, the Wisconsin generator, and the modules
``table``, ``expr``, ``optimizer``, ``planner`` and ``dialect``); the
port's sessions run on the CPU, so kernel mode runs each kernel's plain
version.
Both Wisconsin generators give the same rows for the same seed.

``pk.session("shard_map")`` builds the reference's way of running that
mode in one process: a mesh of one device (the reference's test files
build it so), and on the port a mesh of one shard. ``pk.session(mode,
shards=S)`` (port only) puts the session on a mesh of S CPU shards."""
import types

import numpy as np


def pkg(which: str):
    if which == "ref":
        from repro.core import dialect, expr, optimizer
        from repro.core import physical as PH
        from repro.core import physical_planner as planner
        from repro.core import plan as P
        from repro.core.frame import AFrame
        from repro.data import wisconsin
        from repro.engine import lsm, table
        from repro.engine.ingest import Feed
        from repro.engine.session import Session
        from repro.engine.table import Table
        from repro.kernels import ops

        def session(mode="gspmd", shards=None, **kw):
            assert shards in (None, 1), "the reference runs one device here"
            if mode == "shard_map" or shards:
                import jax
                from jax.sharding import Mesh

                kw["mesh"] = Mesh(np.array(jax.devices()[:1]), ("data",))
            return Session(mode=mode, **kw)
    else:
        from repro_torch.core import dialect, expr, optimizer
        from repro_torch.core import physical as PH
        from repro_torch.core import physical_planner as planner
        from repro_torch.core import plan as P
        from repro_torch.core.frame import AFrame
        from repro_torch.data import wisconsin
        from repro_torch.engine import lsm, table
        from repro_torch.engine.ingest import Feed
        from repro_torch.engine.session import Session
        from repro_torch.engine.table import Table
        from repro_torch.kernels import ops

        def session(mode="gspmd", shards=None, **kw):
            if mode == "shard_map" or shards:
                from repro_torch.launch.mesh import make_local_mesh

                kw["mesh"] = make_local_mesh(shards or 1, device="cpu")
            else:
                kw["device"] = "cpu"
            return Session(mode=mode, **kw)
    return types.SimpleNamespace(name=which, PH=PH, P=P, AFrame=AFrame,
                                 wisconsin=wisconsin, lsm=lsm, Feed=Feed,
                                 Session=Session, Table=Table, ops=ops,
                                 session=session, table=table, expr=expr,
                                 optimizer=optimizer, planner=planner,
                                 dialect=dialect)


REF, PORT = pkg("ref"), pkg("port")


def host_rows(table) -> dict:
    """A generated table's columns as numpy arrays (either package)."""
    return {k: np.asarray(v) for k, v in table.columns.items()}


def assert_same(a, b, label):
    """Bit-identical results, dtypes included (dicts of arrays or scalars
    of the same Python type)."""
    if isinstance(b, dict):
        assert set(a) == set(b), (label, sorted(a), sorted(b))
        for k in b:
            av, bv = np.asarray(a[k]), np.asarray(b[k])
            assert av.dtype == bv.dtype, (label, k, av.dtype, bv.dtype)
            np.testing.assert_array_equal(av, bv, err_msg=f"{label}:{k}")
    else:
        assert type(a) is type(b) and a == b, (label, a, b)


def scaled_launches(launches: dict, shards: int, meshless: bool) -> dict:
    """The kernel launches a query suite makes on a mesh of ``shards``
    shards, from the counts of one run of it: filter_count, segment_agg
    and merge_join_count launch once per shard; a top-k selects once per
    shard and once over the gathered candidates (a meshless run selects
    once, a one-shard mesh twice)."""
    out = {}
    for k, v in launches.items():
        if k == "topk":
            out[k] = v * (shards + 1) if meshless else v // 2 * (shards + 1)
        else:
            out[k] = v * shards
    return out


def counts(sess) -> tuple:
    return tuple(sess.stats[k] for k in ("compiles", "hits", "optimizes",
                                          "plans"))

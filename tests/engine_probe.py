"""The paper's 12 Wisconsin expressions and the sharded engine probe, for
either package (every function takes the package's classes): the tests of
the port, the reference's subprocess on 8 forced host devices and the rank
bodies of tests/rank_workers.py. Imports numpy only, so a spawned rank
that imports it loads no jax."""
import numpy as np

EXPRESSIONS = {
    "1_count": lambda df, dr, rng: len(df),
    "2_project_head": lambda df, dr, rng: df[["two", "four"]].head(),
    "3_filter_count": lambda df, dr, rng: (lambda x: len(
        df[(df["ten"] == x) & (df["twentyPercent"] == x % 5)
           & (df["two"] == x % 2)]))(int(rng.integers(10))),
    "4_group_count": lambda df, dr, rng: df.groupby("oddOnePercent").agg("count"),
    "5_map_head": lambda df, dr, rng: df["stringu1"].map(str.upper).head(),
    "6_max": lambda df, dr, rng: df["unique1"].max(),
    "7_min": lambda df, dr, rng: df["unique1"].min(),
    "8_group_max": lambda df, dr, rng: df.groupby("twenty")["four"].agg("max"),
    "9_sort_head": lambda df, dr, rng: df.sort_values(
        "unique1", ascending=False).head(),
    "10_select_head": lambda df, dr, rng: df[df["ten"] == int(rng.integers(10))].head(),
    "11_range_count": lambda df, dr, rng: (lambda a, b: len(
        df[(df["onePercent"] >= min(a, b)) & (df["onePercent"] <= max(a, b))]))(
        int(rng.integers(100)), int(rng.integers(100))),
    "12_join_count": lambda df, dr, rng: len(df.merge(
        dr, left_on="unique1", right_on="unique1")),
}


def _enc(v):
    if isinstance(v, dict):
        return {k: [np.asarray(x).tolist(), str(np.asarray(x).dtype)]
                for k, x in v.items()}
    return [v, type(v).__name__]


def sharded_probe(Session, AFrame, P, Col, wisconsin, ops, D, mesh) -> dict:
    """The same probe for either package: the 12 Wisconsin expressions in
    shard_map and kernel mode on ``mesh`` (10,000 rows, 8 shards: one zone
    block a shard), explain texts and prune reports of block-skipping
    plans over a clustered dataset, and the hash repartition's totals and
    drops. JSON-ready."""
    t = wisconsin.generate(10_000, seed=5)
    out = {"exprs": {}, "explain": {}, "report": {}, "dispatch": {}}
    rng = np.random.default_rng
    for mode in ("shard_map", "kernel"):
        sess = Session(mesh=mesh, mode=mode)
        sess.create_dataset("data", t, dataverse="bench")
        sess.create_dataset("data_r", t, dataverse="bench")
        df = AFrame("bench", "data", session=sess)
        dr = AFrame("bench", "data_r", session=sess)
        ops.reset_dispatch_counts()
        for name, fn in sorted(EXPRESSIONS.items()):
            out["exprs"][f"{mode}:{name}"] = _enc(fn(df, dr, rng(11)))
        out["dispatch"][mode] = sorted(ops.DISPATCH_COUNTS)
        # clustered, no index: the range predicates skip zone blocks per shard
        clu = Session(mesh=mesh, mode=mode, enable_index=False)
        clu.create_dataset("clu", t, dataverse="bench", primary="unique2")
        scan = P.Filter(P.Scan("clu", "bench"),
                        (Col("unique2") >= 1000) & (Col("unique2") <= 3000))
        plans = {
            "range_count": P.Agg(scan, [P.AggSpec("count", "count", None)]),
            "group_count": P.GroupAgg(scan, ["ten"],
                                      [P.AggSpec("count", "count", None)]),
            "max": P.Agg(scan, [P.AggSpec("max_unique1", "max", "unique1")]),
        }
        for name, plan in plans.items():
            out["explain"][f"{mode}:{name}"] = clu.explain(plan)
            try:
                res = clu.execute(plan)
            except Exception as e:  # the reference's sharded block gather
                out["exprs"][f"{mode}:{name}"] = ["error", type(e).__name__]
                continue
            out["exprs"][f"{mode}:{name}"] = _enc(res)
            out["report"][f"{mode}:{name}"] = {
                k: v for k, v in clu.last_prune_report.items()
                if k != "total_cost"}
    ds = sess.catalog.get("bench", "data")
    k, m = ds.table.columns["unique1"], ds.table.valid
    out["hash"] = [int(x) for x in D.hash_repartition_counts(
        mesh, ("data",), k, m, k, m)]
    k2 = ds.table.columns["ten"]
    out["hash_small"] = [int(x) for x in D.hash_repartition_counts(
        mesh, ("data",), k2, m, k2, m, capacity_factor=1.5)]
    return out

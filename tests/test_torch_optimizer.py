"""The rewrite rules and the costed access-path choice on the port: the
scenarios of tests/test_optimizer.py replayed on both packages in one
process, over the same numpy-seeded catalog. Every optimized plan and every
physical plan — node kinds, fingerprints, costs, notes — equals the
reference's, with and without the ablation switches
(``optimize(enable_pushdown=..., enable_index=...)``,
``plan_physical(enable_index=...)``)."""
import numpy as np
import pytest

from torch_replay import PORT, REF


@pytest.fixture(scope="module")
def catalogs():
    out = {}
    for pk in (REF, PORT):
        sess = pk.session()
        sess.create_dataset("Data", pk.wisconsin.generate(1000), dataverse="d",
                            indexes=["onePercent"], primary="unique2")
        out[pk.name] = sess.catalog
    return out


def _scan(pk):
    return pk.P.Scan("Data", "d")


def _both(catalogs, build, **kw):
    """Optimize ``build(pk)`` in both packages; the port's optimized plan,
    after checking its fingerprint and SQL equal the reference's."""
    opt = {pk.name: pk.optimizer.optimize(build(pk), catalogs[pk.name], **kw)
           for pk in (REF, PORT)}
    assert opt["port"].fingerprint() == opt["ref"].fingerprint()
    assert opt["port"].to_sql() == opt["ref"].to_sql()
    return opt


def _physical(catalogs, opt, **kw):
    """Plan both optimized plans; the port's, after checking kind,
    fingerprint, costs and explain text equal the reference's."""
    phys = {pk.name: pk.planner.plan_physical(opt[pk.name], catalogs[pk.name],
                                              **kw)
            for pk in (REF, PORT)}
    a, b = phys["port"], phys["ref"]
    assert type(a).__name__ == type(b).__name__
    assert a.fingerprint() == b.fingerprint()
    assert a.total_cost() == b.total_cost()
    # the port names its top-k selection for what it runs (a stable sort or
    # the block_topk kernel), not for the JAX primitive
    ref_text = REF.PH.format_plan(b).replace(
        "[lax.top_k]", "[stable sort]").replace(
        "[pallas block_topk]", "[block_topk kernel]")
    assert PORT.PH.format_plan(a) == ref_text
    return a


def test_fuse_filters(catalogs):
    opt = _both(catalogs, lambda pk: pk.P.Filter(
        pk.P.Filter(_scan(pk), pk.expr.Compare("==", pk.expr.Col("a"),
                                               pk.expr.Lit(1))),
        pk.expr.Compare("==", pk.expr.Col("b"), pk.expr.Lit(2))),
        enable_index=False)["port"]
    assert isinstance(opt, PORT.P.Filter)
    assert isinstance(opt.children[0], PORT.P.Scan)
    assert isinstance(opt.predicate, PORT.expr.BoolOp)


def test_limit_sort_becomes_topk(catalogs):
    opt = _both(catalogs, lambda pk: pk.P.Limit(
        pk.P.Sort(_scan(pk), "unique1", False), 5))
    assert isinstance(opt["port"], PORT.P.TopK)
    assert opt["port"].k == 5 and not opt["port"].ascending
    _physical(catalogs, opt)
    _physical(catalogs, opt, mode="kernel")


def test_limit_pushes_below_project(catalogs):
    opt = _both(catalogs, lambda pk: pk.P.Limit(pk.P.Project(
        _scan(pk), [("u", pk.expr.StrUpper(pk.expr.Col("stringu1")))]), 5))
    assert isinstance(opt["port"], PORT.P.Project)
    assert isinstance(opt["port"].children[0], PORT.P.Limit)


def test_count_filter_fuses(catalogs):
    opt = _both(catalogs, lambda pk: pk.P.Agg(
        pk.P.Filter(_scan(pk), pk.expr.Compare("==", pk.expr.Col("ten"),
                                               pk.expr.Lit(1))),
        [pk.P.AggSpec("count", "count", None)]), enable_index=False)
    assert isinstance(opt["port"], PORT.P.FilterCount)
    _physical(catalogs, opt, mode="kernel")


def test_count_join_fuses(catalogs):
    opt = _both(catalogs, lambda pk: pk.P.Agg(
        pk.P.Join(_scan(pk), _scan(pk), "unique1", "unique1"),
        [pk.P.AggSpec("count", "count", None)]))
    assert isinstance(opt["port"], PORT.P.JoinCount)
    _physical(catalogs, opt)


def _range(pk, lo=10, hi=30, col="onePercent"):
    E = pk.expr
    return E.BoolOp("AND", E.Compare(">=", E.Col(col), E.Lit(lo)),
                    E.Compare("<=", E.Col(col), E.Lit(hi)))


def test_index_selected_for_range(catalogs):
    """Expression 11: the index-only count is costed against the scan, and
    ``enable_index=False`` leaves it out, as in the reference."""
    opt = _both(catalogs, lambda pk: pk.P.Agg(
        pk.P.Filter(_scan(pk), _range(pk)),
        [pk.P.AggSpec("count", "count", None)]))
    assert isinstance(opt["port"], PORT.P.FilterCount)
    assert isinstance(opt["port"].children[0], (PORT.P.Scan, PORT.P.Project))
    phys = _physical(catalogs, opt)
    assert isinstance(phys, PORT.PH.IndexOnlyCount)
    assert phys.index_col == "onePercent" and "chosen over" in phys.note
    no_index = _physical(catalogs, opt, enable_index=False)
    assert not isinstance(no_index, PORT.PH.IndexOnlyCount)
    assert phys.cost < no_index.total_cost()
    kernel = _physical(catalogs, opt, mode="kernel", enable_index=False)
    assert isinstance(kernel, PORT.PH.KernelRangeCount)


def test_index_point_with_residual(catalogs):
    opt = _both(catalogs, lambda pk: pk.P.Filter(_scan(pk), pk.expr.BoolOp(
        "AND", pk.expr.Compare("==", pk.expr.Col("onePercent"), pk.expr.Lit(10)),
        pk.expr.Compare("==", pk.expr.Col("two"), pk.expr.Lit(1)))))
    assert isinstance(opt["port"], PORT.P.Filter)
    phys = _physical(catalogs, opt)
    assert isinstance(phys, PORT.PH.IndexProbe) and phys.residual is not None
    assert isinstance(_physical(catalogs, opt, enable_index=False),
                      PORT.PH.FullScanFilter)


def test_no_index_without_catalog_entry(catalogs):
    opt = _both(catalogs, lambda pk: pk.P.Filter(
        _scan(pk), pk.expr.Compare(">=", pk.expr.Col("twenty"), pk.expr.Lit(3))))
    assert isinstance(_physical(catalogs, opt), PORT.PH.FullScanFilter)


def test_column_pruning_inserts_narrow_project(catalogs):
    opt = _both(catalogs, lambda pk: pk.P.Agg(
        _scan(pk), [pk.P.AggSpec("m", "max", "unique1")]), enable_index=False)
    inner = opt["port"].children[0]
    assert isinstance(inner, PORT.P.Project)
    assert [n for n, _ in inner.outputs] == ["unique1"]


def test_point_then_range_cache_collision():
    """A point (== v) and a range (>= a AND <= b) on an indexed column share
    a plan fingerprint; the point plan must not alias one Lit as both
    bounds, or the cached plan cross-binds the range's literals."""
    t_raw = np.asarray(REF.wisconsin.generate(2000, seed=7).columns["onePercent"])
    out = {}
    for pk in (REF, PORT):
        E = pk.expr
        sess = pk.session()
        sess.create_dataset("D", pk.wisconsin.generate(2000, seed=7),
                            dataverse="r", indexes=["onePercent"])
        point = pk.P.Agg(pk.P.Filter(pk.P.Scan("D", "r"), E.Compare(
            "==", E.Col("onePercent"), E.Lit(3))),
            [pk.P.AggSpec("count", "count", None)])
        rng = pk.P.Agg(pk.P.Filter(pk.P.Scan("D", "r"), _range(pk, 0, 1)),
                       [pk.P.AggSpec("count", "count", None)])
        out[pk.name] = (sess.execute(point), sess.execute(rng),
                        sess.stats["hits"])
    assert out["port"] == out["ref"] == (int((t_raw == 3).sum()),
                                         int(((t_raw >= 0) & (t_raw <= 1)).sum()),
                                         1)


def test_optimizer_disabled_modes(catalogs):
    opt = _both(catalogs, lambda pk: pk.P.Agg(
        pk.P.Filter(_scan(pk), _range(pk)),
        [pk.P.AggSpec("count", "count", None)]),
        enable_index=False, enable_pushdown=False)
    assert isinstance(opt["port"], PORT.P.Agg)
    assert isinstance(_physical(catalogs, opt, enable_index=False),
                      PORT.PH.ScalarAgg)

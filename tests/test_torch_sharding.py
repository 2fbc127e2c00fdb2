"""The port's sharding rules (``repro_torch.models.sharding`` and the
registry's PartitionSpecs, ROADMAP A9b) against the JAX reference on the
CPU. Every comparison is exact: a spec is a tuple of axis names, and the
port's equals the reference's ``PartitionSpec`` converted to a tuple.

* ``param_specs`` of every config's reduced model, leaf by leaf, from the
  port's ``abstract_params`` (the model on the "meta" device laid out as
  the reference's pytree) against the reference's ``param_specs`` of its
  ``abstract_params`` (``jax.eval_shape`` over init), for the one-pod axes
  and the multi-pod ones (a two-axis data tuple).
* ``sanitize_pspec`` / ``sanitize_spec_tree``, ``batch_pspecs`` and
  ``cache_pspecs`` (``cache_shard_dim`` "seq" and "head"), and
  ``ShardingCtx.resolve``.
* ``constrain`` returns its argument, with a context or without one.
"""
import dataclasses
import threading
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.launch.mesh import MeshAxes as JAxes
from repro.models import registry as JR
from repro.models import sharding as JS
from repro_torch.configs import _MODULES, get_config
from repro_torch.launch.mesh import MeshAxes, make_local_mesh
from repro_torch.models import registry as R
from repro_torch.models import sharding as S

ARCHS = sorted(_MODULES)
AXES = {"pod": (JAxes(), MeshAxes()),
        "multipod": (JAxes(data=("pod", "data")), MeshAxes(data=("pod", "data")))}


def _ref_items(tree) -> dict:
    """{path: spec as a tuple} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(k.key) for k in path): tuple(s) for path, s in flat}


def _port_items(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_items(v, path + (k,)))
        return out
    assert isinstance(tree, S.PartitionSpec), (path, tree)
    return {"/".join(path): tuple(tree)}


@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, axes):
    jaxes, taxes = AXES[axes]
    jabs = JR.abstract_params(jget_config(arch).reduced())
    want = _ref_items(JS.param_specs(jabs, jaxes))
    got = _port_items(R.params_pspecs(get_config(arch).reduced(), taxes))
    assert got == want
    # the abstract tree itself: the reference's shapes, no storage
    tabs = R.abstract_params(get_config(arch).reduced())
    jshapes = {"/".join(str(k.key) for k in p): tuple(a.shape) for p, a in
               jax.tree_util.tree_flatten_with_path(jabs)[0]}
    tshapes = {"/".join(p): s for p, s in _shapes(tabs).items()}
    assert tshapes == jshapes
    assert all(t.device.type == "meta" for t in _leaves(tabs))


def _shapes(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, path + (k,)))
        return out
    return {path: tuple(tree.shape)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _fake_mesh(shape: dict):
    """The reference's sanitize reads only ``mesh.shape``."""
    return types.SimpleNamespace(shape=dict(shape))


MESH_SHAPES = [{"data": 2, "model": 4}, {"data": 4, "model": 2},
               {"pod": 2, "data": 2, "model": 2}, {"data": 3, "model": 1}]


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=str)
def test_sanitize_pspec_matches_reference(shape):
    rng = np.random.default_rng(0)
    names = list(shape) + [None, ("pod", "data"), ("data", "model")]
    mesh = make_local_mesh(1, 1, device="cpu")
    mesh = dataclasses.replace(mesh, shape=dict(shape))
    for _ in range(300):
        nd = int(rng.integers(0, 5))
        spec = [names[int(rng.integers(len(names)))] for _ in range(int(rng.integers(0, 5)))]
        dims = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 7])) for _ in range(nd))
        want = tuple(JS.sanitize_pspec(JP(*spec), dims, _fake_mesh(shape)))
        got = S.sanitize_pspec(S.P(*spec), dims, mesh)
        assert isinstance(got, S.PartitionSpec)
        assert tuple(got) == want, (spec, dims)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b",
                                  "zamba2-1.2b", "whisper-base"])
def test_sanitize_spec_tree_matches_reference(arch):
    shape = {"data": 4, "model": 2}
    mesh = dataclasses.replace(make_local_mesh(1, 1, device="cpu"), shape=shape)
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jabs = JR.abstract_params(jcfg)
    want = _ref_items(JS.sanitize_spec_tree(
        JS.param_specs(jabs, JAxes()), jabs, _fake_mesh(shape)))
    tabs = R.abstract_params(tcfg)
    got = _port_items(S.sanitize_spec_tree(S.param_specs(tabs, MeshAxes()),
                                           tabs, mesh))
    assert got == want


@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("shard_dim", ["seq", "head"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_pspecs_match_reference(arch, shard_dim, axes):
    jaxes, taxes = AXES[axes]
    jcfg = dataclasses.replace(jget_config(arch).reduced(), cache_shard_dim=shard_dim)
    tcfg = dataclasses.replace(get_config(arch).reduced(), cache_shard_dim=shard_dim)
    for jfn, tfn in ((JR.batch_pspecs, R.batch_pspecs),
                     (JR.cache_pspecs, R.cache_pspecs)):
        want = {k: tuple(v) for k, v in jfn(jcfg, jaxes).items()}
        got = {k: tuple(v) for k, v in tfn(tcfg, taxes).items()}
        assert got == want, jfn.__name__


@pytest.mark.parametrize("axes", list(AXES))
def test_ctx_resolve_matches_reference(axes):
    jaxes, taxes = AXES[axes]
    mesh = make_local_mesh(2, 2, device="cpu")
    jctx = JS.ShardingCtx(_fake_mesh(mesh.shape), jaxes)
    for spec in [("data", None, "model"), ("model",), ("data", "data"), (),
                 (None, "x", "model")]:
        with S.sharding_ctx(mesh, taxes) as ctx:
            assert tuple(ctx.resolve(spec)) == tuple(jctx.resolve(spec)), spec


def test_constrain_is_the_identity():
    x = torch.randn(4, 6, 8)
    assert S.current_ctx() is None
    assert S.constrain(x, "data", None, "model") is x
    mesh = make_local_mesh(4, 2, device="cpu")
    with S.sharding_ctx(mesh) as ctx:
        assert S.current_ctx() is ctx and ctx.mesh is mesh
        # dims the mesh does not divide are dropped, never an error
        for spec in [("data", None, "model"), ("model", "data", None),
                     ("data",), ()]:
            assert S.constrain(x, *spec) is x
        y = torch.randn(3, 5)
        assert S.constrain(y, "data", "model") is y
        with S.sharding_ctx(make_local_mesh(1, 1, device="cpu")) as inner:
            assert S.current_ctx() is inner
        assert S.current_ctx() is ctx
    assert S.current_ctx() is None


def test_ctx_is_process_wide():
    """A backward's recomputation runs on autograd's device thread: the
    context must be visible there (the reference's is thread-local)."""
    seen = []
    with S.sharding_ctx(make_local_mesh(2, 2, device="cpu")) as ctx:
        t = threading.Thread(target=lambda: seen.append(S.current_ctx()))
        t.start()
        t.join()
    assert seen == [ctx]


def test_partition_spec_and_named_sharding():
    assert S.P("model", ("data",)) == ("model", "data")
    assert tuple(JP("model", ("data",))) == ("model", "data")
    assert S.P(None, ("pod", "data")) == (None, ("pod", "data"))
    import copy
    import pickle
    spec = S.P(None, ("pod", "data"), "model")
    assert copy.deepcopy(spec) == spec and pickle.loads(pickle.dumps(spec)) == spec
    assert type(copy.copy(spec)) is S.PartitionSpec
    mesh = make_local_mesh(2, 2, device="cpu")
    tree = R.abstract_params(get_config("qwen3-1.7b").reduced())
    sh = S.param_shardings(tree, mesh, MeshAxes())
    wq = sh["layers"]["attn"]["wq"]
    assert isinstance(wq, S.NamedSharding) and wq.mesh is mesh
    assert wq.spec == (None, "data", "model") and wq.device == torch.device("cpu")

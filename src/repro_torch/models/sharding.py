"""Sharding rules and the model mesh (port of ``repro.models.sharding``).

The rule table assigns each parameter a PartitionSpec by its path in the
reference's pytree (``attn/wq``, ``experts/w1``, ...), so one table serves
both packages: the port's modules name their parameters as the reference
names its keys, and ``convert.params_like`` lays a model out as that
pytree (stacked layers on a leading axis, which stays unsharded).

What the mesh means in the port. A mesh (``launch/mesh.py``) holds
``data x model`` shards, every one on ONE device; work that is local to a
shard runs shard by shard and is merged with the list-of-partials
collectives of ``engine/distributed.py`` (``psum``, ``pmax``, ``pmean``)
in shard order.

* ``data`` axes: a batch splits into ``data`` contiguous row blocks, when
  the extent divides the batch (``sanitize_pspec``'s rule; otherwise the
  batch stays whole). Each shard runs its block on its own and the
  results merge in shard order: ``steps.make_train_step`` takes each
  block's loss and gradients and merges the gradients into the
  global-batch mean. The reference's counterpart is FSDP plus batch
  sharding under GSPMD.
* ``model`` axis:

  - it splits the routed experts (expert parallelism): rank ``r`` owns
    experts ``[r*E/M, (r+1)*E/M)`` and runs ``moe._local_moe``'s body
    with ``rank=r``, ``e_local=E/M`` and its own capacity, computed from
    its own token count; a ``psum`` over the ranks combines them;
  - under ``decode_cache_update="shardmap"`` it splits the decode
    cache's sequence dimension: rank ``r`` owns rows
    ``[r*S/M, (r+1)*S/M)``, views of the one cache tensor (no copy).

* Dense tensor parallelism: ``constrain(x, *spec)`` resolves and
  sanitizes the spec as the reference does and returns ``x`` unchanged.
  Every shard lives on one device, so there is nothing to place, and
  GSPMD computes the same values with or without a constraint. TP is
  never simulated by splitting GEMMs.

The context is process-wide, where the reference's is thread-local: the
backward of a checkpointed block recomputes its forward on autograd's
device thread, and that recomputation must see the same mesh as the
forward did.

``PartitionSpec`` is a plain tuple; a one-name tuple entry reads as the
name, as jax (0.9) normalises it. ``NamedSharding`` is ``(mesh, spec)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any

from repro_torch.launch.mesh import Mesh, MeshAxes


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``None``, an axis name, or a tuple of
    names."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh; the tensor lives on the mesh's one device."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def device(self):
        return self.mesh.device


# pattern -> spec of (D, M); D = data axes tuple, M = model axis name.
# Patterns are matched against "/"-joined pytree paths, first match wins.
# The trailing-dims spec applies to the *last* n dims; leading (stacked
# layer) dims are unsharded.
_RULES: list[tuple[str, Any]] = [
    # -- embeddings / heads ---------------------------------------------------
    (r"embed$", lambda D, M: P(M, D)),            # (V, d): vocab over model
    (r"lm_head$", lambda D, M: P(D, M)),          # (d, V): vocab over model
    (r"patch_proj$", lambda D, M: P(None, D)),    # (patch_dim, d)
    # -- MoE ------------------------------------------------------------------
    (r"router$", lambda D, M: P(D, None)),        # (d, E)
    (r"experts/w(1|3)$", lambda D, M: P(M, D, None)),  # (E, d, fe): EP over model
    (r"experts/w2$", lambda D, M: P(M, None, D)),       # (E, fe, d)
    (r"shared/w(1|3)$", lambda D, M: P(D, M)),
    (r"shared/w2$", lambda D, M: P(M, D)),
    # -- attention ------------------------------------------------------------
    (r"(attn|xattn|shared_attn)/w(q|k|v)$", lambda D, M: P(D, M)),
    (r"(attn|xattn|shared_attn)/b(q|k|v)$", lambda D, M: P(M)),
    (r"(attn|xattn|shared_attn)/wo$", lambda D, M: P(M, D)),
    # -- mlp -------------------------------------------------------------------
    (r"mlp/w(1|3)$", lambda D, M: P(D, M)),
    (r"mlp/w2$", lambda D, M: P(M, D)),
    (r"mlp/b1$", lambda D, M: P(M)),
    # -- rwkv ------------------------------------------------------------------
    (r"wkv/w(r|k|v|g)$", lambda D, M: P(D, M)),
    (r"wkv/wo$", lambda D, M: P(M, D)),
    (r"wkv/(w_lora_a)$", lambda D, M: P(D, None)),
    (r"wkv/(w_lora_b)$", lambda D, M: P(None, M)),
    # -- mamba2 ----------------------------------------------------------------
    (r"ssm/w_in$", lambda D, M: P(D, M)),         # (d, 2*di + 2N + H)
    (r"ssm/w_out$", lambda D, M: P(M, D)),        # (di, d)
]


def spec_for_path(path: str, ndim: int, axes: MeshAxes) -> PartitionSpec:
    D, M = axes.data, axes.model
    for pat, fn in _RULES:
        if re.search(pat, path):
            spec = fn(D, M)
            pad = ndim - len(spec)
            if pad < 0:  # spec longer than the array's rank
                return P()
            return P(*([None] * pad), *spec)
    return P()  # norms, scales, small vectors: replicated


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn("a/b/0", leaf)`` over a tree of dicts, lists and tuples (the
    reference's ``tree_map_with_path`` and its path text)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _ndim(leaf) -> int:
    return leaf.ndim if hasattr(leaf, "ndim") else len(getattr(leaf, "shape", ()))


def param_specs(params_tree: Any, axes: MeshAxes) -> Any:
    """PartitionSpec tree matching ``params_tree``: the reference's pytree
    of anything with an ``ndim`` (``convert.params_like`` of a model, or
    numpy arrays)."""
    return _map_with_path(
        lambda path, leaf: spec_for_path(path, _ndim(leaf), axes), params_tree)


def param_shardings(params_tree: Any, mesh: Mesh, axes: MeshAxes) -> Any:
    return _map_with_path(lambda _, s: NamedSharding(mesh, s),
                          param_specs(params_tree, axes))


class ShardingCtx:
    """The mesh a model path runs on. ``data_index`` is set inside one
    data shard's body (the data-parallel train step), where the batch a
    layer sees is already that shard's block; ``gathered`` holds what a
    body's collective over the data axis reads from the other shards (the
    MoE routing statistics of the step's first pass)."""

    def __init__(self, mesh: Mesh, axes: MeshAxes | None = None):
        self.mesh = mesh
        self.axes = axes or MeshAxes.for_mesh(mesh)
        self.data_index: int | None = None
        self.gathering = False
        self.gathered: dict = {}

    @property
    def data_size(self) -> int:
        return self.axes.data_size(self.mesh)

    @property
    def model_size(self) -> int:
        return self.axes.model_size(self.mesh)

    def data_blocks(self, rows: int) -> int:
        """How many row blocks a batch of ``rows`` splits into: the data
        extent when it divides the rows (``sanitize_pspec``), else 1; 1
        inside a data shard's body."""
        if self.data_index is not None:
            return 1
        return self.data_size if rows % self.data_size == 0 else 1

    @contextlib.contextmanager
    def data_shard(self, index: int, gathering: bool = False):
        """Run the block inside data shard ``index``'s body."""
        prev = self.data_index, self.gathering
        self.data_index, self.gathering = index, gathering
        try:
            yield self
        finally:
            self.data_index, self.gathering = prev

    def resolve(self, spec: tuple) -> PartitionSpec:
        out = []
        for s in spec:
            if s == "data":
                out.append(self.axes.data if len(self.axes.data) > 1
                           else self.axes.data[0])
            elif s == "model":
                out.append(self.axes.model)
            else:
                out.append(s)
        return P(*out)


_CTX: ShardingCtx | None = None


@contextlib.contextmanager
def sharding_ctx(mesh: Mesh, axes: MeshAxes | None = None):
    global _CTX
    prev = _CTX
    _CTX = ShardingCtx(mesh, axes)
    try:
        yield _CTX
    finally:
        _CTX = prev


def current_ctx() -> ShardingCtx | None:
    return _CTX


def constrain(x, *spec):
    """The reference's symbolic sharding constraint: the spec is resolved
    and sanitized against ``x``'s shape, and ``x`` comes back unchanged
    (every shard is on one device; the values are the same)."""
    ctx = current_ctx()
    if ctx is not None:
        sanitize_pspec(ctx.resolve(spec), x.shape, ctx.mesh)
    return x


def sanitize_pspec(spec: PartitionSpec, shape, mesh: Mesh) -> PartitionSpec:
    """Drop sharding on dims the mesh axes do not divide evenly (as jit's
    in_shardings reject uneven partitions)."""
    out = []
    for d, entry in enumerate(spec):
        if entry is None or d >= len(shape):
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        ext = 1
        for nm in names:
            ext *= mesh.shape.get(nm, 1)
        out.append(entry if ext and shape[d] % ext == 0 else None)
    return P(*out)


def sanitize_spec_tree(spec_tree, abstract_tree, mesh: Mesh):
    """``sanitize_pspec`` over matching (specs, shaped leaves) trees."""
    if isinstance(spec_tree, PartitionSpec):
        return sanitize_pspec(spec_tree, abstract_tree.shape, mesh)
    if isinstance(spec_tree, dict):
        return {k: sanitize_spec_tree(v, abstract_tree[k], mesh)
                for k, v in spec_tree.items()}
    return type(spec_tree)(sanitize_spec_tree(s, a, mesh)
                           for s, a in zip(spec_tree, abstract_tree))

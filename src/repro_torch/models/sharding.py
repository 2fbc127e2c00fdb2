"""Sharding rules, the model mesh and weight placement (port of
``repro.models.sharding``).

The rule table assigns each parameter a PartitionSpec by its path in the
reference's pytree (``attn/wq``, ``experts/w1``, ...), so one table serves
both packages: the port's modules name their parameters as the reference
names its keys, and ``convert.params_like`` lays a model out as that
pytree (stacked layers on a leading axis, which stays unsharded).

A model path runs under ``sharding_ctx(mesh)``, over either kind of mesh
of ``launch/mesh.py``.

**The one-process mesh** (``Mesh``: ``data x model`` shards, every one on
ONE device). Nothing is placed: work that is local to a shard runs shard
by shard and is merged with the list-of-partials collectives of
``engine/distributed.py`` (``psum``, ``pmax``, ``pmean``) in shard order.

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

* Dense tensor parallelism is not simulated: ``constrain(x, *spec)``
  resolves and sanitizes the spec and returns ``x`` unchanged, and every
  GEMM runs whole.

**The rank mesh** (``RankMesh``: one ``torch.distributed`` process a
rank). :func:`place_params` keeps on each rank only its shard of every
weight the table shards, sliced from the whole tensor by the sanitized
spec (a plain local tensor; ``Placement`` records the global shape and
which dims are split):

* FSDP over the data axes: a weight's data dim is all-gathered where it
  is used (:func:`weight`, an autograd op whose backward reduce-scatters
  the gradient in the parameter's dtype), inside the checkpointed block,
  so a remat recomputation gathers again and no gathered weight outlives
  its block. The table's data dim is kept (not FSDP2's dim 0): storage
  differs, values do not. A weight the data axes do not split has its
  gradient all-reduced over them after the backward
  (:func:`reduce_grads`).
* TP over ``model``, every family: ``attn|xattn|shared_attn/wq|wk|wv``,
  ``mlp/w1|w3``, ``shared/w1|w3``, ``wkv/wr|wk|wv|wg|w_lora_b`` are
  column-parallel (output dim split: this rank's heads), ``*/wo``,
  ``mlp/w2``, ``shared/w2`` and ``ssm/w_out`` row-parallel (input dim
  split, the output ``psum``-ed over ``model``), ``embed`` and
  ``lm_head`` vocab-parallel (a masked lookup and a vocab-parallel cross
  entropy or an all-gather of the logits). ``ssm/w_in`` is stored as the
  table cuts it (contiguous column blocks, which do not line up with the
  heads) and all-gathered over ``model`` where it is used
  (:func:`model_gathered`, the backward a reduce-scatter), each rank then
  taking its heads' columns and the shared B and C ones. Activations
  stay whole (replicated over ``model``): :func:`tp_enter` marks where
  one enters a rank's partial work (identity forward, ``psum`` of the
  gradient) and :func:`tp_merge` where the partials meet (``psum``
  forward, identity backward); :func:`model_sum` sums a per-rank partial
  statistic (``psum`` both ways). A whole parameter a rank uses a slice
  of (a per-head norm, a bonus, a conv's channels) is sliced after
  :func:`tp_enter`, so its gradient sums over ``model``. The hand kernels
  see only local, contiguous tensors: this rank's heads. Where ``model``
  does not divide a family's heads (attention: the heads or the KV heads;
  rwkv's and the SSD's heads) those weights stay whole over it, as
  ``sanitize_pspec`` keeps an extent it does not divide.
* Experts over ``model``: rank ``r`` stores experts
  ``[r*E/M, (r+1)*E/M)`` and dispatches to them alone.

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

import torch

from repro_torch.engine import distributed as D
from repro_torch.launch.mesh import Mesh, MeshAxes, RankMesh


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
    """A spec over a mesh: on the one-process mesh the tensor lives on its
    one device; on a rank mesh each rank holds its block (``placements``,
    the DTensor placements of the spec)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def device(self):
        return self.mesh.device

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh axis: ``Shard(d)`` where dim d's
        entry names the axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for ax in self.mesh.axis_names:
            dims = [d for d, e in enumerate(self.spec)
                    if e == ax or (isinstance(e, tuple) and ax in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


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

    def __init__(self, mesh, axes: MeshAxes | None = None):
        self.mesh = mesh
        self.axes = axes or MeshAxes.for_mesh(mesh)
        self.data_index: int | None = None
        self.gathering = False
        self.gathered: dict = {}
        # a rank mesh's layers see this data rank's block of the batch
        # (False: the whole batch on every rank, one it did not divide)
        self.batch_split = True

    @property
    def ranked(self) -> bool:
        """A mesh of ``torch.distributed`` ranks (this process one)."""
        return isinstance(self.mesh, RankMesh)

    def group(self, axis: str):
        """A rank mesh's process group over "data" (the data axes),
        "model", or "all" (every rank)."""
        if axis == "data":
            return self.mesh.group(self.axes.data)
        if axis == "model":
            return self.mesh.group(self.axes.model)
        import torch.distributed as dist
        return dist.group.WORLD

    @property
    def data_rank(self) -> int:
        """This rank's index over the data axes (a rank mesh)."""
        return self.mesh.index(self.axes.data)

    @property
    def model_rank(self) -> int:
        return self.mesh.coords.get(self.axes.model, 0)

    @property
    def data_size(self) -> int:
        return self.axes.data_size(self.mesh)

    @property
    def model_size(self) -> int:
        return self.axes.model_size(self.mesh)

    def split(self, rows: int) -> int:
        """How many row blocks a batch of ``rows`` splits into over the
        data axes: their extent when it divides the rows
        (``sanitize_pspec``), else 1."""
        return self.data_size if rows % self.data_size == 0 else 1

    def data_blocks(self, rows: int) -> int:
        """The row blocks a layer splits its batch into: :meth:`split`;
        1 inside a data shard's body and on a rank mesh, where the batch
        is already this shard's."""
        if self.data_index is not None or self.ranked:
            return 1
        return self.split(rows)

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
    (the one-process mesh's shards share one device; a rank mesh's
    activations are local tensors). A DTensor is redistributed to the
    resolved spec."""
    ctx = current_ctx()
    if ctx is not None:
        resolved = sanitize_pspec(ctx.resolve(spec), x.shape, ctx.mesh)
        if ctx.ranked and type(x).__name__ == "DTensor":
            return x.redistribute(ctx.mesh.device_mesh,
                                  NamedSharding(ctx.mesh, resolved).placements)
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


# -- placement on a rank mesh --------------------------------------------------------

_ATTN_PROJ = re.compile(r"(attn|xattn|shared_attn)/[wb](q|k|v|o)$")
_WKV = re.compile(r"wkv/")
_SSM = re.compile(r"ssm/")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a placed parameter's local tensor sits in its whole one:
    ``spec`` (sanitized, over the mesh's axes), the whole ``shape``, and
    the dims split over the data axes and over ``model`` (``None``:
    whole over them)."""

    spec: PartitionSpec
    shape: tuple
    data_dim: int | None
    model_dim: int | None


def _head_counts(path: str, cfg) -> tuple[int, ...]:
    """The head counts a parameter's split over ``model`` must follow:
    the heads and the KV heads of an attention projection, rwkv's heads
    of a ``wkv`` weight, the SSD's heads of an ``ssm`` one; () for the
    rest."""
    if _ATTN_PROJ.search(path):
        return cfg.n_heads, cfg.n_kv_heads
    if _WKV.search(path):
        return (cfg.d_model // cfg.rwkv_head_dim,)
    if _SSM.search(path):
        return (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,)
    return ()


def rank_spec(path: str, shape, mesh, axes: MeshAxes, cfg) -> PartitionSpec:
    """The spec a rank mesh places parameter ``path`` (the reference's
    pytree path) of ``shape`` with: the table's, sanitized, and whole over
    ``model`` where ``model`` does not divide every count of
    :func:`_head_counts` (a rank's block must hold whole heads)."""
    spec = sanitize_pspec(spec_for_path(path, len(shape), axes), shape, mesh)
    M = axes.model_size(mesh)
    if any(n % M for n in _head_counts(path, cfg)):
        spec = P(*(None if e == axes.model else e for e in spec))
    return spec


def local_heads(*counts: int) -> int:
    """``counts[0]`` over the model extent M under a rank mesh's context
    where M divides every count (a rank holds its share of the heads, as
    :func:`rank_spec` places them), else ``counts[0]``: the heads a
    rank's cache holds."""
    ctx = _CTX
    if ctx is None or not ctx.ranked:
        return counts[0]
    M = ctx.model_size
    return counts[0] if any(n % M for n in counts) else counts[0] // M


def _placement(spec: PartitionSpec, shape, axes: MeshAxes) -> Placement:
    D_ = axes.data if len(axes.data) > 1 else axes.data[0]
    data_dim = next((d for d, e in enumerate(spec) if e == D_), None)
    model_dim = next((d for d, e in enumerate(spec) if e == axes.model), None)
    return Placement(spec, tuple(shape), data_dim, model_dim)


def local_slice(full: torch.Tensor, spec: PartitionSpec,
                mesh: RankMesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view): each split
    dim narrowed to the rank's index along its axes."""
    out = full
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        ext = mesh.extent(entry)
        n = full.shape[d] // ext
        out = out.narrow(d, mesh.index(entry) * n, n)
    return out


def placements(model) -> dict:
    """``{parameter name: Placement}`` of a placed model (empty when it
    was never placed)."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, pl in mod.__dict__.get("_placed", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = pl
    return out


@torch.no_grad()
def place_params(model, cfg, mesh: RankMesh, axes: MeshAxes | None = None):
    """Keep on this rank only its block of every parameter (in place:
    each ``nn.Parameter`` keeps its identity and takes its block's data,
    contiguous), by :func:`rank_spec` over the reference's path of the
    parameter (``convert.reference_paths``). Every rank must hold the
    same whole weights before (the same seed, or the reference's numpy
    through ``convert.from_jax``). Build the optimizer state after.
    Returns the model."""
    from repro_torch.models.convert import reference_paths

    if not isinstance(mesh, RankMesh):
        raise ValueError(f"place_params places on a RankMesh, not {mesh!r}: "
                         "the one-process mesh holds every weight whole")
    axes = axes or MeshAxes.for_mesh(mesh)
    paths = reference_paths(model)
    for prefix, mod in model.named_modules():
        placed = dict(mod.__dict__.get("_placed", {}))
        for name, p in mod._parameters.items():
            if p is None:
                continue
            if name in placed:
                raise ValueError(f"{prefix}.{name} is placed already")
            full = f"{prefix}.{name}" if prefix else name
            spec = rank_spec(paths[full], tuple(p.shape), mesh, axes, cfg)
            placed[name] = _placement(spec, p.shape, axes)
            p.data = local_slice(p.data, spec, mesh).contiguous().clone()
        if placed:
            mod._placed = placed
    return model


def _placed(mod, name: str) -> Placement | None:
    """The placement of ``mod.name`` when it is to be gathered here: a
    placed parameter under a rank mesh's context."""
    ctx = _CTX
    if ctx is None or not ctx.ranked:
        return None
    return mod.__dict__.get("_placed", {}).get(name)


class _Gather(torch.autograd.Function):
    """A block, cast to ``dtype``, all-gathered over ``group`` along
    ``dim``; the backward reduce-scatters the gradient in the block's own
    dtype (a float32 parameter's gradient is summed across ranks in
    float32)."""

    @staticmethod
    def forward(ctx, t, dim, group, dtype):
        ctx.dim, ctx.group, ctx.dtype = dim, group, t.dtype
        return D.all_gather(t.detach().to(dtype), group=group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return D.reduce_scatter(g.to(ctx.dtype), ctx.group, ctx.dim), \
            None, None, None


def weight(mod, name: str, dtype=None) -> torch.Tensor:
    """``mod.name`` as the layer computes with it, cast to ``dtype``: on a
    rank mesh a placed weight's data dim all-gathered (its model dim
    stays this rank's block; a data extent of 1 holds it whole already),
    elsewhere the parameter itself."""
    t = getattr(mod, name)
    pl = _placed(mod, name)
    if pl is None or pl.data_dim is None or _CTX.data_size == 1:
        return t if dtype is None else t.to(dtype)
    return _Gather.apply(t, pl.data_dim, _CTX.group("data"), dtype or t.dtype)


def model_gathered(mod, name: str, dtype=None) -> torch.Tensor:
    """:func:`weight`, then all-gathered over ``model`` along its model
    dim where this rank holds only its block: the whole weight, for a
    layer whose rank takes columns the table's contiguous blocks do not
    line up with (``ssm/w_in``). The backward reduce-scatters the
    gradient over ``model``, so a column every rank reads gets the sum of
    their parts."""
    w = weight(mod, name, dtype)
    pl = _placed(mod, name)
    if pl is None or pl.model_dim is None:
        return w
    return _Gather.apply(w, pl.model_dim, _CTX.group("model"), w.dtype)


def model_split(mod, name: str) -> bool:
    """Whether this rank holds only its ``model`` block of ``mod.name``
    (column-, row- or vocab-parallel here)."""
    pl = _placed(mod, name)
    return pl is not None and pl.model_dim is not None


def model_offset(mod, name: str) -> int:
    """The first index of this rank's ``model`` block of ``mod.name``
    along its split dim (the vocab offset of a vocab-parallel weight)."""
    t = getattr(mod, name)
    pl = _placed(mod, name)
    return _CTX.model_rank * t.shape[pl.model_dim]


def vocab_offset(mod, name: str) -> int | None:
    """The vocab offset of this rank's block of ``mod.name`` on a rank
    mesh that splits it over model (vocab-parallel), else None."""
    return model_offset(mod, name) if model_split(mod, name) else None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return D.psum(g, group=ctx.group), None


class _Merge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return D.psum(x, group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return D.psum(x, group=group)

    @staticmethod
    def backward(ctx, g):
        return D.psum(g, group=ctx.group), None


class _MeanData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return D.pmean(x, group=group)

    @staticmethod
    def backward(ctx, g):
        return D.pmean(g, group=ctx.group), None


def data_pmean(x: torch.Tensor) -> torch.Tensor:
    """``pmean`` over the data axes, differentiable: each data rank's loss
    is its share of the global batch's, so the gradient of the mean is
    the mean of the ranks' gradients."""
    return _MeanData.apply(x, _CTX.group("data"))


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """A whole activation entering this rank's partial work over
    ``model``: the same values; its gradient is the ``psum`` of the
    ranks' partial gradients."""
    return _Enter.apply(x, _CTX.group("model"))


def tp_merge(x: torch.Tensor) -> torch.Tensor:
    """The ranks' partials over ``model`` summed into the whole value
    (``psum``); the gradient, the same on every rank, passes through."""
    return _Merge.apply(x, _CTX.group("model"))


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """A per-rank partial statistic summed over ``model`` (``psum``), for
    a value every rank then feeds into its own partial work (the gated
    norm's sum of squares over a rank's channels): its gradient on each
    rank holds only that rank's part, so the backward sums over ``model``
    too."""
    return _Sum.apply(x, _CTX.group("model"))


def rank_slice(t: torch.Tensor, *spans: tuple[int, int]) -> torch.Tensor:
    """The ``(start, length)`` spans of dim 0 of a whole tensor that this
    rank's partial work reads (its heads' rows of a norm scale, a bonus, a
    conv's channels), concatenated after :func:`tp_enter`: each rank's
    gradient fills only its spans, and the ``psum`` gives the whole
    tensor's."""
    t = tp_enter(t)
    parts = [t.narrow(0, a, n) for a, n in spans]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


@torch.no_grad()
def reduce_grads(model) -> None:
    """After a rank mesh's backward: every gradient of a parameter the data
    axes do not split is all-reduced (summed) over them (nothing to sum
    over one data rank); the split ones were reduce-scattered by
    :func:`weight`'s backward."""
    ctx = _CTX
    if ctx is None or not ctx.ranked or ctx.data_size == 1:
        return
    g = ctx.group("data")
    for mod in model.modules():
        placed = mod.__dict__.get("_placed", {})
        for name, p in mod._parameters.items():
            if p is None or p.grad is None:
                continue
            pl = placed.get(name)
            if pl is None or pl.data_dim is None:
                p.grad = D.psum(p.grad, group=g)


def spread(model) -> dict:
    """``{parameter name: "all" | "data" | "model" | None}``: over which
    axes a placed parameter's blocks are distinct (None: whole, the same
    on every rank); what a norm over every rank sums once."""
    out = {}
    for name, pl in placements(model).items():
        d, m = pl.data_dim is not None, pl.model_dim is not None
        out[name] = "all" if d and m else "data" if d else "model" if m else None
    return out


@torch.no_grad()
def full_tensor(t: torch.Tensor, pl: Placement, mesh: RankMesh,
                axes: MeshAxes) -> torch.Tensor:
    """The whole tensor of a placed block ``t`` (a parameter or a moment
    laid out as it): all-gathered over ``model`` and then the data axes
    along their dims."""
    if pl.model_dim is not None:
        t = D.all_gather(t, group=mesh.group(axes.model), dim=pl.model_dim)
    if pl.data_dim is not None:
        t = D.all_gather(t, group=mesh.group(axes.data), dim=pl.data_dim)
    return t


def whole_state(model, opt_state: dict, mesh: RankMesh) -> tuple[dict, dict]:
    """A placed model's parameters and AdamW state, whole (every rank
    gathers them; a checkpoint's rank 0 writes them): ``({name: tensor},
    {"m": ..., "v": ..., "step": ...})``."""
    axes = MeshAxes.for_mesh(mesh)
    pls = placements(model)

    def whole(n, t):
        return full_tensor(t.detach(), pls[n], mesh, axes) if n in pls else t

    params = {n: whole(n, p) for n, p in model.named_parameters()}
    return params, {"m": {n: whole(n, t) for n, t in opt_state["m"].items()},
                    "v": {n: whole(n, t) for n, t in opt_state["v"].items()},
                    "step": opt_state["step"]}


def whole_like(model, opt_state: dict) -> tuple[dict, dict]:
    """Empty host tensors of :func:`whole_state`'s shapes and dtypes: what
    a restore reads the whole state into."""
    pls = placements(model)

    def empty(n, t):
        shape = pls[n].shape if n in pls else t.shape
        return torch.empty(shape, dtype=t.dtype)

    return ({n: empty(n, p) for n, p in model.named_parameters()},
            {"m": {n: empty(n, t) for n, t in opt_state["m"].items()},
             "v": {n: empty(n, t) for n, t in opt_state["v"].items()},
             "step": torch.empty((), dtype=opt_state["step"].dtype)})


@torch.no_grad()
def load_blocks(model, opt_state: dict, params: dict, opt: dict,
                mesh: RankMesh) -> None:
    """Write this rank's blocks of the whole ``params`` and ``opt`` (as
    :func:`whole_state` lays them out) into the placed model and its AdamW
    state."""
    pls = placements(model)
    for n, p in model.named_parameters():
        spec = pls[n].spec if n in pls else P()
        p.copy_(local_slice(params[n], spec, mesh))
        opt_state["m"][n].copy_(local_slice(opt["m"][n], spec, mesh))
        opt_state["v"][n].copy_(local_slice(opt["v"][n], spec, mesh))
    opt_state["step"].copy_(opt["step"])

"""Cost model over the ops a step dispatches (counterpart of
``repro.launch.hlocost``).

The reference walks the compiled, SPMD-partitioned HLO text of a step and
multiplies ``while`` bodies by their trip counts, because XLA's own cost
analysis counts a loop body once. The port has no HLO and no partitioner:
eager PyTorch runs every layer and every loop iteration as its own ops,
so no trip count is needed, and the ops themselves are what the device
executes. :class:`CostModel` is a ``TorchDispatchMode`` that sees each
ATen op a step dispatches (on the card, on the CPU or on "meta", where
nothing is computed) and counts it by the reference's rules
(``HloCostModel._add_op``):

  * flops — 2·M·N·K for matmuls (mm, bmm, addmm, baddbmm, convolution:
    ``torch.utils.flop_counter``'s registered formulas), 1 a result
    element for elementwise arithmetic (dtype conversions included),
    1 an operand element for reductions, sort, scatter, gather and cumsum;
  * bytes — operand plus result bytes of every op: eager PyTorch fuses
    nothing, so each op reads its operands from device memory and writes
    its result there. Views, ``empty`` and metadata ops move nothing
    (the reference's ``ZERO_BYTES``); an in-place indexed write (index_copy_,
    index_put_, index_add_, scatter_) moves its update and the region it
    writes, not the whole tensor (the reference's dynamic-update-slice);
  * the hand kernels by their kernel module's cost (``flash_mha_fwd_cost``,
    ``flash_attention_bwd_cost``, ``flash_decode_cost``), charged by
    ``kernels/ops.py`` in place of what the wrapper dispatches (a ctypes
    launch on the card is invisible to the dispatcher);
  * collectives as ``engine/distributed.py`` reports them: per kind the
    count, the bytes one device of a call's group receives (``bytes``,
    summed over the calls) and what the whole group receives
    (``mesh_bytes``: times the call's parts); as HBM traffic each part
    read and each result written once per device of the group. Times the
    reference's ring wire multipliers, ``wire_bytes_per_device`` is what
    a device that takes part in every call sends (the reference's figure
    where a step runs one group, as a meshless step or the data-parallel
    step's gradient sums do), ``mesh_wire_bytes`` what all the groups'
    devices send together.

It also follows the step's peak of live bytes: every storage an op
creates is added when it appears and taken off by its finalizer. Tensors
that exist before the step (its arguments) are not included.

Only ops that touch a tensor on the model's ``device`` are counted, so a
host-side copy that one device's path makes and another's does not (the
CUDA RNG state a checkpointed block saves) stays out of the totals; nor
are copies between devices (a constant built on the host and moved to
the device, which the CPU's path never copies): they cross the host's
link, not the device's memory.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.runtime import costs

aten = torch.ops.aten

# wire-byte multiplier per collective kind (ring algorithms): an all-reduce
# is a reduce-scatter plus an all-gather (the reference's hlocost.py:56-58)
WIRE_MULT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0, "collective-permute": 1.0,
             "ragged-all-to-all": 1.0}

ZERO_BYTES = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
              aten.new_empty_strided, aten._unsafe_view, aten.detach,
              aten.alias, aten.lift_fresh, aten._local_scalar_dense,
              aten.sym_size, aten.sym_stride, aten.sym_numel,
              aten.sym_storage_offset, aten.resize_, aten.set_}
REDUCTIONS = {aten.sort, aten.argsort, aten.topk, aten.scatter, aten.scatter_,
              aten.scatter_add, aten.scatter_add_, aten.scatter_reduce,
              aten.gather, aten.index_add, aten.index_add_, aten.index_put,
              aten.index_put_, aten.cumsum, aten.cumprod, aten.searchsorted,
              aten._softmax, aten._log_softmax, aten._softmax_backward_data,
              aten._log_softmax_backward_data, aten.embedding_dense_backward,
              aten._foreach_norm}
# in-place indexed writes: (read the update and the indices, write the
# region) — the reference's dynamic-update-slice rule
REGION_WRITES = {aten.index_copy_, aten.index_put_, aten.index_add_,
                 aten.scatter_, aten.scatter_add_}
CONVERSIONS = {aten._to_copy, aten.copy_}
COPIES = {aten.clone}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    """The tensors of an op's arguments or results: tensors, and lists or
    tuples of them (foreach and cat operands, index lists) one level down."""
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    if isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


_KINDS: dict = {}


def _kind(func) -> tuple[str, bool]:
    """How an op is counted, and whether its result aliases an operand
    (a view or an in-place op: no new storage)."""
    if func not in _KINDS:
        packet = func._overloadpacket
        if func.is_view or packet in ZERO_BYTES:
            kind = "zero"
        elif packet in REGION_WRITES:
            kind = "region"
        elif packet in flop_registry:
            kind = "matmul"
        elif packet in REDUCTIONS or torch.Tag.reduction in func.tags:
            kind = "reduce"
        elif packet in CONVERSIONS:
            kind = "convert"
        elif (torch.Tag.pointwise in func.tags and packet not in COPIES) \
                or packet.__name__.startswith("_foreach_"):
            kind = "elementwise"
        else:
            kind = "move"
        _KINDS[func] = (kind, any(r.alias_info is not None
                                  for r in func._schema.returns))
    return _KINDS[func]


class CostModel(TorchDispatchMode):
    """Counts what the ops dispatched inside ``with CostModel(device):``
    cost; :meth:`totals` gives the reference's ``analyze`` dict."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device).type
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.bytes = 0.0
        self.coll: dict = {}
        self.kernels: dict = {}
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._opaque = 0

    # -- the hooks of runtime/costs.py ------------------------------------------
    def __enter__(self):
        costs.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        costs.COUNTERS.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def opaque(self):
        """Ops dispatched inside the block are not counted (a kernel call
        or a collective, charged as a whole)."""
        self._opaque += 1
        try:
            yield
        finally:
            self._opaque -= 1

    def kernel(self, name: str, cost: dict, out) -> None:
        """A hand kernel's call: its ``cost`` charged, its outputs live."""
        if self._opaque:
            return
        rec = self.kernels.setdefault(name, {"count": 0, "flops": 0.0,
                                             "bytes": 0.0})
        rec["count"] += 1
        rec["flops"] += cost["flops"]
        rec["bytes"] += cost["bytes"]
        self.flops += cost["flops"]
        self.bytes += cost["bytes"]
        self._track(_tensors(out))

    def collective(self, kind: str, parts: int, read: int, received: int,
                   out) -> None:
        """One collective over ``parts`` devices, each reading ``read``
        bytes of its part and receiving ``received``."""
        if self._opaque:
            return
        rec = self.coll.setdefault(kind, {"count": 0, "bytes": 0,
                                          "mesh_bytes": 0})
        rec["count"] += 1
        rec["bytes"] += received
        rec["mesh_bytes"] += parts * received
        self.bytes += parts * (read + received)
        self._track(_tensors(out))

    # -- the ops ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._opaque:
            return out
        kind, aliasing = _kind(func)
        ins = _tensors(args)
        ins += [v for k, v in kwargs.items()
                if k != "out" and isinstance(v, torch.Tensor)]
        outs = _tensors(out)
        if not any(t.device.type == self.device for t in ins + outs) \
                or (kind == "convert" and ins[-1].device != outs[0].device):
            return out
        self._count(kind, func, args, kwargs, ins, outs, out)
        if not aliasing:
            self._track(outs)
        return out

    def _count(self, kind, func, args, kwargs, ins, outs, out) -> None:
        if kind == "zero":
            return
        if kind == "region":
            # the indices and the update read, the update's region written
            self.bytes += sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[-1])
            if func._overloadpacket in REDUCTIONS:
                self.flops += ins[-1].numel()
            return
        if kind == "matmul":
            f = flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
            self.flops += f
            self.matmul_flops += f
        elif kind == "reduce":
            self.flops += sum(t.numel() for t in ins)
        elif kind == "convert":
            # the source is the last operand (copy_(self, src)); a change
            # of dtype is the reference's elementwise "convert"
            if ins[-1].dtype != outs[0].dtype:
                self.flops += outs[0].numel()
        elif kind == "elementwise":
            # an in-place foreach op returns nothing: its results are its
            # first operand
            self.flops += sum(t.numel() for t in (outs or _tensors(args[0])))
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

    # -- live bytes -------------------------------------------------------------
    def _track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def totals(self) -> dict:
        def wire(key):
            return sum(WIRE_MULT.get(k, 1.0) * v[key] for k, v in self.coll.items())

        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collectives": {
                "by_kind": {k: dict(v) for k, v in sorted(self.coll.items())},
                "wire_bytes_per_device": wire("bytes"),
                "mesh_wire_bytes": wire("mesh_bytes"),
            },
            "matmul_flops": self.matmul_flops,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "peak_bytes": self.peak,
        }


def analyze(fn, *args, device, **kwargs) -> tuple[dict, object]:
    """``fn(*args, **kwargs)`` under a :class:`CostModel` of ``device``:
    (its totals, fn's result)."""
    with CostModel(device) as model:
        result = fn(*args, **kwargs)
    return model.totals(), result

"""Nested containers of tensors as the reference's pytrees, without JAX:
the flatten, unflatten and map of ``jax.tree_util`` that
``runtime/checkpoint.py`` and ``runtime/compress.py`` need, under its rules.

* A dict's children come in sorted key order, so ``{"params", "opt"}``
  flattens ``opt`` (``m``, ``step``, ``v``) before ``params``; a list's and
  a tuple's in order.
* ``None`` and an empty container are nodes with no leaf.
* Anything else (a tensor, a numpy array, a number) is one leaf.

The leaf order is what makes a checkpoint of either package restore in the
other: ``leaf_<i>.npy`` is the i-th leaf of this order in both.
"""
from __future__ import annotations

from typing import Any, Callable


class TreeDef:
    """The structure of a tree with its leaves taken out. ``str`` gives the
    reference's ``PyTreeDef(...)`` text for the same structure."""

    def __init__(self, node):
        self._node = node   # the tree with every leaf replaced by _LEAF

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and _same(self._node, other._node)

    def __str__(self) -> str:
        return f"PyTreeDef({_text(self._node)})"

    __repr__ = __str__

    @property
    def num_leaves(self) -> int:
        return len(flatten(self._node)[0])


class _Leaf:
    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


# The walks below are module functions taking their accumulator: a
# recursive closure would sit in a reference cycle holding the leaves, and
# a train state's leaves (gigabytes) would then live until the cyclic
# collector runs.

def _walk(x, leaves: list):
    if not _is_node(x):
        leaves.append(x)
        return _LEAF
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _walk(x[k], leaves) for k in sorted(x)}
    return type(x)(_walk(v, leaves) for v in x)


def _build(x, it):
    if x is _LEAF:
        return next(it)
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _build(v, it) for k, v in x.items()}
    return type(x)(_build(v, it) for v in x)


def flatten(tree: Any) -> tuple[list, TreeDef]:
    """(leaves in the reference's order, structure)."""
    leaves: list = []
    node = _walk(tree, leaves)
    return leaves, TreeDef(node)


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef``'s structure holding ``leaves`` in order;
    raises ``ValueError`` when their count differs from its leaves'."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"{treedef} holds {treedef.num_leaves} leaves, "
                         f"{len(leaves)} given")
    return _build(treedef._node, iter(leaves))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``,
    which must have the same structure (``ValueError`` otherwise)."""
    leaves, treedef = flatten(tree)
    others = []
    for other in rest:
        ol, od = flatten(other)
        if od != treedef:
            raise ValueError(f"tree structures differ: {od} != {treedef}")
        others.append(ol)
    return unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def _same(a, b) -> bool:
    if a is _LEAF or b is _LEAF or a is None or b is None:
        return a is b
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _text(x) -> str:
    if x is _LEAF:
        return "*"
    if x is None:
        return "None"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k!r}: {_text(v)}" for k, v in x.items()) + "}"
    body = ", ".join(_text(v) for v in x)
    if isinstance(x, tuple):
        return f"({body},)" if len(x) == 1 else f"({body})"
    return f"[{body}]"

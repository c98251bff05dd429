"""Nested containers of tensors ("pytrees"), walked in JAX's order.

The reference's optimizer, checkpoints and trainer are generic over JAX
pytrees through ``jax.tree_util``. The port's counterparts walk the same
containers in the same order, so that a checkpoint's leaf files line up
between the two packages:

- a dict's values in sorted key order;
- a list's or a tuple's items in order;
- a NamedTuple's fields in order (``OptState``, ``ErrorFeedbackState``);
- ``None`` is an empty node: it holds no leaf.

Anything else (a tensor, a numpy array, a Python number) is a leaf.
``str(treedef)`` renders as JAX's ``PyTreeDef`` does.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


class TreeDef:
    """The structure of a pytree without its leaves."""

    __slots__ = ("kind", "meta", "children", "num_leaves")

    def __init__(self, kind: str, meta, children: tuple):
        self.kind = kind  # "leaf", "none", "dict", "list", "tuple", "namedtuple"
        self.meta = meta  # dict: sorted keys; namedtuple: its type
        self.children = children
        self.num_leaves = 1 if kind == "leaf" else sum(c.num_leaves for c in children)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.meta == other.meta and self.children == other.children)

    def __hash__(self) -> int:
        return hash((self.kind, self.meta, self.children))

    def unflatten(self, leaves) -> Any:
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError(f"too many leaves for {self}")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            leaf = next(it, _END)
            if leaf is _END:
                raise ValueError(f"too few leaves for {self}")
            return leaf
        if self.kind == "none":
            return None
        items = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.meta, items))
        if self.kind == "list":
            return items
        if self.kind == "namedtuple":
            return self.meta(*items)
        return tuple(items)

    def flatten_up_to(self, tree) -> list:
        """The subtrees of ``tree`` that sit where this structure has its
        leaves (``tree`` must have this structure down to them)."""
        out: list = []
        self._up_to(tree, out)
        return out

    def _up_to(self, node, out: list) -> None:
        if self.kind == "leaf":
            out.append(node)
            return
        kind, meta, children = _node(node)
        if kind != self.kind or meta != self.meta or len(children) != len(self.children):
            raise ValueError(f"tree structure {kind} {meta!r} does not match {self}")
        for c, child in zip(self.children, children):
            c._up_to(child, out)

    def __str__(self) -> str:
        return f"PyTreeDef({self._render()})"

    __repr__ = __str__

    def _render(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        parts = [c._render() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {p}" for k, p in zip(self.meta, parts)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(parts) + "]"
        if self.kind == "namedtuple":
            return f"CustomNode(namedtuple[{self.meta.__name__}], [{', '.join(parts)}])"
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"


_END = object()


def _node(node) -> tuple:
    """(kind, meta, children) of one level of ``node``."""
    if node is None:
        return "none", None, ()
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return "dict", keys, tuple(node[k] for k in keys)
    if _is_namedtuple(node):
        return "namedtuple", type(node), tuple(node)
    if isinstance(node, tuple):
        return "tuple", None, node
    if isinstance(node, list):
        return "list", None, tuple(node)
    return "leaf", None, ()


def _walk(node, leaves: list) -> TreeDef:
    """``node``'s structure, its leaves appended to ``leaves``. A module
    function: a recursive closure would form a reference cycle through
    its own cell and keep ``leaves`` (the tensors) alive until the next
    garbage collection."""
    kind, meta, children = _node(node)
    if kind == "leaf":
        leaves.append(node)
        return _LEAF
    return TreeDef(kind, meta, tuple(_walk(c, leaves) for c in children))


def tree_flatten(tree) -> tuple:
    """``(leaves, treedef)`` of ``tree``, the leaves in JAX's order."""
    leaves: list = []
    treedef = _walk(tree, leaves)
    return leaves, treedef


_LEAF = TreeDef("leaf", None, ())


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    return treedef.unflatten(leaves)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching subtrees of
    each of ``rest``), rebuilt in ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten([fn(*args) for args in zip(leaves, *others)])

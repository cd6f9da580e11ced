"""The pytree helpers the optimizers need, in place of ``jax.tree_util``.

A tree is nested ``dict``/``list``/``tuple`` (plain tuples; ``None`` is a
node with no children, as in JAX). Everything else is a leaf: tensors,
numbers, :class:`~repro_torch.core.symmetric.SymmetricMatrix`,
:class:`~repro_torch.solve.cholesky.CholeskyFactor` and named tuples such
as ``PowerSGDState``. Two rules follow the reference, because the
optimizers' state and their choice of leaves depend on them:

* dicts flatten in **sorted key order**, as JAX flattens them, so leaf
  order (and the order of the optimizer state) matches the reference's;
* key paths read as JAX's ``keystr`` gives them (``"['layers']['attn']
  ['wq']"``, ``"[0]"`` for a sequence index): ``shampoo._use_shampoo``
  matches substrings of them.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["TreeDef", "tree_flatten_with_path", "tree_flatten", "tree_leaves", "tree_map"]


def _children(x):
    """``(keys, children)`` of a node; keys are the keystr pieces."""
    if x is None:
        return [], []
    if isinstance(x, dict):
        keys = sorted(x)
        return [f"[{k!r}]" for k in keys], [x[k] for k in keys]
    return [f"[{i}]" for i in range(len(x))], list(x)


class TreeDef:
    """The structure of a flattened tree: node kinds and dict keys, with a
    slot for each leaf."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind, keys=(), children=()):
        self.kind = kind            # "leaf", "none", "dict", "list" or "tuple"
        self.keys = tuple(keys)     # dict keys in sorted order
        self.children = tuple(children)

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def unflatten(self, leaves):
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError(f"too many leaves for a tree of {self.num_leaves}")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            leaf = next(it, _END)
            if leaf is _END:
                raise ValueError(f"too few leaves for a tree of {self.num_leaves}")
            return leaf
        if self.kind == "none":
            return None
        vals = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, vals))
        return vals if self.kind == "list" else tuple(vals)

    def flatten_up_to(self, tree) -> List[Any]:
        """The subtrees of ``tree`` at this structure's leaf slots
        (``jax.tree_util.PyTreeDef.flatten_up_to``); ``tree`` must have this
        structure down to them."""
        out: list = []
        self._up_to(tree, out)
        return out

    def _up_to(self, x, out):
        if self.kind == "leaf":
            out.append(x)
            return
        kind = _kind(x)
        if kind != self.kind:
            raise ValueError(f"tree node {kind} where the structure has {self.kind}")
        if kind == "dict" and tuple(sorted(x)) != self.keys:
            raise ValueError(f"dict keys {sorted(x)} != {list(self.keys)}")
        _, kids = _children(x)
        if len(kids) != len(self.children):
            raise ValueError(f"{kind} of {len(kids)} children where the structure has "
                             f"{len(self.children)}")
        for c, k in zip(self.children, kids):
            c._up_to(k, out)

    def __repr__(self):
        return f"TreeDef({self.kind}, leaves={self.num_leaves})"


_END = object()


def _kind(x) -> str:
    if x is None:
        return "none"
    if isinstance(x, dict):
        return "dict"
    if isinstance(x, list):
        return "list"
    if type(x) is tuple:
        return "tuple"
    return "leaf"


def _flatten(x, path, out, is_leaf):
    if (is_leaf is not None and is_leaf(x)) or _kind(x) == "leaf":
        out.append((path, x))
        return TreeDef("leaf")
    keys, kids = _children(x)
    children = [_flatten(k, path + key, out, is_leaf) for key, k in zip(keys, kids)]
    return TreeDef(_kind(x), sorted(x) if isinstance(x, dict) else (), children)


def tree_flatten_with_path(tree, is_leaf: Callable = None) -> Tuple[list, TreeDef]:
    """``([(keystr path, leaf), ...], treedef)`` in JAX's leaf order."""
    out: list = []
    treedef = _flatten(tree, "", out, is_leaf)
    return out, treedef


def tree_flatten(tree, is_leaf: Callable = None) -> Tuple[list, TreeDef]:
    flat, treedef = tree_flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in flat], treedef


def tree_leaves(tree, is_leaf: Callable = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = None):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of each
    tree in ``rest``; the result has ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten(fn(*xs) for xs in zip(leaves, *others))

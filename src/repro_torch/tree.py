"""Trees of tensors in ``jax.tree_util``'s order.

The port's states are nested dicts, lists, tuples and NamedTuples with
tensors (or numpy arrays) at the leaves, as the reference's pytrees are.
Where the reference numbers leaves (``fake_grad_compression`` folds leaf i
into its key), walks them (AdamW, the IHT projection) or names them (a
checkpoint's manifest), the port visits them in the same order: dict keys
sorted, list and tuple entries in order, NamedTuple fields in order; ``None``
is an empty subtree. A path holds one entry a level: ``("key", k)`` for a
dict, ``("idx", i)`` for a list or tuple, ``("attr", name)`` for a
NamedTuple field.
"""
from __future__ import annotations

from typing import Any, Callable, Optional


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[list]:
    """[(path entry, child)] of a node, or None for a leaf."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        return [(("attr", f), getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(("idx", i), v) for i, v in enumerate(tree)]
    if isinstance(tree, dict):
        return [(("key", k), tree[k]) for k in sorted(tree)]
    return None


def tree_flatten_with_path(tree, path: tuple = ()) -> list:
    """[(path, leaf)] in JAX's leaf order."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [item for entry, child in kids
            for item in tree_flatten_with_path(child, path + (entry,))]


def tree_leaves(tree) -> list:
    """The leaves in JAX's order."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def last_key(path) -> Optional[Any]:
    """The dict key of a path's last level, None when that level is not a dict."""
    return path[-1][1] if path and path[-1][0] == "key" else None


def keystr(path) -> str:
    """A path spelled as ``jax.tree_util.keystr`` spells it (``.opt.mu``,
    ``['w']``, ``[0]``)."""
    spell = {"attr": lambda a: f".{a}", "idx": lambda i: f"[{i}]", "key": lambda k: f"[{k!r}]"}
    return "".join(spell[kind](v) for kind, v in path)


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the iterator
    ``leaves`` (dicts rebuilt with their keys sorted)."""
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(tree_unflatten(c, leaves) for _, c in kids))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_unflatten(c, leaves) for _, c in kids)
    return {entry[1]: tree_unflatten(c, leaves) for entry, c in kids}


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure), in a tree of ``tree``'s structure."""
    leaves = [tree_leaves(t) for t in (tree,) + rest]
    return tree_unflatten(tree, iter([fn(*group) for group in zip(*leaves)]))

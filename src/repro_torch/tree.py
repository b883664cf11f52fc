"""Pytree helpers for the port's nested-dict params, in the reference's order.

jax flattens a dict by its sorted keys and a list or tuple in order; the
optimiser's global norm, the checkpoint's leaf names and the redeploy log's
tensor names all depend on that order, so every walk of a param tree in the
port goes through here.  A path is a tuple of dict keys (str) and list
indices (int).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_path(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs in jax's flatten order; ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable, tree: Any, *rest: Any, prefix: tuple = ()) -> Any:
    """``fn(path, leaf, *matching leaves of rest)`` at every leaf of ``tree``,
    called in ``leaves`` order; dicts keep their key order, lists and tuples
    their type, ``None`` stays ``None``."""
    if isinstance(tree, dict):
        out = {k: map_with_path(fn, tree[k], *(r[k] for r in rest), prefix=prefix + (k,))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, v, *(r[i] for r in rest), prefix=prefix + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(prefix, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    return map_with_path(lambda _, *leaves_: fn(*leaves_), tree, *rest)


def unflatten(like: Any, values: list) -> Any:
    """The tree of ``like`` with its leaves replaced by ``values`` (in
    ``leaves`` order)."""
    it = iter(values)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def path_name(path: tuple, sep: str = "/") -> str:
    """'/'-joined path, the planner's and the redeploy log's tensor name."""
    return sep.join(str(p) for p in path)

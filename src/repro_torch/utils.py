"""Nested-dict helpers shared by the checkpoint store, the deployment
code and the optimizers (the port's counterparts of
``repro.utils.tree_paths``, ``unflatten_dict`` and ``tree_map_with_path``,
and of ``jax.tree.map`` over dict trees)."""
from __future__ import annotations

from typing import Any, Callable


def tree_paths(tree: Any) -> list[tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict/list/tuple tree, paths
    '/'-joined from dict keys (sorted, as JAX flattens dicts) and indices."""
    out: list[tuple[str, Any]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            items = sorted(node.items())
        elif isinstance(node, (list, tuple)):
            items = list(enumerate(node))
        else:
            out.append((prefix, node))
            return
        for k, v in items:
            walk(v, f"{prefix}/{k}" if prefix else str(k))

    walk(tree, "")
    return out


def unflatten_dict(flat: dict[str, Any]) -> dict:
    """Inverse of :func:`tree_paths` for dict trees."""
    out: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of one or more dict/list/tuple trees of the
    same structure (``jax.tree.map`` for the port's dict trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """``fn(path, leaf)`` → new leaf over a dict/list/tuple tree; paths
    '/'-joined from dict keys and indices, as :func:`tree_paths` gives
    them."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(node))
        return fn(prefix, node)

    return walk(tree, "")


def tree_leaves(tree: Any) -> list[Any]:
    """The leaves of a dict/list/tuple tree in :func:`tree_paths` order."""
    return [leaf for _, leaf in tree_paths(tree)]

"""Nested-dict helpers shared by the checkpoint store and the deployment
code (the port's counterparts of ``repro.utils.tree_paths`` /
``unflatten_dict``)."""
from __future__ import annotations

from typing import Any


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

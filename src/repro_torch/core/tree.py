"""Minimal pytree helpers over nested dicts / lists / tuples of tensors.

JAX flattens dicts in SORTED key order; ``torch.utils._pytree`` keeps
insertion order.  Everything that folds leaves into one stream or keys
per-leaf accounting (``TransferPlan``, ``TransferSession``) must walk leaves
in JAX's order, or the folded chunked stream and the per-leaf stats stop
matching the JAX package bit for bit.  These helpers sort explicitly.
"""

from __future__ import annotations

from typing import Any, List, Tuple

LEAF = "*"


def flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """``tree`` -> ([(path, leaf), ...], treedef), dict keys sorted."""
    out: List[Tuple[tuple, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys),
                    tuple(walk(node[k], path + (k,)) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, len(node),
                    tuple(walk(v, path + (f"[{i}]",)) for i, v in enumerate(node)))
        out.append((path, node))
        return LEAF

    treedef = walk(tree, ())
    return out, treedef


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)[0]]


def unflatten(treedef, flat_leaves):
    """Inverse of :func:`flatten_with_path`."""
    it = iter(flat_leaves)

    def build(d):
        if d == LEAF:
            return next(it)
        kind, meta, children = d
        if kind == "dict":
            return {k: build(c) for k, c in zip(meta, children)}
        vals = [build(c) for c in children]
        return vals if kind == "list" else tuple(vals)

    return build(treedef)


def leaf_key(path) -> str:
    """Canonical path -> string key, the JAX package's ``leaf_key``:
    dict keys joined with '/' (sequence entries as ``[i]``)."""
    return "/".join(str(k) for k in path)

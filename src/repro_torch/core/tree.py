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


def _walk(node, path, out):
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys),
                tuple(_walk(node[k], path + (k,), out) for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, len(node),
                tuple(_walk(v, path + (f"[{i}]",), out) for i, v in enumerate(node)))
    out.append((path, node))
    return LEAF


def flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """``tree`` -> ([(path, leaf), ...], treedef), dict keys sorted.

    The recursion is a module-level function, not a closure: a nested
    function that calls itself sits in a reference cycle with its cell,
    and the cycle would keep every leaf it saw alive until Python's
    cyclic collector ran."""
    out: List[Tuple[tuple, Any]] = []
    treedef = _walk(tree, (), out)
    return out, treedef


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)[0]]


def _build(d, it):
    if d == LEAF:
        return next(it)
    kind, meta, children = d
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(meta, children)}
    vals = [_build(c, it) for c in children]
    return vals if kind == "list" else tuple(vals)


def unflatten(treedef, flat_leaves):
    """Inverse of :func:`flatten_with_path`."""
    return _build(treedef, iter(flat_leaves))


def leaf_key(path) -> str:
    """Canonical path -> string key, the JAX package's ``leaf_key``:
    dict keys joined with '/' (sequence entries as ``[i]``)."""
    return "/".join(str(k) for k in path)

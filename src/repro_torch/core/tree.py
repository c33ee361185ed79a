"""Minimal pytree helpers over nested dicts / lists / tuples / NamedTuples
of tensors.

JAX flattens dicts in SORTED key order; ``torch.utils._pytree`` keeps
insertion order.  Everything that folds leaves into one stream or keys
per-leaf accounting (``TransferPlan``, ``TransferSession``) must walk leaves
in JAX's order, or the folded chunked stream and the per-leaf stats stop
matching the JAX package bit for bit.  These helpers sort explicitly.

A ``NamedTuple`` (the train state, ``TrainState(params, opt)``) flattens in
field order with ``.<field>`` path components, JAX's ``GetAttrKey``, so a
train state's leaf keys (``.params/embed``, ``.opt/.m/embed``) are the JAX
package's, and :func:`unflatten` rebuilds the same ``NamedTuple`` type.
"""

from __future__ import annotations

from typing import Any, List, Tuple

LEAF = "*"


def _walk(node, path, out):
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys),
                tuple(_walk(node[k], path + (k,), out) for k in keys))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return (type(node), None,
                tuple(_walk(getattr(node, f), path + (f".{f}",), out)
                      for f in node._fields))
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
    if kind == "list":
        return vals
    return tuple(vals) if kind == "tuple" else kind._make(vals)


def unflatten(treedef, flat_leaves):
    """Inverse of :func:`flatten_with_path`."""
    return _build(treedef, iter(flat_leaves))


def _up_to(d, node, out):
    if d == LEAF:
        out.append(node)
        return
    kind, meta, children = d
    if kind == "dict":
        if not isinstance(node, dict) or tuple(sorted(node)) != meta:
            raise ValueError(f"expected a dict with keys {meta}, got {node!r}")
        for k, c in zip(meta, children):
            _up_to(c, node[k], out)
        return
    if kind in ("list", "tuple"):
        ok = isinstance(node, (list, tuple)) and len(node) == meta
    else:
        ok = isinstance(node, kind)
    if not ok:
        raise ValueError(f"expected a {kind} node, got {node!r}")
    for c, v in zip(children, node):
        _up_to(c, v, out)


def flatten_up_to(treedef, tree) -> list:
    """The subtrees of ``tree`` at ``treedef``'s leaf positions (JAX's
    ``treedef.flatten_up_to``): a tree whose leaves are tuples (sharding
    specs) read against the tree it describes.  Raises where the
    structures differ."""
    out: list = []
    _up_to(treedef, tree, out)
    return out


def leaf_key(path) -> str:
    """Canonical path -> string key, the JAX package's ``leaf_key``:
    dict keys joined with '/' (sequence entries as ``[i]``, NamedTuple
    fields as ``.<field>``)."""
    return "/".join(str(k) for k in path)

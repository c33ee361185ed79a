"""Divisibility-aware sharding rules for parameters, activations and caches,
and the explicit placement they drive (the port of
``repro.distributed.sharding``).

Mesh axes are ``(pod, data, model)``.  Data parallelism runs over
``(pod, data)``, tensor and expert parallelism over ``model``.  A rule
shards a tensor dimension on an axis only when the dimension divides the
axis size; otherwise the dimension is replicated (minitron's 24 heads
never shard over model 16; its attention falls back to the sequence).

A spec is a tuple with one entry a dimension.  An entry is ``None``
(replicated), an axis name, or a tuple of axis names: the dimension splits
row-major over them, the first axis major, as a JAX ``PartitionSpec``
entry splits it (``NamedSharding.devices_indices_map``).  The rules return
the JAX ``ShardingPolicy``'s specs entry for entry, singleton tuples
unwrapped to the bare name (``_maybe``), except at the hybrid's stacked
recurrent leaves (``triples/rec/``, ``extra/``), whose stack dimensions
the port strips before the rules apply (:func:`stack_dims`).

The policy takes a ``DeviceMesh`` (``launch/mesh.py:make_mesh``) or a plain
``{axis: size}`` mapping; the mapping plans shards without a process group
(the tests, ``meta`` tensors).  :func:`shard_slice` takes this rank's block
of a whole tensor, :func:`gather` puts the whole tensor back through
``serving/collective.py:Link.all_gather``, and :func:`local_shape` gives a
shard's shape.

Not ported: ``constrain``, ``constrain_tree``, ``param_sharding`` and
``cache_sharding``.  In JAX they are GSPMD layout hints inside a jitted
program and ``NamedSharding`` objects for its in/out shardings; the port
places tensors explicitly (``training/train_step.py:shard_state``, the mesh
executor's shard slicing), and the model code takes a tensor-parallel
context as an argument where GSPMD reads the hints
(``distributed/tensor_parallel.py``).  Nor are
``use_policy`` and ``current_policy``: the thread-local policy's only
reader in JAX is ``constrain``, and the port's step takes its policy as an
argument.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.core import tree as TR
from repro_torch.launch.mesh import mesh_shape

DP_AXES = ("pod", "data")  # flattened data-parallel axes (present subset used)

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return mesh_shape(mesh)


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(sizes: Dict[str, int], axes) -> int:
    n = 1
    for a in entry_axes(axes):
        n *= sizes.get(a, 1)
    return n


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Resolves logical shard requests against a mesh."""

    mesh: Any
    # how to shard attention activations when heads don't divide 'model':
    #   'seq'  — shard the sequence dim over model (sequence parallelism)
    #   'none' — replicate over model
    attn_fallback: str = "seq"
    # ZeRO-3/FSDP: additionally shard params + optimizer state over 'data'
    # (within a pod; pods stay pure DP so no param gathers cross pods).
    fsdp: bool = False
    # MoE dispatch intermediates (token buffers over dp, expert buffers
    # over model) get specs of their own
    moe_dispatch_sharding: bool = False
    # PD-disaggregated serving: the 'pod' axis separates prefill/decode
    # workers, so activations/caches shard over 'data' only (replicated over
    # 'pod'); the pod axis is reserved for the KV-transfer hop.
    pd_disaggregated: bool = False

    @property
    def sizes(self) -> Dict[str, int]:
        return axis_sizes(self.mesh)

    def dp_axes(self) -> Tuple[str, ...]:
        axes = DP_AXES if not self.pd_disaggregated else ("data",)
        return tuple(a for a in axes if a in self.sizes)

    def fsdp_axes(self) -> Tuple[str, ...]:
        return ("data",) if ("data" in self.sizes and self.fsdp) else ()

    def dp_size(self) -> int:
        return _axis_size(self.sizes, self.dp_axes())

    def tp_size(self) -> int:
        return _axis_size(self.sizes, "model")

    # -- helpers ---------------------------------------------------------------
    def _maybe(self, dim: int, axes):
        """axes if dim divides their product, else None; singleton axis
        tuples unwrapped to the bare name."""
        n = _axis_size(self.sizes, axes)
        if n > 1 and dim % n == 0:
            if isinstance(axes, tuple) and len(axes) == 1:
                return axes[0]
            return axes
        return None

    def _tp(self):
        return "model" if "model" in self.sizes else None

    def spec_for_activation(self, kind: str, shape: Tuple[int, ...]
                            ) -> Optional[Spec]:
        dp, tp = self.dp_axes(), self._tp()
        if kind == "btd":            # (B, S, D) hidden states
            return (self._maybe(shape[0], dp), None, None)
        if kind == "btd_seq":        # (B, S, D) sequence-sharded over model
            return (self._maybe(shape[0], dp), self._maybe(shape[1], tp), None)
        if kind == "bthd":           # (B, S, H, hd) attention activations
            b = self._maybe(shape[0], dp)
            h = self._maybe(shape[2], tp)
            if h is not None:
                return (b, None, h, None)
            if self.attn_fallback == "seq":
                return (b, self._maybe(shape[1], tp), None, None)
            return (b, None, None, None)
        if kind == "logits":         # (B, S, V) or (B, V)
            return ((self._maybe(shape[0], dp),) + (None,) * (len(shape) - 2)
                    + (self._maybe(shape[-1], tp),))
        if kind == "kvcache":        # (B, S, Hkv, hd) or (B, S, r)
            return ((self._maybe(shape[0], dp), self._maybe(shape[1], tp))
                    + (None,) * (len(shape) - 2))
        if kind in ("state", "tokens"):   # (B, ...) recurrent states; ints
            return (self._maybe(shape[0], dp),) + (None,) * (len(shape) - 1)
        # --- MoE dispatch intermediates (models/moe.py) ----------------------
        if kind in ("moe_td", "moe_te"):  # (T, D) tokens; (T, E) router
            if not self.moe_dispatch_sharding:
                return None
            return (self._maybe(shape[0], dp), None)
        if kind in ("moe_ecd", "moe_ecf"):  # (E, C, D|F) expert buffers
            if not self.moe_dispatch_sharding:
                return None
            return (self._maybe(shape[0], tp), None, None)
        raise KeyError(f"unknown activation kind {kind!r}")

    def spec_for_cache(self, name: str, shape: Tuple[int, ...]) -> Spec:
        """Layer-stacked inference caches (see models/kvcache.py layouts)."""
        dp, tp = self.dp_axes(), self._tp()
        leaf = name.split("/")[-1]
        if leaf in ("k", "v", "ckv", "krope"):      # (L, B, S, ...)
            return ((None, self._maybe(shape[1], dp), self._maybe(shape[2], tp))
                    + (None,) * (len(shape) - 3))
        if leaf == "ssm":                            # (L, B, H, P, N)
            return (None, self._maybe(shape[1], dp), self._maybe(shape[2], tp),
                    None, None)
        if leaf == "conv":                           # (L, B, W-1, C)
            return (None, self._maybe(shape[1], dp), None,
                    self._maybe(shape[3], tp))
        if leaf in ("attn_k", "attn_v"):             # (nt, B, W, Hkv, hd)
            return (None, self._maybe(shape[1], dp), None,
                    self._maybe(shape[3], tp), None)
        if leaf == "rec_h":                          # (nt, 2, B, U)
            return (None, None, self._maybe(shape[2], dp),
                    self._maybe(shape[3], tp))
        if leaf == "rec_conv":                       # (nt, 2, B, cw-1, U)
            return (None, None, self._maybe(shape[2], dp), None,
                    self._maybe(shape[4], tp))
        if leaf == "extra_h":                        # (ne, B, U)
            return (None, self._maybe(shape[1], dp), self._maybe(shape[2], tp))
        if leaf == "extra_conv":                     # (ne, B, cw-1, U)
            return (None, self._maybe(shape[1], dp), None,
                    self._maybe(shape[3], tp))
        # unknown cache leaf: batch-only
        if len(shape) > 1:
            return (None, self._maybe(shape[1], dp)) + (None,) * (len(shape) - 2)
        return (None,)

    def cache_specs(self, cache):
        """A tree like ``cache`` (tensors or ``meta`` tensors) with a spec
        at each leaf: what a mesh-targeted
        :class:`~repro_torch.serving.plan.TransferPlan` takes as
        ``specs=``."""
        return _tree_of_specs(cache, self.spec_for_cache)

    # -- parameter rules ---------------------------------------------------------
    # matched against the '/'-joined param path, first hit wins
    PARAM_RULES = (
        # (regex, dims-spec kind)
        (re.compile(r"(embed|tok_embed)$"), "vocab_row"),        # (V, D)
        (re.compile(r"lm_head$"), "vocab_col"),                  # (D, V)
        (re.compile(r"w[qkv]$"), "heads_mid"),                   # (D, H, hd)
        (re.compile(r"wo$"), "heads_first"),                     # (H, hd, D)
        (re.compile(r"w_(gate|up)$"), "ff_col"),                 # (D, F)
        (re.compile(r"w_down$"), "ff_row"),                      # (F, D)
        (re.compile(r"w_gate_up$"), "expert"),                   # (E, D, 2F)
        (re.compile(r"router$"), "replicate"),
        (re.compile(r"wq_a$|wkv_a$"), "ff_col"),                 # (D, r)
        (re.compile(r"wq_b$|wkv_b$"), "mla_b"),                  # (r, H, ·)
        (re.compile(r"in_proj$"), "ff_col"),                     # (D, K)
        (re.compile(r"out_proj$|w_out$"), "ff_row"),             # (K, D)
        (re.compile(r"w_gate_branch$|w_in$"), "ff_col"),
        (re.compile(r"w_a$|w_x$"), "lru_sq"),                    # (U, U)
        (re.compile(r"frontend_proj$"), "ff_col"),
    )

    def spec_for_param(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """The spec of the parameter at ``path`` (``/``-joined) of whole
        ``shape``.  The stack dimensions in front of a block's own shape
        are never split: one for ``layers/``, ``/stack/``, ``triples/attn/``
        and ``extra/``, two for ``triples/rec/`` (a triple's pair of
        recurrent blocks, ``(nt, 2, ...)``); the rules and FSDP see the
        block's shape.  A deliberate difference from the JAX policy, which
        strips one dimension for ``layers/``, ``/stack/`` and ``triples/``
        only, so that there the hybrid's row-split ``triples/rec/`` and
        ``extra/`` leaves split a stack dimension, not their rows; every
        other family's specs are the JAX policy's."""
        tp = self._tp()
        lead: Tuple[Any, ...] = (None,) * stack_dims(path)
        shape = shape[len(lead):]
        kind = "replicate"
        leaf = path.split("/")[-1]
        for rx, k in self.PARAM_RULES:
            if rx.search(leaf):
                kind = k
                break

        def mk(*spec):
            if self.fsdp:
                spec = self._add_fsdp(spec, shape)
            return lead + tuple(spec)

        rest = (None,) * (len(shape) - 1)
        if len(shape) == 0:
            return mk()
        if kind in ("vocab_row", "ff_row", "expert"):
            return mk(self._maybe(shape[0], tp), *rest)
        if kind in ("vocab_col", "ff_col", "lru_sq"):
            return mk(*rest, self._maybe(shape[-1], tp))
        if kind in ("heads_mid", "mla_b") and len(shape) == 3:
            return mk(None, self._maybe(shape[1], tp), None)
        if kind == "heads_first" and len(shape) == 3:
            return mk(self._maybe(shape[0], tp), None, None)
        return mk(*([None] * len(shape)))

    def _add_fsdp(self, spec, shape):
        """ZeRO-3: place 'data' on the largest still-unsharded divisible dim.
        Leaves too-small params (norm scales, biases) replicated — the cost
        of gathering them is larger than the memory they hold."""
        axes = self.fsdp_axes()
        n = _axis_size(self.sizes, axes)
        if n <= 1:
            return spec
        spec = list(spec) + [None] * (len(shape) - len(spec))
        cands = [i for i, s in enumerate(spec)
                 if s is None and i < len(shape) and shape[i] % n == 0
                 and shape[i] >= 4 * n]
        if cands:
            best = max(cands, key=lambda i: shape[i])
            spec[best] = axes if len(axes) > 1 else axes[0]
        return tuple(spec)

    def param_specs(self, params):
        """A tree like ``params`` with a spec at each leaf (the AdamW
        moments take their parameters' specs)."""
        return _tree_of_specs(params, self.spec_for_param)


def stack_dims(path: str) -> int:
    """The number of stack dimensions in front of the block's own shape of
    the parameter at ``path`` (``ShardingPolicy.spec_for_param``)."""
    if path.startswith("triples/rec/"):
        return 2
    if path.startswith(("layers/", "triples/", "extra/")) or "/stack/" in path:
        return 1
    return 0


def _key_str(k: str) -> str:
    """A port path component as the JAX module's ``_key_str`` writes it: a
    sequence index is a bare number, a dict key itself, a ``NamedTuple``
    field ``.<field>``."""
    return k[1:-1] if k.startswith("[") and k.endswith("]") else k


def path_str(path) -> str:
    return "/".join(_key_str(k) for k in path)


def _tree_of_specs(tree, rule):
    flat, treedef = TR.flatten_with_path(tree)
    return TR.unflatten(treedef, [rule(path_str(p), tuple(x.shape))
                                  for p, x in flat])


def leaf_specs(specs_tree, like) -> List[Spec]:
    """The specs of ``specs_tree`` in ``like``'s leaf order."""
    return TR.flatten_up_to(TR.flatten_with_path(like)[1], specs_tree)


# ---------------------------------------------------------------------------
# placement: shapes, this rank's block, the whole tensor back
# ---------------------------------------------------------------------------

def local_shape(shape, spec: Spec, sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of one block of a tensor of ``shape`` under ``spec``;
    raises where a named dimension does not divide."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _axis_size(dict(sizes), entry)
        if out[d] % n:
            raise ValueError(f"dimension {d} ({shape[d]}) does not divide "
                             f"over {entry!r} ({n})")
        out[d] //= n
    return tuple(out)


def coordinate(mesh) -> Dict[str, int]:
    """This rank's index along every axis of a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def shard_slice(x: torch.Tensor, spec: Spec, mesh,
                coord: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``
    (contiguous; a view where the block already is).  ``coord`` is the
    rank's ``{axis: index}`` (default: this process's coordinate in the
    ``DeviceMesh``; pass it with a mapping mesh)."""
    sizes = axis_sizes(mesh)
    if coord is None and splits(spec, sizes):
        coord = coordinate(mesh)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in entry_axes(entry))
        if n > 1:
            idx = 0
            for a in entry_axes(entry):
                idx = idx * sizes[a] + coord[a]
            size = x.shape[d] // n
            x = x.narrow(d, idx * size, size)
    return x.contiguous()


_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def cat_bits(parts: List[torch.Tensor], dim: int) -> torch.Tensor:
    """``torch.cat`` through same-width integer views (float8 and the
    unsigned dtypes have no CPU concatenation of their own)."""
    dtype = parts[0].dtype
    if dtype == torch.bool:
        return torch.cat(parts, dim)
    w = _INT_OF_WIDTH[parts[0].element_size()]
    return torch.cat([p.view(w) for p in parts], dim).view(dtype)


def gather(x: torch.Tensor, spec: Spec, mesh, comm=None) -> torch.Tensor:
    """The whole tensor from this rank's block ``x``: all-gathered over
    every axis ``spec`` names (the minor axis of a tuple entry first),
    through :meth:`~repro_torch.serving.collective.Link.all_gather` on
    ``x``'s device; ``comm`` (a ``CommStats``) counts the bytes."""
    from repro_torch.serving import collective as CL
    sizes = axis_sizes(mesh)
    comm = CL.CommStats() if comm is None else comm
    for d, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            if sizes[a] > 1:
                parts = CL.Link(mesh.get_group(a), x.device, comm).all_gather(x)
                x = cat_bits(parts, d)
    return x


def shard_tree(tree, specs_tree, mesh):
    """This rank's shards of a whole tree (fresh tensors where a leaf is
    split, so the whole tree can be freed; replicated leaves as given)."""
    sizes = axis_sizes(mesh)
    flat, treedef = TR.flatten_with_path(tree)
    return TR.unflatten(treedef, [
        shard_slice(x, s, mesh).clone() if splits(s, sizes) else x
        for (_, x), s in zip(flat, TR.flatten_up_to(treedef, specs_tree))])


def gather_tree(tree, specs_tree, mesh, comm=None):
    """The whole tree from every rank's shards (every rank calls it)."""
    sizes = axis_sizes(mesh)
    flat, treedef = TR.flatten_with_path(tree)
    return TR.unflatten(treedef, [
        gather(x, s, mesh, comm) if splits(s, sizes) else x
        for (_, x), s in zip(flat, TR.flatten_up_to(treedef, specs_tree))])


def restrict(spec: Spec, axes) -> Spec:
    """``spec`` with only the entries that name ``axes`` (the others
    replicated): what a block split over those axes alone is placed by."""
    return tuple(e if e is not None and set(entry_axes(e)) <= set(axes)
                 else None for e in spec)


def splits(spec: Spec, sizes: Mapping[str, int]) -> bool:
    """Whether ``spec`` names an axis of more than one rank."""
    return any(sizes.get(a, 1) > 1 for e in spec for a in entry_axes(e))


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a tree is placed across the ranks of ``policy``'s mesh: ``like``
    holds its whole shapes and dtypes (``meta`` tensors serve), ``specs``
    a spec a leaf.  The checkpoint plane and ``reshard`` take one to save
    the gathered tree and to end a restore in this rank's shards."""

    policy: ShardingPolicy
    specs: Any
    like: Any

    def shard(self, tree):
        return shard_tree(tree, self.specs, self.policy.mesh)

    def gather(self, tree, comm=None):
        return gather_tree(tree, self.specs, self.policy.mesh, comm)


def param_placer(policy: ShardingPolicy):
    """``models.model.init_params``'s ``place``: each leaf (an MoE stack a
    layer at a time, ``layers`` its depth) cut to this rank's block under
    ``policy.spec_for_param`` as soon as it is drawn (a fresh tensor, so
    the whole leaf can be freed; a replicated leaf kept as drawn)."""
    sizes = policy.sizes

    def place(keys, x, layers=None):
        shape = tuple(x.shape) if layers is None else (layers,) + tuple(x.shape)
        spec = policy.spec_for_param("/".join(keys), shape)
        if layers is not None:      # one layer of the stack
            spec = spec[1:]
        if not splits(spec, sizes):
            return x
        return shard_slice(x, spec, policy.mesh).clone()
    return place


def held_bytes(tree, specs_tree, sizes: Mapping[str, int]) -> int:
    """Bytes one rank holds of ``tree`` (whole-tensor shapes) under
    ``specs_tree``: the spec arithmetic a placed tree must match."""
    return sum(math.prod(local_shape(tuple(x.shape), s, sizes)) * x.element_size()
               for x, s in zip(TR.leaves(tree), leaf_specs(specs_tree, tree)))

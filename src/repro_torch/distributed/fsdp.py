"""FSDP blocks gathered for serving, one layer at a time: the context the
model code takes as ``fsdp=``.

Under ``ShardingPolicy(fsdp=True)`` every parameter large enough carries
``data`` on one more dimension (``ShardingPolicy._add_fsdp``), so a rank
holds a block of its ``model`` shard.  In the JAX package GSPMD inserts
the all-gather of each layer's parameters at their use sites
(``repro/distributed/sharding.py:54``).  The port does the same
explicitly: :class:`BlockGather` makes a layer's ``data``-split leaves
whole over ``data`` just before the layer's products, and the gathered
blocks are dropped when the layer returns, so one gathered layer is live
at a time (the train step gathers every leaf up front instead,
``training/train_step.py``).

The result of a gather is the rank's ``model`` block, the slice of
``restrict(spec, ("model",))``: ``_add_fsdp`` only takes a dimension whose
entry is ``None``, so ``data`` and ``model`` never share a dimension, and
the ``data`` blocks come back in data-rank order along theirs (as
``sharding.gather`` joins them).  A gather moves bits: served tokens,
logits and caches are those of the same mesh with ``fsdp`` off, bitwise.

Which leaves are gathered is decided by the whole leaf's spec, not by a
block's shape: a leaf ``_add_fsdp`` left whole (under ``4 * data``, or no
dimension divides) is never touched.  A layer-stacked leaf's spec never
splits its stack dimensions (``sharding.stack_dims``); a layer loop slices
one of them off (``layers/``, ``triples/``, ``extra/``, the MoE stacks
drawn a layer at a time), so a layer's ``data`` dimension is the whole
leaf's less one.  Each call is ONE all-gather over the ``data`` group of a
bucket of every block it makes whole, each block padded to 16 bytes (as a
message's units are, ``serving/collective.py``), through
``Link.all_gather``: its bytes go to :attr:`BlockGather.comm` and, in the
dry run, to the abstract run's ``all-gather`` tally.  With ``fsdp`` off,
or ``data`` of one rank, nothing is split over ``data`` and every call
returns its input, moving nothing.

Under ``pd_disaggregated`` the ``data`` group is the pod's own, so pod 0's
prefill and pod 1's decode each gather within their pod and no parameter
crosses the pod axis (``fsdp_axes``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import torch

from repro_torch.core import tree as TR
from repro_torch.distributed import sharding as SH
from repro_torch.serving import collective as CL


def _data_dim(spec) -> int:
    """The dimension a spec splits over ``data``."""
    return next(d for d, e in enumerate(spec) if "data" in SH.entry_axes(e))


class BlockGather:
    """The gathers of one rank's serving run under ``policy``: built once
    from the whole parameters' shapes (``like``, ``meta`` tensors serve:
    ``models.model.abstract_params``).  ``specs`` maps the path of every
    leaf split over ``data`` to its spec restricted to ``data``
    (``sharding.restrict``, as the train step's gather takes it);
    ``comm`` counts the bytes handed to gloo, ``calls`` the all-gathers."""

    def __init__(self, policy: SH.ShardingPolicy, like):
        sizes = policy.sizes
        self.policy = policy
        self.comm = CL.CommStats()
        self.calls = 0
        self.specs: Dict[str, SH.Spec] = {}
        if not policy.fsdp_axes():
            return
        for p, x in TR.flatten_with_path(like)[0]:
            path = SH.path_str(p)
            spec = SH.restrict(policy.spec_for_param(path, tuple(x.shape)),
                               ("data",))
            if SH.splits(spec, sizes):
                self.specs[path] = spec

    def layer(self, lp: Dict, prefix: str) -> Dict:
        """One layer's slice ``lp`` of the stacks under ``prefix``
        (``layers``, ``triples``, ``extra``) with every ``data``-split
        leaf made whole over ``data``: the rank's ``model`` blocks."""
        return self._tree(lp, prefix + "/", 1)

    def top(self, params: Dict, names: Sequence[str]) -> Dict:
        """``params`` (a shallow copy) with its top-level leaves ``names``
        made whole over ``data``, in one all-gather."""
        got = self._tree({k: params[k] for k in names}, "", 0)
        return {**params, **got}

    def _tree(self, tree, prefix: str, strip: int):
        if not self.specs:
            return tree
        flat, treedef = TR.flatten_with_path(tree)
        leaves = [x for _, x in flat]
        todo = []
        for i, (p, x) in enumerate(flat):
            spec = self.specs.get(prefix + SH.path_str(p))
            if spec is not None:
                todo.append((i, _data_dim(spec[strip:])))
        if not todo:
            return tree
        whole = self._gather([leaves[i] for i, _ in todo], [d for _, d in todo])
        for (i, _), x in zip(todo, whole):
            leaves[i] = x
        return TR.unflatten(treedef, leaves)

    def _gather(self, blocks: List[torch.Tensor], dims: List[int]
                ) -> List[torch.Tensor]:
        """Each of ``blocks`` made whole along its dimension in ``dims``:
        one all-gather of their bytes, each padded to ``CL.ALIGN`` (so each
        block's bytes start aligned for its dtype)."""
        t0 = time.perf_counter()
        link = CL.Link(self.policy.mesh.get_group("data"), blocks[0].device,
                       self.comm)
        parts = []
        for b in blocks:
            v = CL.byte_view(b)
            pad = -v.numel() % CL.ALIGN
            parts.append(v)
            if pad:
                parts.append(torch.zeros(pad, dtype=torch.uint8,
                                         device=v.device))
        rows = torch.stack(link.all_gather(torch.cat(parts)))
        self.calls += 1
        n, off, out = rows.shape[0], 0, []
        for b, d in zip(blocks, dims):
            size = b.numel() * b.element_size()
            # (n, block) in data-rank order, the rank axis moved in front of
            # dimension d and merged into it: one copy, the blocks' bits
            x = rows[:, off:off + size].view(b.dtype).reshape(
                (n,) + tuple(b.shape)).movedim(0, d)
            shape = list(b.shape)
            shape[d] *= n
            out.append(x.reshape(shape))
            off += size + -size % CL.ALIGN
        self.comm.seconds += time.perf_counter() - t0
        return out


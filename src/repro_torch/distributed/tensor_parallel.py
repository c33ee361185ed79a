"""Tensor parallelism over the policy's ``model`` axis: the context the
model code takes as ``tp=``, and the collectives of split products as
autograd functions.

The JAX package has no counterpart module.  There GSPMD partitions the
jitted train step itself: the policy's ``model`` specs (``heads_mid``,
``heads_first``, ``ff_col``, ``ff_row``, ``vocab_row``, ``vocab_col``,
``mla_b``; ``distributed/sharding.py``) and the ``constrain`` hints make
XLA split the products and insert the collectives.  The port places its
shards explicitly, so the model code runs on a rank's shards and calls the
collectives below where GSPMD inserts its own:

* :func:`region` -- the input of a split region: identity forward, the sum
  over ``model`` backward (each rank's products give a part of the
  input's gradient);
* :func:`reduce` -- a row-split product's output: the sum over ``model``
  forward, identity backward;
* :func:`gather` -- an output split over ``model`` along one dimension
  (the ``seq`` fallback's attention blocks; a column-split ``wq_a``,
  ``wkv_a``, ``frontend_proj`` or Mamba-2 ``in_proj`` product, whose
  output is normed over its whole width, joins the residual stream whole
  or is split into z, x, B, C and dt; the RG-LRU's post-conv block, which
  the gate products read whole): all-gathered forward, the rank's slice
  of the whole gradient backward;
* :func:`vocab_embedding` -- the token lookup in a vocab-split table:
  each rank looks up its range, zeros elsewhere, summed over ``model``;
* :func:`vocab_log_prob` -- each position's label log-probability over a
  vocab split over ``model``: the log-softmax's max and sum and the
  label's logit reduced over ``model``, forward and backward.

Every sum adds the ranks' parts in f32 in rank order and rounds once
(:func:`ordered_sum`): an activation or gradient sum
(:meth:`TensorParallel.sum`) as a reduce-scatter (each rank sums its
slice, ``Link.all_to_all``) and an all-gather of the rounded slices
(``Link.all_gather``), the loss's per-position statistics as one
all-gather.  So every model rank holds bitwise the same activation and
the same gradient.  The model code computes a row-split product in f32
(the exact bf16 products, unrounded) and rounds the sum.

Attention (:meth:`TensorParallel.attention`) has four cases: ``heads``
(query and KV heads split), ``kv`` (query heads split, the KV heads not:
each rank computes K/V whole and takes the heads its queries read),
``seq`` (query heads do not split and the policy's ``attn_fallback`` is
``seq``: each rank attends its block of query positions over the keys up
to the block's end, the blocks gathered before ``wo``) and ``none``
(replicated).  The leaves replicated over ``model`` whose gradients are
then partial on each rank (:func:`partial_leaf`) are summed over ``model``
by the train step's gradient reduction; every other leaf's gradient is
its whole gradient (or its shard's) on every rank.

Families: the dense GQA and MLA models, the vision and audio front ends,
MoE, whose FFN splits by experts (``distributed/expert_parallel.py``;
its attention, embedding and head are the dense ones here), Mamba-2 and
the RG-LRU hybrid.  Mamba-2 (``models/ssm.py:mamba2_forward``): a split
``in_proj``'s product is gathered, the conv, the SSD scan, the ``D`` skip
and the gated norm run whole on every model rank, and a split
``out_proj`` is a row product over the rank's d_inner rows; its
replicated leaves get whole gradients.  The RG-LRU
(``models/rglru.py:recurrent_block_forward``): everything after the
products is per channel, so a rank runs its block of the LRU width
exactly, the post-conv block gathered whole for the ``w_a`` / ``w_x``
products only; the replicated per-channel leaves it slices (``conv_w``,
``conv_b``, ``b_a``, ``b_x``, ``lam``) then have partial gradients
(:func:`partial_leaf`).  The hybrid's local attention is the GQA block
with its window.

Each collective's bytes and host time go to the context's ``fwd`` (the
forward pass, remat's recomputation included) or ``bwd`` ``CommStats``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

#: the RG-LRU's replicated per-channel leaves a rank uses its block of
RG_SLICED = ("conv_w", "conv_b", "b_a", "b_x", "lam")


def ordered_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """The f32 sum of ``parts`` in rank order."""
    acc = parts[0].to(torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(torch.float32)
    return acc


class TensorParallel:
    """One rank's view of the ``model`` axis for one model: the process
    group, this rank's index and the group's size, the model's head
    counts, the RG-LRU's width (0 outside the hybrid) and the policy's
    ``attn_fallback``, and the traffic of the collectives (``fwd``,
    ``bwd``)."""

    def __init__(self, group, cfg: ArchConfig, *, attn_fallback: str = "seq"):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.heads = cfg.num_heads
        self.kv_heads = cfg.num_heads if cfg.mla is not None else cfg.num_kv_heads
        self.lru_width = ((cfg.hybrid.lru_width or cfg.d_model)
                          if cfg.hybrid is not None else 0)
        self.attn_fallback = attn_fallback
        # imported here, not with the module: the serving package imports
        # the model stack, and models.layers imports this module
        from repro_torch.serving import collective as CL
        self.fwd, self.bwd = CL.CommStats(), CL.CommStats()

    def splits(self, n: int) -> bool:
        """Whether a dimension of ``n`` splits over ``model``: the policy's
        rule (``ShardingPolicy._maybe``)."""
        return self.size > 1 and n % self.size == 0

    def attention(self, seq: int) -> str:
        """The attention case at ``seq`` positions (module docstring)."""
        if self.splits(self.heads):
            return "heads" if self.splits(self.kv_heads) else "kv"
        if self.attn_fallback == "seq" and self.splits(seq):
            return "seq"
        return "none"

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` positions."""
        size = n // self.size
        return slice(self.rank * size, (self.rank + 1) * size)

    def link(self, backward: bool, device, stats=None):
        """A ``serving.collective.Link`` over ``model`` counting into
        ``stats`` (default: ``bwd`` or ``fwd``)."""
        from repro_torch.serving import collective as CL
        if stats is None:
            stats = self.bwd if backward else self.fwd
        return CL.Link(self.group, device, stats)

    def sum(self, x: torch.Tensor, dtype: torch.dtype, backward: bool,
            stats=None) -> torch.Tensor:
        """The sum of every rank's ``x`` in f32 in rank order, rounded once
        to ``dtype``: a reduce-scatter of equal slices, then an all-gather
        of the rounded slices."""
        link = self.link(backward, x.device, stats)
        flat = x.reshape(-1)
        n = flat.numel()
        per = -(-n // self.size)
        flat = F.pad(flat, (0, per * self.size - n))
        mine = ordered_sum(link.all_to_all(list(flat.split(per)))).to(dtype)
        return torch.cat(link.all_gather(mine))[:n].reshape(x.shape)


def partial_leaf(path: str, tp: TensorParallel, seq: int) -> bool:
    """Whether the gradient of the parameter at ``path`` (``/``-joined) is
    partial on each model rank at ``seq`` positions: the attention leaves
    replicated over ``model`` that a rank uses for its heads or its block
    of positions only (case ``kv``: ``wk``, ``wv``; case ``seq``: ``wq``,
    ``wk``, ``wv``, MLA's ``wq_b`` and ``wkv_b``), and where the LRU width
    splits, the RG-LRU's per-channel leaves a rank slices
    (:data:`RG_SLICED`: its block nonzero, zeros elsewhere)."""
    parts = path.split("/")
    if parts[0] == "extra" or parts[:2] == ["triples", "rec"]:
        return (parts[-2] == "block" and parts[-1] in RG_SLICED
                and tp.splits(tp.lru_width))
    if "attn" not in parts:
        return False
    names = {"kv": ("wk", "wv"),
             "seq": ("wq", "wk", "wv", "wq_b", "wkv_b")}.get(tp.attention(seq), ())
    return parts[-1] in names


class _Region(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, stats):
        ctx.tp, ctx.stats = tp, stats
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum(g, g.dtype, True, ctx.stats), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dtype):
        ctx.in_dtype = x.dtype
        return tp.sum(x, dtype, backward=False)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.in_dtype), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim, stats):
        ctx.tp, ctx.dim, ctx.n = tp, dim, x.shape[dim]
        return torch.cat(tp.link(False, x.device, stats)
                         .all_gather(x.contiguous()), dim)

    @staticmethod
    def backward(ctx, g):
        mine = g.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n).contiguous()
        return mine, None, None, None


def region(x: torch.Tensor, tp: TensorParallel, stats=None) -> torch.Tensor:
    """``x`` as the input of a split region (its gradient summed over
    ``model``; the traffic counted into ``stats``, default ``tp.bwd``)."""
    return _Region.apply(x, tp, stats)


def reduce(x: torch.Tensor, tp: TensorParallel,
           dtype: torch.dtype) -> torch.Tensor:
    """The sum over ``model`` of every rank's ``x`` (a row-split product's
    part), rounded once to ``dtype``."""
    return _Reduce.apply(x, tp, dtype)


def gather(x: torch.Tensor, tp: TensorParallel, dim: int,
           stats=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    gradient of the whole is the same on every rank; a rank keeps its
    slice; the traffic counted into ``stats``, default ``tp.fwd``)."""
    return _Gather.apply(x, tp, dim, stats)


def row_product(a: torch.Tensor, w: torch.Tensor,
                tp: TensorParallel) -> torch.Tensor:
    """``a @ w`` where ``a``'s last dimension and ``w``'s rows are this
    rank's part of a split contraction: the f32 products of the bf16
    values, summed over ``model`` and rounded once to ``a``'s dtype."""
    return reduce(torch.matmul(a.float(), w.float()), tp, a.dtype)


def vocab_embedding(tokens: torch.Tensor, table: torch.Tensor,
                    tp: TensorParallel) -> torch.Tensor:
    """The rows of ``tokens`` from a table whose rows (the vocab) split over
    ``model``: this rank looks up the tokens of its range and zeros the
    others, and the parts are summed (exact: one part is not zero)."""
    vr = table.shape[0]
    local = tokens - tp.rank * vr
    mine = (local >= 0) & (local < vr)
    rows = F.embedding(torch.where(mine, local, torch.zeros_like(local)), table)
    return reduce(rows.masked_fill(~mine[..., None], 0), tp, table.dtype)


class _VocabLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, tp):
        x = logits.float()
        vr = x.shape[-1]
        local = labels.long() - tp.rank * vr
        mine = (local >= 0) & (local < vr)
        idx = torch.where(mine, local, torch.zeros_like(local))
        link = tp.link(False, x.device)
        m = torch.stack(link.all_gather(x.amax(-1))).amax(0)
        shifted = x - m[..., None]
        z = torch.where(mine, shifted.gather(-1, idx[..., None])[..., 0],
                        torch.zeros_like(m))
        s, z = ordered_sum(link.all_gather(
            torch.stack([torch.exp(shifted).sum(-1), z]))).unbind()
        log_s = torch.log(s)
        ctx.save_for_backward(shifted, log_s, mine, idx)
        ctx.in_dtype = logits.dtype
        return z - log_s

    @staticmethod
    def backward(ctx, g):
        shifted, log_s, mine, idx = ctx.saved_tensors
        grad = -torch.exp(shifted - log_s[..., None]) * g[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          torch.where(mine, g, torch.zeros_like(g))[..., None])
        return grad.to(ctx.in_dtype), None, None


def vocab_log_prob(logits: torch.Tensor, labels: torch.Tensor,
                   tp: TensorParallel) -> torch.Tensor:
    """``log_softmax(logits.float())`` at ``labels`` (f32, labels' shape),
    where ``logits`` holds this rank's columns of a vocab split over
    ``model``; the arithmetic of ``torch.log_softmax``: ``(x - max) -
    log(sum(exp(x - max)))``."""
    return _VocabLogProb.apply(logits, labels, tp)

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

Serving (the dense GQA, MLA and MoE families; ``serving/sharded.py``)
runs the same context without autograd.  The policy's cache splits its
sequence axis over ``model`` (``spec_for_cache``: a ``max_seq``-slot cache
in blocks of ``max_seq / model`` slots, every KV head or the whole latent
width, where ``max_seq`` divides; else replicated), which no attention
case leaves on a rank: :func:`prefill_cache_block` moves the prefill's K
and V there (an all-to-all of exactly the blocks that move,
``Link.all_to_all_v``, or a local slice; MLA's latents are whole on every
rank, a local slice), :func:`merge_partials` joins the ranks' partial
softmaxes of a decode step over their key blocks (GQA's
``layers.decode_attention_tp``, MLA's ``mla.mla_decode_tp``), and
:func:`vocab_argmax` takes the greedy token from a rank's vocab columns.

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


# ---------------------------------------------------------------------------
# serving: the cache's sequence split, partial attention, the greedy token
# ---------------------------------------------------------------------------

def cache_span(tp: TensorParallel, max_seq: int, rank: int = None) -> slice:
    """The cache positions group rank ``rank`` (default: this one) holds of
    a ``max_seq``-slot cache: its block where ``max_seq`` splits over
    ``model`` (the policy's ``spec_for_cache``), else all of them."""
    rank = tp.rank if rank is None else rank
    if not tp.splits(max_seq):
        return slice(0, max_seq)
    size = max_seq // tp.size
    return slice(rank * size, (rank + 1) * size)


def _clip(s: slice, lo: int, hi: int) -> slice:
    """``s`` cut to ``[lo, hi)`` (an empty slice where they do not meet)."""
    start = min(max(s.start, lo), hi)
    return slice(start, max(start, min(s.stop, hi)))


def prefill_cache_block(x: torch.Tensor, case: str, tp: TensorParallel,
                        seq: int, max_seq: int) -> torch.Tensor:
    """This rank's block of a ``max_seq``-slot cache leaf, (B, |span|, Hkv,
    hd) or (B, |span|, r) with zeros past the prompt's ``seq`` positions,
    from the K or V the attention ``case`` left on the rank, or an MLA
    latent (``x``):

    * ``heads``: the rank's KV heads over all ``seq`` positions; each rank
      sends every other its heads at that rank's span (an all-to-all), the
      heads concatenated in rank order;
    * ``kv`` and ``none``: every head over every position; a local slice;
    * ``seq``: every head over the positions up to the end of the rank's
      query block.  A rank takes the positions of its span inside query
      block ``i`` from itself for ``i`` up to its own (it holds them) and
      from rank ``i`` above it;
    * a 3-D latent (MLA's ``c_kv`` / ``k_rope``, B, S, r) is whole on every
      rank in every case: a local slice.

    The traffic (exactly the blocks that move) counts into ``tp.fwd``."""
    n = tp.size
    spans = [_clip(cache_span(tp, max_seq, r), 0, seq) for r in range(n)]
    mine = spans[tp.rank]
    if x.dim() == 3 or case in ("kv", "none"):
        real = x[:, mine]
    elif case == "heads":
        b, _, h, d = x.shape
        got = tp.link(False, x.device).all_to_all_v(
            [x[:, s].contiguous() for s in spans],
            [(b, mine.stop - mine.start, h, d)] * n)
        real = torch.cat(got, dim=2)
    elif case == "seq":
        b, _, h, d = x.shape
        qb = seq // n
        part = [[_clip(spans[j], i * qb, (i + 1) * qb) for i in range(n)]
                for j in range(n)]
        me = tp.rank
        got = tp.link(False, x.device).all_to_all_v(
            [x[:, part[j][me]].contiguous() if j < me else x[:, :0]
             for j in range(n)],
            [(b, part[me][i].stop - part[me][i].start, h, d) if i > me
             else (b, 0, h, d) for i in range(n)])
        real = torch.cat([x[:, part[me][i]] if i <= me else got[i]
                          for i in range(n)], dim=1)
    else:
        raise ValueError(f"unknown attention case {case!r}")
    span = cache_span(tp, max_seq)
    out = x.new_zeros((x.shape[0], span.stop - span.start)
                      + tuple(real.shape[2:]))
    out[:, :real.shape[1]] = real
    return out


def write_slot(block: torch.Tensor, slot: torch.Tensor, span: slice,
               new: torch.Tensor) -> None:
    """Write each row's ``new`` (B, ...) IN PLACE at cache slot ``slot``
    (B,) of a rank's ``block`` (B, |span|, ...) of the cache, for the rows
    whose slot lies in the rank's ``span``; every other row's block is left
    as it was (its value at the clamped slot read and written back).  No
    shape depends on the data: no host read."""
    rows = torch.arange(block.shape[0], device=block.device)
    mine = (slot >= span.start) & (slot < span.stop)
    at = torch.clamp(slot - span.start, 0, span.stop - span.start - 1)
    keep = mine.reshape((-1,) + (1,) * (new.dim() - 1))
    block[rows, at] = torch.where(keep, new.to(block.dtype), block[rows, at])


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   tp: TensorParallel) -> torch.Tensor:
    """Attention over keys split over ``model``: each rank's f32 running max
    ``m`` (...), sum ``l`` (...) and unnormalised ``acc`` (..., dv) over its
    keys, all-gathered and merged in rank order (each part rescaled to the
    largest max), then normalised: (..., dv) f32.  A rank that saw no key
    (``m`` = -1e30) adds exactly 0."""
    parts = tp.link(False, m.device).all_gather(
        torch.cat([m[..., None], l[..., None], acc], dim=-1).float())
    top = torch.stack([p[..., 0] for p in parts]).amax(0)
    tot_l = torch.zeros_like(top)
    tot = torch.zeros_like(acc, dtype=torch.float32)
    for p in parts:
        corr = torch.exp(p[..., 0] - top)
        tot_l = tot_l + p[..., 1] * corr
        tot = tot + p[..., 2:] * corr[..., None]
    return tot / torch.clamp(tot_l[..., None], min=1e-30)


def vocab_argmax(logits: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The greedy token (int64, ``logits.shape[:-1]``) of logits whose last
    dimension is this rank's columns of a vocab split over ``model``: each
    rank's largest value and its first index, all-gathered (value bits and
    global index in one int64 pair), and the first rank with the largest
    value wins, so a tie goes to the whole vocabulary's first index, as
    ``torch.argmax`` gives it."""
    vr = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[..., None])[..., 0].float()
    pair = torch.stack([val.view(torch.int32).to(torch.int64),
                        idx + tp.rank * vr], dim=-1)
    parts = tp.link(False, logits.device).all_gather(pair)
    best_v = parts[0][..., 0].to(torch.int32).view(torch.float32)
    best_i = parts[0][..., 1]
    for p in parts[1:]:
        v = p[..., 0].to(torch.int32).view(torch.float32)
        better = v > best_v
        best_v = torch.where(better, v, best_v)
        best_i = torch.where(better, p[..., 1], best_i)
    return best_i

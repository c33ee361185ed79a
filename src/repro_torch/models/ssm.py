"""Mamba-2 block on PyTorch: the SSD (state-space duality) chunked scan and
the recurrent decode step, the port of ``repro.models.ssm``.

The SSD algorithm of arXiv:2405.21060 (§6): the sequence is split into
chunks of ``cfg.chunk``; the intra-chunk terms are batched products, the
inter-chunk terms a small state recurrence over the chunks (a loop of
``S / chunk`` steps carrying (B, H, P, N)).  Decode is the exact one-step
SSM recurrence.  None of it is a Pallas kernel in the JAX package, so the
large products go to ``torch.einsum``.

Types follow JAX's promotion, which ``torch.einsum`` does not do: ``x *
dt`` is bf16 x f32 -> f32; ``(C B^T ∘ L)`` is rounded to bf16 before its
product with the f32 inputs; the decays and the carried states are rounded
to bf16 where the JAX code casts them (``astype(bc.dtype)``,
``astype(cc.dtype)``) and then promoted back to f32.  The transferred state
is (ssm f32 (B, H, P, N), conv bf16 (B, W-1, C)).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models.layers import rms_norm

BF16 = torch.bfloat16


class SSMState(NamedTuple):
    ssm: torch.Tensor     # (B, H, P, N) f32 recurrent state
    conv: torch.Tensor    # (B, conv_width-1, conv_channels) rolling buffer


def dims(d_model: int, cfg: SSMConfig):
    """(d_inner, heads, conv channels)."""
    d_inner = cfg.expand * d_model
    return d_inner, d_inner // cfg.head_dim, d_inner + 2 * cfg.n_groups * cfg.d_state


def init_mamba2(normal, nl: int, d_model: int, cfg: SSMConfig, device) -> dict:
    """One stack of ``nl`` Mamba-2 blocks with ``repro.models.ssm.init_mamba2``'s
    shapes and scales; ``normal(shape, scale)`` draws bf16."""
    d_inner, heads, conv_ch = dims(d_model, cfg)
    proj_out = 2 * d_inner + 2 * cfg.n_groups * cfg.d_state + heads
    a_log = torch.log(torch.linspace(1.0, 16.0, heads, dtype=torch.float32))
    return {
        "in_proj": normal((nl, d_model, proj_out), d_model ** -0.5),
        "conv_w": normal((nl, cfg.conv_width, conv_ch), 0.1),
        "conv_b": torch.zeros((nl, conv_ch), dtype=BF16, device=device),
        "A_log": a_log.to(device).expand(nl, heads).contiguous(),
        "D": torch.ones((nl, heads), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((nl, heads), dtype=torch.float32, device=device),
        "norm": torch.ones((nl, d_inner), dtype=BF16, device=device),
        "out_proj": normal((nl, d_inner, d_model), d_inner ** -0.5),
    }


def out_product(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The unsplit ``out_proj`` product ``y @ w`` (a split one is
    ``tensor_parallel.row_product``)."""
    return torch.matmul(y, w)


def _split_proj(zxbcdt, d_inner, n_groups, d_state, heads):
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * n_groups * d_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * n_groups * d_state:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq: (B, S, C) with (W, C) taps, each
    product and each partial sum rounded to bf16 in tap order (the JAX
    ``sum`` over bf16 terms), then bias and SiLU."""
    width = w.shape[0]
    pads = F.pad(xbc, (0, 0, width - 1, 0))
    s = xbc.shape[1]
    out = pads[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + pads[:, i:i + s] * w[i]
    return F.silu(out + b)


def segsum_exp(dacs: torch.Tensor) -> torch.Tensor:
    """exp(Σ decay) lower-triangular matrix within a chunk.

    dacs: (..., L, H) inclusive cumsum of dA.  Returns (..., L, L, H) with
    entry [i, j] = exp(dacs_i - dacs_j) for i >= j else 0; masked BEFORE the
    exp, as the JAX code does (the upper entries would overflow)."""
    li = dacs[..., :, None, :] - dacs[..., None, :, :]
    n = dacs.shape[-2]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dacs.device))
    li = torch.where(mask[..., :, :, None], li,
                     torch.tensor(float("-inf"), device=dacs.device))
    return torch.exp(li)


def ssd_scan(x, dt, a_log, b_mat, c_mat, cfg: SSMConfig,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    x (B, S, H, P) bf16, dt (B, S, H) f32 (softplus'd), a_log (H,) f32 (A =
    -exp(a_log)), b_mat / c_mat (B, S, G, N) bf16.  Returns (y (B, S, H, P)
    in x's dtype, final state (B, H, P, N) f32).  S that is not a multiple
    of the chunk is padded with zero-dt steps, which are exact no-ops
    (decay 1, input 0)."""
    bsz, s, h, p_ = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    q = cfg.chunk
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // q
    rep = h // g

    a = -torch.exp(a_log)                                  # (H,) negative
    da = dt * a                                            # (B, S, H)
    xd = x.float() * dt[..., None]                         # bf16 x f32 -> f32

    xc = xd.reshape(bsz, nc, q, h, p_)
    dac = da.reshape(bsz, nc, q, h)
    bc = torch.repeat_interleave(b_mat.reshape(bsz, nc, q, g, n), rep, dim=3)
    cc = torch.repeat_interleave(c_mat.reshape(bsz, nc, q, g, n), rep, dim=3)
    bcf, ccf = bc.float(), cc.float()

    dacs = torch.cumsum(dac, dim=2)                        # (B, C, Q, H)

    # 1) intra-chunk (diagonal blocks): Y_ii = (C_i B_j^T ∘ L_ij) X_j
    cb = torch.einsum("bclhn,bcmhn->bclmh", ccf, bcf)
    l_mat = segsum_exp(dacs)                               # (B, C, Q, Q, H)
    y_diag = torch.einsum("bclmh,bcmhp->bclhp",
                          (cb * l_mat).to(x.dtype).float(), xc)
    del cb, l_mat

    # 2) chunk states: B^T diag(decay) X
    decay_states = torch.exp(dacs[:, :, -1:, :] - dacs).to(bc.dtype).float()
    states = torch.einsum("bclhn,bclhp->bchpn", bcf * decay_states[..., None], xc)

    # 3) inter-chunk recurrence: a loop over the chunks
    chunk_decay = torch.exp(dacs[:, :, -1, :])             # (B, C, H)
    carry = (torch.zeros((bsz, h, p_, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)                                 # state BEFORE chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B, C, H, P, N)

    # 4) inter-chunk output: Y_off = C_i · S_prev · exp(dacs)
    state_decay = torch.exp(dacs).to(cc.dtype).float()
    y_off = torch.einsum("bclhn,bchpn->bclhp", ccf,
                         prev_states.to(cc.dtype).float()) * state_decay[..., None]

    y = (y_diag + y_off).reshape(bsz, nc * q, h, p_)[:, :s]
    return y.to(x.dtype), carry


def mamba2_forward(p, x: torch.Tensor, cfg: SSMConfig, d_model: int,
                   initial_state: Optional[SSMState] = None, tp=None
                   ) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence Mamba-2 block: (B, S, D) -> (B, S, D) + final state.

    Under ``tp`` (training's tensor parallelism) ``p["in_proj"]`` holds
    this rank's columns where its K splits over ``model`` and
    ``p["out_proj"]`` this rank's rows where d_inner splits, each on its
    own.  K concatenates z, x, B, C and dt, so a column block is no head
    group: the rank's ``in_proj`` product is gathered whole, the conv, the
    SSD scan, the ``D`` skip and the gated norm run whole on every rank
    (the replicated leaves get whole gradients, the same bits on every
    rank), and ``out_proj`` is a row product over the rank's d_inner
    rows."""
    d_inner, heads, _ = dims(d_model, cfg)
    bsz, s, _ = x.shape
    gn = cfg.n_groups * cfg.d_state
    in_split = tp is not None and tp.splits(2 * d_inner + 2 * gn + heads)
    out_split = tp is not None and tp.splits(d_inner)
    if in_split:
        zxbcdt = TP.gather(torch.matmul(TP.region(x, tp), p["in_proj"]), tp, -1)
    else:
        zxbcdt = torch.matmul(x, p["in_proj"])
    z, xbc, dt = _split_proj(zxbcdt, d_inner, cfg.n_groups, cfg.d_state, heads)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_inner].reshape(bsz, s, heads, cfg.head_dim)
    b_mat = xbc[..., d_inner: d_inner + gn].reshape(bsz, s, cfg.n_groups, cfg.d_state)
    c_mat = xbc[..., d_inner + gn:].reshape(bsz, s, cfg.n_groups, cfg.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"])

    init = initial_state.ssm if initial_state is not None else None
    y, final = ssd_scan(xs, dt, p["A_log"], b_mat, c_mat, cfg, initial_state=init)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(bsz, s, d_inner)
    y = rms_norm(y * F.silu(z), p["norm"])
    if out_split:
        # the region first: the rank's rows' gradient comes back whole
        y_blk = TP.region(y, tp)[..., tp.block(d_inner)]
        out = TP.row_product(y_blk, p["out_proj"], tp)
    else:
        out = out_product(y, p["out_proj"])

    # conv state for decode continuation: the last (width-1) PRE-conv xBC
    tail = zxbcdt[:, -(cfg.conv_width - 1):, :]
    _, xbc_tail, _ = _split_proj(tail, d_inner, cfg.n_groups, cfg.d_state, heads)
    return out, SSMState(ssm=final, conv=xbc_tail)


def mamba2_decode(p, x: torch.Tensor, state: SSMState, cfg: SSMConfig,
                  d_model: int) -> Tuple[torch.Tensor, SSMState]:
    """Single-token recurrence: x (B, 1, D).  The conv over the rolling
    window sums its f32 products and rounds once (the JAX einsum's)."""
    d_inner, heads, _ = dims(d_model, cfg)
    bsz = x.shape[0]
    gn = cfg.n_groups * cfg.d_state
    zxbcdt = torch.matmul(x, p["in_proj"])[:, 0]                     # (B, K)
    z, xbc_new, dt = _split_proj(zxbcdt, d_inner, cfg.n_groups, cfg.d_state, heads)

    window = torch.cat([state.conv, xbc_new[:, None, :]], dim=1)     # (B, W, C)
    conv_out = (window.float() * p["conv_w"].float()).sum(dim=1).to(x.dtype) \
        + p["conv_b"]
    xbc = F.silu(conv_out)
    xs = xbc[..., :d_inner].reshape(bsz, heads, cfg.head_dim)
    b_vec = xbc[..., d_inner: d_inner + gn].reshape(bsz, cfg.n_groups, cfg.d_state)
    c_vec = xbc[..., d_inner + gn:].reshape(bsz, cfg.n_groups, cfg.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"])                       # (B, H)

    a = -torch.exp(p["A_log"])
    da = torch.exp(dt * a)                                           # (B, H)
    rep = heads // cfg.n_groups
    bh = torch.repeat_interleave(b_vec, rep, dim=1).float()          # (B, H, N)
    ch = torch.repeat_interleave(c_vec, rep, dim=1).float()
    xd = xs.float() * dt[..., None]
    new_ssm = state.ssm * da[:, :, None, None] + xd[..., None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, ch)
    y = y + p["D"][None, :, None] * xs.float()
    y = y.reshape(bsz, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = out_product(y, p["out_proj"])[:, None, :]
    return out, SSMState(ssm=new_ssm, conv=window[:, 1:, :])


def state_block(state: SSMState, cfg: SSMConfig, d_model: int, tp
                ) -> SSMState:
    """This rank's block of a whole state under the policy's cache rules
    (``spec_for_cache``): ``ssm`` its heads where H splits over ``model``,
    ``conv`` its channels where C splits, each on its own."""
    _, heads, conv_ch = dims(d_model, cfg)
    ssm, conv = state.ssm, state.conv
    if tp.splits(heads):
        ssm = ssm[:, tp.block(heads)]
    if tp.splits(conv_ch):
        conv = conv[..., tp.block(conv_ch)]
    return SSMState(ssm=ssm.contiguous(), conv=conv.contiguous())


def mamba2_decode_tp(p, x: torch.Tensor, state: SSMState, cfg: SSMConfig,
                     d_model: int, tp) -> Tuple[torch.Tensor, SSMState]:
    """:func:`mamba2_decode` on this rank's shards and state blocks
    (:func:`state_block`'s layout): x (B, 1, D) whole on every model rank.

    * ``in_proj``: where its K splits, the rank's columns' product is
      all-gathered (collective 1), so z, x, B, C and dt are whole;
    * the conv step runs on the rank's C block with its conv state and
      the block's taps and bias: each channel's f32 sum over the window is
      rounded once, so the block holds the whole step's bits at those
      channels; where C splits the post-conv block is all-gathered
      (collective 2), whole x, B and C on every rank (a C block is no head
      group: C concatenates x, B and C);
    * the SSM step updates the rank's heads of ``ssm`` (every head where H
      does not split): decays, inputs and the read-out in f32, each head
      as the whole step computes it; its heads' ``y`` rounded to bf16 and
      all-gathered where H splits (collective 3);
    * the gated norm runs over all of d_inner on every rank (the same
      bits); ``out_proj`` is a row product over the rank's d_inner rows
      where d_inner splits: f32 products summed over ``model`` in rank
      order and rounded once (a reduce-scatter and an all-gather,
      collectives 4-5), else the whole bf16 product.

    Each split is taken where its dimension divides ``model``, each on its
    own (at mamba2-2.7b, model 2, all five; reduced at model 3 only C's).
    The collectives count into ``tp.fwd``.  Returns the output (B, 1, D),
    whole on every rank, and the rank's new state blocks."""
    d_inner, heads, conv_ch = dims(d_model, cfg)
    bsz = x.shape[0]
    gn = cfg.n_groups * cfg.d_state
    k = 2 * d_inner + 2 * gn + heads
    zxbcdt = torch.matmul(x, p["in_proj"])[:, 0]                     # (B, K/k)
    if tp.splits(k):
        zxbcdt = TP.gather(zxbcdt, tp, -1)
    z, xbc_new, dt = _split_proj(zxbcdt, d_inner, cfg.n_groups, cfg.d_state, heads)

    cblk = tp.block(conv_ch) if tp.splits(conv_ch) else slice(0, conv_ch)
    window = torch.cat([state.conv, xbc_new[:, None, cblk]], dim=1)  # (B, W, c)
    conv_out = (window.float() * p["conv_w"][:, cblk].float()).sum(dim=1) \
        .to(x.dtype) + p["conv_b"][cblk]
    xbc = F.silu(conv_out)
    if tp.splits(conv_ch):
        xbc = TP.gather(xbc, tp, -1)
    hblk = tp.block(heads) if tp.splits(heads) else slice(0, heads)
    hl = hblk.stop - hblk.start
    xs = xbc[..., :d_inner].reshape(bsz, heads, cfg.head_dim)[:, hblk]
    b_vec = xbc[..., d_inner: d_inner + gn].reshape(bsz, cfg.n_groups, cfg.d_state)
    c_vec = xbc[..., d_inner + gn:].reshape(bsz, cfg.n_groups, cfg.d_state)
    dt = F.softplus(dt[:, hblk].float() + p["dt_bias"][hblk])         # (B, h)

    a = -torch.exp(p["A_log"][hblk])
    da = torch.exp(dt * a)
    group = torch.arange(hblk.start, hblk.stop, device=x.device) \
        // (heads // cfg.n_groups)
    bh = b_vec[:, group].float()                                     # (B, h, N)
    ch = c_vec[:, group].float()
    xd = xs.float() * dt[..., None]
    new_ssm = state.ssm * da[:, :, None, None] + xd[..., None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, ch)
    y = y + p["D"][hblk][None, :, None] * xs.float()
    y = y.reshape(bsz, hl * cfg.head_dim).to(x.dtype)
    if tp.splits(heads):
        y = TP.gather(y, tp, -1)
    y = rms_norm(y * F.silu(z), p["norm"])
    if tp.splits(d_inner):
        out = TP.row_product(y[:, tp.block(d_inner)], p["out_proj"], tp)
    else:
        out = out_product(y, p["out_proj"])
    return out[:, None, :], SSMState(ssm=new_ssm, conv=window[:, 1:, :])

"""Griffin / RecurrentGemma recurrent block on PyTorch: conv1d + RG-LRU, the
port of ``repro.models.rglru``.

RG-LRU (arXiv:2402.19427):
    r_t = σ(W_a x_t + b_a)                      (recurrence gate)
    i_t = σ(W_x x_t + b_x)                      (input gate)
    a_t = exp(-c · softplus(Λ) · r_t),  c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

Prefill evaluates the linear recurrence with a log-depth (Hillis–Steele)
scan over the sequence axis: ``log2(S)`` rounds of tensor operations, not a
Python loop over the positions.  ``jax.lax.associative_scan`` combines in
another tree, so the two agree to f32 rounding, not bitwise.  Decode is the
exact one-step update.  The recurrent state (B, lru_width) f32 and the
conv's last ``conv_width - 1`` inputs are the transferred state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as TP

RGLRU_C = 8.0
BF16 = torch.bfloat16


def init_rglru_block(normal, lead: tuple, d_model: int, lru_width: int,
                     conv_width: int, device) -> dict:
    """Recurrent blocks stacked over ``lead`` with
    ``repro.models.rglru.init_rglru_block``'s shapes and scales;
    ``normal(shape, scale)`` draws bf16."""
    s, su = d_model ** -0.5, lru_width ** -0.5
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, lru_width,
                                              dtype=np.float32)) / RGLRU_C))
    lam = torch.as_tensor(lam.astype(np.float32), device=device)

    def zeros(n, dt):
        return torch.zeros(lead + (n,), dtype=dt, device=device)

    return {
        "w_gate_branch": normal(lead + (d_model, lru_width), s),
        "w_in": normal(lead + (d_model, lru_width), s),
        "conv_w": normal(lead + (conv_width, lru_width), 0.1),
        "conv_b": zeros(lru_width, BF16),
        "w_a": normal(lead + (lru_width, lru_width), su),
        "b_a": zeros(lru_width, torch.float32),
        "w_x": normal(lead + (lru_width, lru_width), su),
        "b_x": zeros(lru_width, torch.float32),
        "lam": lam.expand(lead + (lru_width,)).contiguous(),
        "w_out": normal(lead + (lru_width, d_model), su),
    }


def _gates(p, x: torch.Tensor, x_blk: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., U) post-conv activations -> (a, gated input), both f32.
    With ``x_blk`` (tensor parallelism) the gates are those of a block of
    channels: ``x`` is read whole by the products with the block's columns
    of ``w_a`` / ``w_x`` and ``p``'s vectors are the block's, and the
    gated input is ``x_blk``'s."""
    x_blk = x if x_blk is None else x_blk
    r = torch.sigmoid(torch.matmul(x, p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid(torch.matmul(x, p["w_x"]).float() + p["b_x"])
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) in f32, numerically guarded
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * x_blk.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` (h_{-1} = 0) along
    ``dim``, Hillis–Steele: round ``k`` combines each position with the one
    ``2**k`` before it, ``(a1, b1) ∘ (a2, b2) = (a1 a2, a2 b1 + b2)``.
    Returns the scanned (a, h)."""
    n = a.shape[dim]
    off = 1
    while off < n:
        a_prev = a.narrow(dim, 0, n - off)
        b_prev = b.narrow(dim, 0, n - off)
        a_cur = a.narrow(dim, off, n - off)
        b_cur = b.narrow(dim, off, n - off)
        b = torch.cat([b.narrow(dim, 0, off), a_cur * b_prev + b_cur], dim=dim)
        a = torch.cat([a.narrow(dim, 0, off), a_prev * a_cur], dim=dim)
        off *= 2
    return a, b


def rglru_scan(p, x: torch.Tensor, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, U) -> (h (B, S, U) in x's dtype, final state (B, U) f32)."""
    a, b = _gates(p, x)
    if h0 is not None:
        # fold the initial state in as a virtual step 0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0.float()[:, None], b], dim=1)
    _, hh = linear_scan(a, b, dim=1)
    if h0 is not None:
        hh = hh[:, 1:]
    return hh.to(x.dtype), hh[:, -1]


def rglru_step(p, x_t: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B, U), h: (B, U) -> (out in x_t's dtype, new h f32)."""
    a, b = _gates(p, x_t)
    new_h = a * h.float() + b
    return new_h.to(x_t.dtype), new_h


def out_product(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The unsplit ``w_out`` product ``y @ w`` (a split one is
    ``tensor_parallel.row_product``)."""
    return torch.matmul(y, w)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv (B, S, U) with (W, U) taps: each product and
    partial sum rounded to x's dtype in tap order (the JAX ``sum``), then
    the bias."""
    width, s = w.shape[0], x.shape[1]
    pads = F.pad(x, (0, 0, width - 1, 0))
    out = pads[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + pads[:, i:i + s] * w[i]
    return out + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def recurrent_block_forward(p, x: torch.Tensor, state: Optional[dict] = None,
                            tp=None) -> Tuple[torch.Tensor, dict]:
    """Griffin recurrent block over a full sequence: x (B, S, D) -> (out,
    {"h": (B, U) f32, "conv": (B, conv_width-1, U) pre-conv inputs}).

    Under ``tp`` (training's tensor parallelism, the LRU width U split
    over ``model``) ``p`` holds this rank's columns of ``w_gate_branch``,
    ``w_in``, ``w_a`` and ``w_x`` and its rows of ``w_out`` (:func:`_tp_forward`)."""
    if tp is not None:
        return _tp_forward(p, x, tp)
    gate = _gelu(torch.matmul(x, p["w_gate_branch"]))
    u = torch.matmul(x, p["w_in"])
    uc = _causal_conv(u, p["conv_w"], p["conv_b"])
    hseq, h_last = rglru_scan(p, uc, h0=state["h"] if state is not None else None)
    out = out_product(hseq * gate, p["w_out"])
    width = p["conv_w"].shape[0]
    return out, {"h": h_last, "conv": u[:, -(width - 1):, :]}


def _tp_forward(p, x: torch.Tensor, tp) -> Tuple[torch.Tensor, dict]:
    """The recurrent block on this rank's block of U channels.  After the
    products everything is per channel (the conv rounds a channel's taps
    in order, the gates and the scan are elementwise), so the block's
    gate branch, conv, gates and scan are the whole block's bits at those
    channels: the conv takes the block's slice of the replicated
    ``conv_w`` / ``conv_b``, and the gates the block's ``b_a``, ``b_x``
    and ``lam`` (their gradients are partial: the block here, zeros
    elsewhere; ``tensor_parallel.partial_leaf``).  The ``w_a`` / ``w_x``
    products read the post-conv activations whole: the block is gathered
    over ``model`` under a :func:`~TP.region`, whose backward sums the
    ranks' partial gradients so that the gather's backward slices a whole
    one.  ``w_out`` is a row product over the block.  The state returned
    is the block's."""
    blk = tp.block(tp.lru_width)
    xr = TP.region(x, tp)
    gate = _gelu(torch.matmul(xr, p["w_gate_branch"]))
    u = torch.matmul(xr, p["w_in"])
    uc = _causal_conv(u, p["conv_w"][:, blk], p["conv_b"][blk])
    whole = TP.region(TP.gather(uc, tp, -1), tp)
    gp = {"w_a": p["w_a"], "w_x": p["w_x"], "b_a": p["b_a"][blk],
          "b_x": p["b_x"][blk], "lam": p["lam"][blk]}
    a, b = _gates(gp, whole, uc)
    _, hh = linear_scan(a, b, dim=1)
    out = TP.row_product(hh.to(uc.dtype) * gate, p["w_out"], tp)
    width = p["conv_w"].shape[0]
    return out, {"h": hh[:, -1], "conv": u[:, -(width - 1):, :]}


def recurrent_block_step(p, x: torch.Tensor, state: dict
                         ) -> Tuple[torch.Tensor, dict]:
    """Single decode step: x (B, 1, D).  The conv over the rolling window
    sums its f32 products and rounds once (the JAX einsum's)."""
    gate = _gelu(torch.matmul(x, p["w_gate_branch"]))[:, 0]
    u = torch.matmul(x, p["w_in"])[:, 0]                           # (B, U)
    window = torch.cat([state["conv"], u[:, None, :]], dim=1)
    uc = (window.float() * p["conv_w"].float()).sum(dim=1).to(x.dtype) \
        + p["conv_b"]
    h_out, h_new = rglru_step(p, uc, state["h"])
    out = out_product(h_out * gate, p["w_out"])[:, None, :]
    return out, {"h": h_new, "conv": window[:, 1:, :]}


def recurrent_block_step_tp(p, x: torch.Tensor, state: dict, tp
                            ) -> Tuple[torch.Tensor, dict]:
    """:func:`recurrent_block_step` on this rank's block of the LRU width U
    (split over ``model``; where U does not split, call
    :func:`recurrent_block_step` on the whole): x (B, 1, D) whole on every
    model rank, ``p`` the rank's columns of ``w_gate_branch``, ``w_in``,
    ``w_a`` and ``w_x`` and rows of ``w_out`` (``conv_w``, ``conv_b``,
    ``b_a``, ``b_x`` and ``lam`` whole, sliced to the block), ``state`` the
    block's ``h`` (B, U/m) f32 and ``conv`` (B, W-1, U/m).  As in
    training's :func:`_tp_forward`, everything after the products is per
    channel: the gate branch and ``w_in`` products are the block's
    columns, the conv step sums the block's window in f32 and rounds once
    (the whole step's bits at those channels), the post-conv block is
    all-gathered (the one collective before ``w_out``) for the ``w_a`` /
    ``w_x`` products, whose columns are the block's, and ``rglru_step``
    updates the block's ``h``.  ``w_out`` is a row product over the block:
    f32 products summed over ``model`` in rank order, rounded once (a
    reduce-scatter and an all-gather).  The collectives count into
    ``tp.fwd``.  Returns the output (B, 1, D), whole on every rank, and
    the block's new state."""
    blk = tp.block(tp.lru_width)
    gate = _gelu(torch.matmul(x, p["w_gate_branch"]))[:, 0]        # (B, U/m)
    u = torch.matmul(x, p["w_in"])[:, 0]
    window = torch.cat([state["conv"], u[:, None, :]], dim=1)
    uc = (window.float() * p["conv_w"][:, blk].float()).sum(dim=1) \
        .to(x.dtype) + p["conv_b"][blk]
    gp = {"w_a": p["w_a"], "w_x": p["w_x"], "b_a": p["b_a"][blk],
          "b_x": p["b_x"][blk], "lam": p["lam"][blk]}
    a, b = _gates(gp, TP.gather(uc, tp, -1), uc)
    h_new = a * state["h"].float() + b
    out = TP.row_product(h_new.to(uc.dtype) * gate, p["w_out"], tp)
    return out[:, None, :], {"h": h_new, "conv": window[:, 1:, :]}

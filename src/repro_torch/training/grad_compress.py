"""Compressed cross-pod gradient all-reduce (the port of
``repro.training.grad_compress``).

Hierarchical data parallelism at multi-pod scale: within a pod, gradients
reduce over the fast fabric; across pods they cross the slow link.  Pod
gradients are bf16, so the SplitZip codec applies verbatim and losslessly:
no optimization semantics change; the only numerics are the f32 adds any
all-reduce performs.

A thin policy layer over the bulk-data plane: the caller stacks pod-partial
gradients on a leading pod dimension, a cached
:class:`~repro_torch.serving.plan.TransferPlan` routes each leaf (bf16 at
or above ``MIN_COMPRESS_ELEMS`` per participant -> the splitzip stream,
everything else raw), and the session's collective executor
(``session.ring_reduce``) runs the rotating ring over the compressed
streams on ``torch.distributed``.  No codec or wire calls live here;
per-step accounting surfaces as a
:class:`~repro_torch.serving.plan.TransferStats` in ``last_stats``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import codebook as cbm
from repro_torch.core import tree as TR
from repro_torch.core.codebook import (Codebook,
                                       DEFAULT_BF16_CODEBOOK as DEFAULT_GRAD_CODEBOOK)
from repro_torch.core.profile import resolve_profile
from repro_torch.launch.mesh import mesh_shape
from repro_torch.serving.plan import TransferConfig, TransferPlan, TransferStats

# Leaves smaller than this ship raw: codec framing would not pay for itself.
# Applied per ring participant via TransferConfig.min_compress_elems.
MIN_COMPRESS_ELEMS = 16384

#: TransferStats of the most recent ``compressed_cross_pod_mean`` exchange
#: (None until the first multi-pod call; single-pod meshes cross no link).
last_stats: Optional[TransferStats] = None

_SESSIONS: Dict[Tuple, Any] = {}


def gradient_transfer_config(codebook: Codebook = DEFAULT_GRAD_CODEBOOK,
                             compress: bool = True) -> TransferConfig:
    """Routing policy for gradient pytrees: bf16 leaves at or above
    ``MIN_COMPRESS_ELEMS`` ride the splitzip stream, small and other-dtype
    leaves go raw, and fp32 stays raw (the ring takes no hi/lo split).
    The codec is ``auto``: the CUDA kernels for gradients on the card,
    their plain versions for gradients on the CPU."""
    return TransferConfig(codebook=codebook, enabled=compress,
                          compress_fp32=False, backend="auto",
                          min_compress_elems=MIN_COMPRESS_ELEMS)


def calibrate_on_grads(grads, k: int = 16) -> Codebook:
    """Offline calibration pass over a representative gradient pytree."""
    leaves = [g.detach().to(torch.bfloat16).reshape(-1).view(torch.int16)
              .cpu().numpy().view(np.uint16) for g in TR.leaves(grads)]
    return cbm.calibrate(leaves, k=k)


def _session(grads_stacked, mesh, codebook: Codebook, compress: bool,
             device):
    """Session cache: the plan is a property of (structure, mesh, policy),
    not of the step."""
    flat, treedef = TR.flatten_with_path(grads_stacked)
    key = (treedef, tuple((tuple(x.shape), str(x.dtype)) for _, x in flat),
           id(mesh), codebook, compress, str(device))
    sess = _SESSIONS.get(key)
    if sess is None:
        plan = TransferPlan.build(
            grads_stacked, gradient_transfer_config(codebook, compress),
            mesh=mesh, specs=tuple(("pod",) for _ in flat))
        sess = plan.session(device=device)
        _SESSIONS[key] = sess
    return sess


def compressed_cross_pod_mean(grads_stacked, mesh,
                              codebook: Codebook = DEFAULT_GRAD_CODEBOOK,
                              compress: bool = True):
    """(n_pod, ...)-stacked pod-partial grads -> mean grads, on every rank of
    ``mesh`` (a ``DeviceMesh``; every rank passes the stacked tree and
    contributes its pod's row).  Output leaves drop the pod dimension."""
    global last_stats
    if "pod" not in (mesh.mesh_dim_names or ()):
        # single-pod mesh: nothing to exchange, just average the leading dim
        return TR.unflatten(TR.flatten_with_path(grads_stacked)[1], [
            torch.mean(g.to(torch.float32), dim=0).to(g.dtype)
            for g in TR.leaves(grads_stacked)])
    leaves = TR.leaves(grads_stacked)
    device = leaves[0].device if leaves else None
    sess = _session(grads_stacked, mesh, codebook, compress, device)
    out = sess.ring_reduce(grads_stacked, axis="pod", mean=True)
    last_stats = sess.last_stats
    return out


def compressed_cross_pod_mean_own(grads, mesh,
                                  codebook: Codebook = DEFAULT_GRAD_CODEBOOK,
                                  compress: bool = True):
    """``compressed_cross_pod_mean`` from this rank's own pod gradients:
    every rank of ``mesh`` passes its pod's row alone, since the ring reads
    no other row of the stacked tree.  The plan and session are those of
    the stacked tree (built from its shapes, on the meta device)."""
    global last_stats
    if "pod" not in (mesh.mesh_dim_names or ()):
        return grads            # one pod: its gradients are the mean
    n = mesh_shape(mesh)["pod"]
    flat, treedef = TR.flatten_with_path(grads)
    like = TR.unflatten(treedef, [
        torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device="meta")
        for _, x in flat])
    device = flat[0][1].device if flat else None
    sess = _session(like, mesh, codebook, compress, device)
    out = sess.ring_reduce_own(grads, axis="pod", mean=True)
    last_stats = sess.last_stats
    return out


def cross_pod_wire_bytes(grads, n_pod: int = 2, compress: bool = True,
                         profile: str = "paper",
                         codebook: Codebook = DEFAULT_GRAD_CODEBOOK,
                         link_bw: float = 1.0) -> float:
    """Analytic link bytes per step for the ring exchange (for reports):
    the byte classes from the gradient plan's route table, the ratio from
    the resolved codec profile (the paper's figures, or a calibration)."""
    plan = TransferPlan.build(grads, gradient_transfer_config(
        codebook, compress), granularity="tensor")
    ratio = (resolve_profile(profile, link_bw=link_bw).ratio
             if compress else 1.0)
    return plan.collective_wire_bytes(ratio, n_hops=n_pod - 1)

"""The training step: loss -> gradients -> (optionally compressed)
cross-pod mean -> AdamW (the port of ``repro.training.train_step``).

Two gradient modes:

* ``grad_compress=False``: the loss of one process's global batch,
  ``backward`` and the update.
* ``grad_compress=True`` on a mesh with a ``pod`` axis
  (``launch/mesh.py:make_mesh``, one process a pod): rank ``r`` takes pod
  ``r``'s slice of the global batch (the JAX step's pod split), computes
  its pod's gradients and averages them across pods through the
  compressed ring (``training/grad_compress.py``).  The JAX step stacks
  the pods' gradients on a leading pod dimension; the ring reads only a
  rank's own row, so each rank hands it its own gradients
  (``compressed_cross_pod_mean_own``).  The metrics are each pod's,
  averaged across the ranks.

Gradients keep the parameter dtype, as ``jax.grad`` returns them: bf16
gradients ride the codec, f32 ones (the MoE router, the SSM's ``A_log``, …)
ship raw.  Attention in training is ``layers.chunked_attention`` under
autograd (``models.model.loss_fn``), never the flash kernel.

``jit_train_step`` (ahead-of-time compilation with in/out shardings) and
the ``ShardingPolicy`` it takes are JAX-only: the step here runs eagerly,
replicated on every rank.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as TR
from repro_torch.core.codebook import Codebook
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models import model as M
from repro_torch.training import grad_compress as GC
from repro_torch.training import optimizer as OPT


class TrainState(NamedTuple):
    params: dict
    opt: OPT.AdamWState


def init_state(cfg: ArchConfig, generator: torch.Generator,
               device=None) -> TrainState:
    """Seeded parameters (``models.model.init_params``) and a fresh AdamW
    state, on ``device`` (default: the generator's)."""
    params = M.init_params(cfg, generator, device)
    return TrainState(params=params, opt=OPT.init(params))


def value_and_grad(params, batch: Dict, cfg: ArchConfig, *,
                   kv_block: int = 1024, remat: bool = True):
    """``((total, (ce, aux)), grads)``: ``loss_fn`` and its gradients in
    the parameters' dtypes (zeros for a parameter the loss does not
    reach), as ``jax.value_and_grad(loss_fn, has_aux=True)`` returns."""
    flat, treedef = TR.flatten_with_path(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    with torch.enable_grad():
        total, (ce, aux) = M.loss_fn(TR.unflatten(treedef, leaves), batch,
                                     cfg, kv_block=kv_block, remat=remat)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
    return ((total.detach(), (ce.detach(), aux.detach())),
            TR.unflatten(treedef, list(grads)))


def make_train_step(cfg: ArchConfig,
                    opt_cfg: OPT.AdamWConfig = OPT.AdamWConfig(),
                    mesh=None, *, grad_compress: bool = False,
                    grad_codebook: Codebook = GC.DEFAULT_GRAD_CODEBOOK,
                    kv_block: int = 1024, remat: bool = True):
    """``step(state, batch) -> (state, metrics)``; metrics are 0-d tensors
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``.  ``mesh`` is a
    ``DeviceMesh`` over an initialised group; it matters only with
    ``grad_compress``."""
    n_pod = mesh_shape(mesh).get("pod", 1) if mesh is not None else 1

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if grad_compress and n_pod > 1:
            r = mesh.get_local_rank("pod")
            mine = {k: x.reshape(n_pod, x.shape[0] // n_pod, *x.shape[1:])[r]
                    for k, x in batch.items()}
            (total, (ce, aux)), g = value_and_grad(
                state.params, mine, cfg, kv_block=kv_block, remat=remat)
            grads = GC.compressed_cross_pod_mean_own(
                g, mesh, codebook=grad_codebook)
            del g
            m = torch.stack([total, ce, aux]).to("cpu", torch.float32)
            dist.all_reduce(m, group=mesh.get_group("pod"))
            total, ce, aux = (m / n_pod).to(total.device).unbind()
        else:
            (total, (ce, aux)), grads = value_and_grad(
                state.params, batch, cfg, kv_block=kv_block, remat=remat)
        params, opt, om = OPT.update(opt_cfg, grads, state.opt, state.params)
        metrics = {"loss": total, "ce": ce, "aux": aux, **om}
        return TrainState(params=params, opt=opt), metrics

    return step

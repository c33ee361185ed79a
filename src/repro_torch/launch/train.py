"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs real optimizer steps: the config, the synthetic data stream, the train
step, SplitZip-compressed checkpoints (``--ckpt-dir``, ``--ckpt-every``,
``--resume``) and, across processes, the compressed cross-pod gradient
mean (``--grad-compress``).  Runs on the card unless ``--device`` names
another (``--device cpu`` runs the codec kernels' plain versions); without
CUDA and without ``--device`` it raises.  Weights and data come from
``--seed``.

``--mesh N`` or ``--mesh N,D,M`` trains across N pods of D data ranks of
M model ranks, one process a rank over gloo (``N·D·M`` processes), under
the sharding policy the JAX launcher builds,
``ShardingPolicy(make_mesh((N, D, M), ("pod", "data", "model")))``
(``distributed/sharding.py``; the sharded step of
``training/train_step.py``): the global batch splits over the pod and
data ranks and the gradients sum over ``data`` in f32; with
``--grad-compress`` pods average them through the compressed ring,
without it the sum goes on over ``pod`` in f32, as the JAX launcher's
step averages over pod and data.  ``M > 1`` is tensor parallelism
(``distributed/tensor_parallel.py``) for every family: dense, MLA, MoE
(split by experts, ``distributed/expert_parallel.py``), the front ends,
Mamba-2 and the RG-LRU hybrid.  A MoE config routes over the
ranks that share one loss (pods and data, or a pod's data ranks under
the ring), as the JAX step's global-batch FFN does.  The JAX
launcher's ``--mesh D,M`` has no pod axis: here ``N,D,M`` always names
all three (and a single ``N`` the pods).  A launch by ``torchrun`` sets
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``::

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch smollm-135m --reduced --mesh 1,2,1
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-135m --reduced --mesh 2,2,1 --grad-compress
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-135m --mesh 1,2,2
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen3-moe-30b-a3b --reduced --mesh 2
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch mamba2-2.7b --reduced --mesh 1,1,2

Rank 0 prints and writes the checkpoints (the gathered state, which the
unsharded trainer and the JAX ``Checkpointer`` load); every rank restores
and takes its shards.  The JAX launcher has no FSDP flag, so neither has
this one: ``make_run(policy=ShardingPolicy(..., fsdp=True))`` trains with
parameters and moments sharded over ``data``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeConfig, get_config
from repro_torch.core.codebook import Codebook
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.distributed import checkpoint as CKPT
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.launch.mesh import make_mesh
from repro_torch.training import grad_compress as GC
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_step as TS
from repro_torch.training.data import DataConfig, SyntheticTokenStream


def opt_config(lr: float, steps: int) -> OPT.AdamWConfig:
    """The launcher's AdamW: cosine over the run, a tenth of it warm-up."""
    return OPT.AdamWConfig(lr=lr, total_steps=max(steps, 2),
                           warmup_steps=max(steps // 10, 1))


def parse_mesh(spec: str) -> Tuple[int, int, int]:
    """``N`` or ``N,D,M`` -> ``(N, D, M)``: N pods of D data ranks of M
    model ranks (``N`` alone: ``(N, 1, 1)``)."""
    dims = tuple(int(x) for x in spec.split(","))
    if len(dims) not in (1, 3) or any(d < 1 for d in dims):
        raise SystemExit(f"--mesh {spec!r}: give N pods or N,D,M "
                         "(pod, data, model)")
    return dims if len(dims) == 3 else (dims[0], 1, 1)


def make_run(cfg: ArchConfig, *, batch: int, seq: int, lr: float, steps: int,
             seed: int = 0, device: DeviceLike = None,
             policy: Optional[ShardingPolicy] = None,
             grad_compress: bool = False,
             grad_codebook: Codebook = GC.DEFAULT_GRAD_CODEBOOK,
             donate: bool = False, kv_block: Optional[int] = None):
    """The launcher's training run: ``(state, step_at)`` with
    ``step_at(state, step) -> (state, metrics)`` the train step on the
    data stream's batch ``step``.  Parameters and data come from
    ``seed``.  Under ``policy`` the state is this rank's shards, drawn leaf
    by leaf and cut at once (``TS.init_state(policy=)``, bitwise
    ``TS.shard_state`` of the whole state), and every rank draws the
    global batch.  The
    launcher averages gradients under the default gradient codebook;
    ``grad_codebook`` lets a caller hand the ring one calibrated on its
    own gradients (``GC.calibrate_on_grads``).  ``donate``: each step
    updates the state it is given in place (``TS.make_train_step``).
    ``kv_block``: the attention's key block (default ``min(seq, 1024)``)."""
    device = resolve_device(device)
    shape = ShapeConfig("cli", seq_len=seq, global_batch=batch, kind="train")
    step_fn = TS.make_train_step(cfg, opt_config(lr, steps), policy,
                                 grad_compress=grad_compress,
                                 grad_codebook=grad_codebook,
                                 kv_block=kv_block or min(seq, 1024),
                                 donate=donate)
    data = SyntheticTokenStream(cfg, shape, DataConfig(seed=seed), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = TS.init_state(cfg, gen, device, policy)

    def step_at(state, step: int):
        return step_fn(state, data.batch_at(step))

    return state, step_at


def _join_group(world: int, device: Optional[str]):
    """The process group of a ``torchrun`` launch and this rank's device."""
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit(f"--mesh of {world} ranks runs one process a rank: "
                         f"launch with torchrun --nproc-per-node {world}")
    if not dist.is_initialized():
        dist.init_process_group("gloo")
    if dist.get_world_size() != world:
        raise SystemExit(f"--mesh needs {world} processes; "
                         f"torchrun started {dist.get_world_size()}")
    if device is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = f"cuda:{local % torch.cuda.device_count()}"
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU scale)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="N or N,D,M: N pods of D data ranks of M model "
                         "ranks (one process a rank, under torchrun)")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = parse_mesh(args.mesh) if args.mesh else (1, 1, 1)
    world = shape[0] * shape[1] * shape[2]
    policy, device = None, args.device
    if world > 1:
        device = _join_group(world, device)
        policy = ShardingPolicy(make_mesh(shape, ("pod", "data", "model")))
    device = resolve_device(device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    state, step_at = make_run(cfg, batch=args.batch, seq=args.seq, lr=args.lr,
                              steps=args.steps, seed=args.seed, device=device,
                              policy=policy, grad_compress=args.grad_compress)
    # one Checkpointer for the run: its plan is built once for the state's
    # structure, and every save and restore adds to one TransferStats;
    # under a policy it saves the gathered state and restores shards
    ckpt = CKPT.Checkpointer(
        args.ckpt_dir, device=device,
        placement=TS.placement(cfg, policy) if policy else None) \
        if args.ckpt_dir else None
    start_step = 0
    if args.resume and ckpt and CKPT.latest_step(args.ckpt_dir) is not None:
        state, _extra, start_step = ckpt.restore(state)
        say(f"resumed from step {start_step}")

    synchronize(device)
    t0 = time.time()
    for step in range(start_step, args.steps):
        state, metrics = step_at(state, step)
        if step % args.log_every == 0:
            say(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                f"ce {float(metrics['ce']):.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"lr {float(metrics['lr']):.2e}", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            path = ckpt.save(step + 1, state, extra={"arch": cfg.name})
            say(f"checkpointed -> {path}")
    synchronize(device)
    dt = time.time() - t0
    tok = (args.steps - start_step) * args.batch * args.seq
    say(f"done: {args.steps - start_step} steps, "
        f"{tok / max(dt, 1e-9):.0f} tok/s")
    if ckpt is not None and lead:
        s = ckpt.stats
        say(f"checkpoint plane: {s.wire_bytes:.0f} wire bytes  "
            f"refetches {s.refetches}  verify_failures {s.verify_failures}")
    if args.grad_compress and GC.last_stats is not None:
        g = GC.last_stats
        say(f"gradient plane (per step): {g.wire_bytes:.0f} wire bytes  "
            f"raw ring fallbacks {g.raw_refetches}")
    if policy is not None:
        dist.barrier()   # no rank tears its connections down under a peer
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""Sharded serving under a ``ShardingPolicy``: the port's counterpart of the
prefill, decode and ``xfer_*`` branches of the JAX dry-run's
``build_lowerable`` (``repro/launch/dryrun.py:132-239``).

There each branch is one jitted program whose in/out shardings come from
the policy, and GSPMD splits it across the mesh.  Here every rank runs its
part explicitly, over ``torch.distributed`` (gloo), on its shards:

* :func:`place_params` -- this rank's block of the seeded parameters
  (``init_params(place=)``, as the sharded train state is drawn), and
  :func:`local_batch` its rows of a global batch (the policy's ``tokens``
  spec, the JAX ``batch_sh``);
* :func:`serve` -- the prefill cells (``dryrun.py:203-219``:
  ``prefill_step`` under the policy) and the decode cells (``:221-239``:
  ``serve_step`` over a cache laid out by ``cache_sharding``): the rank's
  prefill under the ``model`` axis's tensor parallelism leaves it its
  block of the cache (the sequence split over ``model``, or a recurrent
  state's heads or channels; the batch over the data axes), then
  ``decode_loop`` steps on those blocks;
* :func:`disaggregated_step` -- the ``xfer_*`` cells (``:162-192``), the
  paper's pipeline "prefill -> SplitZip -> DCN hop -> decode pod": under
  ``ShardingPolicy(pd_disaggregated=True)`` pod 0 prefills, each pod-0
  rank ships its own cache shard (``TransferSession.transfer_shard``) to
  the pod-1 rank with its ``(data, model)`` coordinate, the first token
  and ``cache_len`` going with it, and pod 1 decodes from the shards it
  received, never assembling the whole cache.  The JAX cell stops at the
  moved cache; decoding there is the decode cells' ``serve_step``.

:func:`transfer_config` is the dry-run's ``_transfer_config``
(``dryrun.py:110-129``) for its transfer variants.

Families (``models.model.require_tp_serving``): dense GQA (K/V heads
split, the cache's K/V blocks moved into each rank's span); MLA, whose
latent cache (``ckv``, ``krope``) is whole on every model rank after the
prefill's gathered down products, so each rank slices its span, and whose
decode is the absorbed form over the span (``mla.mla_decode_tp``); and
MoE, whose FFN runs under expert parallelism (:func:`expert_parallel`,
built once on every rank, outside the steps: the routing group is the
policy's data axes, under ``pd_disaggregated`` the pod's data ranks, and
the experts split over ``model`` where they divide it); and the recurrent
families, Mamba-2 and the RG-LRU hybrid, whose state does not grow with
the sequence and splits on heads or channels, never on it: Mamba-2's
``ssm`` (L, B, H, P, N) over H and ``conv`` (L, B, W-1, C) over C, each
where it divides ``model``; the hybrid's ``rec_h`` / ``rec_conv`` /
``extra_h`` / ``extra_conv`` over the LRU width U and its window
``attn_k`` / ``attn_v`` over the KV heads (recurrentgemma's one MQA head
does not split, so every model rank holds the whole window).  No span, no
merge of partials: a decode step runs on the rank's state blocks
(``models.model.decode_step``).  The hop carries whatever leaves the cache
has: the f32 states ship raw, or, under ``compress_fp32`` (the
``xfer_fp32`` variant), their hi halves through the codec
(``fp32_hilo``); a leaf replicated over ``model`` is shipped by every
model rank to its pod-1 peer, so each copy is counted where it is sent.

Under ``ShardingPolicy(fsdp=True)`` (the dry-run's ``fsdp`` and
``fsdp_moe`` variants) a rank holds a block of its ``model`` shards, split
once more over ``data``: every prefill and every decode step gathers each
layer's blocks over ``data`` just before that layer's products and drops
them after (:func:`block_gather`, ``distributed/fsdp.py``), where GSPMD
inserts the per-layer all-gather in JAX.  The results are bitwise those of
the same mesh with ``fsdp`` off.  Under ``pd_disaggregated`` the ``data``
group is a pod's, so no parameter gather crosses the pod axis.  The
policy's ``moe_dispatch_sharding`` is a GSPMD hint the port does not
carry: the ``moe`` variants serve as ``base`` and ``fsdp`` do.

The front ends: a vision prompt (``patches`` before ``tokens``) fills
``frontend_len`` + tokens cache positions (``launch/serve.prompt_positions``),
so the patches take the first slots of the sequence split (rank 0's span
first), and it decodes as the dense family does.  The encoder-only audio
family has no decode cell (``shape_applicable`` drops it in the JAX
dry-run): :func:`serve` runs its prefill cell alone, which leaves the rank
its vocab columns of the frames' logits and an empty cache, and its
``xfer_*`` cell ships that empty cache, pod 1 decoding nothing
(:func:`disaggregated_step`).  Nothing falls back: a collective's failure
fails the call, and a sharded step never runs whole on one rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as TR
from repro_torch.core.codebook import DEFAULT_BF16_CODEBOOK, Codebook
from repro_torch.device import resolve_device
from repro_torch.distributed import expert_parallel as EP
from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch.serve import prompt_positions
from repro_torch.models import kvcache as KC
from repro_torch.models import model as M
from repro_torch.models.kvcache import DecodeState
from repro_torch.serving import collective as CL
from repro_torch.serving.decode import decode_loop
from repro_torch.serving.plan import TransferConfig, TransferPlan
from repro_torch.serving.prefill import PrefillOutput, prefill_step

#: the dry-run's transfer variants (``_transfer_config``): the keyword
#: arguments of each one's ``TransferConfig`` beside its codebook, by the
#: variant's suffix
TRANSFER_VARIANTS = {
    "raw": dict(enabled=False),
    "chunked": dict(chunk=1024, cap=64),
    "fp32": dict(layout="global", global_budget=0.0025, compress_fp32=True),
    "pipelined": dict(chunk=1024, cap=64, n_chunks=8),
    "tight": dict(layout="global", global_budget=0.0025),
    "global": dict(layout="global"),
}


#: the dry-run's policy variants that serve through :func:`serve` (the
#: ``xfer_*`` ones through :func:`disaggregated_step`)
SERVING_VARIANTS = ("base", "moe", "fsdp", "fsdp_moe")


def transfer_config(variant: str, codebook: Codebook = DEFAULT_BF16_CODEBOOK,
                    **over) -> TransferConfig:
    """The ``TransferConfig`` of a dry-run transfer ``variant``
    (``xfer_raw``, ``xfer_chunked``, ``xfer_global``, ``xferonly_*``): the
    default bf16 codebook and the variant's knobs; a variant without a
    known suffix gets the ``global`` layout, as in the JAX table.
    ``over`` sets further fields (the codec ``backend``)."""
    suffix = variant.rsplit("_", 1)[-1]
    kw = TRANSFER_VARIANTS.get(suffix, TRANSFER_VARIANTS["global"])
    return TransferConfig(codebook=codebook, **{**kw, **over})


def tensor_parallel(policy: SH.ShardingPolicy, cfg: ArchConfig
                    ) -> TP.TensorParallel:
    """This rank's context over the policy mesh's ``model`` axis."""
    return TP.TensorParallel(policy.mesh.get_group("model"), cfg,
                             attn_fallback=policy.attn_fallback)


def expert_parallel(policy: SH.ShardingPolicy, cfg: ArchConfig,
                    tp: TP.TensorParallel) -> Optional[EP.ExpertParallel]:
    """A MoE config's serving context for its FFN (None for any other):
    routed over the policy's data axes (``routing_group``, collective:
    every rank calls it, in one order), the experts over ``tp``'s
    ``model`` where they divide it, and no balance statistics (serving
    differentiates nothing)."""
    if cfg.moe is None:
        return None
    return EP.ExpertParallel(cfg, EP.routing_group(policy, ring=False), tp,
                             balance=False)


def block_gather(policy: SH.ShardingPolicy, cfg: ArchConfig
                 ) -> FS.BlockGather:
    """This rank's per-layer gathers of its FSDP blocks over ``data``
    (``fsdp=`` of the steps; with ``fsdp`` off it gathers nothing)."""
    return FS.BlockGather(policy, M.abstract_params(cfg))


def place_params(cfg: ArchConfig, generator: torch.Generator,
                 policy: SH.ShardingPolicy, device=None) -> Dict:
    """This rank's block of ``init_params(cfg, generator)`` under the
    policy's parameter specs, every leaf cut as it is drawn."""
    return M.init_params(cfg, generator, device, SH.param_placer(policy))


def local_batch(batch: Dict, policy: SH.ShardingPolicy) -> Dict:
    """This rank's rows of a global batch (the ``tokens`` spec: the batch
    over the data axes where it divides them, else whole)."""
    return {k: SH.shard_slice(x, policy.spec_for_activation(
        "tokens", tuple(x.shape)), policy.mesh) for k, x in batch.items()}


def cache_like(cfg: ArchConfig, batch: int, max_seq: int,
               prompt_len: Optional[int] = None) -> Dict:
    """The whole cache's shapes and dtypes (``meta`` tensors) after a
    prefill of ``prompt_len`` positions (default: any, at least the
    hybrid's window): what the policy's ``cache_specs`` and a mesh
    ``TransferPlan`` are built from.  The hybrid's window holds
    ``min(window, prompt_len)`` positions after a prefill (``init_cache``
    allots ``min(window, max_seq)``), so a prompt shorter than the window
    plans that many; no other family's shapes depend on the prompt."""
    if cfg.hybrid is not None and prompt_len is not None:
        max_seq = min(max_seq, prompt_len)
    return KC.init_cache(cfg, batch, max_seq, device="meta")


@dataclasses.dataclass
class ServeResult:
    """One rank's sharded serving: the prefill's output (its rows, its
    vocab columns and its cache blocks), the greedy tokens decoded after
    the first (B_rank, num_steps; None for an encoder-only config, which
    has no decode cell), the decode state after them (an encoder-only
    config's: the prefill's), the
    tensor-parallel context whose ``fwd`` counted the collectives, a
    MoE's expert-parallel context (its ``fwd`` the routing collectives,
    ``out_gather`` the expert outputs'; else None), and the FSDP gathers
    (``fsdp.comm`` their bytes, ``fsdp.calls`` the all-gathers; none
    with ``fsdp`` off)."""
    prefill: PrefillOutput
    tokens: Optional[torch.Tensor]
    state: DecodeState
    tp: TP.TensorParallel
    ep: Optional[EP.ExpertParallel] = None
    fsdp: Optional[FS.BlockGather] = None


def serve(params, batch: Dict, cfg: ArchConfig, policy: SH.ShardingPolicy, *,
          max_seq: int, num_steps: int, kv_block: int = 1024,
          on_logits=None) -> ServeResult:
    """The prefill and decode cells of one rank: ``params`` are the rank's
    shards (:func:`place_params`), ``batch`` the global batch, of which the
    rank runs its rows; the prefill (``prefill_step(tp=)``) leaves the
    rank its cache blocks, on which ``decode_loop(tp=)`` decodes
    ``num_steps`` tokens (``on_logits(i, logits)`` sees each step's
    logits, the rank's vocab columns).  An encoder-only config runs the
    prefill cell alone: ``tokens`` None, the state the prefill's (an empty
    cache of the frames' length); ``decode_loop`` would raise
    (``models.kvcache.require_decoder``).  Under an ``fsdp`` policy
    ``params`` are the rank's FSDP blocks, gathered a layer at a time
    (:func:`block_gather`; the result's ``fsdp``)."""
    M.require_tp_serving(cfg)
    tp = tensor_parallel(policy, cfg)
    ep = expert_parallel(policy, cfg, tp)
    fs = block_gather(policy, cfg)
    out = prefill_step(params, local_batch(batch, policy), cfg,
                       max_seq=max_seq, kv_block=kv_block, tp=tp, ep=ep,
                       fsdp=fs)
    if cfg.encoder_only:
        return ServeResult(prefill=out, tokens=None, state=out.state, tp=tp,
                           ep=ep, fsdp=fs)
    toks, st = decode_loop(params, out.first_token, out.state, cfg,
                           num_steps, tp=tp, max_seq=max_seq,
                           on_logits=on_logits, ep=ep, fsdp=fs)
    return ServeResult(prefill=out, tokens=toks, state=st, tp=tp, ep=ep,
                       fsdp=fs)


@dataclasses.dataclass
class HopResult:
    """One rank's disaggregated step.  A prefill rank (pod 0): its prefill
    output and the session whose ``last_stats`` / ``last_comm`` account
    the hop; ``tokens`` and ``state`` None.  A decode rank (pod 1): the
    shard it received (``received``), the first token and ``cache_len``
    that came with it, the tokens decoded from it and the final state;
    ``prefill`` None.  ``side`` counts the first token's and
    ``cache_len``'s message, ``tp.fwd`` the collectives over ``model``,
    a MoE's ``ep`` its routing and expert-output collectives, ``fsdp``
    the FSDP gathers within the pod (:class:`ServeResult`)."""
    pod: int
    session: object
    side: CL.CommStats
    tp: TP.TensorParallel
    ep: Optional[EP.ExpertParallel] = None
    fsdp: Optional[FS.BlockGather] = None
    prefill: Optional[PrefillOutput] = None
    received: Optional[Dict] = None
    first_token: Optional[torch.Tensor] = None
    tokens: Optional[torch.Tensor] = None
    state: Optional[DecodeState] = None


def hop_plan(cfg: ArchConfig, policy: SH.ShardingPolicy, tc: TransferConfig,
             batch: int, max_seq: int,
             prompt_len: Optional[int] = None) -> TransferPlan:
    """The mesh plan of a ``batch`` x ``max_seq`` cache after a prefill of
    ``prompt_len`` positions (:func:`cache_like`) under the policy's
    ``cache_specs`` (from shapes alone: no rank holds the whole cache).
    An encoder-only config's cache is ``{}``: its plan has no routes, no
    segments, a stream of 0 elements and no specs, the ``tensor``
    granularity (what the JAX ``TransferPlan.build({}, ...)`` gives), and
    its hop moves no unit (:func:`disaggregated_step`)."""
    like = cache_like(cfg, batch, max_seq, prompt_len)
    return TransferPlan.build(like, tc, mesh=policy.mesh,
                              specs=policy.cache_specs(like))


def disaggregated_step(params, batch: Dict, cfg: ArchConfig,
                       policy: SH.ShardingPolicy, tc: TransferConfig, *,
                       max_seq: int, num_steps: int, kv_block: int = 1024,
                       device=None, on_logits=None) -> HopResult:
    """The ``xfer_*`` cell of one rank (module docstring) on a ``(pod,
    data, model)`` mesh under a ``pd_disaggregated`` policy: pod 0
    prefills its rows of ``batch`` and ships its cache blocks, pod 1
    decodes ``num_steps`` tokens from them; the hop's session (of
    :func:`hop_plan`'s plan, its codec on ``device``) comes back in the
    result.

    An encoder-only config's cache is empty.  Pod 0 ships it all the same
    (``transfer_shard({})``: a message of no unit, no codec launch), then
    the first units and ``cache_len`` as for every family; pod 1 receives
    ``{}`` (``received``), the first units and ``cache_len``, and decodes
    nothing (``tokens`` None).  ``last_stats`` reads 0 raw and 0 wire
    bytes on both pods: no chunk, no leaf, no retry step.  Under an
    ``fsdp`` policy each pod gathers its FSDP blocks within itself, as
    :func:`serve` does."""
    if not policy.pd_disaggregated:
        raise ValueError("the disaggregated step needs a pd_disaggregated "
                         "policy: pods are prefill and decode workers")
    M.require_tp_serving(cfg)
    mesh, sizes = policy.mesh, policy.sizes
    if sizes.get("pod", 1) != 2:
        raise ValueError(f"the disaggregated step runs on 2 pods, not "
                         f"{sizes.get('pod', 1)}")
    b, s = next(iter(batch.values())).shape[0], prompt_positions(cfg, batch)
    session = hop_plan(cfg, policy, tc, b, max_seq, s).session(device=device)
    plan = session.plan
    pod = mesh.get_local_rank("pod")
    tp = tensor_parallel(policy, cfg)
    ep = expert_parallel(policy, cfg, tp)
    fs = block_gather(policy, cfg)
    side = CL.CommStats()
    if pod == plan.src_pod:
        out = prefill_step(params, local_batch(batch, policy), cfg,
                           max_seq=max_seq, kv_block=kv_block, tp=tp, ep=ep,
                           fsdp=fs)
        session.transfer_shard(out.state.cache)
        link = CL.Link(mesh.get_group("pod"), out.first_token.device, side)
        link.wait(link.isend(plan.dst_pod, [
            CL.raw_unit(out.first_token), CL.raw_unit(out.state.cache_len)]))
        return HopResult(pod=pod, session=session, side=side, tp=tp, ep=ep,
                         fsdp=fs, prefill=out)
    shard = session.transfer_shard(None)
    dev = resolve_device(device)
    rows = SH.local_shape((b,), policy.spec_for_activation("tokens", (b,)),
                          sizes)
    link = CL.Link(mesh.get_group("pod"), dev, side)
    _, body = link.recv(plan.src_pod, 2)
    first = body.raw(rows, torch.int32)
    body.end_unit()
    cache_len = body.raw(rows, torch.int32)
    body.end_unit()
    body.done()
    state = DecodeState(cache=shard, cache_len=cache_len)
    if cfg.encoder_only:
        return HopResult(pod=pod, session=session, side=side, tp=tp, ep=ep,
                         fsdp=fs, received=shard, first_token=first,
                         state=state)
    toks, st = decode_loop(params, first, state, cfg, num_steps, tp=tp,
                           max_seq=max_seq, on_logits=on_logits, ep=ep,
                           fsdp=fs)
    return HopResult(pod=pod, session=session, side=side, tp=tp, ep=ep,
                     fsdp=fs, received=shard, first_token=first, tokens=toks,
                     state=st)


def main(argv=None) -> None:
    """One rank of a sharded serving run, launched with ``torchrun``::

        torchrun --nproc-per-node 4 -m repro_torch.serving.sharded \\
            --arch smollm-135m --reduced --device cpu --mesh 1,2,2
        torchrun --nproc-per-node 4 -m repro_torch.serving.sharded \\
            --arch smollm-135m --reduced --device cpu --mesh 2,1,2 \\
            --variant xfer_chunked
        torchrun --nproc-per-node 4 -m repro_torch.serving.sharded \\
            --arch smollm-135m --reduced --device cpu --mesh 1,2,2 \\
            --variant fsdp

    ``--arch`` is any family with a sharded serving path: dense GQA,
    ``minicpm3-4b`` (MLA), ``qwen3-moe-30b-a3b`` (MoE, its experts over
    ``model``), ``mamba2-2.7b`` (Mamba-2; ``--variant xfer_fp32`` sends
    its f32 state's hi halves through the codec) and
    ``recurrentgemma-9b`` (the RG-LRU hybrid), ``pixtral-12b`` (the
    vision front end; ``--prompt-len`` counts its patches) and
    ``hubert-xlarge`` (encoder-only: the prefill cell, and the hop of its
    empty cache; each rank prints its first units).  ``--variant base``
    runs :func:`serve` (the prefill and decode cells), as do ``fsdp`` and
    ``fsdp_moe`` on FSDP blocks (each prints its gathers); an ``xfer_*``
    variant runs :func:`disaggregated_step` under a ``pd_disaggregated``
    policy on 2 pods.  The policy is the dry run's for the variant
    (``launch/dryrun.POLICY_VARIANTS``); ``xfer_*`` under ``fsdp`` runs
    through the Python API.  Parameters and the prompt
    (``launch/serve.make_prompt``) come from ``--seed``.  Without
    ``--device`` each rank takes the card."""
    import argparse

    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import POLICY_VARIANTS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_prompt
    from repro_torch.launch.train import _join_group, parse_mesh

    ap = argparse.ArgumentParser(prog="python -m repro_torch.serving.sharded")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", required=True, help="N,D,M: pods, data, model")
    ap.add_argument("--variant", default="base",
                    help="base, fsdp, fsdp_moe, or a dry-run transfer "
                         "variant (xfer_raw, xfer_chunked, xfer_global, ...)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="cache slots (default: twice the prompt)")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--codec-backend", default=None,
                    help="the hop's codec (default: cuda on the card, else "
                         "torch)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = parse_mesh(args.mesh)
    device = resolve_device(_join_group(shape[0] * shape[1] * shape[2],
                                        args.device))
    xfer = args.variant.startswith("xfer")
    if not xfer and args.variant not in SERVING_VARIANTS:
        raise SystemExit(f"--variant {args.variant}: not a serving variant "
                         f"({', '.join(SERVING_VARIANTS)} or xfer_*)")
    policy = SH.ShardingPolicy(make_mesh(shape, ("pod", "data", "model")),
                               **{**POLICY_VARIANTS.get(args.variant, {}),
                                  "pd_disaggregated": xfer})
    max_seq = args.max_seq or 2 * args.prompt_len
    params = place_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), policy, device)
    batch = make_prompt(cfg, args.batch, args.prompt_len, device=device,
                        seed=args.seed + 1)
    coord = SH.coordinate(policy.mesh)
    if xfer:
        backend = args.codec_backend or ("cuda" if device.type == "cuda"
                                         else "torch")
        res = disaggregated_step(
            params, batch, cfg, policy,
            transfer_config(args.variant, backend=backend), max_seq=max_seq,
            num_steps=args.new_tokens, device=device)
        st = res.session.last_stats
        raw = sum(x.numel() * x.element_size() for x in TR.leaves(
            res.prefill.state.cache if res.pod == 0 else res.received))
        print(f"rank {dist.get_rank()} {coord}: hop {raw} raw bytes, "
              f"{st.wire_bytes:.0f} wire bytes (ratio "
              f"{raw / max(st.wire_bytes, 1):.4f}), retry steps "
              f"{st.n_retry_steps}", flush=True)
        tokens, first = res.tokens, res.first_token
    else:
        res = serve(params, batch, cfg, policy, max_seq=max_seq,
                    num_steps=args.new_tokens)
        tokens, first = res.tokens, res.prefill.first_token
        if policy.fsdp:
            print(f"rank {dist.get_rank()} {coord}: fsdp gathers "
                  f"{res.fsdp.calls} all-gathers, {res.fsdp.comm.sent_bytes:.0f}"
                  f" bytes sent", flush=True)
    if coord["model"] == 0:
        if tokens is not None:
            print(f"rank {dist.get_rank()} {coord}: tokens {tokens.tolist()}",
                  flush=True)
        elif cfg.encoder_only and first is not None:
            print(f"rank {dist.get_rank()} {coord}: first units "
                  f"{first.tolist()}", flush=True)
    dist.barrier()   # no rank tears its connections down under a peer
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

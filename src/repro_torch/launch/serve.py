"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the disaggregated pipeline in one process: calibrate a SplitZip
codebook on this model's own KV activations, then prefill -> compressed
transfer -> decode for a batch of random prompts, reporting the transfer
ratio, codec health and the time of each phase on the device.

Runs on the card unless ``--device`` names another (``--device cpu`` runs
the kernels' plain versions); without CUDA and without ``--device`` it
raises.  ``--codec-backend`` picks the codec from the registry (``auto``
resolves to ``cuda``, the hand-written kernels; ``torch`` is the reference
codec; ``wire`` / ``wire-verify`` ship SZ02 payloads).  ``--n-chunks`` > 1
switches the transfer to the chunked pipelined executor; ``--compress-fp32``
sends the f32 recurrent states (mamba2's SSM state, the RG-LRU's h) through
the plan's hi/lo route instead of raw.  Weights are random, made from
``--seed``.  A vision config's ``--prompt-len`` counts its patch positions
before the text tokens, as in the JAX launcher; an encoder-only config
(hubert-xlarge) has no decode phase and is refused, as the JAX launcher
refuses it.

``--profile`` selects the codec profile that prices the analytic transfer
report (:mod:`repro_torch.core.profile`): ``paper`` (the paper's H200
figures), ``measured`` (the calibrated ``build/profiles.json``, measured on
the spot when absent) or a ``profiles.json`` path; ``--link-gbps`` is the
simulated PD link.  The report line names the profile's provenance.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import codebook as cbm
from repro_torch.core import tree as TR
from repro_torch.core.backend import available_backends
from repro_torch.core.profile import resolve_profile
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import model as M
from repro_torch.models.kvcache import DecodeState
from repro_torch.models.kvpool import ResidentState
from repro_torch.serving.engine import DisaggregatedEngine
from repro_torch.serving.prefill import PrefillOutput


@torch.no_grad()
def calibrate_on_model(cfg, params, *, device, seq: int = 32, batch: int = 2,
                       seed: int = 0) -> cbm.Codebook:
    """Paper §3.3: one-time calibration on representative KV tensors (a
    prefill of random prompts through this model; a vision prompt gets its
    patches before ``seq`` text tokens)."""
    if cfg.frontend == "vision_patches":
        seq += cfg.frontend_len
    prompt = make_prompt(cfg, batch, seq, device=device, seed=seed)
    _, state = M.prefill(params, prompt, cfg, max_seq=seq)
    leaves = [x.reshape(-1).view(torch.int16).cpu().numpy().view(np.uint16)
              for x in TR.leaves(state.cache) if x.dtype == torch.bfloat16]
    if not leaves:
        return cbm.DEFAULT_BF16_CODEBOOK
    return cbm.calibrate(leaves, k=16)


def make_prompt(cfg, batch: int, prompt_len: int, *, device, seed: int) -> Dict:
    """``make_inputs`` without the labels: ``prompt_len`` positions, a vision
    config's patches among them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = ShapeConfig("serve", seq_len=prompt_len, global_batch=batch,
                        kind="prefill")
    return {k: v for k, v in M.make_inputs(cfg, shape, gen,
                                           seq=prompt_len).items()
            if k != "labels"}


def prompt_positions(cfg, prompt: Dict) -> int:
    """Cache positions a prompt fills: its frames, or its tokens after a
    vision config's patches."""
    if "frames" in prompt:
        return prompt["frames"].shape[1]
    n = prompt["tokens"].shape[1]
    return n + cfg.frontend_len if cfg.frontend == "vision_patches" else n


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, 1 + new_tokens)
    prefill: PrefillOutput        # the prefill worker's cache and first token
    # what the decode worker received: the raw cache, or the admitted
    # compressed-resident pool state (which decode then updates in place)
    delivered: Union[DecodeState, ResidentState]
    seconds: Dict[str, float]     # prefill / transfer / decode_loop, synced


def serve_once(eng: DisaggregatedEngine, prompt: Dict, new_tokens: int,
               max_seq: Optional[int] = None) -> ServeResult:
    """prefill -> transfer -> decode through ``eng``, each phase timed on the
    host clock around work that ends in a device synchronize.  A
    compressed-resident engine gets its cache padded to a page multiple."""
    max_seq = eng.resident_max_seq(
        max_seq or prompt_positions(eng.cfg, prompt) + 1 + new_tokens)
    seconds = {}

    def timed(name, fn):
        synchronize(eng.device)
        t0 = time.perf_counter()
        out = fn()
        synchronize(eng.device)
        seconds[name] = time.perf_counter() - t0
        return out

    pre = timed("prefill", lambda: eng.prefill(prompt, max_seq=max_seq))
    delivered = timed("transfer", lambda: eng.transfer(pre.state))
    toks = timed("decode_loop", lambda: eng.decode(pre.first_token, delivered,
                                                   new_tokens))
    tokens = torch.cat([pre.first_token[:, None], toks], dim=1)
    return ServeResult(tokens=tokens, prefill=pre, delivered=delivered,
                       seconds=seconds)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (raises "
                         "without one)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--codec-backend", default="auto",
                    choices=sorted(available_backends()),
                    help="codec backend registry key; 'auto' resolves to the "
                         "CUDA kernels")
    ap.add_argument("--n-chunks", type=int, default=1,
                    help=">1 => chunked pipelined transfer engine")
    ap.add_argument("--compress-fp32", action="store_true",
                    help="hi/lo-split-compress f32 recurrent states "
                         "(SSM/RG-LRU) through the plan's fp32_hilo route")
    ap.add_argument("--link-gbps", type=float, default=100.0,
                    help="simulated PD link (Gbit/s) for the analytic report")
    ap.add_argument("--profile", default="paper",
                    help="codec profile source for the analytic report: "
                         "'paper' (the paper's H200 figures), 'measured' "
                         "(calibrated build/profiles.json; measured now if "
                         "absent), or a profiles.json path")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only; it has no decode phase "
                         "to serve (run serving.prefill.prefill_step)")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device)
    cb = calibrate_on_model(cfg, params, device=device, seed=args.seed + 1)
    print(f"calibrated top-16 exponents: {cb.exponents}")

    profile = resolve_profile(args.profile, link_bw=args.link_gbps * 1e9 / 8,
                              backend=args.codec_backend, device=device)
    eng = DisaggregatedEngine(cfg, params, cb, compress=not args.no_compress,
                              backend=args.codec_backend,
                              n_chunks=args.n_chunks,
                              compress_fp32=args.compress_fp32,
                              profile=profile, device=device)
    prompt = make_prompt(cfg, args.batch, args.prompt_len, device=device,
                         seed=args.seed + 2)
    res = serve_once(eng, prompt, args.new_tokens,
                     max_seq=args.prompt_len + args.new_tokens + 1)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"generated {tuple(res.tokens.shape)} tokens on {where}")
    for name, sec in res.seconds.items():
        print(f"{name + ' time':21s}: {sec * 1e3:.3f} ms")
    print(f"cache raw bytes      : {eng.stats.raw_cache_bytes:,.0f}")
    print(f"cache wire bytes     : {eng.stats.wire_bytes:,.0f}")
    print(f"transfer ratio       : {eng.stats.transfer_ratio:.3f}x")
    print(f"codec ok (no overflow): {eng.stats.codec_ok}")
    print(f"codec backend        : {args.codec_backend} (resolved: "
          f"{eng.tc.get_backend().name})")
    print(eng.describe_plan())
    if eng.stats.chunk_retries:
        print(f"capacity schedule    : {eng.stats.chunk_retries} units "
              f"retried, {eng.stats.chunk_retry_steps} extra encode attempts")
    if eng.stats.chunk_wire_bytes:
        per = eng.stats.chunk_wire_bytes
        print(f"pipelined chunks     : {len(per)} shipped (requested "
              f"{args.n_chunks}) — per-chunk wire bytes min={min(per):,.0f} "
              f"max={max(per):,.0f}")
    rep = eng.transfer_report()
    print(f"analytic transfer    : native {rep.t_native * 1e3:.2f} ms -> "
          f"splitzip {rep.t_splitzip * 1e3:.2f} ms ({rep.speedup:.3f}x at "
          f"{args.link_gbps:.0f} Gb/s, profile: {profile.source})")
    return res


if __name__ == "__main__":
    main()

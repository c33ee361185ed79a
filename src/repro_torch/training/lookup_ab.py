"""Time the train step with the model's token lookup beside indexing, in turns.

    PYTHONPATH=src python -m repro_torch.training.lookup_ab [--steps N]

The step is ``launch/train.py:make_run``'s, at smollm-135m's full width,
batch 8 x 2048, under deterministic algorithms (phase ``train`` of
``chip_smoke.py``).  ``models.model.embed_inputs`` looks tokens up with
``F.embedding``, whose backward on the card sums a token's rows in f32; the
other turn swaps in the lookup by indexing, whose backward adds them in
bf16.  Turns run embedding, indexing, indexing, embedding, each from the
same initial state: one warm step, then ``--steps`` steps, each timed on
the host around a synchronized step and on the device by CUDA events.
Then the lookup's forward and backward alone at the batch's tokens, in the
same turns (CUDA events, 20 calls each).  Prints one JSON line; needs the
card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time


def _indexing(orig):
    def embed_inputs(params, batch, cfg):
        if cfg.frontend is not None:
            return orig(params, batch, cfg)
        return params["embed"][batch["tokens"]]
    return embed_inputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("lookup_ab: no CUDA device")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as LT
    from repro_torch.models import model as M

    cfg = get_config(args.arch)
    device = torch.device("cuda", 0)
    orig = M.embed_inputs
    lookups = {"embedding": orig, "indexing": _indexing(orig)}
    state0, step_at = LT.make_run(cfg, batch=args.batch, seq=args.seq,
                                  lr=3e-4, steps=args.steps + 1, seed=0,
                                  device=device)
    turns = ("embedding", "indexing", "indexing", "embedding")
    steps = {k: {"host_ms": [], "device_ms": [], "losses": []} for k in lookups}
    try:
        for name in turns:
            M.embed_inputs = lookups[name]
            state, _ = step_at(state0, 0)          # warm
            torch.cuda.synchronize()
            for i in range(1, args.steps + 1):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                a.record()
                state, m = step_at(state, i)
                b.record()
                torch.cuda.synchronize()
                steps[name]["host_ms"].append((time.perf_counter() - t0) * 1e3)
                steps[name]["device_ms"].append(a.elapsed_time(b))
                steps[name]["losses"].append(float(m["loss"]))
            del state
    finally:
        M.embed_inputs = orig
    del state0

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.training.data import DataConfig, SyntheticTokenStream
    tokens = SyntheticTokenStream(
        cfg, ShapeConfig("cli", args.seq, args.batch, "train"),
        DataConfig(seed=0), device=device).batch_at(0)["tokens"]
    gen = torch.Generator(device=device).manual_seed(3)
    w = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                     device=device) * 0.02).to(torch.bfloat16)
    up = torch.randn(tuple(tokens.shape) + (cfg.d_model,), generator=gen,
                     device=device).to(torch.bfloat16)
    alone = {k: [] for k in lookups}
    for name in turns:
        look = lookups[name]
        for _ in range(21):
            p = w.clone().requires_grad_(True)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            look({"embed": p}, {"tokens": tokens}, cfg).backward(up)
            b.record()
            torch.cuda.synchronize()
            alone[name].append(a.elapsed_time(b))
        del alone[name][-21]                       # the first call of a turn
    print(json.dumps(dict(
        arch=args.arch, batch=args.batch, seq=args.seq, turns=list(turns),
        device=torch.cuda.get_device_name(0),
        step={k: dict(v, host_ms_median=statistics.median(v["host_ms"]),
                      device_ms_median=statistics.median(v["device_ms"]))
              for k, v in steps.items()},
        lookup_fwd_bwd_ms={k: dict(median=statistics.median(v), min=min(v))
                           for k, v in alone.items()})), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

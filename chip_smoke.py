#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port of SplitZip runs on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line (any failure raises, exit code != 0):

1. device   — the card's name and power limit, torch/CUDA versions, and the
              build of the CUDA kernels from ``src/repro_torch/kernels/csrc``
              (``nvcc`` for sm_90a, all sources at once).
2. kernels  — all four codec kernels held BITWISE against their plain
              PyTorch versions for bf16 / fp8_e5m2 / fp8_e4m3 on edge inputs
              (specials, zero-/all-escape rows, count == cap and cap + 1,
              cap 1/64/128, a ragged tail), then timed with CUDA events at
              the main path's shape (one smollm-135m KV leaf) beside their
              plain versions and their memory bound.
3. main     — smollm-135m at full width with seeded random weights: batch 8,
              prompt 2048, 16 new tokens, codebook calibrated on the model's
              own prefill KV, through ``launch/serve.py``'s code path with
              the ``cuda`` backend at n_chunks 1 and 8 and with
              compression off.  Delivered caches must equal the prefill
              cache bit for bit and the tokens must agree across the runs.
4. capacity — a cache with one chunk of nothing but escapes walks the
              capacity schedule to ``layout='global'``: the dense kernels
              launch and delivery stays bitwise.

The launch counters are set to 0 right before phase 3 and read right after
phase 4: those two phases are the main path.  The ``kernels`` JSON line,
the card's ``nvidia-smi`` line and, last, ``{"ok": true, "device": ...}``
close the output.  Without CUDA, or outside a checkout, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12       # 32-bit ALU rate outside the tensor cores
ARCH, BATCH, PROMPT, NEW_TOKENS = "smollm-135m", 8, 2048, 16


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

KERNELS = {
    "encode_fused": ("src/repro_torch/kernels/csrc/splitzip_encode.cu",
                     "src/repro/kernels/splitzip_encode.py:203"),
    "decode_fused": ("src/repro_torch/kernels/csrc/splitzip_decode.cu",
                     "src/repro/kernels/splitzip_decode.py:142"),
    "encode_dense": ("src/repro_torch/kernels/csrc/splitzip_encode.cu",
                     "src/repro/kernels/splitzip_encode.py:154"),
    "decode_dense": ("src/repro_torch/kernels/csrc/splitzip_decode.cu",
                     "src/repro/kernels/splitzip_decode.py:99"),
}


def phase_kernels(torch, cfg, device):
    from repro_torch.core import codec as C
    from repro_torch.core.codebook import calibrate
    from repro_torch.kernels import cases as K
    from repro_torch.kernels import splitzip_decode as D
    from repro_torch.kernels import splitzip_encode as E

    # edge inputs, all formats, every kernel bitwise against its plain version
    n_cases = 0
    for fmt, cb in K.CODEBOOKS.items():
        for name, bits, cap in K.kernel_cases(fmt, seed=1):
            t = torch.from_numpy(bits.view("int16") if bits.dtype.itemsize == 2
                                 else bits).to(device)
            if bits.dtype.itemsize == 2:
                t = t.view(torch.uint16)
            errs = K.check_case(t, cb, cap)
            if max(errs.values()) != 0:
                raise AssertionError(f"{fmt}/{name}: kernel != plain {errs}")
            n_cases += 1
    torch.cuda.synchronize()

    # main-path shape: one smollm KV leaf (L, B, S, Hkv, hd), synthetic bf16
    shape = (cfg.num_layers, BATCH, PROMPT + 1 + NEW_TOKENS, cfg.num_kv_heads,
             cfg.head_dim)
    gen = torch.Generator(device=device).manual_seed(7)
    leaf = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    sample = leaf.reshape(-1)[: 1 << 22].view(torch.int16).cpu().numpy().view("uint16")
    cb = calibrate([sample], k=16)
    exps, chunk, cap = tuple(cb.exponents), 1024, 64
    x = C.to_bits(leaf, "bf16").reshape(-1, chunk)
    rows, n = x.shape[0], x.numel()
    enc = E.encode_fused(x, exps, "bf16", chunk, cap)
    sm, packed, pos, val, cnt = enc
    cnt = torch.clamp(cnt, max=cap)
    dense = E.encode_dense(x, exps, "bf16", chunk)
    applied = int(cnt.sum())          # escape slots decode_fused reads
    runs = {
        "encode_fused": (lambda: E.encode_fused(x, exps, "bf16", chunk, cap),
                         lambda: E.encode_fused_plain(x, exps, "bf16", chunk, cap),
                         2 * n + n + n // 2 + 3 * rows * cap + 4 * rows, 16 * n),
        "decode_fused": (lambda: D.decode_fused(packed, sm, pos, val, cnt, exps, "bf16", chunk),
                         lambda: D.decode_fused_plain(packed, sm, pos, val, cnt, exps, "bf16", chunk),
                         n // 2 + n + 3 * applied + 4 * rows + 2 * n, 12 * n),
        "encode_dense": (lambda: E.encode_dense(x, exps, "bf16", chunk),
                         lambda: E.encode_dense_plain(x, exps, "bf16", chunk),
                         2 * n + n + n // 2 + n, 12 * n),
        "decode_dense": (lambda: D.decode_dense(dense[1], dense[0], exps, "bf16", chunk),
                         lambda: D.decode_dense_plain(dense[1], dense[0], exps, "bf16", chunk),
                         n // 2 + n + 2 * n, 10 * n),
    }
    records = {}
    for name, (kernel, plain, nbytes, ops) in runs.items():
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = K.max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain at the main-path shape")
        b_ms, b_by = bound_ms(nbytes, ops)
        ms = cuda_ms(kernel, reps=20)
        records[name] = dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1], launches=None, max_abs_err=err,
            bitwise_equal=True, ms=ms, kernel_ms=ms,
            plain_ms=cuda_ms(plain, reps=3, warmup=1), bound_ms=b_ms,
            bound_by=b_by, library_ms=None, bytes=nbytes, ops=ops,
            shape=[rows, chunk], escapes_applied=applied if name == "decode_fused" else None)
    del leaf, x, enc, dense
    torch.cuda.empty_cache()
    emit(phase="kernels", edge_cases=n_cases, formats=list(K.CODEBOOKS),
         timed={k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "bytes")}
                for k, v in records.items()})
    return records


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def phase_main(torch, cfg, device):
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DisaggregatedEngine

    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device)
    cb = serve.calibrate_on_model(cfg, params, device=device, seed=1)
    prompt = serve.make_prompt(cfg, BATCH, PROMPT, device=device, seed=2)

    def same_cache(a, b):
        return all(C.bits_equal(x, y) for x, y in zip(TR.leaves(a), TR.leaves(b)))

    def codec_seconds(eng, cache):
        """The transfer once more through a session of the engine's plan,
        its encode (``send``) and decode (``recv``) halves timed apart."""
        sess = eng.plan.session()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.send(cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = sess.recv()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not same_cache(out, cache):
            raise AssertionError("send/recv: delivered cache != prefill cache")
        return {"encode": t1 - t0, "decode": t2 - t1}

    results, tokens = {}, {}
    for label, kw in (("cuda_n1", dict(n_chunks=1)),
                      ("cuda_n8", dict(n_chunks=8)),
                      ("raw", dict(compress=False))):
        eng = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device, **kw)
        res = serve.serve_once(eng, prompt, NEW_TOKENS)
        if not same_cache(res.delivered.cache, res.prefill.state.cache):
            raise AssertionError(f"{label}: delivered cache != prefill cache")
        tokens[label] = res.tokens
        seconds = dict(res.seconds)
        if eng.plan is not None:
            seconds.update(codec_seconds(eng, res.prefill.state.cache))
        results[label] = dict(
            seconds=seconds,
            transfer_ratio=eng.stats.transfer_ratio,
            raw_bytes=eng.stats.raw_cache_bytes, wire_bytes=eng.stats.wire_bytes,
            codec_ok=eng.stats.codec_ok, plan=eng.describe_plan())
        if label == "cuda_n1":
            first = res
    for label in ("cuda_n8", "raw"):
        if not torch.equal(tokens[label], tokens["cuda_n1"]):
            raise AssertionError(f"tokens differ: {label} vs cuda_n1")
    if not bool(torch.isfinite(first.prefill.last_logits.float()).all()):
        raise AssertionError("non-finite prefill logits")
    n_elems = sum(x.numel() for x in TR.leaves(first.prefill.state.cache))
    emit(phase="main", arch=cfg.name, batch=BATCH, prompt=PROMPT,
         new_tokens=NEW_TOKENS, cache_elements=n_elems,
         codebook=list(cb.exponents), runs=results,
         tokens_equal=True, delivered_bitwise=True)
    return cb, first


def phase_capacity(torch, cfg, cb, first, device):
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.core.codebook import FORMATS
    from repro_torch.models.kvcache import DecodeState
    from repro_torch.serving.engine import DisaggregatedEngine

    cache = {k: v.clone() for k, v in first.prefill.state.cache.items()}
    esc_e = next(e for e in range(256) if e not in cb.exponents)
    mbits = FORMATS["bf16"]["mbits"]
    chunk_bits = (torch.arange(1024, device=device, dtype=torch.int32) % 128) \
        | (esc_e << mbits)
    flat = C.signed_view(cache["k"].view(torch.uint16)).reshape(-1)
    flat[:1024] = chunk_bits.to(torch.int16)
    state = DecodeState(cache=cache, cache_len=first.prefill.state.cache_len)
    eng = DisaggregatedEngine(cfg, None, cb, backend="cuda", device=device)
    out = eng.transfer(state)
    torch.cuda.synchronize()
    if not all(C.bits_equal(x, y) for x, y in zip(TR.leaves(out.cache),
                                                 TR.leaves(cache))):
        raise AssertionError("capacity schedule: delivered cache != sent cache")
    steps = eng.stats.chunk_retry_steps
    if steps != 3 or not eng.stats.codec_ok:
        raise AssertionError(f"capacity schedule walked {steps} steps "
                             "(expected cap -> 2cap -> 4cap -> global = 3)")
    emit(phase="capacity", retry_steps=steps, transfer_ratio=eng.stats.transfer_ratio,
         delivered_bitwise=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for the kernel build log (default: none)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to prove", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import splitzip_decode as D
    from repro_torch.kernels import splitzip_encode as E

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "nvcc.log").write_text("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    emit(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=round(build_s, 3), built=sorted(logs),
         ptxas=[ln.strip() for v in logs.values() for ln in v.splitlines()
                if "registers" in ln or "bytes smem" in ln])

    cfg = get_config(ARCH)
    records = phase_kernels(torch, cfg, device)

    wrappers = {"encode_fused": E.encode_fused, "decode_fused": D.decode_fused,
                "encode_dense": E.encode_dense, "decode_dense": D.decode_dense}
    for w in wrappers.values():
        w.launches = 0
    cb, first = phase_main(torch, cfg, device)
    after_main = {k: w.launches for k, w in wrappers.items()}
    phase_capacity(torch, cfg, cb, first, device)
    launches = {k: w.launches for k, w in wrappers.items()}
    emit(phase="launches", after_main=after_main, after_capacity=launches)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for k, rec in records.items():
        rec["launches"] = launches[k]
    emit(kernels=list(records.values()))
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

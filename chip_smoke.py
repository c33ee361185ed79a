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
5. attention — the paged-attention kernels against their plain versions:
              ``decode_pages`` (the kernels' shared page decoder) BITWISE
              for bf16 / fp8_e5m2 / fp8_e4m3 pages with escape counts 0,
              cap and over cap, padding and repeated slots, NaN/Inf/zero/
              subnormal payloads; ``paged_gqa_attention`` and
              ``paged_mla_attention`` within ``PARTIALS_RTOL`` on edge inputs
              (an empty row, nq 1 and 4 causal, K/V and ckv/krope with their
              own caps, every format) and at the main paths' geometries,
              where each is timed beside its plain version, its bound, and
              SDPA over the same prefix held raw (a yardstick only).
6. resident — smollm-135m at full width, ``resident="compressed"``: batch 8,
              prompt 2048, 40 new tokens through ``serve_once``.  Admitted
              (not demoted), the pool rehydrates bitwise to the prefill
              cache, one flush per row, the exact resident/raw byte counts,
              and teacher-forced logits within 0.12 max|logits| of raw decode.
7. mla      — minicpm3-4b at full width (62 layers), batch 4, prompt 1000,
              40 new tokens: the raw path (cuda backend, n_chunks 1 and 8,
              compression off) bitwise, then the resident path as phase 6.
8. demotion — an out-of-band codebook makes the stream inadmissible: the
              batch demotes once and its tokens equal the raw-resident
              engine's bit for bit.
9. moe      — qwen3-moe-30b-a3b at full width (48 layers, d_model 2048,
              128 experts top-8, about 61 GB of random bf16 weights drawn
              a layer at a time), batch 4, prompt 2048, 40 new tokens: the
              raw path (n_chunks 1 and 8, compression off) bitwise, then
              the resident path as phase 6 (32-token pages).  Peak device
              memory is reported per phase.

Prefill attention runs the flash-attention kernel in every attention layer.
Phase ``flash`` (after phase 5) holds it against its plain version on
seeded edge cases; each family's phase then holds it on the live q/k/v of
its first and last layer (captured from a prefill at the served geometry)
against the plain version and against ``chunked_attention``, and times it
beside the plain version and ``scaled_dot_product_attention`` (a yardstick
the port never calls); phase ``flash_live`` reports the three geometries.

The launch counters are set to 0 right before each main-path run and read
right after it: the served transfer of phase 3 (``encode_fused``,
``decode_fused``), the capacity walk of phase 4 (``encode_dense``,
``decode_dense``), the served resident decode of phases 6
(``paged_gqa_attention``) and 7 (``paged_mla_attention``), and the served
prefills of phases 3, 7 and 9 (``flash_attention``: one launch per layer,
30 + 62 + 48); the checks around those runs are not counted.  The
``kernels`` JSON line, the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": ...}`` close the output.  Without CUDA, or outside
a checkout, it exits non-zero before printing any result.
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
H100_BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core rate
ARCH, BATCH, PROMPT, NEW_TOKENS = "smollm-135m", 8, 2048, 16
RES_TOKENS = 40                  # phase 6: the tails fill and flush at step 32
MLA_ARCH, MLA_BATCH, MLA_PROMPT = "minicpm3-4b", 4, 1000
MOE_ARCH, MOE_BATCH, MOE_PROMPT = "qwen3-moe-30b-a3b", 4, 2048
PROMPT_OF = {ARCH: PROMPT, MLA_ARCH: MLA_PROMPT, MOE_ARCH: MOE_PROMPT}
# |logits| bound of resident vs raw decode, the JAX package's own
# (tests/test_kvpool.py): raw decode accumulates p.v in bf16, the paged
# kernel in f32
LOGITS_BOUND = 0.12


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


def bound_ms(nbytes: float, ops: float, ops_per_s: float = H100_F32_OPS_PER_S):
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_counters():
    """Every kernel wrapper, by its kernel's name."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import splitzip_attention as SA
    from repro_torch.kernels import splitzip_decode as D
    from repro_torch.kernels import splitzip_encode as E
    return {"encode_fused": E.encode_fused, "decode_fused": D.decode_fused,
            "encode_dense": E.encode_dense, "decode_dense": D.decode_dense,
            "paged_gqa_attention": SA.paged_gqa_attention,
            "paged_mla_attention": SA.paged_mla_attention,
            "decode_pages": SA.decode_pages,
            "flash_attention": FA.flash_attention}


def counted(fn, *args):
    """``fn(*args)`` with every launch counter set to 0 just before it and
    read just after it: ``(result, {kernel: launches})``."""
    wrappers = launch_counters()
    for w in wrappers.values():
        w.launches = 0
    out = fn(*args)
    return out, {k: w.launches for k, w in wrappers.items()}


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

    results, tokens, launches = {}, {}, {}
    for label, kw in (("cuda_n1", dict(n_chunks=1)),
                      ("cuda_n8", dict(n_chunks=8)),
                      ("raw", dict(compress=False))):
        eng = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device, **kw)
        res, launches[label] = counted(serve.serve_once, eng, prompt, NEW_TOKENS)
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
    return cb, first, params, prompt, launches


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
    out, launches = counted(eng.transfer, state)
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
    return launches


# ---------------------------------------------------------------------------
# phase 5: the paged-attention kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN_KERNELS = {
    "paged_gqa_attention": ("src/repro_torch/kernels/csrc/splitzip_attention.cu",
                            "src/repro/kernels/splitzip_attention.py:212"),
    "paged_mla_attention": ("src/repro_torch/kernels/csrc/splitzip_attention.cu",
                            "src/repro/kernels/splitzip_attention.py:360"),
}
# the main paths' geometries: smollm-135m at batch 8 after a 2048-token
# prompt (80-token pages, 25 full), minicpm3-4b at batch 4 after 1000
# tokens (64-token pages, 15 full)
GQA_MAIN = dict(batch=BATCH, nq=1, heads=9, hkv=3, hd=64, dv=64, tp=80,
                pages=27, lens=[PROMPT] * BATCH)
MLA_MAIN = dict(batch=MLA_BATCH, nq=1, heads=40, rank=256, rope=32, tp=64,
                pages=17, lens=[MLA_PROMPT] * MLA_BATCH)
GQA_EDGE = dict(batch=3, heads=4, hkv=2, hd=32, dv=128, tp=16, pages=4,
                lens=[64, 37, 9])           # dv != hd, own caps, an empty row
MLA_EDGE = dict(batch=3, heads=8, rank=128, rope=32, tp=32, pages=3,
                lens=[96, 50, 20])          # own caps, an empty row


def _page_bytes(streams):
    sm, _, pos, _, _ = streams
    pe = sm.shape[1] * sm.shape[2]
    return 1.5 * pe + 3 * pos.shape[1] + 4


def attention_work(case, kind):
    """(bytes, operations) the call must move and do: every full page's
    compressed streams and page-table entries read once, q read, the f32
    partials written; nq H Tp (score width + context width) multiply-adds a
    page, two operations each (the rate counts a fused multiply-add as
    two)."""
    tp = case["tokens_per_page"]
    if kind == "gqa":
        q = case["q"]
        b, nq, h, hd = q.shape
        s0, s1, table = case["k_streams"], case["v_streams"], case["page_table_k"]
        dv = s1[0].shape[1] * s1[0].shape[2] // tp // case["hkv"]
        width, out_w = hd + dv, dv
        q_bytes = q.numel() * 2
    else:
        ql, qr = case["q_lat"], case["q_rope"]
        b, nq, h, r = ql.shape
        s0, s1, table = case["ckv_streams"], case["krope_streams"], \
            case["page_table_ckv"]
        width, out_w = 2 * r + qr.shape[-1], r
        q_bytes = (ql.numel() + qr.numel()) * 2
    n = int((case["cache_len"] // tp).clamp(max=table.shape[1]).sum())
    nbytes = (n * (_page_bytes(s0) + _page_bytes(s1) + 8) + q_bytes
              + b * nq * h * (out_w + 2) * 4 + b * 4)
    return nbytes, n * 2 * nq * h * tp * width


def raw_sdpa_ms(torch, case, kind):
    """SDPA over the same prefix held RAW in bf16 (the decoded full pages):
    a yardstick of what attention over uncompressed KV costs here.  Not the
    same function (no page decode, normalized output) and never called by
    the port."""
    import torch.nn.functional as F
    from repro_torch.core import codec as C
    from repro_torch.kernels import splitzip_attention as SA
    tp = case["tokens_per_page"]
    fmt, exps, chunk = case["fmt"], case["exponents"], case["chunk"]

    def prefix(streams, table):
        n = int((case["cache_len"] // tp).min())
        ids = table[:, :n].reshape(-1).long()
        sel = tuple(C.unsigned_view(C.signed_view(t)[ids]) if t.dtype == torch.uint16
                    else t[ids] for t in streams)
        bits = SA.decode_pages_plain(sel, exps, fmt, chunk)
        return SA.bits_to_float(bits, fmt).to(torch.bfloat16).reshape(
            table.shape[0], n * tp, -1)

    if kind == "gqa":
        q = case["q"]
        b, nq, h, hd = q.shape
        hkv = case["hkv"]
        k = prefix(case["k_streams"], case["page_table_k"]).reshape(b, -1, hkv, hd)
        v = prefix(case["v_streams"], case["page_table_v"]).reshape(b, -1, hkv, hd)
        k = k.transpose(1, 2).repeat_interleave(h // hkv, dim=1).contiguous()
        v = v.transpose(1, 2).repeat_interleave(h // hkv, dim=1).contiguous()
        qq = q.transpose(1, 2).contiguous()
    else:
        ql, qr = case["q_lat"], case["q_rope"]
        b, nq, h, r = ql.shape
        c = prefix(case["ckv_streams"], case["page_table_ckv"])
        kr = prefix(case["krope_streams"], case["page_table_krope"])
        k = torch.cat([c, kr], dim=-1)[:, None].expand(b, h, -1, -1).contiguous()
        v = c[:, None].expand(b, h, -1, -1).contiguous()
        qq = torch.cat([ql, qr], dim=-1).transpose(1, 2).contiguous()
    scale = case["scale"]
    return cuda_ms(lambda: F.scaled_dot_product_attention(qq, k, v, scale=scale),
                   reps=20)


def phase_attention(torch, device):
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import cases as K
    from repro_torch.kernels import splitzip_attention as SA

    # the shared page decoder, bitwise, every format
    n_dec = 0
    for name, fmt, exps, streams in AC.decode_cases(seed=3):
        dev = tuple(t.to(device) for t in streams)
        got = SA.decode_pages(dev, exps, fmt, 1024)
        torch.cuda.synchronize()
        if K.max_abs_err((got,), (SA.decode_pages_plain(dev, exps, fmt, 1024),)) != 0:
            raise AssertionError(f"decode_pages {name}: kernel != plain")
        n_dec += 1

    # edge inputs, every format, nq 1 and 4 (causal)
    n_edge, worst_edge = 0, 0.0
    for fmt in ("bf16", "fp8_e5m2", "fp8_e4m3"):
        for nq in (1, 4):
            for kind, make, kw, fn in (
                    ("gqa", AC.gqa_case, GQA_EDGE, SA.paged_gqa_attention),
                    ("mla", AC.mla_case, MLA_EDGE, SA.paged_mla_attention)):
                case = AC.to_device(make(fmt, 20 + nq, nq=nq, **kw), device)
                got = fn(**case)
                torch.cuda.synchronize()
                plain = SA.paged_gqa_attention_plain if kind == "gqa" \
                    else SA.paged_mla_attention_plain
                worst_edge = max(worst_edge, AC.check_partials(got, plain(**case)))
                n_edge += 1

    # the main paths' geometries: check, then time
    records = {}
    for name, kind, make, kw, fn, plain in (
            ("paged_gqa_attention", "gqa", AC.gqa_case, GQA_MAIN,
             SA.paged_gqa_attention, SA.paged_gqa_attention_plain),
            ("paged_mla_attention", "mla", AC.mla_case, MLA_MAIN,
             SA.paged_mla_attention, SA.paged_mla_attention_plain)):
        case = AC.to_device(make("bf16", 7, **kw), device)
        k_streams = case["k_streams"] if kind == "gqa" else case["ckv_streams"]
        got_bits = SA.decode_pages(k_streams, case["exponents"], "bf16", 1024)
        if K.max_abs_err((got_bits,), (SA.decode_pages_plain(
                k_streams, case["exponents"], "bf16", 1024),)) != 0:
            raise AssertionError(f"{name}: page decode != plain at main geometry")
        err = AC.check_partials(fn(**case), plain(**case))
        nbytes, ops = attention_work(case, kind)
        b_ms, b_by = bound_ms(nbytes, ops)
        ms = cuda_ms(lambda: fn(**case), reps=20)
        records[name] = dict(
            name=name, route="cuda", source=ATTN_KERNELS[name][0],
            replaces=ATTN_KERNELS[name][1], launches=None, max_abs_err=err,
            tolerance=f"rtol {AC.PARTIALS_RTOL} (f32 sums in another order)",
            ms=ms, kernel_ms=ms, plain_ms=cuda_ms(lambda: plain(**case), reps=3,
                                                  warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            library="none: no single PyTorch call decodes pages",
            raw_sdpa_ms=raw_sdpa_ms(torch, case, kind), bytes=nbytes, ops=ops,
            geometry={k: v for k, v in kw.items() if k != "lens"},
            cache_len=kw["lens"][0])
    torch.cuda.empty_cache()
    emit(phase="attention", decode_cases=n_dec, edge_cases=n_edge,
         edge_max_abs_err=worst_edge, decode_bitwise=True,
         timed={k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "raw_sdpa_ms",
                                      "max_abs_err", "bytes")}
                for k, v in records.items()})
    return records


# ---------------------------------------------------------------------------
# prefill flash attention against its plain version
# ---------------------------------------------------------------------------

FLASH_KERNEL = ("src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:91")


def phase_flash(torch, device):
    """The kernel against ``flash_attention_ref`` on every seeded edge case,
    with each case's tolerance, and twice: the same bits on a second run."""
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import flash_attention as FA
    worst = {}
    for c in AC.flash_cases(seed=1):
        q, k, v = (t.to(device) for t in (c["q"], c["k"], c["v"]))
        got = FA.flash_attention(q, k, v, causal=c["causal"])
        torch.cuda.synchronize()
        want = FA.flash_attention_ref(q, k, v, causal=c["causal"])
        worst[c["name"]] = AC.check_close(got, want, *c["tol"])
        if not torch.equal(got, FA.flash_attention(q, k, v, causal=c["causal"])):
            raise AssertionError(f"flash {c['name']}: two runs differ")
    emit(phase="flash", edge_cases=len(worst), max_abs_err=worst,
         tolerances={k: list(v) for k, v in AC.FLASH_TOL.items()},
         deterministic=True)


def capture_flash(fn, *args):
    """``fn(*args)`` with the q/k/v of its first and last flash-attention
    call kept (the first and last attention layer of a prefill): the
    layers' handle on the kernel module is swapped for a recorder that
    calls the real wrapper, whose launch counter stays its own."""
    import types
    from repro_torch.models import layers as L
    kernels, seen = L.FA, []

    def keep(q, k, v, **kw):
        seen[1:] = [(q, k, v, kw)]
        return kernels.flash_attention(q, k, v, **kw)

    L.FA = types.SimpleNamespace(flash_attention=keep)
    try:
        out = fn(*args)
    finally:
        L.FA = kernels
    return out, (seen[0], seen[-1])


def flash_live(torch, layers, arch):
    """The kernel on a served prefill's live q/k/v (first and last layer)
    against its plain version (one bf16 ulp) and ``chunked_attention``
    (the JAX package's 3e-2), then timed on the first layer's beside the
    plain version and SDPA (causal, GQA, the same bf16 inputs)."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L
    errs = []
    for q, k, v, kw in layers:
        causal = kw.get("causal", True)
        got = FA.flash_attention(q, k, v, causal=causal)
        errs.append(dict(
            plain=AC.check_close(got, FA.flash_attention_ref(q, k, v, causal=causal),
                                 *AC.FLASH_TOL["bf16"]),
            chunked=AC.check_close(got, L.chunked_attention(q, k, v, causal=causal,
                                                            kv_block=512),
                                   AC.FLASH_VS_CHUNKED, AC.FLASH_VS_CHUNKED)))
        torch.cuda.empty_cache()
    q, k, v, kw = layers[0]
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    nbytes = FA.hbm_bytes(b, sq, skv, h, hkv, d, dv)
    ops = FA.flops(b, sq, skv, h, d, dv, causal=True)
    b_ms, b_by = bound_ms(nbytes, ops, H100_BF16_OPS_PER_S)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
        library = "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
    except RuntimeError as exc:      # e.g. a value width SDPA refuses
        sdpa, library = None, f"none: SDPA refused ({str(exc).splitlines()[0]})"
    ms = cuda_ms(lambda: FA.flash_attention(q, k, v), reps=10)
    rec = dict(arch=arch, geometry=dict(B=b, S=sq, H=h, Hkv=hkv, d=d, dv=dv),
               max_abs_err=max(e["plain"] for e in errs), errors=errs,
               ms=ms, plain_ms=cuda_ms(lambda: FA.flash_attention_ref(q, k, v),
                                       reps=2, warmup=1),
               bound_ms=b_ms, bound_by=b_by, library_ms=sdpa, library=library,
               bytes=nbytes, ops=ops, tflops=ops / ms / 1e9)
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phases 6 and 7: compressed-resident decode at full width
# ---------------------------------------------------------------------------

def live_pool_check(torch, cfg, states, device) -> float:
    """The family's paged kernel against its plain version on live pools
    after their flush: the real page tables (pages allocated in (row, page,
    layer) order at admission, (layer, row) order at the flush), the
    flushed pages, every row's own length; the first and last layer,
    seeded queries.  Returns the largest absolute difference."""
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import splitzip_attention as SA
    from repro_torch.models import mla as MLA
    gen = torch.Generator(device=device).manual_seed(5)

    def q(*shape):
        return (0.25 * torch.randn(*shape, generator=gen, device=device)
                ).to(torch.bfloat16)

    worst = 0.0
    for st in states:
        g, b, h = st.geom, st.geom.batch, cfg.num_heads
        common = dict(cache_len=st.cache_len, exponents=g.exponents,
                      chunk=g.chunk, tokens_per_page=g.tokens_per_page,
                      causal=True)
        for i in (0, g.n_layers - 1):
            if cfg.mla is not None:
                c, r = st.leaves["ckv"], st.leaves["krope"]
                kw = dict(q_lat=q(b, 1, h, cfg.mla.kv_lora_rank),
                          q_rope=q(b, 1, h, cfg.mla.qk_rope_head_dim),
                          ckv_streams=c.streams(), krope_streams=r.streams(),
                          page_table_ckv=c.page_table[i],
                          page_table_krope=r.page_table[i],
                          fmt=g.leaf("ckv").fmt, scale=MLA.mla_scale(cfg.mla),
                          **common)
                fn, plain = SA.paged_mla_attention, SA.paged_mla_attention_plain
            else:
                k, v = st.leaves["k"], st.leaves["v"]
                kw = dict(q=q(b, 1, h, cfg.head_dim), k_streams=k.streams(),
                          v_streams=v.streams(), page_table_k=k.page_table[i],
                          page_table_v=v.page_table[i], fmt=g.leaf("k").fmt,
                          hkv=cfg.num_kv_heads, scale=1.0 / cfg.head_dim ** 0.5,
                          **common)
                fn, plain = SA.paged_gqa_attention, SA.paged_gqa_attention_plain
            worst = max(worst, AC.check_partials(fn(**kw), plain(**kw)))
    return worst


def resident_checks(torch, cfg, params, cb, prompt, new_tokens, device, *,
                    want_bytes, want_max_seq):
    """Serve ``resident="compressed"`` through ``serve_once`` (its launches
    counted), then hold a fresh admission of the same prefill against the
    prefill cache (bitwise rehydrate, exact bytes), teacher-force the served
    tokens through resident and raw decode steps side by side, and hold the
    paged kernel against its plain version on both flushed pools.  The
    fresh admission's prefill is the one whose first and last layer hold
    the flash-attention kernel (``flash_live``).  Returns the phase's record
    and the served run's launches."""
    from repro_torch.core import codec as C
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.kvcache import DecodeState
    from repro_torch.serving.engine import DisaggregatedEngine

    eng = DisaggregatedEngine(cfg, params, cb, resident="compressed",
                              backend="cuda", device=device)
    res, launches = counted(serve.serve_once, eng, prompt, new_tokens)
    st = eng.stats
    if (st.resident_admits, st.resident_demotions) != (1, 0):
        raise AssertionError(f"admits/demotions {st.resident_admits}/"
                             f"{st.resident_demotions}, want 1/0")
    pool = eng._pool
    g = pool.geom
    if g.max_seq != want_max_seq:
        raise AssertionError(f"max_seq {g.max_seq} != {want_max_seq}")
    n_full0 = PROMPT_OF[cfg.name] // g.tokens_per_page
    flushed = {lg.key: pool.allocated_pages(lg.key)
               - g.n_layers * g.batch * n_full0 for lg in g.leaves}
    if any(v != g.n_layers * g.batch for v in flushed.values()):
        raise AssertionError(f"flush allocated {flushed}, want "
                             f"{g.n_layers * g.batch} pages a leaf")
    got_bytes = (pool.hbm_bytes(), pool.raw_bytes())
    if got_bytes != want_bytes:
        raise AssertionError(f"resident/raw bytes {got_bytes} != {want_bytes}")

    eng_raw = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device)
    raw = serve.serve_once(eng_raw, prompt, new_tokens)
    same_tok = (res.tokens == raw.tokens)
    agree = float(same_tok.float().mean())
    # per row, the first generated position where resident and raw differ
    # (random weights give flat logits, so one flip changes all that follows)
    first_diff = [int(torch.nonzero(~row)[0]) if not bool(row.all()) else None
                  for row in same_tok.cpu()]

    # a fresh admission of the same prefill: rehydrate, then teacher forcing
    eng_tf = DisaggregatedEngine(cfg, params, cb, resident="compressed",
                                 backend="cuda", device=device)
    pre, flash_layers = capture_flash(eng_tf.prefill, prompt, want_max_seq)
    flash = flash_live(torch, flash_layers, cfg.name)
    del flash_layers
    rst = eng_tf.transfer(pre.state)
    tpool = eng_tf._pool
    reh = tpool.rehydrate(rst)
    for k, v in pre.state.cache.items():
        if not C.bits_equal(reh[k], v):
            raise AssertionError(f"rehydrate after admission != prefill cache ({k})")
    del reh
    raw_st = DecodeState(cache={k: v.clone() for k, v in pre.state.cache.items()},
                         cache_len=pre.state.cache_len.clone())
    worst, served_argmax = 0.0, 0
    t_res = t_raw = 0.0
    with torch.no_grad():
        for i in range(new_tokens):
            tok = res.tokens[:, i:i + 1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lr, raw_st = M.decode_step(params, tok, raw_st, cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lc, rst = M.resident_decode_step(params, tok, rst, cfg)
            rst = tpool.flush_full_tails(rst)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            t_raw, t_res = t_raw + (t1 - t0), t_res + (t2 - t1)
            a, b = lr.float(), lc.float()
            if not bool(torch.isfinite(b).all()):
                raise AssertionError(f"non-finite resident logits at step {i}")
            scale = max(1e-3, float(a.abs().max()))
            ratio = float((a - b).abs().max()) / scale
            worst = max(worst, ratio)
            if ratio >= LOGITS_BOUND:
                raise AssertionError(f"step {i}: |resident - raw| = {ratio:.4f} "
                                     f"max|logits| >= {LOGITS_BOUND}")
            served_argmax += int(torch.equal(
                torch.argmax(lc, dim=-1).to(torch.int32), res.tokens[:, i + 1]))
    live_err = live_pool_check(torch, cfg, (pool.state, rst), device)
    return dict(
        tokens_per_page=g.tokens_per_page, max_seq=g.max_seq,
        resident_admits=st.resident_admits,
        resident_demotions=st.resident_demotions, flushed_pages=flushed,
        resident_hbm_bytes=got_bytes[0], resident_raw_bytes=got_bytes[1],
        resident_ratio=got_bytes[1] / got_bytes[0],
        transfer_ratio=st.transfer_ratio,
        rehydrate_bitwise=True, tokens_agree_with_raw=agree,
        first_divergence_per_row=first_diff,
        teacher_forced_max_ratio=worst, logits_bound=LOGITS_BOUND,
        teacher_forced_steps_matching_served=served_argmax,
        live_pool_max_abs_err=live_err, live_pool_rtol=AC.PARTIALS_RTOL,
        seconds_resident=res.seconds, seconds_raw=raw.seconds,
        step_ms_resident=t_res / new_tokens * 1e3,
        step_ms_raw=t_raw / new_tokens * 1e3, served_launches=launches,
        flash_live=flash), launches


def phase_resident(torch, cfg, params, cb, prompt, device):
    out, launches = resident_checks(
        torch, cfg, params, cb, prompt, RES_TOKENS, device,
        want_bytes=(315_780_480, 398_131_200), want_max_seq=2160)
    emit(phase="resident", arch=cfg.name, batch=BATCH, prompt=PROMPT,
         new_tokens=RES_TOKENS, **out)
    return launches, out["flash_live"]


def phase_mla(torch, device):
    from repro_torch.configs.base import get_config
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DisaggregatedEngine

    cfg = get_config(MLA_ARCH)
    gen = torch.Generator(device=device).manual_seed(10)
    params = M.init_params(cfg, gen, device)
    cb = serve.calibrate_on_model(cfg, params, device=device, seed=11)
    prompt = serve.make_prompt(cfg, MLA_BATCH, MLA_PROMPT, device=device, seed=12)
    raw_runs, tokens = {}, {}
    for label, kw in (("cuda_n1", dict(n_chunks=1)),
                      ("cuda_n8", dict(n_chunks=8)),
                      ("raw", dict(compress=False))):
        eng = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device, **kw)
        res = serve.serve_once(eng, prompt, RES_TOKENS)
        if not all(C.bits_equal(x, y) for x, y in zip(
                TR.leaves(res.delivered.cache), TR.leaves(res.prefill.state.cache))):
            raise AssertionError(f"mla {label}: delivered cache != prefill cache")
        tokens[label] = res.tokens
        raw_runs[label] = dict(seconds=res.seconds,
                               transfer_ratio=eng.stats.transfer_ratio,
                               codec_ok=eng.stats.codec_ok)
        del res, eng
    for label in ("cuda_n8", "raw"):
        if not torch.equal(tokens[label], tokens["cuda_n1"]):
            raise AssertionError(f"mla tokens differ: {label} vs cuda_n1")
    out, launches = resident_checks(
        torch, cfg, params, cb, prompt, RES_TOKENS, device,
        want_bytes=(126_684_352, 155_418_624), want_max_seq=1088)
    emit(phase="mla", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, kv_lora_rank=cfg.mla.kv_lora_rank,
         rope=cfg.mla.qk_rope_head_dim, vocab=cfg.vocab_size,
         batch=MLA_BATCH, prompt=MLA_PROMPT, new_tokens=RES_TOKENS,
         raw_runs=raw_runs, raw_tokens_equal=True, delivered_bitwise=True,
         **out)
    del params
    torch.cuda.empty_cache()
    return launches, out["flash_live"]


def phase_moe(torch, device):
    """qwen3-moe-30b-a3b at full width: the raw path bitwise, then the
    resident path (``resident_checks``).  Returns the served resident run's
    launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DisaggregatedEngine

    def peak_gb():
        gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        return gb

    cfg = get_config(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(20),
                           device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(x.numel() * x.element_size() for x in TR.leaves(params))
    peak = {"init": peak_gb()}
    cb = serve.calibrate_on_model(cfg, params, device=device, seed=21)
    prompt = serve.make_prompt(cfg, MOE_BATCH, MOE_PROMPT, device=device, seed=22)
    raw_runs, tokens = {}, {}
    for label, kw in (("cuda_n1", dict(n_chunks=1)),
                      ("cuda_n8", dict(n_chunks=8)),
                      ("raw", dict(compress=False))):
        eng = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device, **kw)
        res = serve.serve_once(eng, prompt, RES_TOKENS)
        if not all(C.bits_equal(x, y) for x, y in zip(
                TR.leaves(res.delivered.cache), TR.leaves(res.prefill.state.cache))):
            raise AssertionError(f"moe {label}: delivered cache != prefill cache")
        tokens[label] = res.tokens
        raw_runs[label] = dict(seconds=res.seconds,
                               transfer_ratio=eng.stats.transfer_ratio,
                               raw_bytes=eng.stats.raw_cache_bytes,
                               wire_bytes=eng.stats.wire_bytes,
                               codec_ok=eng.stats.codec_ok)
        del res, eng
        peak[label] = peak_gb()
    for label in ("cuda_n8", "raw"):
        if not torch.equal(tokens[label], tokens["cuda_n1"]):
            raise AssertionError(f"moe tokens differ: {label} vs cuda_n1")
    out, launches = resident_checks(
        torch, cfg, params, cb, prompt, RES_TOKENS, device,
        want_bytes=(640_505_856, 830_472_192), want_max_seq=2112)
    peak["resident"] = peak_gb()
    emit(phase="moe", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
         experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
         d_ff_expert=cfg.moe.d_ff_expert, vocab=cfg.vocab_size,
         weight_bytes=weight_bytes, init_seconds=init_s,
         batch=MOE_BATCH, prompt=MOE_PROMPT, new_tokens=RES_TOKENS,
         raw_runs=raw_runs, raw_tokens_equal=True, delivered_bitwise=True,
         peak_memory_gb=peak, **out)
    del params
    torch.cuda.empty_cache()
    return launches, out["flash_live"]


def phase_demotion(torch, cfg, params, prompt, device):
    from repro_torch.core.codebook import Codebook
    from repro_torch.launch import serve
    from repro_torch.serving.engine import DisaggregatedEngine

    bad = Codebook(fmt="bf16", exponents=tuple(range(16)))   # every value escapes
    eng_res = DisaggregatedEngine(cfg, params, bad, resident="compressed",
                                  backend="cuda", device=device)
    eng_raw = DisaggregatedEngine(cfg, params, bad, backend="cuda", device=device)
    max_seq = eng_res.resident_max_seq(PROMPT + 1 + NEW_TOKENS)
    res, launches = counted(serve.serve_once, eng_res, prompt, NEW_TOKENS)
    raw = serve.serve_once(eng_raw, prompt, NEW_TOKENS, max_seq=max_seq)
    if (eng_res.stats.resident_demotions, eng_res.stats.resident_admits) != (1, 0):
        raise AssertionError("inadmissible stream: expected one demotion")
    if not torch.equal(res.tokens, raw.tokens):
        raise AssertionError("demoted tokens != raw-resident tokens")
    emit(phase="demotion", resident_demotions=1, tokens_bitwise=True,
         max_seq=max_seq, seconds=res.seconds)
    return launches


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    t_start = t0 = time.perf_counter()
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
    records.update(phase_attention(torch, device))
    phase_flash(torch, device)

    # each main-path run is counted alone (``counted``): the served
    # transfer (phase 3, cuda n_chunks 1), the capacity walk (phase 4), and
    # the served resident decodes of each family (phases 6, 7 and 9); the
    # served prefills of phases 3, 7 and 9 count the flash-attention kernel
    cb, first, params, prompt, main_runs = phase_main(torch, cfg, device)
    windows = {"main": main_runs["cuda_n1"], "main_n8": main_runs["cuda_n8"],
               "capacity": phase_capacity(torch, cfg, cb, first, device)}
    del first
    flash = {}
    windows["resident"], flash[ARCH] = phase_resident(torch, cfg, params, cb,
                                                      prompt, device)
    windows["mla"], flash[MLA_ARCH] = phase_mla(torch, device)
    windows["demotion"] = phase_demotion(torch, cfg, params, prompt, device)
    del params, cb, prompt
    torch.cuda.empty_cache()
    windows["moe"], flash[MOE_ARCH] = phase_moe(torch, device)
    emit(phase="launches", **windows)
    emit(phase="flash_live", geometries=flash)
    owner = {"encode_fused": "main", "decode_fused": "main",
             "encode_dense": "capacity", "decode_dense": "capacity",
             "paged_gqa_attention": "resident", "paged_mla_attention": "mla"}
    for k, rec in records.items():
        rec["launches"] = windows[owner[k]][k]
    # the flash-attention kernel: one launch per layer of each served prefill
    served_prefills = {ARCH: ("main", 30), MLA_ARCH: ("mla", 62),
                       MOE_ARCH: ("moe", 48)}
    by_arch = {a: windows[w]["flash_attention"] for a, (w, _) in served_prefills.items()}
    if by_arch != {a: n for a, (_, n) in served_prefills.items()}:
        raise AssertionError(f"flash_attention launches per served prefill "
                             f"{by_arch}, want one per attention layer")
    moe_rec = flash[MOE_ARCH]
    records["flash_attention"] = dict(
        name="flash_attention", route="cuda", source=FLASH_KERNEL[0],
        replaces=FLASH_KERNEL[1], launches=sum(by_arch.values()),
        launches_by_arch=by_arch, max_abs_err=moe_rec["max_abs_err"],
        tolerance="atol 1e-3, rtol 8e-3 (one bf16 ulp)",
        ms=moe_rec["ms"], kernel_ms=moe_rec["ms"], plain_ms=moe_rec["plain_ms"],
        bound_ms=moe_rec["bound_ms"], bound_by=moe_rec["bound_by"],
        library_ms=moe_rec["library_ms"], library=moe_rec["library"],
        bytes=moe_rec["bytes"], ops=moe_rec["ops"], geometry=moe_rec["geometry"],
        geometries={a: {k: r[k] for k in ("geometry", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "max_abs_err")}
                    for a, r in flash.items()})
    missing = [k for k, rec in records.items() if not rec["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if windows["resident"]["paged_gqa_attention"] < 30 * RES_TOKENS:
        raise AssertionError("paged_gqa_attention: fewer than one launch per "
                             "layer and step on the resident path")
    if windows["mla"]["paged_mla_attention"] < 62 * RES_TOKENS:
        raise AssertionError("paged_mla_attention: fewer than one launch per "
                             "layer and step on the MLA resident path")
    if windows["moe"]["paged_gqa_attention"] < 48 * RES_TOKENS:
        raise AssertionError("paged_gqa_attention: fewer than one launch per "
                             "layer and step on the MoE resident path")
    emit(kernels=list(records.values()), seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

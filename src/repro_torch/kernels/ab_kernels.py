"""Time a redesigned kernel beside an earlier revision's, in turns.

    PYTHONPATH=src python -m repro_torch.kernels.ab_kernels --old DIR \
        [--kernel paged_mla_attention|encode_fused|decode_fused|decode_dense|
                  flash_attention]
        [--reps N]

``DIR`` holds that revision's source of the kernel (``git show
REV:src/repro_torch/kernels/csrc/<file>``, REV the parent commit) in a
directory git ignores (``build/parent``), with the headers it includes
(else this revision's are used) and, for the codec kernels, both codec
sources.  It is built there with this package's ``nvcc`` flags and called
through its own C entry; this revision's kernel runs through its wrapper.

* ``paged_mla_attention`` (the default; ``splitzip_attention.cu``): the
  earlier ``sz_paged_mla`` (one CTA per row and group of up to 8 heads over
  all its pages, on the f32 CUDA cores, with the token tile, 256 threads and
  shared memory its wrapper chose), at minicpm3-4b's served resident decode
  (``attention_cases.MLA_SERVED``), bf16.
* ``encode_fused`` / ``decode_fused`` / ``decode_dense``
  (``splitzip_encode.cu`` / ``splitzip_decode.cu``): the earlier
  ``sz_encode_fused`` / ``sz_decode_fused`` / ``sz_decode_dense`` through
  today's C prototypes, at the main path's shape (``cases.codec_leaf``: one
  smollm-135m KV leaf, 92,925 rows of 1024 bf16, cap 64) and at the
  escape-heavy one (``cases.escape_heavy``: the same leaf with about two
  escapes a row); ``decode_dense`` on the dense streams
  (``encode_dense``) of each.  Each line has the kernel's grid and its
  raw (bf16) GB/s.  Then says which codec kernels compile to the earlier
  revision's instructions (``sass_equal``: ``cuobjdump``, where the toolkit
  has it), by role, whatever their C++ names.
* ``flash_attention`` (``flash_attention.cu``): the earlier
  ``sz_flash_attention_tc`` (no ``window`` argument) against this
  revision's wrapper without a window, at the served prefill geometries
  (``FLASH_SERVED``), seeded bf16 q/k/v; also whether the two outputs are
  equal bit for bit.

Both outputs are first held against the plain version (bitwise for the
codec), then timed in turns, old, new, new, old: ``old_ms``/``new_ms`` are
device time (``timing.graph_ms``: ``--reps`` calls in one CUDA graph,
replayed), and ``old_eager_ms``/``new_eager_ms`` the same calls issued from
Python (``timing.cuda_ms``), which include a wrapper's host work where it
exceeds its kernels.  One JSON line per shape, then the card's
``nvidia-smi`` line.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import attention_cases as AC
from repro_torch.kernels import build
from repro_torch.kernels import cases as K
from repro_torch.kernels import splitzip_attention as SA
from repro_torch.kernels import splitzip_decode as D
from repro_torch.kernels import splitzip_encode as E
from repro_torch.kernels.splitzip_decode import decode_lut
from repro_torch.kernels.timing import cuda_ms, graph_ms

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: kernel -> (source, its earlier C entry and that entry's argtypes)
OLD_PROTOTYPES = {
    "paged_mla_attention": ("splitzip_attention", {
        "sz_paged_mla": [_I] + [_P] * 18 + [_I] * 15 + [ctypes.c_float]
                        + [_I] * 3 + [_P, _P]}),
    "encode_fused": ("splitzip_encode", {
        "sz_encode_fused": [_I] + [_P] * 6 + [_L, _I, _I, _P, _P]}),
    "decode_fused": ("splitzip_decode", {
        "sz_decode_fused": [_I] + [_P] * 6 + [_L, _I, _I, _P, _P]}),
    "decode_dense": ("splitzip_decode", {
        "sz_decode_dense": [_I] + [_P] * 3 + [_L, _I, _P, _P]}),
    "flash_attention": ("flash_attention", {
        "sz_flash_attention_tc": [_P] * 4 + [_L] * 9 + [_I] * 8
                                 + [ctypes.c_float, _P]}),
}
#: the served prefill geometries without a window: (B, S, H, Hkv, d, dv)
FLASH_SERVED = {"smollm-135m": (8, 2048, 9, 3, 64, 64),
                "minicpm3-4b": (4, 1000, 40, 40, 96, 64),
                "minitron-4b": (4, 2048, 24, 8, 128, 128),
                "qwen3-moe-30b-a3b": (4, 2048, 32, 4, 128, 128)}
#: the codec sources, and the codec kernels this revision leaves alone
CODEC_SOURCES = ("splitzip_encode", "splitzip_decode")
UNCHANGED = ("encode_fused", "encode_dense", "decode_fused")
CODEC_CHUNK, CODEC_CAP = 1024, 64
#: the earlier wrapper's limits: query heads a CTA, the default dynamic
#: shared memory, token sub-tiles tried (largest first)
OLD_HEADS_PER_CTA = 8
OLD_SMEM_DEFAULT = 48 * 1024
OLD_TILES = (64, 32, 16, 8, 4, 2, 1)


def compile_old(old: Path, name: str):
    """The earlier source ``name`` in ``old`` -> (its library's path, the
    ``nvcc`` log).  A header it includes is looked up beside it, then in
    this revision's ``csrc/``."""
    src, so = old / f"{name}.cu", old / f"lib{name}_old.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so),
         str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the old {name}:\n{proc.stdout}")
    return so, proc.stdout


def build_old(old: Path, kernel: str):
    """The earlier source of ``kernel`` in ``old`` -> (loaded library, its
    path, the ``nvcc`` log)."""
    name, prototypes = OLD_PROTOTYPES[kernel]
    so, log = compile_old(old, name)
    lib = ctypes.CDLL(str(so))
    lib.sz_error_string.argtypes = [_I]
    lib.sz_error_string.restype = ctypes.c_char_p
    for fn, argtypes in prototypes.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    return lib, so, log


def _ptxas(log: str):
    """The ``-Xptxas -v`` lines of an ``nvcc`` log: per kernel, its
    registers, spills and shared memory."""
    return [ln.strip() for ln in log.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


def in_turns(old, new, reps: int) -> dict:
    """old, new, new, old, on the device clock and on the eager one."""
    out = {}
    for key, clock in (("", graph_ms), ("eager_", cuda_ms)):
        t = [clock(old, reps), clock(new, reps), clock(new, reps),
             clock(old, reps)]
        out.update({f"old_{key}ms": (t[0] + t[3]) / 2,
                    f"new_{key}ms": (t[1] + t[2]) / 2,
                    f"{key}turns_ms": t})
    out["speedup"] = out["old_ms"] / out["new_ms"]
    return out


def old_tile_and_smem(tp: int, floats_fixed: int, floats_per_token: int):
    """The earlier wrapper's token tile: the largest whose f32 shared memory
    fits the default limit, else the smallest with the limit raised."""
    for tile in OLD_TILES:
        tile = min(tile, tp)
        smem = 4 * (floats_fixed + tile * floats_per_token)
        if smem <= OLD_SMEM_DEFAULT:
            return tile, smem
    return tile, smem


def old_mla(lib, case):
    """The earlier ``sz_paged_mla``: one CTA a (row, group of up to 8
    heads) over all its pages, its tile and shared memory as its wrapper
    chose them."""
    ql, qr = case["q_lat"], case["q_rope"]
    cs, rs = case["ckv_streams"], case["krope_streams"]
    b, nq, h, r = ql.shape
    rope, tp = qr.shape[-1], case["tokens_per_page"]
    hpc = max(d for d in range(1, min(h, OLD_HEADS_PER_CTA) + 1) if h % d == 0)
    rows = nq * hpc
    tile, smem = old_tile_and_smem(tp, rows * (2 * r + rope + 3),
                                   (r + 1) + (rope + 1) + rows)
    acc = torch.empty((b, nq, h, r), dtype=torch.float32, device=ql.device)
    m = torch.empty((b, nq, h), dtype=torch.float32, device=ql.device)
    l = torch.empty_like(m)
    err = lib.sz_paged_mla(
        build.FMT_ID[case["fmt"]], ql.data_ptr(), qr.data_ptr(),
        *(t.data_ptr() for t in cs), *(t.data_ptr() for t in rs),
        case["page_table_ckv"].data_ptr(), case["page_table_krope"].data_ptr(),
        case["cache_len"].data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, nq, h, hpc, r, rope, case["page_table_ckv"].shape[1], tp,
        tp * r, cs[2].shape[1], cs[0].shape[0], tp * rope, rs[2].shape[1],
        rs[0].shape[0], 1, float(case["scale"]), tile, 256, smem,
        decode_lut(case["exponents"]).ctypes.data, build.stream_of(ql))
    build.check(lib, err, "old paged_mla_attention")
    return acc, m, l


def ab_mla(lib, dev, reps: int) -> None:
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, kw in AC.MLA_SERVED.items():
        case = AC.to_device(AC.mla_case("bf16", 7, **kw), dev)
        want = SA.paged_mla_attention_plain(**case)
        AC.check_partials(old_mla(lib, case), want)
        AC.check_partials(SA.paged_mla_attention(**case), want)
        rec = in_turns(lambda: old_mla(lib, case),
                       lambda: SA.paged_mla_attention(**case), reps)
        grid = SA.mla_grid(kw["batch"], kw["nq"], kw["heads"], kw["pages"], n_sm)
        print(json.dumps(dict(kernel="paged_mla_attention", geometry=name,
                              **{k: v for k, v in kw.items() if k != "lens"},
                              cache_len=kw["lens"][0], grid=grid, **rec)),
              flush=True)


def old_encode(lib, x, exps):
    """The earlier ``sz_encode_fused`` into fresh outputs, as its wrapper
    called it."""
    rows, dev = x.shape[0], x.device
    sm = torch.empty((rows, CODEC_CHUNK), dtype=torch.uint8, device=dev)
    packed = torch.empty((rows, CODEC_CHUNK // 2), dtype=torch.uint8, device=dev)
    pos = torch.empty((rows, CODEC_CAP), dtype=torch.uint16, device=dev)
    val = torch.empty((rows, CODEC_CAP), dtype=torch.uint8, device=dev)
    cnt = torch.empty((rows, 1), dtype=torch.int32, device=dev)
    err = lib.sz_encode_fused(
        build.FMT_ID["bf16"], x.data_ptr(), sm.data_ptr(), packed.data_ptr(),
        pos.data_ptr(), val.data_ptr(), cnt.data_ptr(), rows, CODEC_CHUNK,
        CODEC_CAP, E.encode_lut(exps).ctypes.data, build.stream_of(x))
    build.check(lib, err, "old encode_fused")
    return sm, packed, pos, val, cnt


def old_decode(lib, streams, exps):
    """The earlier ``sz_decode_fused`` into a fresh output."""
    packed, sm, pos, val, cnt = streams
    out = torch.empty(sm.shape, dtype=torch.uint16, device=sm.device)
    err = lib.sz_decode_fused(
        build.FMT_ID["bf16"], packed.data_ptr(), sm.data_ptr(), pos.data_ptr(),
        val.data_ptr(), cnt.data_ptr(), out.data_ptr(), sm.shape[0],
        CODEC_CHUNK, CODEC_CAP, decode_lut(exps).ctypes.data,
        build.stream_of(sm))
    build.check(lib, err, "old decode_fused")
    return out


def old_decode_dense(lib, dense, exps):
    """The earlier ``sz_decode_dense`` into a fresh output."""
    sm, packed = dense[0], dense[1]
    out = torch.empty(sm.shape, dtype=torch.uint16, device=sm.device)
    err = lib.sz_decode_dense(
        build.FMT_ID["bf16"], packed.data_ptr(), sm.data_ptr(), out.data_ptr(),
        sm.shape[0], CODEC_CHUNK, decode_lut(exps).ctypes.data,
        build.stream_of(sm))
    build.check(lib, err, "old decode_dense")
    return out


#: a codec kernel's mangled name: (encode|decode), its role where the name
#: has it, element type (t u16, h u8), mbits, ebits, elements a lane where
#: templated, and FUSED where a bool template argument says it (the first
#: port's ``encode_kernel`` / ``decode_kernel``, this ``decode_kernel``)
_CODEC_NAME = re.compile(r"(encode|decode)_(?:(fused|dense)_)?kernelI([th])"
                         r"Li(\d)ELi(\d)E(?:Li(\d+)E)?(?:Lb([01])E)?")


def codec_sass_of(sass: str) -> dict:
    """``{(role, element type, mbits, ebits, lane elements): instructions}``
    of the codec kernels in ``cuobjdump -sass`` text; role is
    ``{encode,decode}_{fused,dense}``, whatever the kernel's C++ name.
    Parameter offsets (constant bank 0) are masked, so a kernel whose
    parameter list moved still compares by its instructions."""
    out, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = _CODEC_NAME.search(m.group(1))
            key = None
            if k:
                op, kind, t, mb, eb, lane, fused = k.groups()
                kind = kind or ("fused" if fused == "1" else "dense")
                key = (f"{op}_{kind}", t, mb, eb, lane or "")
                out[key] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if key is not None and m:
            out[key].append(re.sub(r"c\[0x0\]\[(R\d+\+)?0x[0-9a-f]+\]",
                                   r"c[0x0][\1*]", m.group(1)))
    return out


def sass_equal(old: dict, new: dict) -> dict:
    """``{role: bool}`` for each role in ``UNCHANGED`` that either side
    has: every instantiation present on both sides with equal
    instructions."""
    out = {}
    for role in UNCHANGED:
        a = {k: v for k, v in old.items() if k[0] == role}
        b = {k: v for k, v in new.items() if k[0] == role}
        if a or b:
            out[role] = bool(a) and a == b
    return out


def codec_sass_check(old_dir: Path, built: dict) -> dict:
    """Which of the codec kernels this revision leaves alone compile to the
    same instructions as the earlier revision's (both codec sources from
    ``old_dir``; ``built`` maps a source already built there to its
    library), or ``{"sass_equal": None}`` where the toolkit has no
    ``cuobjdump``."""
    old, new = {}, {}
    for name in CODEC_SOURCES:
        so = built.get(name) or compile_old(old_dir, name)[0]
        a, b = build.sass(so), build.sass(build.library_path(name))
        if a is None or b is None:
            return dict(sass_equal=None)
        old.update(codec_sass_of(a))
        new.update(codec_sass_of(b))
    return dict(sass_equal=sass_equal(old, new),
                kernels_old=sorted("/".join(k) for k in old),
                kernels_new=sorted("/".join(k) for k in new))


def ab_codec(kernel: str, lib, lib_path: Path, old_dir: Path, dev,
             reps: int) -> None:
    x, cb = K.codec_leaf(dev)
    exps = tuple(cb.exponents)
    inputs = {"main": x, "escape_heavy": K.escape_heavy(x, cb)}
    for label, bits in inputs.items():
        rows = bits.shape[0]
        enc = E.encode_fused(bits, exps, "bf16", CODEC_CHUNK, CODEC_CAP)
        streams = (enc[1], enc[0], enc[2], enc[3],
                   torch.clamp(enc[4], max=CODEC_CAP))
        if kernel == "encode_fused":
            old = lambda: old_encode(lib, bits, exps)
            new = lambda: E.encode_fused(bits, exps, "bf16", CODEC_CHUNK, CODEC_CAP)
            want = E.encode_fused_plain(bits, exps, "bf16", CODEC_CHUNK, CODEC_CAP)
            grid = E.fused_grid("bf16", rows, CODEC_CHUNK, dev)
        elif kernel == "decode_fused":
            old = lambda: (old_decode(lib, streams, exps),)
            new = lambda: (D.decode_fused(*streams, exps, "bf16", CODEC_CHUNK),)
            want = (D.decode_fused_plain(*streams, exps, "bf16", CODEC_CHUNK),)
            grid = D.fused_grid("bf16", rows, CODEC_CHUNK, dev)
        else:
            dense = E.encode_dense(bits, exps, "bf16", CODEC_CHUNK)
            old = lambda: (old_decode_dense(lib, dense, exps),)
            new = lambda: (D.decode_dense(dense[1], dense[0], exps, "bf16",
                                          CODEC_CHUNK),)
            want = (D.decode_dense_plain(dense[1], dense[0], exps, "bf16",
                                         CODEC_CHUNK),)
            grid = D.dense_grid("bf16", rows, CODEC_CHUNK, dev)
        for who, fn in (("old", old), ("new", new)):
            if K.max_abs_err(fn(), want) != 0:
                raise AssertionError(f"{who} {kernel} != plain on {label}")
        escapes = int(enc[4].sum())
        rec = in_turns(old, new, reps)
        raw = 2 * bits.numel()          # the bf16 bytes a leaf holds
        print(json.dumps(dict(kernel=kernel, input=label, rows=rows,
                              chunk=CODEC_CHUNK, cap=CODEC_CAP,
                              escapes=escapes, escapes_per_row=escapes / rows,
                              applied=int(streams[4].sum()), bitwise_equal=True,
                              grid=[grid, E.FUSED_WARPS],
                              old_raw_gb_per_s=raw / rec["old_ms"] / 1e6,
                              new_raw_gb_per_s=raw / rec["new_ms"] / 1e6,
                              **rec)), flush=True)
        del enc, streams, want, old, new
        torch.cuda.empty_cache()
    built = {OLD_PROTOTYPES[kernel][0]: lib_path}
    print(json.dumps(dict(kernel=kernel, **codec_sass_check(old_dir, built))),
          flush=True)


def ab_flash(lib, dev, reps: int) -> None:
    from repro_torch.kernels import flash_attention as FA
    for arch, (b, s, h, hkv, d, dv) in FLASH_SERVED.items():
        gen = torch.Generator(device=dev).manual_seed(b * s + h)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, dv)))
        out = torch.empty((b, s, h, dv), dtype=torch.bfloat16, device=dev)
        scale = float(d ** -0.5)

        def old():
            err = lib.sz_flash_attention_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], b, s, s, h,
                hkv, d, dv, 1, scale, build.stream_of(q))
            if err:
                raise RuntimeError(lib.sz_error_string(err).decode())
            return out

        def new():
            return FA.flash_attention(q, k, v, causal=True)

        want = FA.flash_attention_ref(q, k, v, causal=True)
        for fn in (old, new):
            AC.check_close(fn(), want, *AC.FLASH_TOL["bf16"])
        same = bool(torch.equal(old().clone(), new()))
        rec = in_turns(old, new, reps)
        print(json.dumps(dict(kernel="flash_attention", arch=arch,
                              geometry=dict(B=b, S=s, H=h, Hkv=hkv, d=d, dv=dv),
                              bitwise_equal=same, **rec)), flush=True)
        del q, k, v, out, want
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path,
                    help="directory with the earlier revision's .cu source")
    ap.add_argument("--kernel", default="paged_mla_attention",
                    choices=sorted(OLD_PROTOTYPES))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lib, lib_path, old_log = build_old(args.old, args.kernel)
    new_log = build.build_all().get(OLD_PROTOTYPES[args.kernel][0], "")
    print(json.dumps(dict(kernel=args.kernel, ptxas_old=_ptxas(old_log),
                          ptxas_new=_ptxas(new_log))), flush=True)
    if args.kernel == "paged_mla_attention":
        ab_mla(lib, dev, args.reps)
    elif args.kernel == "flash_attention":
        ab_flash(lib, dev, args.reps)
    else:
        ab_codec(args.kernel, lib, lib_path, args.old, dev, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

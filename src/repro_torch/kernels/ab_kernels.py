"""Time the two redesigned attention kernels beside an earlier revision's.

    PYTHONPATH=src python -m repro_torch.kernels.ab_kernels --old DIR [--reps N]

``DIR`` holds that revision's ``flash_attention.cu`` and
``splitzip_attention.cu`` (``git show REV:src/repro_torch/kernels/csrc/<file>``)
in a directory git ignores.  They are built there with this package's
``nvcc`` flags and called through their own C entries (``sz_flash_attention``
as both revisions declare it; ``sz_paged_gqa`` with the earlier one's token
tile, 128 threads and shared memory, as its wrapper chose them).  This
revision's kernels run through their wrappers.

Each geometry is timed in turns, old, new, new, old, after both outputs
are held against the plain version: ``old_ms``/``new_ms`` are device time
(``timing.graph_ms``: ``--reps`` calls in one CUDA graph, replayed), and
``old_eager_ms``/``new_eager_ms`` the same calls issued from Python
(``timing.cuda_ms``), which include a wrapper's host work where it exceeds
its kernels.  The geometries: prefill flash attention at the three served prefills' shapes and
layouts (qwen3-moe-30b-a3b, smollm-135m, minicpm3-4b, whose ``v`` is a head
slice of ``kv``; seeded bf16 values, since neither kernel's work depends on
them), paged GQA at the served resident geometries (``GQA_SERVED``).  One
JSON line a geometry, then the card's ``nvidia-smi`` line.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import attention_cases as AC
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import splitzip_attention as SA
from repro_torch.kernels.splitzip_decode import decode_lut
from repro_torch.kernels.timing import cuda_ms, graph_ms

_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_PROTOTYPES = {
    "flash_attention": {
        "sz_flash_attention": FA._PROTOTYPES["sz_flash_attention"]},
    "splitzip_attention": {
        "sz_paged_gqa": [_I] + [_P] * 17 + [_I] * 15 + [ctypes.c_float]
                        + [_I] * 3 + [_P, _P]},
}

#: (name, B, S, H, Hkv, d, dv, v read from a wider head axis of this width)
FLASH_SERVED = (("qwen3-moe-30b-a3b", 4, 2048, 32, 4, 128, 128, None),
                ("smollm-135m", 8, 2048, 9, 3, 64, 64, None),
                ("minicpm3-4b", 4, 1000, 40, 40, 96, 64, 128))


def build_old(old: Path):
    """The earlier sources in ``old`` -> loaded libraries, by name."""
    libs, procs = {}, {}
    for name in OLD_PROTOTYPES:
        src, so = old / f"{name}.cu", old / f"lib{name}_old.so"
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the old {name}:\n{log}")
        lib = ctypes.CDLL(str(old / f"lib{name}_old.so"))
        lib.sz_error_string.argtypes = [_I]
        lib.sz_error_string.restype = ctypes.c_char_p
        for fn, argtypes in OLD_PROTOTYPES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        libs[name] = lib
    return libs


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


def old_flash(lib, q, k, v):
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    err = lib.sz_flash_attention(
        FA.DTYPE_ID[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, sq, skv, h, hkv, d, dv, 1, float(1.0 / np.sqrt(d)),
        build.stream_of(q))
    build.check(lib, err, "old flash_attention")
    return out


def old_gqa(lib, case):
    """The earlier ``sz_paged_gqa``: one CTA a (row, KV head), its tile and
    shared memory as its wrapper chose them."""
    q, ks, vs = case["q"], case["k_streams"], case["v_streams"]
    b, nq, h, hd = q.shape
    tp, hkv = case["tokens_per_page"], case["hkv"]
    pe_k, pe_v = ks[0].shape[1] * ks[0].shape[2], vs[0].shape[1] * vs[0].shape[2]
    dv, rows = pe_v // tp // hkv, nq * (h // hkv)
    tile, smem = SA._tile_and_smem(tp, rows * hd + rows * dv + 3 * rows,
                                   (hd + 1) + (dv + 1) + rows)
    acc = torch.empty((b, nq, h, dv), dtype=torch.float32, device=q.device)
    m = torch.empty((b, nq, h), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = lib.sz_paged_gqa(
        build.FMT_ID[case["fmt"]], q.data_ptr(), *(t.data_ptr() for t in ks),
        *(t.data_ptr() for t in vs), case["page_table_k"].data_ptr(),
        case["page_table_v"].data_ptr(), case["cache_len"].data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, nq, h, hkv, hd, dv,
        case["page_table_k"].shape[1], tp, pe_k, ks[2].shape[1], ks[0].shape[0],
        pe_v, vs[2].shape[1], vs[0].shape[0], 1, float(case["scale"]), tile,
        128, smem, decode_lut(case["exponents"]).ctypes.data,
        build.stream_of(q))
    build.check(lib, err, "old paged_gqa_attention")
    return acc, m, l


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path,
                    help="directory with the earlier revision's .cu sources")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build_old(args.old)
    build.build_all()
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    for name, b, s, h, hkv, d, dv, wide in FLASH_SERVED:
        q, k = randn(b, s, h, d), randn(b, s, hkv, d)
        v = randn(b, s, hkv, wide)[..., wide - dv:] if wide else randn(b, s, hkv, dv)
        want = FA.flash_attention_ref(q, k, v)
        AC.check_close(old_flash(libs["flash_attention"], q, k, v), want,
                       *AC.FLASH_TOL["bf16"])
        AC.check_close(FA.flash_attention(q, k, v), want, *AC.FLASH_TOL["bf16"])
        tc_before = FA.flash_attention.launches_tc
        rec = in_turns(lambda: old_flash(libs["flash_attention"], q, k, v),
                       lambda: FA.flash_attention(q, k, v), args.reps)
        rec["tensor_core_path"] = FA.flash_attention.launches_tc > tc_before
        print(json.dumps(dict(kernel="flash_attention", geometry=name, B=b, S=s,
                              H=h, Hkv=hkv, d=d, dv=dv, **rec)), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()

    for name, kw in AC.GQA_SERVED.items():
        case = AC.to_device(AC.gqa_case("bf16", 7, **kw), dev)
        want = SA.paged_gqa_attention_plain(**case)
        AC.check_partials(old_gqa(libs["splitzip_attention"], case), want)
        AC.check_partials(SA.paged_gqa_attention(**case), want)
        rec = in_turns(lambda: old_gqa(libs["splitzip_attention"], case),
                       lambda: SA.paged_gqa_attention(**case), args.reps)
        print(json.dumps(dict(kernel="paged_gqa_attention", geometry=name,
                              **{k: v for k, v in kw.items() if k != "lens"},
                              cache_len=kw["lens"][0], **rec)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

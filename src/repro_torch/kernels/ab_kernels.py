"""Time the redesigned MLA paged-attention kernel beside an earlier revision's.

    PYTHONPATH=src python -m repro_torch.kernels.ab_kernels --old DIR [--reps N]

``DIR`` holds that revision's ``splitzip_attention.cu`` (``git show
REV:src/repro_torch/kernels/csrc/splitzip_attention.cu``, REV the parent
commit, whose MLA kernel is one CTA per row and group of up to 8 heads over
all its pages, on the f32 CUDA cores) in a directory git ignores.  It is
built there with this package's ``nvcc`` flags and called through its own C
entry (``sz_paged_mla`` as that revision declares it, with the token tile,
256 threads and shared memory its wrapper chose).  This revision's kernel
runs through its wrapper.

The geometry is minicpm3-4b's served resident decode
(``attention_cases.MLA_SERVED``), bf16, timed in turns, old, new, new, old,
after both outputs are held against the plain version: ``old_ms``/``new_ms``
are device time (``timing.graph_ms``: ``--reps`` calls in one CUDA graph,
replayed), and ``old_eager_ms``/``new_eager_ms`` the same calls issued from
Python (``timing.cuda_ms``), which include a wrapper's host work where it
exceeds its kernels.  One JSON line, then the card's ``nvidia-smi`` line.
Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import attention_cases as AC
from repro_torch.kernels import build
from repro_torch.kernels import splitzip_attention as SA
from repro_torch.kernels.splitzip_decode import decode_lut
from repro_torch.kernels.timing import cuda_ms, graph_ms

_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_PROTOTYPES = {
    "splitzip_attention": {
        "sz_paged_mla": [_I] + [_P] * 18 + [_I] * 15 + [ctypes.c_float]
                        + [_I] * 3 + [_P, _P]},
}
#: the earlier wrapper's limits: query heads a CTA, the default dynamic
#: shared memory, token sub-tiles tried (largest first)
OLD_HEADS_PER_CTA = 8
OLD_SMEM_DEFAULT = 48 * 1024
OLD_TILES = (64, 32, 16, 8, 4, 2, 1)


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
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, kw in AC.MLA_SERVED.items():
        case = AC.to_device(AC.mla_case("bf16", 7, **kw), dev)
        want = SA.paged_mla_attention_plain(**case)
        AC.check_partials(old_mla(libs["splitzip_attention"], case), want)
        AC.check_partials(SA.paged_mla_attention(**case), want)
        rec = in_turns(lambda: old_mla(libs["splitzip_attention"], case),
                       lambda: SA.paged_mla_attention(**case), args.reps)
        grid = SA.mla_grid(kw["batch"], kw["nq"], kw["heads"], kw["pages"], n_sm)
        print(json.dumps(dict(kernel="paged_mla_attention", geometry=name,
                              **{k: v for k, v in kw.items() if k != "lens"},
                              cache_len=kw["lens"][0], grid=grid, **rec)),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build and load the CUDA kernels: ``nvcc`` -> shared library -> ctypes.

Each source under ``csrc/`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` at first use into ``build/repro_torch_kernels/``
at the repository root (listed in ``.gitignore``).  A library's file name
carries a hash of its source, of the headers under ``csrc/`` and of the
compiler flags, so an edited source or header rebuilds and an unchanged one
is reused.  All missing libraries are compiled
together, one ``nvcc`` process per source.

Importing this module builds nothing; :func:`library` (called by a kernel
wrapper on its first launch) and :func:`build_all` do.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "splitzip_encode": CSRC / "splitzip_encode.cu",
    "splitzip_decode": CSRC / "splitzip_decode.cu",
    "splitzip_attention": CSRC / "splitzip_attention.cu",
    "flash_attention": CSRC / "flash_attention.cu",
}
#: headers the sources include: a library's key covers them too
HEADERS = (CSRC / "codec_stream.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# loaded libraries, by name (a CDLL stays loaded for the process's life)
_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``<repo>/build/repro_torch_kernels`` (src/repro_torch/kernels -> repo)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                           "the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + b"".join(h.read_bytes() for h in HEADERS)
                            + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every library that is missing, all ``nvcc`` runs at once.

    Returns ``{name: compiler output}`` for the libraries built by this call
    (``-Xptxas=-v`` reports registers and shared memory per kernel)."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str, prototypes: Optional[dict] = None) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed.

    ``prototypes`` maps C function names to their ``argtypes``; every
    function returns a C ``int`` (a ``cudaError_t``)."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.sz_error_string.argtypes = [ctypes.c_int]
        lib.sz_error_string.restype = ctypes.c_char_p
        for fn, argtypes in (prototypes or {}).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def sass(lib_path: Path) -> Optional[str]:
    """The library's SASS (``cuobjdump -sass``), or None where the toolkit
    has no ``cuobjdump``."""
    tool = next((c for c in ("/usr/local/cuda/bin/cuobjdump",
                             shutil.which("cuobjdump")) if c and Path(c).is_file()),
                None)
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def loaded() -> Dict[str, ctypes.CDLL]:
    """The libraries loaded in this process so far (empty until a launch)."""
    return dict(_LOADED)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.sz_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# operand checks shared by the kernel wrappers
# ---------------------------------------------------------------------------

#: the ``fmt`` argument of every C entry point
FMT_ID = {"bf16": 0, "fp8_e5m2": 1, "fp8_e4m3": 2}

#: the codec kernels walk a row in whole 256-element warp steps (the dense
#: encode with one CTA of chunk / 8 threads a row)
MAX_CHUNK = 8192


def on_cuda(*tensors) -> bool:
    """True when every operand lies on a CUDA device, False when every one
    lies on the CPU; raises on a mix or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands on devices {sorted(kinds)}: expected all "
                     "CUDA (kernel) or all CPU (plain version)")


def check_operand(t, name: str, dtype, shape) -> None:
    """Dtype, shape and contiguity of one kernel operand."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_launchable(chunk: int, *tensors) -> None:
    """What only the CUDA kernels require: a chunk of whole 256-element
    warp steps and 16-byte aligned operands."""
    if chunk % 256 or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk}: the CUDA kernels need a multiple of "
                         f"256 up to {MAX_CHUNK}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream

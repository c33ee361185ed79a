"""Calibrated codec profiles: measure the real codec, serialize, reload.

The port of ``repro.core.profile``.  The transfer report and the plan's time
model (``TransferPlan.estimate_time``) are only as good as the
:class:`~repro_torch.core.pipeline.CodecProfile` they are charged with.
This module calibrates one from a measurement of the codec the serving path
runs, on the card it runs on:

* :meth:`CalibratedProfile.measure` runs the codec through the backend
  registry (:mod:`repro_torch.core.backend`) over a synthetic KV-shaped
  workload and records encode/decode throughput and the achieved ratio,
  with provenance (backend, format, workload size, repeats).  Times are the
  host clock around calls that end in a device synchronize, a mean over
  ``repeats`` after ``warmup``.
* :func:`save_profiles` / :func:`load_profiles` serialize a set of them to
  JSON (``build/profiles.json`` by default, under the ignored ``build/``;
  ``SPLITZIP_PROFILES`` overrides).  The schema is the JAX package's, so
  each package reads a file the other wrote.
* :func:`resolve_profile` turns a profile *source* (``"paper"``,
  ``"measured"`` or a ``profiles.json`` path) plus a link bandwidth into a
  concrete :class:`CodecProfile`.  The paper's figures live HERE and
  nowhere else in the port: they are the paper's H200 measurements, not
  this port's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.backend import get_backend
from repro_torch.core.codebook import Codebook, calibrate
from repro_torch.core.pipeline import CodecProfile
from repro_torch.device import resolve_device, synchronize

# ---------------------------------------------------------------------------
# the paper's figures — the ONE place in the port they live
# ---------------------------------------------------------------------------

#: Paper §4.1: encode throughput measured on an NVIDIA H200 (bytes/s against
#: uncompressed bytes).  The paper's number, not this port's.
PAPER_G_ENC = 613.3e9
#: Paper §4.1: decode throughput measured on an NVIDIA H200.
PAPER_G_DEC = 2181.8e9
#: Paper Table 2 compression ratio on Qwen3-32B KV caches.
PAPER_RATIO = 1.324

#: Default location of calibrated profiles, relative to the repo root, under
#: the ignored ``build/`` (so a port run never rewrites what the JAX
#: package's ``--profile measured`` loads); ``SPLITZIP_PROFILES`` overrides.
DEFAULT_PROFILES_PATH = os.environ.get(
    "SPLITZIP_PROFILES", os.path.join("build", "profiles.json"))

PROFILES_SCHEMA_VERSION = 1


def paper_profile(link_bw: float, *, ratio: float = PAPER_RATIO,
                  fixed_overhead_s: float = 0.0) -> CodecProfile:
    """The paper's H200 codec figures under a caller-chosen link bandwidth,
    with provenance ``"paper-h200"``."""
    return CodecProfile(g_enc=PAPER_G_ENC, g_dec=PAPER_G_DEC, ratio=ratio,
                        link_bw=link_bw, fixed_overhead_s=fixed_overhead_s,
                        source="paper-h200")


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _synthetic_kv_bits(n: int, seed: int = 0) -> np.ndarray:
    """KV-like bf16 bits: exponents concentrated on a top-16 band, drawn
    with numpy and rounded float32 -> bf16 to nearest even (the JAX
    package's workload, bit for bit)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp(rng.standard_normal(n))
    bf = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return bf.view(torch.int16).numpy().view(np.uint16)


def _time(fn, repeats: int, warmup: int, device) -> float:
    """Mean host-clock seconds of ``fn``, each call ended by a device
    synchronize."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return float(np.mean(times))


@dataclasses.dataclass(frozen=True)
class CalibratedProfile:
    """One backend/format's measured codec characteristics + provenance.

    Encode and decode throughput in bytes/s (against uncompressed bytes)
    and the achieved ratio.  The link bandwidth is a property of the
    deployment, not of the codec, so :meth:`profile` takes it as an
    argument.  ``workload_elems``/``repeats``/``source`` record how the
    numbers were obtained."""

    backend: str          # codec backend registry key ('cuda', 'torch', ...)
    fmt: str              # container format measured ('bf16', 'fp8_e5m2')
    g_enc: float          # encode throughput, bytes/s vs uncompressed
    g_dec: float          # decode throughput, bytes/s vs uncompressed
    ratio: float          # achieved compression ratio on the workload
    workload_elems: int   # elements in the measured workload
    repeats: int          # timed repetitions averaged
    source: str = "measured"

    @property
    def key(self) -> str:
        """Registry key inside ``profiles.json``: ``backend/fmt``."""
        return f"{self.backend}/{self.fmt}"

    def profile(self, link_bw: float,
                fixed_overhead_s: float = 0.0) -> CodecProfile:
        """Materialize a :class:`CodecProfile` under ``link_bw`` (bytes/s)."""
        return CodecProfile(g_enc=self.g_enc, g_dec=self.g_dec,
                            ratio=self.ratio, link_bw=link_bw,
                            fixed_overhead_s=fixed_overhead_s,
                            source=f"{self.source}:{self.key}")

    @classmethod
    def measure(cls, backend: str = "cuda",
                shapes: Sequence[Tuple[int, ...]] = ((1 << 16,),), *,
                codebook: Optional[Codebook] = None,
                repeats: int = 3, warmup: int = 1, seed: int = 0,
                source: str = "measured", device=None) -> "CalibratedProfile":
        """Run the codec through the backend registry on ``device`` (default:
        the CUDA card; raises without one) and time it.

        ``shapes`` lists the tensor shapes measured (aggregate throughput
        over all of them).  The codebook defaults to a calibration on the
        workload itself.  The device measured on is appended to ``source``
        (``measured@NVIDIA H100 80GB HBM3``, ``measured@cpu``): on the CPU
        the ``cuda`` backend runs its kernels' plain versions."""
        dev = resolve_device(device)
        where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type)
        be = get_backend(backend)
        total_bytes = total_wire = t_enc_total = t_dec_total = 0.0
        workload_elems = 0
        for shape in shapes:
            n = int(np.prod(shape))
            bits = _synthetic_kv_bits(n, seed=seed)
            cb = codebook or calibrate([bits], k=16)
            x = (torch.from_numpy(bits.view(np.int16)).to(dev)
                 .view(torch.bfloat16).reshape(shape))
            ct = be.encode(x, cb)
            nbytes = float(bits.nbytes)
            total_bytes += nbytes
            total_wire += float(be.wire_bytes(ct))
            workload_elems += n
            t_enc_total += _time(lambda: be.encode(x, cb), repeats, warmup, dev)
            t_dec_total += _time(lambda: be.decode(ct), repeats, warmup, dev)
            del x, ct
        return cls(backend=be.name, fmt=(codebook.fmt if codebook else "bf16"),
                   g_enc=total_bytes / max(t_enc_total, 1e-12),
                   g_dec=total_bytes / max(t_dec_total, 1e-12),
                   ratio=total_bytes / max(total_wire, 1.0),
                   workload_elems=workload_elems, repeats=repeats,
                   source=f"{source}@{where}")

    @classmethod
    def from_throughput(cls, backend: str, fmt: str, enc_gbps: float,
                        dec_gbps: float, ratio: float, *,
                        workload_elems: int, repeats: int,
                        source: str = "measured") -> "CalibratedProfile":
        """Build from already-measured GB/s numbers."""
        return cls(backend=backend, fmt=fmt, g_enc=enc_gbps * 1e9,
                   g_dec=dec_gbps * 1e9, ratio=ratio,
                   workload_elems=workload_elems, repeats=repeats,
                   source=source)


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def save_profiles(profiles: Iterable[CalibratedProfile],
                  path: Optional[str] = None) -> str:
    """Serialize calibrated profiles to JSON (keyed ``backend/fmt``; later
    entries with the same key win).  Returns the path written."""
    path = path or DEFAULT_PROFILES_PATH
    payload = {"version": PROFILES_SCHEMA_VERSION,
               "profiles": {p.key: dataclasses.asdict(p) for p in profiles}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_profiles(path: Optional[str] = None) -> Dict[str, CalibratedProfile]:
    """Load ``profiles.json`` -> ``{key: CalibratedProfile}``.

    Raises ``FileNotFoundError`` when the file doesn't exist and
    ``ValueError`` on a schema-version mismatch."""
    path = path or DEFAULT_PROFILES_PATH
    with open(path) as f:
        payload = json.load(f)
    if payload.get("version") != PROFILES_SCHEMA_VERSION:
        raise ValueError(
            f"profiles file {path!r} has schema version "
            f"{payload.get('version')!r}, expected {PROFILES_SCHEMA_VERSION}; "
            "measure again to regenerate it")
    return {k: CalibratedProfile(**v)
            for k, v in payload.get("profiles", {}).items()}


def _pick(profiles: Dict[str, CalibratedProfile], backend: Optional[str],
          fmt: str) -> CalibratedProfile:
    if backend is not None and backend != "auto":
        key = f"{backend}/{fmt}"
        if key not in profiles:
            raise KeyError(
                f"no calibrated profile for {key!r}; available: "
                f"{sorted(profiles)} — measure it or pass --profile paper")
        return profiles[key]
    # unspecified / 'auto': prefer the cuda measurement ('auto' is cuda in
    # the port), else any entry of the requested format, deterministically
    if f"cuda/{fmt}" in profiles:
        return profiles[f"cuda/{fmt}"]
    matches = sorted(k for k in profiles if k.endswith(f"/{fmt}"))
    if not matches:
        raise KeyError(f"no calibrated profile of format {fmt!r}; "
                       f"available: {sorted(profiles)}")
    return profiles[matches[0]]


def resolve_calibration(path: Optional[str] = None, *,
                        backend: Optional[str] = None, fmt: str = "bf16",
                        source: str = "measured-on-demand",
                        device=None) -> CalibratedProfile:
    """Load the ``backend/fmt`` entry from ``path`` (default
    :data:`DEFAULT_PROFILES_PATH`); when the file or the entry doesn't exist
    yet, measure a small workload NOW on ``device``, merge it into the file,
    and return it.  A schema-version mismatch propagates as ``ValueError``."""
    path = path or DEFAULT_PROFILES_PATH
    try:
        return _pick(load_profiles(path), backend, fmt)
    except (FileNotFoundError, KeyError):
        pass
    be = backend if backend not in (None, "auto") else "cuda"
    cal = CalibratedProfile.measure(backend=be, source=source, device=device)
    try:
        merged = load_profiles(path)
    except FileNotFoundError:
        merged = {}
    merged[cal.key] = cal
    save_profiles(merged.values(), path)
    return cal


def resolve_profile(source: str, *, link_bw: float,
                    fixed_overhead_s: float = 0.0,
                    backend: Optional[str] = None, fmt: str = "bf16",
                    path: Optional[str] = None, device=None) -> CodecProfile:
    """Turn a profile *source* into a concrete :class:`CodecProfile`:

    * ``"paper"`` — the paper's H200 figures (:func:`paper_profile`);
    * ``"measured"`` — the calibrated ``profiles.json`` (``path=`` or
      :data:`DEFAULT_PROFILES_PATH`), measured on ``device`` now when
      missing;
    * a path ending in ``.json`` — exactly that file (raise if missing).

    ``backend`` selects which measurement (``None``/``"auto"`` prefers the
    cuda entry); ``link_bw``/``fixed_overhead_s`` describe the deployment's
    link, never part of a calibration."""
    if source == "paper":
        return paper_profile(link_bw, fixed_overhead_s=fixed_overhead_s)
    if source.endswith(".json"):
        return _pick(load_profiles(source), backend, fmt).profile(
            link_bw, fixed_overhead_s)
    if source == "measured":
        return resolve_calibration(path, backend=backend, fmt=fmt,
                                   device=device).profile(link_bw,
                                                          fixed_overhead_s)
    raise ValueError(
        f"unknown profile source {source!r}; expected 'paper', 'measured', "
        "or a profiles.json path")

"""The port's codec profiles, the plan's time model and the transfer report
against the JAX package's.

Same seeded inputs in both packages: the synthetic KV workload bitwise, a
CPU measurement's ratio and workload size (the port's ``torch`` backend
against the JAX ``xla`` one; times are host-clock CPU numbers and are not
compared), profiles files each package writes and the other reads, the
source resolution, and ``estimate_time`` / ``byte_split`` /
``expected_attempts`` / ``transfer_report`` to 1e-12 relative on the same
plans.  Also the one-shot transfer shims and the launcher's report line.
"""

import dataclasses
import json
import os
import types

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import codebook as jcb  # noqa: E402
from repro.core import pipeline as JP  # noqa: E402
from repro.core import profile as JPR  # noqa: E402
from repro.serving import plan as JPL  # noqa: E402
from repro.serving import transfer as JT  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core import pipeline as TP  # noqa: E402
from repro_torch.core import profile as TPR  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.kvcache import DecodeState  # noqa: E402
from repro_torch.serving import plan as TPL  # noqa: E402
from repro_torch.serving import transfer as TT  # noqa: E402
from repro_torch.serving.engine import DisaggregatedEngine  # noqa: E402

REL = 1e-12


def close(a, b) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def make_caches(seed: int = 0):
    """A bf16 KV pair, an fp32 leaf, a float8 leaf and an int leaf, as a JAX
    pytree and as the port's dict, from the same bits."""
    rng = np.random.default_rng(seed)
    kb = rng.standard_normal((2, 3, 37, 2, 16)).astype(jnp.bfloat16).view(np.uint16)
    vb = rng.standard_normal((2, 3, 37, 2, 16)).astype(jnp.bfloat16).view(np.uint16)
    f32 = rng.standard_normal((4, 33)).astype(np.float32)
    f8 = rng.integers(0, 256, 900).astype(np.uint8)
    ids = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    jc = {"k": jnp.asarray(kb).view(jnp.bfloat16),
          "v": jnp.asarray(vb).view(jnp.bfloat16), "f": jnp.asarray(f32),
          "e": jnp.asarray(f8).view(jnp.float8_e5m2), "ids": jnp.asarray(ids)}
    tc = {"k": torch.from_numpy(kb.view(np.int16)).view(torch.bfloat16),
          "v": torch.from_numpy(vb.view(np.int16)).view(torch.bfloat16),
          "f": torch.from_numpy(f32),
          "e": torch.from_numpy(f8).view(torch.float8_e5m2),
          "ids": torch.from_numpy(ids)}
    cb = jcb.calibrate([kb], k=16)
    return jc, tc, cb, tcb.Codebook.from_json(cb.to_json())


def leaf_bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return C.signed_view(x).contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.asarray(x).view(np.uint8).reshape(-1)


def profiles(**kw):
    base = dict(g_enc=900e9, g_dec=1400e9, ratio=1.33, link_bw=12.5e9,
                fixed_overhead_s=2e-5)
    base.update(kw)
    return JP.CodecProfile(**base), TP.CodecProfile(**base)


# ---------------------------------------------------------------------------
# the workload and the measurement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(1, 0), (4097, 3), (1 << 16, 0)])
def test_synthetic_kv_bits_match(n, seed):
    np.testing.assert_array_equal(TPR._synthetic_kv_bits(n, seed),
                                  JPR._synthetic_kv_bits(n, seed))


def test_measure_ratio_and_workload_match():
    shapes = ((4096,), (3, 1000))
    j = JPR.CalibratedProfile.measure(backend="xla", shapes=shapes,
                                      repeats=1, warmup=0)
    t = TPR.CalibratedProfile.measure(backend="torch", shapes=shapes,
                                      repeats=1, warmup=0, device="cpu")
    assert (t.ratio, t.workload_elems, t.fmt, t.repeats) == \
        (j.ratio, j.workload_elems, j.fmt, j.repeats)
    assert t.backend == "torch" and t.source == "measured@cpu"
    assert t.g_enc > 0 and t.g_dec > 0
    w = TPR.CalibratedProfile.measure(backend="wire", shapes=((5000,),),
                                      repeats=1, warmup=0, device="cpu")
    jw = JPR.CalibratedProfile.measure(backend="wire", shapes=((5000,),),
                                       repeats=1, warmup=0)
    assert (w.backend, w.ratio) == (jw.backend, jw.ratio)


def test_measure_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPR.CalibratedProfile.measure()


# ---------------------------------------------------------------------------
# profiles files and source resolution
# ---------------------------------------------------------------------------

def test_profiles_files_cross_read(tmp_path):
    jprofs = [JPR.CalibratedProfile.from_throughput(
        "xla", "bf16", 1.5, 2.5, 1.31, workload_elems=100, repeats=2),
        JPR.CalibratedProfile("pallas", "fp8_e5m2", 3e9, 4e9, 1.2, 7, 1)]
    tprofs = [TPR.CalibratedProfile.from_throughput(
        "cuda", "bf16", 1234.5, 2345.6, 1.3329, workload_elems=95_155_200,
        repeats=5, source="measured@NVIDIA H100 80GB HBM3"),
        TPR.CalibratedProfile("torch", "bf16", 1e9, 2e9, 1.33, 65536, 3)]
    jpath = JPR.save_profiles(jprofs, str(tmp_path / "j" / "profiles.json"))
    tpath = TPR.save_profiles(tprofs, str(tmp_path / "t" / "profiles.json"))
    assert {k: dataclasses.asdict(v) for k, v in TPR.load_profiles(jpath).items()} \
        == {p.key: dataclasses.asdict(p) for p in jprofs}
    assert {k: dataclasses.asdict(v) for k, v in JPR.load_profiles(tpath).items()} \
        == {p.key: dataclasses.asdict(p) for p in tprofs}
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"version": 0, "profiles": {}}))
    with pytest.raises(ValueError, match="schema version"):
        TPR.load_profiles(str(stale))
    # resolution: auto prefers the cuda entry, an explicit backend its own
    loaded = TPR.load_profiles(tpath)
    assert TPR._pick(loaded, None, "bf16").backend == "cuda"
    assert TPR._pick(loaded, "auto", "bf16").backend == "cuda"
    assert TPR._pick(loaded, "torch", "bf16").backend == "torch"
    # the deliberate difference: the JAX 'auto' prefers its xla entry
    mixed = JPR.save_profiles(jprofs + [JPR.CalibratedProfile(
        **dataclasses.asdict(tprofs[0]))], str(tmp_path / "mixed.json"))
    assert JPR._pick(JPR.load_profiles(mixed), None, "bf16").backend == "xla"
    assert TPR._pick(TPR.load_profiles(mixed), None, "bf16").backend == "cuda"
    with pytest.raises(KeyError):
        TPR._pick(loaded, "wire", "bf16")
    got = TPR.resolve_profile(tpath, link_bw=12.5e9, fixed_overhead_s=1e-5)
    assert got == TP.CodecProfile(1234.5e9, 2345.6e9, 1.3329, 12.5e9, 1e-5,
                                  "measured@NVIDIA H100 80GB HBM3:cuda/bf16")


def test_resolve_paper_and_measured(tmp_path):
    assert (TPR.PAPER_G_ENC, TPR.PAPER_G_DEC, TPR.PAPER_RATIO) == \
        (JPR.PAPER_G_ENC, JPR.PAPER_G_DEC, JPR.PAPER_RATIO)
    assert dataclasses.astuple(TPR.resolve_profile("paper", link_bw=5e9)) == \
        dataclasses.astuple(JPR.resolve_profile("paper", link_bw=5e9))
    assert TPR.PROFILES_SCHEMA_VERSION == JPR.PROFILES_SCHEMA_VERSION
    assert TPR.DEFAULT_PROFILES_PATH == os.environ.get(
        "SPLITZIP_PROFILES", os.path.join("build", "profiles.json"))
    path = str(tmp_path / "p.json")
    prof = TPR.resolve_profile("measured", link_bw=5e9, backend="torch",
                               path=path, device="cpu")
    assert prof.source == "measured-on-demand@cpu:torch/bf16"
    assert list(TPR.load_profiles(path)) == ["torch/bf16"]
    again = TPR.resolve_calibration(path, backend="torch", device="cpu")
    assert again.profile(5e9) == prof                  # loaded, not measured
    with pytest.raises(FileNotFoundError):
        TPR.resolve_profile(str(tmp_path / "missing.json"), link_bw=1.0)
    with pytest.raises(ValueError, match="unknown profile source"):
        TPR.resolve_profile("guess", link_bw=1.0)


# ---------------------------------------------------------------------------
# the time model and the report
# ---------------------------------------------------------------------------

PLAN_CONFIGS = [dict(), dict(n_chunks=3), dict(n_chunks=8, cap=8),
                dict(compress_fp32=True, n_chunks=4), dict(layout="global"),
                dict(compress_fp32=True), dict(retry_doublings=0, n_chunks=2)]


@pytest.mark.parametrize("kw", PLAN_CONFIGS, ids=lambda kw: str(sorted(kw.items())))
def test_time_model_matches(kw):
    jc, tc, cb, tcb_ = make_caches()
    jp = JPL.TransferPlan.build(jc, JPL.TransferConfig(codebook=cb, **kw))
    tp = TPL.TransferPlan.build(tc, TPL.TransferConfig(codebook=tcb_, **kw))
    for scale in (1.0, 0.37, 12.0):
        assert tp.chunk_raw_bytes(scale) == jp.chunk_raw_bytes(scale)
        assert tp.byte_split(scale) == jp.byte_split(scale)
        assert close(tp.collective_wire_bytes(1.33, 3, scale),
                     jp.collective_wire_bytes(1.33, 3, scale))
    for p in (0.0, 0.01, 0.4, 1.0):
        assert all(close(a, b) for a, b in zip(tp.expected_attempts(p),
                                               jp.expected_attempts(p)))
        for jprof, tprof in (profiles(), profiles(link_bw=400e9, ratio=1.1)):
            for scale in (1.0, 2.5):
                assert close(tp.estimate_time(tprof, scale=scale, overflow_p=p),
                             jp.estimate_time(jprof, scale=scale, overflow_p=p))


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_transfer_report_matches(n_chunks):
    jc, tc, cb, tcb_ = make_caches(seed=1)
    jp = JPL.TransferPlan.build(jc, JPL.TransferConfig(codebook=cb,
                                                       n_chunks=n_chunks))
    tp = TPL.TransferPlan.build(tc, TPL.TransferConfig(codebook=tcb_,
                                                       n_chunks=n_chunks))
    jprof, tprof = profiles()
    for plan_kw in (dict(), dict(plan="yes")):
        for chunks in (1, n_chunks, 7):
            args = (1.23e8, 9.1e7)
            j = JT.transfer_report(*args, jprof, n_chunks=chunks,
                                   plan=jp if plan_kw else None)
            t = TT.transfer_report(*args, tprof, n_chunks=chunks,
                                   plan=tp if plan_kw else None)
            for a, b in zip(dataclasses.astuple(j), dataclasses.astuple(t)):
                assert close(a, b)
            assert close(j.speedup, t.speedup) and close(j.ratio, t.ratio)


def test_engine_report_and_shims():
    jc, tc, cb, tcb_ = make_caches(seed=2)
    jprof, tprof = profiles()
    cache = {"k": tc["k"], "v": tc["v"]}
    eng = DisaggregatedEngine(None, {}, tcb_, backend="torch", n_chunks=3,
                              profile=tprof, device="cpu")
    eng.transfer(DecodeState(cache=cache, cache_len=torch.tensor([37, 37, 37])))
    rep = eng.transfer_report()
    want = TT.transfer_report(eng.stats.raw_cache_bytes, eng.stats.wire_bytes,
                              tprof, n_chunks=3, plan=eng.plan)
    assert rep == want and rep.ratio == eng.stats.transfer_ratio
    # the one-shot shims against the JAX package's
    tcfg = TPL.TransferConfig(codebook=tcb_, n_chunks=3)
    jcfg = JPL.TransferConfig(codebook=cb, n_chunks=3)
    tcomp, traw = TT.compress_cache(tc, tcfg)
    jcomp, jraw = JT.compress_cache(jc, jcfg)
    assert sorted(tcomp) == sorted(jcomp) and sorted(traw) == sorted(jraw)
    assert abs(TT.compressed_wire_bytes(tcomp, traw)
               - float(JT.compressed_wire_bytes(jcomp, jraw))) <= \
        1e-6 * TT.compressed_wire_bytes(tcomp, traw)   # JAX sums in float32
    # one encode at plan capacity: the random fp8 leaf overflows and decodes
    # lossy in both packages alike (the scheduled session ships it raw)
    back = TT.decompress_cache(tcomp, traw, tc)
    jback = JT.decompress_cache(jcomp, jraw, jc)
    for a, b in zip(jax.tree.leaves(jback), TR.leaves(back)):
        np.testing.assert_array_equal(leaf_bytes(a), leaf_bytes(b))
    tout, tst = TT.transfer_cache_chunked(tc, tcfg)
    jout, jst = JT.transfer_cache_chunked(jc, jcfg)
    for a, b in zip(jax.tree.leaves(jout), TR.leaves(tout)):
        np.testing.assert_array_equal(leaf_bytes(a), leaf_bytes(b))
    assert (tst.chunk_wire_bytes, tst.wire_bytes) == (jst.chunk_wire_bytes,
                                                      jst.wire_bytes)
    tsegs, tmetas, _ = TT.split_cache_segments(tc, 3, 1024)
    jsegs, jmetas, _ = JT.split_cache_segments(jc, 3, 1024)
    assert tmetas == jmetas and len(tsegs) == len(jsegs)
    for a, b in zip(jsegs, tsegs):
        np.testing.assert_array_equal(leaf_bytes(a), leaf_bytes(b))
    assert TT.raw_wire_bytes(tc) == JT.raw_wire_bytes(jc)
    with pytest.raises(ValueError, match="return_hlo"):
        TT.transfer_cache_cross_pod(tc, None, tcfg, return_hlo=True)
    no_pod = types.SimpleNamespace(mesh_dim_names=("data",),
                                   mesh=torch.zeros(1))
    with pytest.raises(ValueError, match="'pod' mesh axis"):
        TT.transfer_cache_cross_pod(tc, no_pod, tcfg)


def test_launcher_reports_the_profile(tmp_path, capsys):
    path = str(tmp_path / "profiles.json")
    TPR.save_profiles([TPR.CalibratedProfile("wire", "bf16", 2e9, 3e9, 1.3,
                                             100, 1, "measured@cpu")], path)
    serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                "--new-tokens", "2", "--batch", "1", "--prompt-len", "16",
                "--codec-backend", "wire", "--profile", path,
                "--link-gbps", "25"])
    out = capsys.readouterr().out
    assert "analytic transfer" in out and "at 25 Gb/s" in out
    assert "profile: measured@cpu:wire/bf16" in out
    assert "codec backend        : wire" in out

"""The persistent executor (``session.save`` / ``session.load``) and the
``Checkpointer`` against the JAX package.

The same train-state tree (numpy from a seed) goes into both packages:
bf16 weights (the ``splitzip`` route), f32 moments (``fp32_hilo``), an fp8
leaf (``fp8``), a bf16 leaf below ``min_compress_elems`` and an int32 step
(``raw``).  A ``szpersist-1`` directory is the manifest and one SZ02 file a
leaf (``docs/wire_format.md`` §9), so the two packages must write the same
bytes: the manifests are equal as JSON and byte for byte, each leaf file is
equal byte for byte, and a directory either package saved loads bit for bit
in the other.  Corrupted files, injected wire faults and the checkpoint
fallback must leave the same ``TransferStats`` counts as the JAX session's.
Every comparison is exact.
"""

import ast
import dataclasses
import json
import os
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core.codebook import Codebook as JCodebook  # noqa: E402
from repro.core.wire import WireIntegrityError as JWireIntegrityError  # noqa: E402
from repro.distributed import checkpoint as JCKPT  # noqa: E402
from repro.serving import faults as JF  # noqa: E402
from repro.serving import plan as JPL  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core.codebook import Codebook as TCodebook  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.core.wire import WireIntegrityError, fletcher32  # noqa: E402
from repro_torch.distributed import checkpoint as CKPT  # noqa: E402
from repro_torch.serving import faults as TF  # noqa: E402
from repro_torch.serving import plan as TPL  # noqa: E402
from repro_torch.serving import session as TS  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
EXPONENTS = tuple(range(113, 129))
JBOOK = JCodebook(fmt="bf16", exponents=EXPONENTS)


def states(seed: int = 0):
    """One train state as a JAX tree and as the port's, from the same bits."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(96, 64)).astype(np.float32)
    tiny = rng.normal(size=(4,)).astype(np.float32)
    m = rng.normal(size=(96, 64)).astype(np.float32)
    e = (rng.normal(size=(40, 32)) * 4).astype(np.float32)
    jw, jtiny = jnp.asarray(w, jnp.bfloat16), jnp.asarray(tiny, jnp.bfloat16)
    je = jnp.asarray(e).astype(jnp.float8_e5m2)
    js = {"params": {"w": jw, "tiny": jtiny}, "opt": {"m": jnp.asarray(m)},
          "act": {"e": je}, "step": jnp.asarray(11 + seed, jnp.int32)}

    def t_bf16(x):
        return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)

    ts = {"params": {"w": t_bf16(jw), "tiny": t_bf16(jtiny)},
          "opt": {"m": torch.from_numpy(m)},
          "act": {"e": torch.from_numpy(np.asarray(je).view(np.uint8).copy()
                                        ).view(torch.float8_e5m2)},
          "step": torch.tensor(11 + seed, dtype=torch.int32)}
    return js, ts


def leaf_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return C.signed_view(x).contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def assert_same_tree(jtree, ttree):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = TR.flatten_with_path(ttree)[0]
    assert [JPL.leaf_key(p) for p, _ in jl] == [TR.leaf_key(p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert str(np.asarray(a).dtype) == C.dtype_name(b.dtype), p
        assert tuple(a.shape) == tuple(b.shape), p
        assert leaf_bytes(a) == leaf_bytes(b), p


def assert_same_stats(sj, st):
    assert dataclasses.asdict(sj) == dataclasses.asdict(st)


def sessions(js, ts, faults=None, **kw):
    kw = dict(codebook=JBOOK, backend="wire", compress_fp32=True,
              min_compress_elems=64, **kw)
    jplan = JPL.TransferPlan.build(js, JPL.TransferConfig(**kw))
    kw["codebook"] = TCodebook(fmt="bf16", exponents=EXPONENTS)
    tplan = TPL.TransferPlan.build(ts, TPL.TransferConfig(**kw))
    tfaults = None if faults is None else TF.FaultPlan(**faults)
    jfaults = None if faults is None else JF.FaultPlan(**faults)
    return (jplan.session(faults=jfaults),
            tplan.session(faults=tfaults, device="cpu"))


def corrupt_largest(path, xor: int = 0x55) -> str:
    name = max((f for f in os.listdir(path) if f.endswith(".szc")),
               key=lambda f: os.path.getsize(os.path.join(path, f)))
    blob = bytearray(open(os.path.join(path, name), "rb").read())
    blob[len(blob) // 2] ^= xor
    open(os.path.join(path, name), "wb").write(bytes(blob))
    return name


@pytest.fixture
def saved(tmp_path):
    """The same state saved by both packages, with its sessions."""
    js, ts = states()
    jsess, tsess = sessions(js, ts)
    jsess.save(str(tmp_path / "jax"), js, extra={"note": "x", "n": 3})
    tsess.save(str(tmp_path / "torch"), ts, extra={"note": "x", "n": 3})
    return tmp_path, js, ts, jsess, tsess


# ---------------------------------------------------------------------------
# the persistent executor
# ---------------------------------------------------------------------------

def test_routes_cover_every_persistent_route():
    js, ts = states()
    jsess, tsess = sessions(js, ts)
    routes = {r.key: r.route for r in tsess.plan.routes}
    assert routes == {"act/e": "fp8", "opt/m": "fp32_hilo",
                      "params/tiny": "raw", "params/w": "splitzip",
                      "step": "raw"}
    assert routes == {r.key: r.route for r in jsess.plan.routes}
    assert (TS.PERSIST_FORMAT, TS.PERSIST_MANIFEST) == ("szpersist-1",
                                                        "manifest.json")


def test_roundtrip_every_route_bit_exact(saved):
    tmp, js, ts, jsess, tsess = saved
    tree, extra = tsess.load(str(tmp / "torch"))
    assert_same_tree(js, tree)
    assert extra == {"note": "x", "n": 3}
    s = tsess.last_stats
    assert s.leaf_ok == {"act/e": True, "opt/m": True, "params/w": True}
    assert s.fp32_lo_wire_bytes == 96 * 64 * 2
    assert s.fp8_wire_bytes > 0 and s.raw_passthrough_bytes == 4 * 2 + 4


def test_save_stats_match_jax(saved):
    *_, jsess, tsess = saved
    assert_same_stats(jsess.last_stats, tsess.last_stats)


def test_manifests_and_leaf_files_are_byte_equal(saved):
    tmp = saved[0]
    files = sorted(os.listdir(tmp / "jax"))
    assert files == sorted(os.listdir(tmp / "torch"))
    assert files == ["leaf_00000.szc", "leaf_00001.szc", "leaf_00002.szc",
                     "leaf_00003.szc", "leaf_00004.szc", "manifest.json"]
    for f in files:
        assert (tmp / "jax" / f).read_bytes() == (tmp / "torch" / f).read_bytes(), f
    jm = json.loads((tmp / "jax" / "manifest.json").read_text())
    tm = json.loads((tmp / "torch" / "manifest.json").read_text())
    assert jm == tm and tm["format"] == "szpersist-1"
    assert [e["key"] for e in tm["leaves"]] == [r.key for r in saved[4].plan.routes]


def test_jax_saved_directory_loads_bitwise_in_the_port(saved):
    tmp, js, ts, jsess, tsess = saved
    tree, extra = tsess.load(str(tmp / "jax"))
    assert_same_tree(js, tree)
    assert extra == {"note": "x", "n": 3}
    jsess.load(str(tmp / "jax"))
    assert_same_stats(jsess.last_stats, tsess.last_stats)


def test_port_saved_directory_loads_bitwise_in_jax(saved):
    tmp, js, ts, jsess, _ = saved
    tree, extra = jsess.load(str(tmp / "torch"))
    assert_same_tree(tree, ts)
    assert extra == {"note": "x", "n": 3}


def test_corrupt_file_raises_and_publishes_the_jax_stats(saved):
    tmp, js, ts, jsess, tsess = saved
    assert corrupt_largest(tmp / "jax") == corrupt_largest(tmp / "torch")
    with pytest.raises(JWireIntegrityError):
        jsess.load(str(tmp / "jax"))
    with pytest.raises(WireIntegrityError):
        tsess.load(str(tmp / "torch"))
    st = tsess.last_stats
    assert st.verify_failures == tsess.plan.tc.retry_doublings + 2
    assert st.refetches == st.verify_failures - 1 and False in st.leaf_ok.values()
    assert_same_stats(jsess.last_stats, st)


def test_corrupt_frame_under_a_matching_manifest_checksum_raises(saved):
    """The second check: a payload whose manifest Fletcher was rewritten to
    match the corruption still fails its SZ02 frame table."""
    tmp, js, ts, jsess, tsess = saved
    for where in ("jax", "torch"):
        path = tmp / where
        man = json.loads((path / "manifest.json").read_text())
        entry = next(e for e in man["leaves"] if e["route"] == "splitzip")
        blob = bytearray((path / entry["file"]).read_bytes())
        blob[entry["sz_bytes"] - 1] ^= 0x01    # the last body byte
        (path / entry["file"]).write_bytes(bytes(blob))
        entry["checksum"] = fletcher32(bytes(blob))
        (path / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(JWireIntegrityError):
        jsess.load(str(tmp / "jax"))
    with pytest.raises(WireIntegrityError):
        tsess.load(str(tmp / "torch"))


def test_injected_faults_heal_through_rereads(tmp_path):
    js, ts = states(seed=1)
    faults = dict(corrupt_chunks=(0, 2), drop_chunks=(1,), persistent_attempts=1)
    jsess, tsess = sessions(js, ts, faults=faults)
    jsess.save(str(tmp_path / "j"), js)
    tsess.save(str(tmp_path / "t"), ts)
    jtree, _ = jsess.load(str(tmp_path / "j"))
    ttree, _ = tsess.load(str(tmp_path / "t"))
    assert_same_tree(js, ttree)
    assert_same_tree(jtree, ts)
    st = tsess.last_stats
    assert (st.refetches, st.verify_failures, st.faults_injected) == (3, 3, 3)
    assert_same_stats(jsess.last_stats, st)


def test_structure_drift_and_unknown_format_raise(saved):
    tmp, js, ts, jsess, tsess = saved
    other = TPL.TransferPlan.build(
        {"params": {"w": ts["params"]["w"]}},
        tsess.plan.tc).session(device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        other.load(str(tmp / "torch"))
    man = json.loads((tmp / "torch" / "manifest.json").read_text())
    man["format"] = "szpersist-0"
    (tmp / "torch" / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="unknown persistent format"):
        tsess.load(str(tmp / "torch"))


def test_save_is_atomic(tmp_path, monkeypatch):
    js, ts = states()
    _, tsess = sessions(js, ts)
    from repro_torch.core import backend as TB

    def refuse(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(TB.WireBackend, "encode", refuse)
    with pytest.raises(RuntimeError, match="disk full"):
        tsess.save(str(tmp_path / "ck"), ts)
    assert os.listdir(tmp_path) == []


def test_load_needs_a_device_without_cuda(saved, monkeypatch):
    """A session without a device loads onto the card: without one it
    raises, it does not fall back to the CPU."""
    tmp, js, ts, _, tsess = saved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sess = tsess.plan.session()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sess.load(str(tmp / "torch"))


# ---------------------------------------------------------------------------
# the Checkpointer
# ---------------------------------------------------------------------------

def test_checkpoint_falls_back_bit_exactly(tmp_path):
    (jgood, tgood), (jbad, tbad) = states(seed=1), states(seed=2)
    jck = JCKPT.Checkpointer(str(tmp_path / "j"))
    tck = CKPT.Checkpointer(str(tmp_path / "t"), device="cpu")
    for ck, good, bad in ((jck, jgood, jbad), (tck, tgood, tbad)):
        ck.save(10, good, extra={"arch": "a"})
        ck.save(20, bad)
    for d in ("j", "t"):
        corrupt_largest(tmp_path / d / "step_0000000020", 0xFF)
    jtree, jextra, jstep = jck.restore(jgood)
    tree, extra, step = tck.restore(tgood)
    assert (step, extra) == (jstep, jextra) == (10, {"arch": "a"})
    assert_same_tree(jgood, tree)
    assert tck.stats.verify_failures > 0
    assert_same_stats(jck.stats, tck.stats)


def test_checkpoint_raises_when_every_candidate_is_corrupt(tmp_path):
    _, ts = states()
    ck = CKPT.Checkpointer(str(tmp_path), device="cpu")
    ck.save(5, ts)
    target = tmp_path / "step_0000000005"
    for f in os.listdir(target):
        if f.endswith(".szc"):
            (target / f).write_bytes(b"junk")
    with pytest.raises(CKPT.CheckpointCorrupt):
        ck.restore(ts)
    with pytest.raises(FileNotFoundError):
        CKPT.Checkpointer(str(tmp_path / "none"), device="cpu").restore(ts)


def test_checkpoint_module_api_matches_jax(tmp_path):
    js, ts = states(seed=3)
    for mod, tree, d in ((JCKPT, js, "j"), (CKPT, ts, "t")):
        mod.save(str(tmp_path / d), 1, tree)
        mod.save(str(tmp_path / d), 2, tree, extra={"k": 1})
    assert CKPT.steps_available(str(tmp_path / "t")) == [1, 2]
    assert CKPT.latest_step(str(tmp_path / "t")) == 2
    assert CKPT.latest_step(str(tmp_path / "none")) is None
    assert CKPT.checkpoint_bytes(str(tmp_path / "t"), 2) == \
        JCKPT.checkpoint_bytes(str(tmp_path / "j"), 2) > 0
    tree, extra, step = CKPT.restore(str(tmp_path / "j"), ts, device="cpu")
    assert step == 2 and extra == {"k": 1}
    assert_same_tree(js, tree)
    jtree, _, _ = JCKPT.restore(str(tmp_path / "t"), js)
    assert_same_tree(jtree, ts)
    assert CKPT.CKPT_CODEBOOK.exponents == JCKPT.CKPT_CODEBOOK.exponents


def test_checkpoint_holds_no_codec_wire_or_hash_call():
    """The checkpoint module is policy only: every byte it writes goes
    through the session."""
    path = REPO / "src" / "repro_torch" / "distributed" / "checkpoint.py"
    tree = ast.parse(path.read_text())
    banned = {"encode", "decode", "decode_bits", "fletcher32", "checksum",
              "frame_checksums", "verify_payload", "payload_from_streams",
              "streams_from_payload", "crc32", "sha256", "md5", "adler32"}
    called = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            called.add(f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", ""))
    assert not called & banned, called & banned
    imported = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    imported |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
    assert not imported & {"hashlib", "zlib", "binascii",
                           "repro_torch.core.codec", "repro_torch.core.backend",
                           "repro_torch.kernels.ops"}
    assert {"repro_torch.serving.session", "repro_torch.core.wire"} <= imported

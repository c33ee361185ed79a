"""The port's SZ02 wire format, Fletcher-32 and ``wire`` backends against the
JAX package's.

Same seeded numpy inputs in both packages: Fletcher-32 tags (odd lengths,
more than one 2**20-word block, bytes that cross leaf boundaries), the
backends' ``checksum`` over the same streams, SZ02 payloads byte for byte
(bf16 and both fp8 formats, k 16 and k 8, lengths that are not a multiple
of the chunk or are odd, chunks over the escape cap), ``verify_payload`` on
corrupted payloads, ``payload_bytes_model``, and whole sessions through the
``wire`` backends.  On the CPU the ``wire`` backend runs the codec kernels'
plain versions.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import backend as JB  # noqa: E402
from repro.core import codebook as jcb  # noqa: E402
from repro.core import wire as JW  # noqa: E402
from repro.serving import plan as JPL  # noqa: E402
from repro_torch.core import backend as TB  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.core import wire as TW  # noqa: E402
from repro_torch.serving import plan as TPL  # noqa: E402

TORCH_FP = {"bf16": torch.bfloat16, "fp8_e5m2": torch.float8_e5m2,
            "fp8_e4m3": torch.float8_e4m3fn}
JAX_FP = {"bf16": jnp.bfloat16, "fp8_e5m2": jnp.float8_e5m2,
          "fp8_e4m3": jnp.float8_e4m3fn}


def container(bits: np.ndarray) -> torch.Tensor:
    """numpy container bits -> a torch tensor of the same width (CPU)."""
    if bits.dtype == np.uint16:
        return torch.from_numpy(bits.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(bits)


def make_bits(fmt: str, n: int, k: int, *, heavy: bool, seed: int):
    """Container bits and a calibrated codebook; ``heavy`` puts 300 escapes
    of one chunk at the start, past every per-chunk cap (where the codebook
    leaves an exponent out: fp8_e4m3's 16 exponents fit k 16)."""
    rng = np.random.default_rng(seed)
    if fmt == "bf16":
        x = rng.standard_normal(n) * np.exp(rng.standard_normal(n))
        bits = x.astype(jnp.bfloat16).view(np.uint16)
    else:
        bits = rng.integers(0, 256, n).astype(np.uint8)
    cb = jcb.calibrate([bits], k=k, fmt=fmt)
    spec = tcb.FORMATS[fmt]
    rare = [e for e in range(1 << spec["ebits"]) if e not in cb.exponents]
    if heavy and rare:
        bits[:300] = rare[0] << spec["mbits"]
    return bits, cb, tcb.Codebook.from_json(cb.to_json())


# ---------------------------------------------------------------------------
# Fletcher-32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 65535, 65537, 131072,
                               (1 << 21) + 5, (3 << 21) + 2])
def test_fletcher32_matches(n):
    buf = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    want = JW.fletcher32(buf.tobytes())
    assert TW.fletcher32(torch.from_numpy(buf)) == want
    assert TW.fletcher32(buf.tobytes()) == want


def test_fletcher32_of_all_ones_words():
    """Worst-case words (0xFFFF) at the largest block: no sum overflows."""
    buf = np.full((1 << 21) + 3, 255, np.uint8)
    assert TW.fletcher32(torch.from_numpy(buf)) == JW.fletcher32(buf.tobytes())
    assert list(TW.frame_checksums(torch.from_numpy(buf))) == \
        list(JW._frame_checksums(buf))


@pytest.mark.parametrize("layout", ["chunked", "global"])
def test_checksum_matches_over_leaf_boundaries(layout):
    """``checksum`` concatenates the streams before summing: leaves of odd
    byte length shift every later word across a boundary."""
    bits, cb, tcb_ = make_bits("bf16", 5 * 1024 + 333, 16, heavy=True, seed=1)
    jct = JB.get_backend("xla").encode(jnp.asarray(bits).view(jnp.bfloat16), cb,
                                       layout=layout)
    for name in ("torch", "cuda"):
        tct = TB.get_backend(name).encode(container(bits).view(torch.bfloat16),
                                          tcb_, layout=layout)
        assert TB.get_backend(name).checksum(tct) == \
            JB.get_backend("xla").checksum(jct)
    odd = [np.arange(n, dtype=np.uint8) for n in (3, 1, 5, 2)]
    assert TB.CodecBackend().checksum(torch.from_numpy(np.concatenate(odd))) == \
        JB.CodecBackend().checksum(jnp.asarray(np.concatenate(odd)))
    raw = np.random.default_rng(2).standard_normal((7, 3)).astype(np.float32)
    assert TB.get_backend("torch").checksum(torch.from_numpy(raw)) == \
        JB.get_backend("xla").checksum(jnp.asarray(raw))


# ---------------------------------------------------------------------------
# SZ02 payloads
# ---------------------------------------------------------------------------

CASES = [(fmt, k, n, heavy)
         for fmt in ("bf16", "fp8_e5m2", "fp8_e4m3") for k in (16, 8)
         for n, heavy in ((5000, False), (3001, True), (1, False),
                          (2048, True))]


@pytest.mark.parametrize("fmt,k,n,heavy", CASES,
                         ids=lambda v: str(v))
def test_payload_matches_byte_for_byte(fmt, k, n, heavy):
    bits, cb, tcb_ = make_bits(fmt, n, k, heavy=heavy, seed=n + k)
    want, jstats = JW.encode(bits, cb)
    got, tstats = TW.encode(container(bits), tcb_)
    assert got == want
    assert dataclasses.astuple(tstats) == dataclasses.astuple(jstats)
    assert len(got) == TW.payload_bytes_model(n, tstats.n_escapes, fmt, k) \
        == JW.payload_bytes_model(n, jstats.n_escapes, fmt, k)
    jwc = JB.get_backend("wire").encode(jnp.asarray(bits).view(JAX_FP[fmt]), cb)
    for be in ("wire", "wire-verify"):
        wc = TB.get_backend(be).encode(container(bits).view(TORCH_FP[fmt]), tcb_)
        assert wc.payload == want == jwc.payload and wc.stats == tstats
        assert C.bits_equal(TB.get_backend(be).decode(wc),
                            container(bits).view(TORCH_FP[fmt]))
        assert TB.get_backend(be).checksum(wc) == \
            JB.get_backend("wire").checksum(jwc)
    dec = TW.decode(got, verify=True, device="cpu")
    np.testing.assert_array_equal(C.widen(dec).numpy(), bits.astype(np.int64))
    if heavy and k < 1 << tcb.FORMATS[fmt]["ebits"]:
        assert tstats.n_escapes >= 300


def test_verify_payload_names_the_corrupted_frame():
    bits, cb, tcb_ = make_bits("bf16", 200_000, 16, heavy=True, seed=3)
    payload, _ = TW.encode(container(bits), tcb_)
    header = TW._HEADER.size + 16
    n_frames = TW.n_integrity_frames(len(payload) - header - 4 *
                                     TW._parse(payload).n_frames)
    assert TW._parse(payload).n_frames == n_frames >= 4
    body_off = header + 4 * n_frames
    for offset in (0, TW.FRAME_BYTES - 1, 2 * TW.FRAME_BYTES + 17,
                   len(payload) - body_off - 1):
        bad = bytearray(payload)
        bad[body_off + offset] ^= 0x10
        bad = bytes(bad)
        frames = TW.verify_payload(bad)
        assert frames == JW.verify_payload(bad) == (offset // TW.FRAME_BYTES,)
        with pytest.raises(TW.WireIntegrityError) as err:
            TB.get_backend("wire-verify").decode(TB.WireCompressed(
                payload=bad, shape=(bits.size,), dtype="bfloat16", fmt="bf16",
                stats=None, device="cpu"))
        assert err.value.frames == frames
    assert TW.verify_payload(payload) == () == JW.verify_payload(payload)
    with pytest.raises(ValueError, match="magic"):
        TW.decode(b"XXXX" + payload[4:], device="cpu")


def test_wire_decode_raises_without_cuda(monkeypatch):
    bits, _, tcb_ = make_bits("bf16", 1000, 16, heavy=False, seed=4)
    payload, _ = TW.encode(container(bits), tcb_)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.decode(payload)


# ---------------------------------------------------------------------------
# sessions through the wire backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["wire", "wire-verify"])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_wire_session_matches_jax(backend, n_chunks):
    rng = np.random.default_rng(5)
    kb = rng.standard_normal((2, 40, 2, 16)).astype(jnp.bfloat16).view(np.uint16)
    vb = rng.standard_normal((2, 40, 2, 16)).astype(jnp.bfloat16).view(np.uint16)
    vb.reshape(-1)[:200] = 0x0080 + np.arange(200)      # one chunk over cap
    f8 = rng.integers(0, 256, 700).astype(np.uint8)
    cb = jcb.calibrate([kb], k=16)
    jc = {"k": jnp.asarray(kb).view(jnp.bfloat16),
          "v": jnp.asarray(vb).view(jnp.bfloat16),
          "e": jnp.asarray(f8).view(jnp.float8_e5m2)}
    tc = {"k": container(kb).view(torch.bfloat16),
          "v": container(vb).view(torch.bfloat16),
          "e": torch.from_numpy(f8).view(torch.float8_e5m2)}
    jp = JPL.TransferPlan.build(jc, JPL.TransferConfig(
        codebook=cb, backend=backend, n_chunks=n_chunks))
    tp = TPL.TransferPlan.build(tc, TPL.TransferConfig(
        codebook=tcb.Codebook.from_json(cb.to_json()), backend=backend,
        n_chunks=n_chunks))
    js, ts = jp.session(), tp.session()
    jo, to = js.transfer(jc), ts.transfer(tc)
    for a, b in zip(jax.tree.leaves(jo), TR.leaves(to)):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8).reshape(-1),
                                      C.signed_view(b).contiguous()
                                      .view(torch.uint8).numpy().reshape(-1))
    for name in ("chunk_wire_bytes", "chunk_ok", "leaf_wire_bytes", "leaf_ok",
                 "fp8_wire_bytes", "raw_passthrough_bytes", "n_elements"):
        assert getattr(js.last_stats, name) == getattr(ts.last_stats, name), name
    assert js.last_stats.wire_bytes == ts.last_stats.wire_bytes
    if n_chunks == 1:
        comp, _ = tp.session().transfer_compressed(tc)
        for key, wc in comp.items():
            assert len(wc.payload) == TW.payload_bytes_model(
                wc.stats.n_elements, wc.stats.n_escapes, wc.fmt)

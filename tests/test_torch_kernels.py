"""The port's codec kernel modules against the JAX package's Pallas kernels.

Each kernel module's public function (``encode_fused``, ``decode_fused``,
``encode_dense``, ``decode_dense``) takes its plain PyTorch version for CPU
tensors; here it must match the Pallas kernel run with ``interpret=True``
BITWISE on the same bits, for bf16, fp8_e5m2 and fp8_e4m3.  The ops layer
must dispatch as the JAX package does: fused up to ``MAX_FUSED_CAP``, the
two-stage path above it or when ``fused=False``, and the ``layout='global'``
compaction.  Inputs are the seeded edge cases of
:mod:`repro_torch.kernels.cases`.

The JAX comparisons import JAX through the ``ref`` fixture
(``pytest.importorskip("jax")``), so this file also runs where JAX is not
installed: on the machine with the card, ``pytest -m cuda`` holds every CUDA
kernel against its plain version (those tests skip here, without a card).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import codec as C
from repro_torch.kernels import build, cases as K, ops
from repro_torch.kernels import splitzip_decode as D
from repro_torch.kernels import splitzip_encode as E

FORMATS = ("bf16", "fp8_e5m2", "fp8_e4m3")
CHUNK = 1024


@pytest.fixture(scope="module")
def ref():
    """The JAX package's kernel modules (Pallas, interpret mode on the CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import codebook as jcb
    from repro.kernels import ops as JO
    from repro.kernels import splitzip_decode as JD
    from repro.kernels import splitzip_encode as JE
    return dict(jnp=jnp, jcb=jcb, JO=JO, JD=JD, JE=JE)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def to_torch_bits(bits: np.ndarray) -> torch.Tensor:
    if bits.dtype == np.uint16:
        return torch.from_numpy(bits.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(bits)


def tnp(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def assert_same(jax_out, torch_out, names):
    for name, a, b in zip(names, jax_out, torch_out):
        a, b = np.asarray(a), tnp(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        np.testing.assert_array_equal(a, b, err_msg=name)


def case_rows(fmt: str, name: str):
    """A named case, padded to whole chunks: (numpy bits, torch bits, cap)."""
    bits, cap = {n: (b, c) for n, b, c in K.kernel_cases(fmt)}[name]
    padded = C._pad_to_chunk(to_torch_bits(bits), CHUNK,
                             C.pad_bits_for(K.CODEBOOKS[fmt]))
    x = padded.reshape(-1, CHUNK)
    return tnp(x), x, cap


# every format on specials + a ragged tail; bf16 also at each capacity edge
KERNEL_CASES = ([(fmt, "specials_ragged") for fmt in FORMATS]
                + [("bf16", n) for n in ("count1_cap1", "count2_cap1",
                                         "count128_cap128", "all_escape_cap64")]
                + [("fp8_e5m2", "count65_cap64")])


@pytest.mark.parametrize("fmt,name", KERNEL_CASES)
def test_kernel_functions_match_pallas(ref, fmt, name):
    jnp, JE, JD = ref["jnp"], ref["JE"], ref["JD"]
    xb, x, cap = case_rows(fmt, name)
    exps = tuple(K.CODEBOOKS[fmt].exponents)
    br = JE.fit_block_rows(xb.shape[0], JE.DEFAULT_BLOCK_ROWS)
    kw = dict(fmt=fmt, chunk=CHUNK, block_rows=br, interpret=True)

    j_enc = JE.encode_fused(jnp.asarray(xb), exps, cap=cap, **kw)
    t_enc = E.encode_fused(x, exps, fmt, CHUNK, cap)
    assert_same(j_enc, t_enc, ("sign_mantissa", "packed", "esc_pos",
                               "esc_val", "esc_count"))

    j_dense = JE.encode_dense(jnp.asarray(xb), exps, **kw)
    t_dense = E.encode_dense(x, exps, fmt, CHUNK)
    assert_same(j_dense, t_dense, ("sign_mantissa", "packed", "is_escape"))

    sm, packed, pos, val, cnt = t_enc
    cnt = torch.clamp(cnt, max=cap)
    j_dec = JD.decode_fused(*(jnp.asarray(tnp(t)) for t in (packed, sm, pos,
                                                             val, cnt)),
                            exps, **kw)
    assert_same([j_dec], [D.decode_fused(packed, sm, pos, val, cnt, exps,
                                         fmt, CHUNK)], ["fused bits"])
    j_ddec = JD.decode_dense(jnp.asarray(tnp(packed)), jnp.asarray(tnp(sm)),
                             exps, **kw)
    assert_same([j_ddec], [D.decode_dense(packed, sm, exps, fmt, CHUNK)],
                ["dense bits"])


# (layout, cap, fused): fused kernel, cap > MAX_FUSED_CAP (two-stage), the
# global compaction over the fused kernel's buffers, and fused=False
DISPATCH = [("chunked", 64, True), ("chunked", 256, True),
            ("global", C.DEFAULT_CAP, True), ("chunked", 64, False),
            ("global", C.DEFAULT_CAP, False)]


@pytest.mark.parametrize("layout,cap,fused", DISPATCH)
def test_ops_dispatch_matches_pallas(ref, layout, cap, fused):
    jnp, JO, jcb = ref["jnp"], ref["JO"], ref["jcb"]
    import jax
    bits = {n: b for n, b, _ in K.kernel_cases("bf16")}["specials_ragged"]
    cb = K.CODEBOOKS["bf16"]
    jx = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    tx = to_torch_bits(bits).view(torch.bfloat16)
    jct = JO.encode(jx, jcb.Codebook(fmt="bf16", exponents=cb.exponents),
                    cap=cap, layout=layout, fused=fused)
    tct = ops.encode(tx, cb, cap=cap, layout=layout, fused=fused)
    assert_same(jax.tree.leaves(jct), tct.tensors(),
                ("sign_mantissa", "packed", "esc_pos", "esc_val", "esc_count",
                 "ok"))
    assert (jct.cap, jct.layout) == (tct.cap, tct.layout)
    assert_same([JO.decode_bits(jct, fused=fused)],
                [ops.decode_bits(tct, fused=fused)], ["decoded bits"])
    np.testing.assert_array_equal(tnp(C.to_bits(ops.decode(tct, fused=fused),
                                                 "bf16")), bits)


def test_global_decode_patches_escapes_past_the_fused_cap():
    """A chunk with more escapes than the fused kernel's per-row buffer
    decodes exactly through the two-stage global layout."""
    cb = K.CODEBOOKS["bf16"]
    bits = K._row_with_escapes(cb, 300, CHUNK, np.random.default_rng(9))
    x = to_torch_bits(np.concatenate([bits, bits[:100]])).view(torch.bfloat16)
    ct = ops.encode(x, cb, cap=CHUNK, layout="global", fused=False)
    want = C.encode(x, cb, cap=CHUNK, layout="global")
    assert bool(ct.ok) and int(ct.esc_count[0]) >= 300
    for a, b in zip(ct.tensors(), want.tensors()):
        assert C.bits_equal(a, b)
    assert C.bits_equal(ops.decode(ct, fused=False), x)
    assert not bool(ops.encode(x, cb, cap=CHUNK, layout="global").ok)


def test_cpu_operands_take_the_plain_version():
    xb, x, cap = case_rows("bf16", "specials_ragged")
    exps = tuple(K.CODEBOOKS["bf16"].exponents)
    before = (E.encode_fused.launches, E.encode_dense.launches,
              D.decode_fused.launches, D.decode_dense.launches)
    errs = K.check_case(to_torch_bits(xb.reshape(-1)), K.CODEBOOKS["bf16"], cap)
    assert errs == dict.fromkeys(errs, 0)
    after = (E.encode_fused.launches, E.encode_dense.launches,
             D.decode_fused.launches, D.decode_dense.launches)
    assert before == after                      # nothing launched on the CPU
    assert build.loaded() == {}
    meta = torch.empty(x.shape, dtype=torch.uint16, device="meta")
    with pytest.raises(ValueError, match="devices"):
        E.encode_fused(meta, exps, "bf16", CHUNK, cap)


def test_wrappers_reject_bad_operands():
    _, x, _ = case_rows("bf16", "zero_escape")
    exps = tuple(K.CODEBOOKS["bf16"].exponents)
    with pytest.raises(TypeError):
        E.encode_fused(x.view(torch.int16), exps, "bf16", CHUNK, 64)
    with pytest.raises(ValueError):
        E.encode_dense(x.reshape(-1), exps, "bf16", CHUNK)
    with pytest.raises(ValueError):
        E.encode_fused(x, exps, "bf16", CHUNK, E.MAX_FUSED_CAP + 1)
    with pytest.raises(ValueError):
        E.encode_fused(x, exps, "bf16", CHUNK, 0)
    with pytest.raises(ValueError, match="k <= 16"):
        E.encode_dense(x, tuple(range(100, 117)), "bf16", CHUNK)
    sm, packed, pos, val, cnt = E.encode_fused(x, exps, "bf16", CHUNK, 64)
    wide = torch.cat([sm, sm], dim=1)[:, ::2]                 # non-contiguous
    with pytest.raises(ValueError, match="contiguous"):
        D.decode_dense(packed, wide, exps, "bf16", CHUNK)
    with pytest.raises(ValueError):
        D.decode_fused(packed, sm, pos, val, cnt.reshape(-1), exps, "bf16",
                       CHUNK)


@pytest.mark.parametrize("fmt", FORMATS)
def test_edge_cases_round_trip(fmt):
    """The on-card edge cases hold on the CPU: rows within capacity decode
    back to their input bits."""
    for name, bits, cap in K.kernel_cases(fmt, seed=1):
        errs = K.check_case(to_torch_bits(bits), K.CODEBOOKS[fmt], cap)
        assert max(errs.values()) == 0, name


def test_build_is_keyed_on_the_source_and_stays_out_of_git(tmp_path,
                                                           monkeypatch):
    repo = build.build_dir().parents[1]
    assert build.build_dir() == repo / "build" / "repro_torch_kernels"
    assert "build/" in (repo / ".gitignore").read_text().split()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    paths = {build.library_path(n) for n in build.SOURCES}
    assert sorted(build.SOURCES) == ["flash_attention", "splitzip_attention",
                                     "splitzip_decode", "splitzip_encode"]
    assert len(paths) == 4 and all(p.parent == build.build_dir() for p in paths)
    # an edited source gets another library
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setitem(build.SOURCES, "probe", src)
    v1 = build.library_path("probe")
    src.write_text("// v2\n")
    assert build.library_path("probe") != v1


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    from pathlib import Path
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernels_match_plain_on_card(cuda_device, fmt):
    """Every CUDA kernel bitwise against its plain version on the card."""
    launched = E.encode_fused.launches
    for name, bits, cap in K.kernel_cases(fmt, seed=2):
        errs = K.check_case(to_torch_bits(bits).to(cuda_device),
                            K.CODEBOOKS[fmt], cap)
        torch.cuda.synchronize()
        assert max(errs.values()) == 0, (name, errs)
    assert E.encode_fused.launches > launched

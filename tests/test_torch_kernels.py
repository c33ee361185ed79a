"""The port's codec kernel modules against the JAX package's Pallas kernels.

Each kernel module's public function (``encode_fused``, ``decode_fused``,
``encode_dense``, ``decode_dense``) takes its plain PyTorch version for CPU
tensors; here it must match the Pallas kernel run with ``interpret=True``
BITWISE on the same bits, for bf16, fp8_e5m2 and fp8_e4m3.  The ops layer
must dispatch as the JAX package does: fused up to ``MAX_FUSED_CAP``, the
two-stage path above it or when ``fused=False``, and the ``layout='global'``
compaction.  Inputs are the seeded edge cases of
:mod:`repro_torch.kernels.cases`, among them the edges of the persistent
warp-a-row fused kernels (``fused_cases``, ``repeated_slot_case``), which the
fused functions must match at every chunk width they take.

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
FORMATS_MBITS = {"bf16": 7, "fp8_e5m2": 2, "fp8_e4m3": 3}
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


FUSED_CASE_NAMES = [name for name, *_ in K.fused_cases("bf16")]


def fused_case(fmt: str, name: str):
    """A named fused-kernel edge case: (numpy rows, torch rows, cap, chunk)."""
    bits, cap, chunk = {n: (b, c, ch) for n, b, c, ch in K.fused_cases(fmt)}[name]
    x = to_torch_bits(bits).reshape(-1, chunk)
    return tnp(x), x, cap, chunk


@pytest.mark.parametrize("fmt,name", [("bf16", n) for n in FUSED_CASE_NAMES]
                         + [(f, n) for f in FORMATS[1:]
                            for n in ("chunk768", "count31_32_33_cap40")])
def test_fused_edges_match_pallas(ref, fmt, name):
    """The fused encode and decode at the persistent kernels' edges: chunk
    widths 256 to 8192, 1 and 7 rows, counts 31/32/33 and cap, every escape
    in one 16-element span."""
    jnp, JE, JD = ref["jnp"], ref["JE"], ref["JD"]
    xb, x, cap, chunk = fused_case(fmt, name)
    exps = tuple(K.CODEBOOKS[fmt].exponents)
    kw = dict(fmt=fmt, chunk=chunk, block_rows=xb.shape[0], interpret=True)
    t_enc = E.encode_fused(x, exps, fmt, chunk, cap)
    assert_same(JE.encode_fused(jnp.asarray(xb), exps, cap=cap, **kw), t_enc,
                ("sign_mantissa", "packed", "esc_pos", "esc_val", "esc_count"))
    sm, packed, pos, val, cnt = t_enc
    cnt = torch.clamp(cnt, max=cap)
    j_dec = JD.decode_fused(*(jnp.asarray(tnp(t)) for t in (packed, sm, pos,
                                                             val, cnt)),
                            exps, **kw)
    assert_same([j_dec], [D.decode_fused(packed, sm, pos, val, cnt, exps, fmt,
                                         chunk)], ["fused bits"])


DENSE_CASE_NAMES = [f"chunk{chunk}" for chunk, _, _ in K.FUSED_CHUNKS] + ["rows1",
                                                                       "rows7"]


@pytest.mark.parametrize("fmt,name", [(f, n) for f in FORMATS
                                      for n in DENSE_CASE_NAMES])
def test_dense_edges_match_pallas(ref, fmt, name):
    """The dense decode at the persistent kernels' edges (chunk widths 256
    to 8192, 1 and 7 rows) on ``encode_dense``'s streams: escapes stay at
    code 0's exponent, as in the Pallas ``decode_dense``."""
    jnp, JE, JD = ref["jnp"], ref["JE"], ref["JD"]
    xb, x, _, chunk = fused_case(fmt, name)
    exps = tuple(K.CODEBOOKS[fmt].exponents)
    br = JE.fit_block_rows(xb.shape[0], JE.DEFAULT_BLOCK_ROWS)
    kw = dict(fmt=fmt, chunk=chunk, block_rows=br, interpret=True)
    sm, packed, is_esc = E.encode_dense(x, exps, fmt, chunk)
    assert_same(JE.encode_dense(jnp.asarray(xb), exps, **kw), (sm, packed, is_esc),
                ("sign_mantissa", "packed", "is_escape"))
    got = D.decode_dense(packed, sm, exps, fmt, chunk)
    want = JD.decode_dense(jnp.asarray(tnp(packed)), jnp.asarray(tnp(sm)), exps, **kw)
    assert_same([want], [got], ["dense bits"])
    # exactly the escaped elements differ from the input
    esc = tnp(is_esc) != 0
    assert esc.any()
    np.testing.assert_array_equal(tnp(got) != xb, esc)


@pytest.mark.parametrize("fmt", FORMATS)
def test_repeated_slot_matches_pallas(ref, fmt):
    """Slots 31 and 32 name one position: the later slot wins, as the Pallas
    kernel's slot loop has it."""
    jnp, JD = ref["jnp"], ref["JD"]
    streams = K.repeated_slot_case(fmt)
    exps = tuple(K.CODEBOOKS[fmt].exponents)
    got = D.decode_fused(*streams, exps, fmt, CHUNK)
    want = JD.decode_fused(*(jnp.asarray(tnp(t)) for t in streams), exps,
                           fmt=fmt, chunk=CHUNK, block_rows=2, interpret=True)
    assert_same([want], [got], ["fused bits"])
    pos, val = C.widen(streams[2]), streams[3]
    p = int(pos[0, 31])
    assert int(pos[0, 32]) == p and int(val[0, 32]) != int(val[0, 31])
    field = got[:1].to(torch.int32) >> FORMATS_MBITS[fmt]
    mask = (1 << (8 * got.element_size() - 1 - FORMATS_MBITS[fmt])) - 1
    assert int(field[0, p]) & mask == int(val[0, 32])


def test_fused_cases_reach_their_edges():
    """The cases are what their names say: every chunk width, 1 and 7 rows,
    true counts 31/32/33/cap/cap+1, 16 escapes in one 16-element span."""
    cases = {n: (b, c, ch) for n, b, c, ch in K.fused_cases("bf16")}
    exps = tuple(K.CODEBOOKS["bf16"].exponents)

    def counts(name):
        bits, cap, chunk = cases[name]
        x = to_torch_bits(bits).reshape(-1, chunk)
        return E.encode_fused(x, exps, "bf16", chunk, cap)[4].reshape(-1).tolist()

    assert {cases[f"chunk{c}"][2] for c, _, _ in K.FUSED_CHUNKS} == {256, 768, 2048, 8192}
    for chunk, want, cap in K.FUSED_CHUNKS:
        assert counts(f"chunk{chunk}") == list(want)
        assert max(want) > cap
    assert len(counts("rows1")) == 1 and len(counts("rows7")) == 7
    assert counts("count31_32_33_cap40") == [31, 32, 33, 40, 41]
    bits, cap, chunk = cases["one_lane16"]
    x = to_torch_bits(bits).reshape(-1, chunk)
    _, _, pos, _, cnt = E.encode_fused(x, exps, "bf16", chunk, cap)
    assert cnt.reshape(-1).tolist() == [cap] * 3 == [16] * 3
    for row, lane in zip(C.widen(pos).tolist(), (0, 13, 63)):
        assert row == list(range(16 * lane, 16 * lane + 16))


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


@pytest.mark.parametrize("fmt", FORMATS)
def test_k8_cases_match_pallas(ref, fmt):
    """8-entry exponent tables (``cases.CODEBOOKS_K8``): the fused and dense
    kernel functions against the Pallas kernels (interpreted) on the
    specials and the all-escape row, and every k-8 edge case round-trips."""
    jnp, JE, JD = ref["jnp"], ref["JE"], ref["JD"]
    cb = K.CODEBOOKS_K8[fmt]
    exps = tuple(cb.exponents)
    cases = {n: (b, c) for n, b, c in K.kernel_cases(fmt, seed=2, cb=cb)}
    for name in ("specials_ragged", "all_escape_cap64"):
        bits, cap = cases[name]
        x = C._pad_to_chunk(to_torch_bits(bits), CHUNK,
                            C.pad_bits_for(cb)).reshape(-1, CHUNK)
        xb = tnp(x)
        kw = dict(fmt=fmt, chunk=CHUNK, interpret=True,
                  block_rows=JE.fit_block_rows(xb.shape[0], JE.DEFAULT_BLOCK_ROWS))
        t_enc = E.encode_fused(x, exps, fmt, CHUNK, cap)
        assert_same(JE.encode_fused(jnp.asarray(xb), exps, cap=cap, **kw), t_enc,
                    ("sign_mantissa", "packed", "esc_pos", "esc_val", "esc_count"))
        assert_same(JE.encode_dense(jnp.asarray(xb), exps, **kw),
                    E.encode_dense(x, exps, fmt, CHUNK),
                    ("sign_mantissa", "packed", "is_escape"))
        sm, packed, pos, val, cnt = t_enc
        cnt = torch.clamp(cnt, max=cap)
        j_dec = JD.decode_fused(*(jnp.asarray(tnp(t)) for t in (packed, sm, pos,
                                                                 val, cnt)),
                                exps, **kw)
        assert_same([j_dec], [D.decode_fused(packed, sm, pos, val, cnt, exps,
                                             fmt, CHUNK)], ["fused bits"])
    for name, bits, cap in K.kernel_cases(fmt, seed=2, cb=cb):
        assert max(K.check_case(to_torch_bits(bits), cb, cap).values()) == 0, name
    for name, bits, cap, chunk in K.fused_cases(fmt, seed=2, cb=cb):
        assert max(K.check_case(to_torch_bits(bits), cb, cap, chunk).values()) == 0, name


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


def test_build_is_keyed_on_the_shared_header(tmp_path, monkeypatch):
    """An edit to a header the sources include rebuilds every library."""
    assert all(h.is_file() and h.parent == build.CSRC for h in build.HEADERS)
    header = tmp_path / "h.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(build, "HEADERS", (header,))
    before = {n: build.library_path(n) for n in build.SOURCES}
    header.write_text("// v2\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)


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


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_k8_kernels_match_plain_on_card(cuda_device, fmt):
    """Every CUDA kernel bitwise against its plain version under an
    8-entry exponent table, on the edge cases and the fused edges."""
    cb = K.CODEBOOKS_K8[fmt]
    cases = [(n, b, c, 1024) for n, b, c in K.kernel_cases(fmt, seed=3, cb=cb)]
    for name, bits, cap, chunk in cases + K.fused_cases(fmt, seed=3, cb=cb):
        errs = K.check_case(to_torch_bits(bits).to(cuda_device), cb, cap, chunk)
        torch.cuda.synchronize()
        assert max(errs.values()) == 0, (name, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_fused_edges_match_plain_on_card(cuda_device, fmt):
    """The persistent fused kernels bitwise against their plain versions at
    their edges (every chunk width, 1 and 7 rows, the 32-slot prefetch, one
    lane's span, a repeated slot), and over more rows than one pass of the
    persistent grid covers, in a count that is no multiple of its warps."""
    for name, bits, cap, chunk in K.fused_cases(fmt, seed=2):
        errs = K.check_case(to_torch_bits(bits).to(cuda_device),
                            K.CODEBOOKS[fmt], cap, chunk)
        torch.cuda.synchronize()
        assert max(errs.values()) == 0, (name, errs)
    streams = tuple(t.to(cuda_device) for t in K.repeated_slot_case(fmt))
    assert K.check_decode_case(streams, K.CODEBOOKS[fmt]) == 0
    # 1024 takes 16 elements a lane, 768 takes 8: each its own grid
    for chunk in (1024, 768):
        big = 1 << 40
        warps = max(E.fused_grid(fmt, big, chunk, cuda_device) * E.FUSED_WARPS,
                    D.fused_grid(fmt, big, chunk, cuda_device) * D.FUSED_WARPS)
        assert E.fused_grid(fmt, 7, chunk, cuda_device) == 1
        bits = K.many_rows(fmt, warps + 37, seed=3, chunk=chunk)
        errs = K.check_case(to_torch_bits(bits).to(cuda_device),
                            K.CODEBOOKS[fmt], 64, chunk)
        torch.cuda.synchronize()
        assert max(errs.values()) == 0, ("more rows than a grid pass", chunk, errs)


def _sass(functions):
    """``cuobjdump -sass`` text of ``{mangled name: [instructions]}``."""
    lines = []
    for name, body in functions.items():
        lines.append(f"\t\tFunction : {name}")
        lines += [f"        /*{16 * i:04x}*/                   {ins} ;   /* 0x0 */"
                  for i, ins in enumerate(body)]
    return "\n".join(lines)


def test_codec_sass_compares_kernels_by_role():
    """``ab_kernels`` holds the codec kernels a revision leaves alone to the
    parent's SASS by role: the templated ``decode_kernel<..., true>`` is the
    parent's ``decode_fused_kernel``, ``<..., false>`` its dense decode, and
    a moved parameter offset is not a difference."""
    from repro_torch.kernels import ab_kernels as AB
    tail = "EEEvPKhS2_PKtS2_PKiPT_xiiNS_9DecodeLutE"
    old = _sass({
        f"_ZN12_GLOBAL__N_119decode_fused_kernelItLi7ELi8ELi16{tail}":
            ["LDC R1, c[0x0][0x28]", "EXIT"],
        "_ZN12_GLOBAL__N_119decode_dense_kernelIhLi2ELi5EEEvPKhS2_PT_iNS_9DecodeLutE":
            ["S2R R0, SR_TID.X", "EXIT"],
        "_ZN12_GLOBAL__N_119encode_fused_kernelItLi7ELi8ELi16EEEvPKT_Ph": ["NOP"],
        "_ZN12_GLOBAL__N_119encode_dense_kernelIhLi3ELi4EEEvPKT_PhS4_S4_i": ["NOP"],
        "_Z9unrelatedv": ["BRA"]})
    new = _sass({
        f"_ZN12_GLOBAL__N_113decode_kernelItLi7ELi8ELi16ELb1{tail}":
            ["LDC R1, c[0x0][0x30]", "EXIT"],
        f"_ZN12_GLOBAL__N_113decode_kernelIhLi2ELi5ELi16ELb0{tail}":
            ["LDG.E.128.CONSTANT R4, [R2.64]", "EXIT"],
        "_ZN12_GLOBAL__N_119encode_fused_kernelItLi7ELi8ELi16EEEvPKT_Ph": ["NOP"],
        "_ZN12_GLOBAL__N_119encode_dense_kernelIhLi3ELi4EEEvPKT_PhS4_S4_i": ["NOP"]})
    a, b = AB.codec_sass_of(old), AB.codec_sass_of(new)
    assert sorted(a) == [("decode_dense", "h", "2", "5", ""),
                         ("decode_fused", "t", "7", "8", "16"),
                         ("encode_dense", "h", "3", "4", ""),
                         ("encode_fused", "t", "7", "8", "16")]
    assert ("decode_dense", "h", "2", "5", "16") in b
    assert a[("decode_fused", "t", "7", "8", "16")] == ["LDC R1, c[0x0][*]", "EXIT"]
    assert AB.sass_equal(a, b) == {"encode_fused": True, "encode_dense": True,
                                   "decode_fused": True}
    changed = dict(b)
    changed[("encode_dense", "h", "3", "4", "")] = ["NOP", "NOP"]
    del changed[("encode_fused", "t", "7", "8", "16")]
    assert AB.sass_equal(a, changed) == {"encode_fused": False,
                                         "encode_dense": False,
                                         "decode_fused": True}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_dense_decode_matches_plain_past_its_grid_on_card(cuda_device, fmt):
    """The persistent dense decode bitwise against its plain version over
    more rows than one pass of its own grid covers, at 16 elements a lane
    (chunk 1024) and 8 (chunk 768); 7 rows take one CTA."""
    exps = tuple(K.CODEBOOKS[fmt].exponents)
    for chunk in (1024, 768):
        assert D.dense_grid(fmt, 7, chunk, cuda_device) == 1
        rows = D.dense_grid(fmt, 1 << 40, chunk, cuda_device) * D.FUSED_WARPS + 37
        x = to_torch_bits(K.many_rows(fmt, rows, seed=4, chunk=chunk)).to(
            cuda_device).reshape(rows, chunk)
        sm, packed, _ = E.encode_dense(x, exps, fmt, chunk)
        launched = D.decode_dense.launches
        got = D.decode_dense(packed, sm, exps, fmt, chunk)
        torch.cuda.synchronize()
        assert D.decode_dense.launches == launched + 1
        want = D.decode_dense_plain(packed, sm, exps, fmt, chunk)
        assert K.max_abs_err((got,), (want,)) == 0, chunk


@pytest.mark.cuda
def test_decode_grids_use_their_own_occupancy(cuda_device, tmp_path):
    """The fused and the dense decode kernel of one library each size their
    persistent grid from their own occupancy, whichever is asked first: in
    a fresh copy of the library (its own cache) each grid equals what the
    runtime gives for its own kernel, times the SMs."""
    import ctypes
    import shutil
    D.fused_grid("bf16", 1, CHUNK, cuda_device)           # builds the library
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for order in (("fused", "dense"), ("dense", "fused")):
        lib = ctypes.CDLL(str(shutil.copy(build.library_path("splitzip_decode"),
                                          tmp_path / f"lib_{order[0]}.so")))
        for fmt in FORMATS:
            for chunk in (1024, 768):
                for kernel in order:
                    entry = getattr(lib, f"sz_decode_{kernel}_grid")
                    entry.argtypes = D._PROTOTYPES[f"sz_decode_{kernel}_grid"]
                    ctas = ctypes.c_int(0)
                    with torch.cuda.device(cuda_device):
                        assert entry(build.FMT_ID[fmt], 1 << 40, chunk,
                                     ctypes.byref(ctas)) == 0
                    fit = D.ctas_per_sm(kernel, fmt, chunk, cuda_device)
                    assert ctas.value == fit * sms, (order, fmt, chunk, kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_payload_on_card_matches_host(cuda_device, fmt):
    """The ``wire`` backend builds the SZ02 body on the card from the codec
    kernels' streams (escapes compacted in chunk order, fields repacked):
    byte for byte the reference codec's payload built on the CPU, on every
    edge case (caps 1 to 128: over-cap chunks take the global re-encode);
    ``wire-verify`` decodes it on the card back to the sent bits."""
    from repro_torch.core import backend as TB
    from repro_torch.core import wire as W
    cb = K.CODEBOOKS[fmt]
    be = TB.get_backend("wire-verify")
    for name, bits, cap in K.kernel_cases(fmt):
        host = to_torch_bits(bits)
        want, stats = W.encode(host, cb)
        x = host.to(cuda_device)
        wc = be.encode(x, cb, cap=cap)
        assert wc.payload == want and wc.stats == stats, name
        assert C.bits_equal(be.decode(wc), x), name
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_fletcher32_on_card_matches_cpu(cuda_device):
    from repro_torch.core import wire as W
    for n in (1, 2, 65537, (3 << 21) + 1):
        buf = torch.from_numpy(
            np.random.default_rng(n).integers(0, 256, n).astype(np.uint8))
        card = buf.to(cuda_device)
        assert W.fletcher32(card) == W.fletcher32(buf)
        np.testing.assert_array_equal(W.frame_checksums(card),
                                      W.frame_checksums(buf))

"""The port's paged-attention modules against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version, which must match the
JAX package's Pallas kernel run with ``interpret=True`` on the same pages:
``m`` within rtol 1e-6, ``l`` and ``acc`` within rtol 1e-5, each with an
absolute floor of the same share of the tensor's largest magnitude (both
sides sum in f32, in another order: the Pallas interpreter's dot against
PyTorch's einsum).  The plain page decoder must equal the JAX package's bitwise, in
all three formats.  The tail/merge/finalize glue must match too.

The inputs are the seeded pages of :mod:`repro_torch.kernels.attention_cases`
(every byte drawn, escape counts 0 / some / cap / over cap), on pools of a
few pages so the interpreted kernels stay quick.  The ``cuda`` test holds
the CUDA kernels against their plain versions on a card and skips here.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import attention_cases as AC
from repro_torch.kernels import cases as K
from repro_torch.kernels import splitzip_attention as SA
from repro_torch.kernels.cases import CODEBOOKS

CHUNK = 1024
FORMATS = ("bf16", "fp8_e5m2", "fp8_e4m3")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's attention module (Pallas, interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import splitzip_attention as JSA
    from repro.models import kvpool as JP
    return dict(jnp=jnp, JSA=JSA, JP=JP)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def np_of(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def jax_streams(ref, streams):
    return tuple(ref["jnp"].asarray(np_of(t)) for t in streams)


def jax_bf16(ref, t):
    import jax
    return jax.lax.bitcast_convert_type(ref["jnp"].asarray(np_of(t)),
                                        ref["jnp"].bfloat16)


def assert_partials(got, want):
    """m within rtol 1e-6, l and acc within rtol 1e-5; the absolute floor of
    each is the same share of the tensor's largest magnitude (an entry of
    ``acc`` near 0 is a sum of terms of the row's scale, and inherits their
    rounding, not a share of its own small value)."""
    for g, w, rtol in zip(got, want, (1e-5, 1e-6, 1e-5)):
        w = np.asarray(w)
        scale = float(np.abs(w[w > -1e29]).max(initial=0.0))
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=rtol * max(scale, 1e-6))


# ---------------------------------------------------------------------------
# the page decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_pages_matches_jax_bitwise(ref, fmt):
    """Dense decode + page escapes (count 0 / cap / over cap, any exponent:
    NaN, Inf, zero and subnormal payloads) against ``_decode_pool_pages``."""
    JP = ref["JP"]
    jnp = ref["jnp"]
    rng = np.random.default_rng(3)
    cb = CODEBOOKS[fmt]
    pe, cap = 2 * CHUNK, 16
    streams = AC.page_streams(cb, 6, pe, cap, CHUNK, rng)
    got = SA.decode_pages(streams, tuple(cb.exponents), fmt, CHUNK)
    assert got.dtype == (torch.uint16 if fmt == "bf16" else torch.uint8)
    sm, packed, pos, val, cnt = jax_streams(ref, streams)
    leaf = JP.PagedLeaf(sign_mantissa=sm, packed=packed, esc_pos=pos,
                        esc_val=val, esc_cnt=cnt,
                        page_table=jnp.zeros((1, 1, 1), jnp.int32),
                        tail=jnp.zeros((1, 1, 1, 1), jnp.bfloat16))
    lg = JP.LeafGeometry(key="k", shape=(1, 1, 1, 1), dtype="bfloat16",
                         fmt=fmt, m=1, page_elems=pe, page_chunks=2,
                         escape_cap=cap, n_pages=6)
    geom = JP.PoolGeometry(tokens_per_page=1, chunk=CHUNK, max_pages=1,
                           n_layers=1, batch=1, max_seq=1,
                           exponents=tuple(cb.exponents), leaves=(lg,))
    want = np.asarray(JP._decode_pool_pages(leaf, lg, geom))
    mask = 0xFFFF if fmt == "bf16" else 0xFF
    np.testing.assert_array_equal(np_of(got).astype(np.int64),
                                  want.astype(np.int64) & mask)


def test_decode_pages_checks_operands():
    cb = CODEBOOKS["bf16"]
    sm, packed, pos, val, cnt = AC.page_streams(cb, 2, CHUNK, 8, CHUNK,
                                                np.random.default_rng(0))
    with pytest.raises(TypeError):
        SA.decode_pages((sm, packed, pos.view(torch.int16), val, cnt),
                        cb.exponents, "bf16", CHUNK)
    with pytest.raises(ValueError):
        SA.decode_pages((sm, packed, pos, val, cnt.reshape(-1)), cb.exponents,
                        "bf16", CHUNK)


# ---------------------------------------------------------------------------
# paged GQA and MLA: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

GQA_CASES = {
    # nq 2 (causal mask active), dv != hd with their own caps, an empty row
    "nq2_dv_ne_hd_empty_row": dict(batch=2, nq=2, heads=4, hkv=2, hd=32,
                                   dv=128, tp=16, pages=3, lens=[45, 9]),
    "nq1": dict(batch=2, nq=1, heads=4, hkv=2, hd=32, dv=32, tp=16, pages=3,
                lens=[48, 33]),
}


@pytest.mark.parametrize("name", sorted(GQA_CASES))
def test_paged_gqa_plain_matches_pallas(ref, name):
    case = AC.gqa_case("bf16", 11, **GQA_CASES[name])
    got = SA.paged_gqa_attention(**case)
    want = ref["JSA"].paged_gqa_attention(
        jax_bf16(ref, case["q"]), jax_streams(ref, case["k_streams"]),
        jax_streams(ref, case["v_streams"]),
        ref["jnp"].asarray(case["page_table_k"].numpy()),
        ref["jnp"].asarray(case["page_table_v"].numpy()),
        ref["jnp"].asarray(case["cache_len"].numpy()),
        exponents=case["exponents"], fmt="bf16", chunk=CHUNK,
        tokens_per_page=case["tokens_per_page"], hkv=case["hkv"], causal=True,
        scale=case["scale"], interpret=True)
    assert_partials(got, want)
    if 9 in GQA_CASES[name]["lens"]:                  # the empty row
        acc, m, l = got
        assert bool((m[1] == SA.NEG_INF).all()) and not l[1].any() and not acc[1].any()


MLA_CASES = {
    # nq 2, ckv/krope with their own page_chunks and caps, an empty row
    "nq2_empty_row": dict(batch=2, nq=2, heads=4, rank=128, rope=32, tp=32,
                          pages=3, lens=[80, 20]),
    "nq1": dict(batch=2, nq=1, heads=4, rank=128, rope=32, tp=32, pages=3,
                lens=[96, 40]),
}


@pytest.mark.parametrize("name", sorted(MLA_CASES))
def test_paged_mla_plain_matches_pallas(ref, name):
    case = AC.mla_case("bf16", 12, **MLA_CASES[name])
    assert case["ckv_streams"][2].shape[1] != case["krope_streams"][2].shape[1]
    got = SA.paged_mla_attention(**case)
    want = ref["JSA"].paged_mla_attention(
        jax_bf16(ref, case["q_lat"]), jax_bf16(ref, case["q_rope"]),
        jax_streams(ref, case["ckv_streams"]),
        jax_streams(ref, case["krope_streams"]),
        ref["jnp"].asarray(case["page_table_ckv"].numpy()),
        ref["jnp"].asarray(case["page_table_krope"].numpy()),
        ref["jnp"].asarray(case["cache_len"].numpy()),
        exponents=case["exponents"], fmt="bf16", chunk=CHUNK,
        tokens_per_page=case["tokens_per_page"], scale=case["scale"],
        causal=True, interpret=True)
    assert_partials(got, want)


def test_wrappers_check_operands():
    case = AC.gqa_case("bf16", 1, **GQA_CASES["nq1"])
    with pytest.raises(TypeError):
        SA.paged_gqa_attention(**{**case, "q": case["q"].float()})
    with pytest.raises(ValueError, match="geometry"):
        SA.paged_gqa_attention(**{**case, "hkv": 4})
    with pytest.raises(ValueError):
        SA.paged_gqa_attention(**{**case, "cache_len": case["cache_len"][:1]})
    mcase = AC.mla_case("bf16", 1, **MLA_CASES["nq1"])
    with pytest.raises(ValueError, match="geometry"):
        SA.paged_mla_attention(**{**mcase, "tokens_per_page": 16})


# ---------------------------------------------------------------------------
# the GQA split (flash-decoding): ranges, per-split partials, merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(AC.GQA_SPLIT_EDGE))
def test_gqa_split_partials_merge_to_the_unsplit_plain_version(name):
    """The split ranges cover each row's full pages exactly once; folding
    the per-range plain partials with ``merge_partials`` (and merging them
    as the merge kernel does) gives the unsplit plain version's ``m``
    bitwise and ``l``, ``acc`` within ``PARTIALS_RTOL``."""
    kw, n_split = AC.GQA_SPLIT_EDGE[name]
    case = AC.gqa_case("bf16", 31, **kw)
    n_pages = case["page_table_k"].shape[1]
    tp = case["tokens_per_page"]
    for length in case["cache_len"].tolist():
        n_full = min(length // tp, n_pages)
        covered = [p for lo, hi in SA.split_ranges(n_split, n_pages, n_full)
                   for p in range(lo, hi)]
        assert covered == list(range(n_full)), (length, covered)
    parts = SA.paged_gqa_splits_plain(**case, n_split=n_split)
    assert parts[0].shape[0] == n_split
    want = SA.paged_gqa_attention_plain(**case)
    folded = tuple(x[0] for x in parts)
    for s in range(1, n_split):
        folded = SA.merge_partials(folded, tuple(x[s] for x in parts))
    for got in (folded, SA.merge_splits(*parts)):
        assert torch.equal(got[1], want[1])
        AC.check_partials(got, want)


def test_gqa_split_edges_reach_their_edges():
    """Each edge case has what its name says: empty splits, a row with no
    full page, and a split whose every key is above a query's diagonal."""
    kw, n_split = AC.GQA_SPLIT_EDGE["more_splits_than_pages"]
    assert n_split > kw["pages"]
    kw, n_split = AC.GQA_SPLIT_EDGE["empty_row"]
    assert min(kw["lens"]) < kw["tp"]
    kw, n_split = AC.GQA_SPLIT_EDGE["nq4_causal_masked_split"]
    case = AC.gqa_case("bf16", 31, **kw)
    acc, m, l = SA.paged_gqa_splits_plain(**case, n_split=n_split)
    dead = m <= SA.NEG_INF                        # (split, B, nq, H)
    assert bool(dead[-1, 0, 0].all())             # last split, first query
    assert not bool(dead[-1, 0, -1].any())        # ... the last query sees it
    assert not l[dead].any() and not acc[dead].any()


@pytest.mark.parametrize("args,want", [
    ((132, 8, 3, 27), 11),      # smollm-135m resident: 264 CTAs
    ((132, 4, 4, 66), 17),      # qwen3-moe-30b-a3b resident: 272 CTAs
    ((132, 1, 1, 4), 4),        # at most one split a page
    ((132, 64, 8, 40), 1),      # the rows alone cover the card
    ((132, 2, 2, 0), 1),        # no pages
])
def test_gqa_split_count_covers_the_card(args, want):
    n_sm, b, hkv, n_pages = args
    n_split = SA.split_count(*args)
    assert n_split == want
    assert 1 <= n_split <= max(1, n_pages)
    if n_split < n_pages:
        assert b * hkv * n_split >= SA.SPLIT_WAVES * n_sm


def test_gqa_tile_fits_the_budget():
    """A whole page is one tile where it fits (the served geometries); the
    shared memory formula is the CUDA source's."""
    assert SA._gqa_tile(80, 3, 64, 64, 2) == 80
    assert SA._gqa_tile(32, 8, 128, 128, 2) == 32
    assert SA.gqa_smem_bytes(80, 3, 64, 64, 2) == 2 * 15_360 + 2 * 21_120 + 2_520
    assert SA._gqa_tile(256, 8, 128, 128, 2) < 256


# ---------------------------------------------------------------------------
# the MLA split: head groups, split count, per-split partials, merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(AC.MLA_SPLIT_EDGE))
def test_mla_split_partials_merge_to_the_unsplit_plain_version(name):
    """As for GQA: the ranges cover each row's full pages once; the per-split
    plain partials, folded with ``merge_partials`` and merged as the merge
    kernel does, give the unsplit plain version's ``m`` bitwise and ``l``,
    ``acc`` within ``PARTIALS_RTOL``."""
    kw, n_split = AC.MLA_SPLIT_EDGE[name]
    case = AC.mla_case("bf16", 32, **kw)
    n_pages = case["page_table_ckv"].shape[1]
    tp = case["tokens_per_page"]
    for length in case["cache_len"].tolist():
        n_full = min(length // tp, n_pages)
        covered = [p for lo, hi in SA.split_ranges(n_split, n_pages, n_full)
                   for p in range(lo, hi)]
        assert covered == list(range(n_full)), (length, covered)
    parts = SA.paged_mla_splits_plain(**case, n_split=n_split)
    assert parts[0].shape == (n_split, *case["q_lat"].shape)
    want = SA.paged_mla_attention_plain(**case)
    folded = tuple(x[0] for x in parts)
    for s in range(1, n_split):
        folded = SA.merge_partials(folded, tuple(x[s] for x in parts))
    for got in (folded, SA.merge_splits(*parts)):
        assert torch.equal(got[1], want[1])
        AC.check_partials(got, want)


def test_mla_split_edges_reach_their_edges():
    """Each MLA edge case has what its name says."""
    E = AC.MLA_SPLIT_EDGE
    assert E["more_splits_than_pages"][1] > E["more_splits_than_pages"][0]["pages"]
    assert min(E["empty_row"][0]["lens"]) < E["empty_row"][0]["tp"]
    kw, n_split = E["nq4_causal_masked_split"]
    acc, m, l = SA.paged_mla_splits_plain(**AC.mla_case("bf16", 32, **kw),
                                          n_split=n_split)
    dead = m <= SA.NEG_INF                        # (split, B, nq, H)
    assert bool(dead[-1, 0, 0].all())             # last split, first query
    assert not bool(dead[-1, 0, -1].any())        # ... the last query sees it
    assert not l[dead].any() and not acc[dead].any()
    kw = E["nq4_h40_four_groups"][0]
    assert SA.mla_grid(kw["batch"], 4, 40, kw["pages"], 132)[1] == 4
    assert E["rope64"][0]["rope"] == 64
    case = AC.mla_case("bf16", 32, **E["distinct_caps_rank256"][0])
    assert case["ckv_streams"][2].shape[1] != case["krope_streams"][2].shape[1]
    kw = E["two_tiles_a_page"][0]
    assert SA._mla_tile(kw["tp"], kw["heads"], kw["rank"], kw["rope"]) \
        == SA.MLA_TILE < kw["tp"]
    assert kw["tp"] % SA.MLA_TILE % 16                      # a padded tile


@pytest.mark.parametrize("h,nq,want", [
    (40, 1, 40),                # minicpm3-4b decode: one CTA a row
    (40, 4, 10),                # 160 rows: four groups of 10 heads
    (40, 2, 20),
    (8, 1, 8),
    (8, 4, 8),
    (1, 1, 1),
    (1, 64, 1),
])
def test_mla_head_group(h, nq, want):
    hpc = SA.mla_head_group(h, nq)
    assert hpc == want and h % hpc == 0 and nq * hpc <= SA.MLA_MAX_ROWS


def test_mla_head_group_raises_past_64_queries():
    with pytest.raises(ValueError, match="queries"):
        SA.mla_head_group(1, 65)


@pytest.mark.parametrize("args,want", [
    ((4, 1, 40, 17, 132), (4, 1, 17)),    # minicpm3-4b served: a page a split
    ((4, 4, 40, 17, 132), (4, 4, 17)),
    ((64, 1, 40, 17, 132), (64, 1, 5)),   # 320 CTAs: past two waves
    ((4, 1, 40, 0, 132), (4, 1, 1)),      # no pages
])
def test_mla_grid_at_the_served_shape(args, want):
    assert SA.mla_grid(*args) == want


def test_mla_smem_fits_the_card():
    """minicpm3-4b's decode takes whole 64-token pages as tiles in 159,488
    bytes (the CUDA source's ``mla_smem``); a wide rope halves the tile."""
    assert SA.mla_smem_bytes(64, 40, 256, 32) == 48 * 296 * 2 + 2 * 64 * 296 * 2 \
        + 2 * 27_648 == 159_488
    assert SA._mla_tile(64, 40, 256, 32) == 64
    assert SA._mla_tile(64, 64, 256, 256) == 32
    assert SA.mla_smem_bytes(32, 64, 256, 256) <= SA.SMEM_MAX


def test_launch_paged_mla_takes_cuda_operands_only():
    case = AC.mla_case("bf16", 1, **MLA_CASES["nq1"])
    with pytest.raises(ValueError, match="CUDA"):
        SA.launch_paged_mla(**case, n_split=2)


# ---------------------------------------------------------------------------
# tail partials, merge, finalize
# ---------------------------------------------------------------------------

def test_tail_merge_finalize_match_jax(ref):
    jnp, JSA = ref["jnp"], ref["JSA"]
    rng = np.random.default_rng(5)
    B, nq, hkv, g, T, dv = 2, 1, 2, 3, 16, 8
    s = rng.standard_normal((B, nq, hkv, g, T)).astype(np.float32)
    v4 = rng.standard_normal((B, T, hkv, dv)).astype(np.float32)
    s3 = rng.standard_normal((B, nq, 5, T)).astype(np.float32)
    v3 = rng.standard_normal((B, T, dv)).astype(np.float32)
    valid = np.arange(T)[None, :] < np.array([[7], [16]])
    for ss, vv in ((s, v4), (s3, v3)):
        got = SA.tail_partials(torch.from_numpy(ss), torch.from_numpy(vv),
                               torch.from_numpy(valid))
        want = JSA.tail_partials(jnp.asarray(ss), jnp.asarray(vv),
                                 jnp.asarray(valid))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        other = tuple(x * 0.5 - 0.25 for x in got)
        m_got = SA.merge_partials(got, other)
        m_want = JSA.merge_partials(want, tuple(jnp.asarray(x.numpy())
                                                for x in other))
        for a, b in zip(m_got, m_want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        fin = SA.finalize(m_got[0], m_got[2])
        jfin = JSA.finalize(m_want[0], m_want[2])
        assert fin.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            fin.view(torch.int16).numpy(),
            np.asarray(jfin).view(np.int16))


# ---------------------------------------------------------------------------
# on a card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_attention_kernels_match_plain_on_card(cuda_device, fmt):
    for _, f, exps, streams in AC.decode_cases(seed=2):
        if f != fmt:
            continue
        dev = tuple(t.to(cuda_device) for t in streams)
        got = SA.decode_pages(dev, exps, fmt, CHUNK)
        torch.cuda.synchronize()
        assert K.max_abs_err((got.cpu(),), (SA.decode_pages_plain(
            streams, exps, fmt, CHUNK),)) == 0
    for kw in GQA_CASES.values():
        for nq in (1, 4):
            case = AC.gqa_case(fmt, 4, **{**kw, "nq": nq})
            got = SA.paged_gqa_attention(**AC.to_device(case, cuda_device))
            torch.cuda.synchronize()
            AC.check_partials(got, SA.paged_gqa_attention(**case))
    for kw in MLA_CASES.values():
        for nq in (1, 4):
            case = AC.mla_case(fmt, 5, **{**kw, "nq": nq})
            got = SA.paged_mla_attention(**AC.to_device(case, cuda_device))
            torch.cuda.synchronize()
            AC.check_partials(got, SA.paged_mla_attention(**case))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_gqa_split_edges_match_plain_on_card(cuda_device, fmt):
    """The split and merge kernels at each split edge, with the edge's own
    split count, one split, and the wrapper's choice, against the unsplit
    plain version; the wrapper counts one launch a call."""
    for name, (kw, n_split) in AC.GQA_SPLIT_EDGE.items():
        case = AC.gqa_case(fmt, 6, **kw)
        want = SA.paged_gqa_attention(**case)
        dev = AC.to_device(case, cuda_device)
        before = SA.paged_gqa_attention.launches
        for n in (n_split, 1):
            got = SA.launch_paged_gqa(**dev, n_split=n)
            torch.cuda.synchronize()
            AC.check_partials(got, want)
        AC.check_partials(SA.paged_gqa_attention(**dev), want)
        torch.cuda.synchronize()
        assert SA.paged_gqa_attention.launches == before + 3, name


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_mla_split_edges_match_plain_on_card(cuda_device, fmt):
    """The MLA split and merge kernels at each split edge, with the edge's
    own split count, one split, and the wrapper's choice, against the
    unsplit plain version; the wrapper counts one launch a call."""
    for name, (kw, n_split) in AC.MLA_SPLIT_EDGE.items():
        case = AC.mla_case(fmt, 6, **kw)
        want = SA.paged_mla_attention(**case)
        dev = AC.to_device(case, cuda_device)
        before = SA.paged_mla_attention.launches
        for n in (n_split, 1):
            got = SA.launch_paged_mla(**dev, n_split=n)
            torch.cuda.synchronize()
            AC.check_partials(got, want)
        AC.check_partials(SA.paged_mla_attention(**dev), want)
        torch.cuda.synchronize()
        assert SA.paged_mla_attention.launches == before + 3, name

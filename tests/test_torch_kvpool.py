"""The port's compressed-resident KV pool against the JAX package's.

Both packages get the same cache (numpy from a seed), the same codebook and
the wire streams of the same codec, so the pool must come out BITWISE the
same: geometry field by field, page streams, escape lists and counts, page
tables, tails, free-lists and byte counts, through admission (ragged rows,
tail decode), tail growth and flushes across a page boundary, rehydration
(including the pending-page splice after a failed flush), row eviction and
every ``ResidencyError``.  The engine tests run the port alone: the resident
mode serves and stays admitted, demotion is bitwise the raw-resident run,
and a flush that fails mid-stream demotes to the port's own raw decode
from the rehydrated cache, which must equal the JAX package's rehydration of
the same state.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import codebook as jcb  # noqa: E402
from repro.core.backend import resolve_backend  # noqa: E402
from repro.models import kvpool as JP  # noqa: E402
from repro.serving.plan import TransferConfig as JTC, TransferPlan as JPlan  # noqa: E402
from repro.serving.session import encode_leaves as jencode  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core.backend import get_backend  # noqa: E402
from repro_torch.models import kvpool as TP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import decode as TD  # noqa: E402
from repro_torch.serving.engine import DisaggregatedEngine  # noqa: E402
from repro_torch.serving.plan import TransferConfig as TTC, TransferPlan as TPlan  # noqa: E402
from repro_torch.serving.session import encode_leaves as tencode  # noqa: E402

CHUNK = 1024


# ---------------------------------------------------------------------------
# helpers: the same data in both packages, bit views for comparison
# ---------------------------------------------------------------------------

def t_of(a) -> torch.Tensor:
    """A JAX/numpy array as a torch tensor with the same bits."""
    a = np.array(np.asarray(a), order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(a)


def bits(x) -> np.ndarray:
    """Integer bit view of a torch tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        x = C.signed_view(x)
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        elif x.dtype.is_floating_point and x.element_size() == 1:
            x = x.view(torch.uint8)
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return a.view(np.int16)
    if "float8" in a.dtype.name:
        return a.view(np.uint8)
    return a


def same(a, b, what=""):
    np.testing.assert_array_equal(bits(a), bits(b), err_msg=what)


def make_cache(shapes, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def dense_shapes(L=2, B=2, S=64, hkv=2, hd=32, dv=None):
    return {"k": (L, B, S, hkv, hd), "v": (L, B, S, hkv, dv or hd)}


def both(cache_np, page_bytes=2048, cb_from=None):
    """(jax cache, torch cache, jax pool, torch pool, jax wire, torch wire,
    jax codebook) for the same numpy cache."""
    jc = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache_np.items()}
    tc = {k: t_of(v) for k, v in jc.items()}
    src = jc if cb_from is None else {k: jc[k] for k in cb_from}
    flat = np.concatenate([np.asarray(jax.lax.bitcast_convert_type(
        v, jnp.uint16)).ravel() for v in src.values()])
    cb = jcb.calibrate(flat, k=16, fmt="bf16")
    tcbk = tcb.Codebook(fmt="bf16", exponents=tuple(cb.exponents))
    jpool = JP.KVPool.for_cache(jc, cb, resolve_backend("xla", require_jittable=True),
                                chunk=CHUNK, page_bytes=page_bytes)
    tpool = TP.KVPool.for_cache(tc, tcbk, get_backend("torch"), chunk=CHUNK,
                                page_bytes=page_bytes)
    jcomp, _ = jencode(JPlan.build(jc, JTC(codebook=cb, chunk=CHUNK)), jc)
    tcomp, _ = tencode(TPlan.build(tc, TTC(codebook=tcbk, chunk=CHUNK,
                                           backend="torch")), tc)
    return jc, tc, jpool, tpool, jcomp, tcomp, cb


def assert_states_equal(js, ts, jpool, tpool):
    np.testing.assert_array_equal(np.asarray(js.cache_len), ts.cache_len.numpy())
    for lg in jpool.geom.leaves:
        jl, tl = js.leaves[lg.key], ts.leaves[lg.key]
        for f in ("sign_mantissa", "packed", "esc_pos", "esc_val", "esc_cnt",
                  "page_table", "tail"):
            same(getattr(jl, f), getattr(tl, f), f"{lg.key}.{f}")
        assert jpool._free[lg.key] == tpool._free[lg.key], lg.key


def assert_rehydrate_equal(js, ts, jpool, tpool):
    jr, tr = jpool.rehydrate(js), tpool.rehydrate(ts)
    assert sorted(jr) == sorted(tr)
    for k in jr:
        assert tr[k].dtype == torch.bfloat16
        same(jr[k], tr[k], f"rehydrate {k}")


def append_both(jpool, js, tpool, ts, values):
    """Append one token per (layer, row) to both states: ``values`` maps
    leaf -> (L, B, m) numpy f32.  JAX: functional; port: in place."""
    g = jpool.geom
    tp = g.tokens_per_page
    new_leaves = dict(js.leaves)
    for lg in g.leaves:
        new = jnp.asarray(values[lg.key], jnp.bfloat16)
        leaf = js.leaves[lg.key]
        tail = leaf.tail
        for layer in range(g.n_layers):
            tail = tail.at[layer].set(JP._append_tail(
                tail[layer], new[layer][:, None, :], js.cache_len % tp))
            TP._append_tail(ts.leaves[lg.key].tail[layer],
                            t_of(new[layer])[:, None, :], ts.cache_len % tp)
        new_leaves[lg.key] = dataclasses.replace(leaf, tail=tail)
    js = dataclasses.replace(js, leaves=new_leaves, cache_len=js.cache_len + 1)
    ts = dataclasses.replace(ts, cache_len=ts.cache_len + 1)
    return js, ts


def jax_geometry(g):
    return JP.PoolGeometry(**{**dataclasses.asdict(g), "leaves": tuple(
        JP.LeafGeometry(**dataclasses.asdict(lg)) for lg in g.leaves)})


def jax_leaf(tl):
    """A port ``PagedLeaf`` as the JAX package's, bit for bit."""
    return JP.PagedLeaf(
        sign_mantissa=jnp.asarray(tl.sign_mantissa.numpy()),
        packed=jnp.asarray(tl.packed.numpy()),
        esc_pos=jnp.asarray(bits(tl.esc_pos).view(np.uint16)),
        esc_val=jnp.asarray(tl.esc_val.numpy()),
        esc_cnt=jnp.asarray(tl.esc_cnt.numpy()),
        page_table=jnp.asarray(tl.page_table.numpy()),
        tail=jax.lax.bitcast_convert_type(
            jnp.asarray(bits(tl.tail).view(np.uint16)), jnp.bfloat16))


def random_token(jpool, rng, hot=None):
    g = jpool.geom
    out = {}
    for lg in g.leaves:
        v = rng.standard_normal((g.n_layers, g.batch, lg.m)).astype(np.float32)
        if hot == lg.key:
            v[:] = 1e30                                   # every element escapes
        out[lg.key] = v
    return out


# ---------------------------------------------------------------------------
# geometry, admission, rehydration
# ---------------------------------------------------------------------------

GEOMETRIES = {
    "dense": (dense_shapes(), 2048),
    "dv_ne_hd": (dense_shapes(L=1, B=2, S=128, hkv=2, hd=32, dv=16), 8192),
    "mla": ({"ckv": (1, 2, 128, 128), "krope": (1, 2, 128, 32)}, 16384),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_geometry_matches_jax(name):
    shapes, pb = GEOMETRIES[name]
    _, _, jpool, tpool, _, _, _ = both(make_cache(shapes), page_bytes=pb)
    assert dataclasses.asdict(jpool.geom) == dataclasses.asdict(tpool.geom)
    assert jpool._free == tpool._free
    assert jpool.hbm_bytes() == tpool.hbm_bytes()
    assert jpool.raw_bytes() == tpool.raw_bytes()
    assert jpool.resident_ratio() == tpool.resident_ratio()
    assert_states_equal(jpool.state, tpool.state, jpool, tpool)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_admit_and_rehydrate_match_jax(name):
    """Ragged rows: a full row, and one ending mid-page (tail decode)."""
    shapes, pb = GEOMETRIES[name]
    jc, tc, jpool, tpool, jcomp, tcomp, _ = both(make_cache(shapes, seed=1),
                                                 page_bytes=pb)
    tp = jpool.geom.tokens_per_page
    S = jpool.geom.max_seq
    lens = np.array([S, S - tp - tp // 2 - 1][:jpool.geom.batch], np.int32)
    js = jpool.admit_from_wire(jcomp, jnp.asarray(lens))
    ts = tpool.admit_from_wire(tcomp, torch.from_numpy(lens))
    assert_states_equal(js, ts, jpool, tpool)
    assert_rehydrate_equal(js, ts, jpool, tpool)
    reh = tpool.rehydrate(ts)
    for k in tc:
        for row, n in enumerate(lens):
            same(reh[k][:, row, :n], tc[k][:, row, :n], f"{k} row {row}")
    for lg in jpool.geom.leaves:
        assert tpool.allocated_pages(lg.key) == jpool.allocated_pages(lg.key)
        same(JP._decode_pool_pages(js.leaves[lg.key], lg, jpool.geom)
             .astype(jnp.uint16),
             TP.decode_pool_pages(ts.leaves[lg.key], lg, tpool.geom),
             f"decode_pool_pages {lg.key}")


def test_flush_across_page_boundary_matches_jax():
    """Tokens appended to the tail, flushed at each boundary (including a
    page that is part admission tail, part appended): pools, tables and
    free-lists stay bitwise the JAX package's."""
    jc, tc, jpool, tpool, jcomp, tcomp, _ = both(make_cache(dense_shapes(), 2))
    tp = jpool.geom.tokens_per_page
    lens = np.array([tp + tp // 2, tp - 1], np.int32)
    js = jpool.admit_from_wire(jcomp, jnp.asarray(lens))
    ts = tpool.admit_from_wire(tcomp, torch.from_numpy(lens))
    rng = np.random.default_rng(7)
    before = {k: tpool.allocated_pages(k) for k in ("k", "v")}
    for _ in range(tp + 2):                       # crosses >= 1 boundary a row
        js, ts = append_both(jpool, js, tpool, ts, random_token(jpool, rng))
        js = jpool.flush_full_tails(js)
        ts = tpool.flush_full_tails(ts)
        assert_states_equal(js, ts, jpool, tpool)
    assert_rehydrate_equal(js, ts, jpool, tpool)
    end = lens + tp + 2
    crossed = int(((end // tp) - (lens // tp)).sum())
    for k in ("k", "v"):
        assert tpool.allocated_pages(k) - before[k] == 2 * crossed


def test_failed_flush_rolls_back_and_rehydrates_pending_page():
    """A flush that fails (escape overflow on the LATER leaf, then pool
    exhaustion on it) writes nothing and leaks no page; rehydrating the
    state with the just-filled page still unmapped splices the full tail
    there, as the JAX package does."""
    jc, tc, jpool, tpool, jcomp, tcomp, _ = both(make_cache(dense_shapes(), 3))
    tp = jpool.geom.tokens_per_page
    lens = np.array([tp - 1, tp - 1], np.int32)
    js = jpool.admit_from_wire(jcomp, jnp.asarray(lens))
    ts = tpool.admit_from_wire(tcomp, torch.from_numpy(lens))
    rng = np.random.default_rng(10)

    hot = random_token(jpool, rng, hot="v")
    jb, tb = append_both(jpool, js, tpool, ts, hot)
    snap = {k: [getattr(tb.leaves[k], f).clone() for f in
                ("sign_mantissa", "page_table", "esc_cnt")] for k in ("k", "v")}
    free = {k: tpool.free_pages(k) for k in ("k", "v")}
    for pool, st in ((jpool, jb), (tpool, tb)):
        with pytest.raises((JP.ResidencyError, TP.ResidencyError), match="escape"):
            pool.flush_full_tails(st)
    assert {k: tpool.free_pages(k) for k in ("k", "v")} == free
    for k in ("k", "v"):
        for a, f in zip(snap[k], ("sign_mantissa", "page_table", "esc_cnt")):
            same(a, getattr(tb.leaves[k], f), f"{k}.{f} after failed flush")
    assert_rehydrate_equal(jb, tb, jpool, tpool)      # the pending-page splice

    # exhaustion on "v": "k"'s fresh pages go back to its free-list
    jpool2, tpool2 = both(make_cache(dense_shapes(), 3))[2:4]
    js2 = jpool2.admit_from_wire(jcomp, jnp.asarray(lens))
    ts2 = tpool2.admit_from_wire(tcomp, torch.from_numpy(lens))
    js2, ts2 = append_both(jpool2, js2, tpool2, ts2, random_token(jpool2, rng))
    free_k = tpool2.free_pages("k")
    for pool, st in ((jpool2, js2), (tpool2, ts2)):
        stash = pool._free["v"]
        pool._free["v"] = []
        with pytest.raises((JP.ResidencyError, TP.ResidencyError),
                           match="exhausted"):
            pool.flush_full_tails(st)
        pool._free["v"] = stash
    assert tpool2.free_pages("k") == free_k
    assert jpool2._free == tpool2._free
    ts2 = tpool2.flush_full_tails(ts2)
    js2 = jpool2.flush_full_tails(js2)
    assert_states_equal(js2, ts2, jpool2, tpool2)


def test_free_rows_matches_jax():
    jc, tc, jpool, tpool, jcomp, tcomp, _ = both(make_cache(dense_shapes(), 4))
    lens = np.array([64, 64], np.int32)
    jpool.admit_from_wire(jcomp, jnp.asarray(lens))
    tpool.admit_from_wire(tcomp, torch.from_numpy(lens))
    held = tpool.allocated_pages("k")
    jpool.free_rows([0])
    tpool.free_rows([0])
    assert tpool.allocated_pages("k") == held // 2
    assert_states_equal(jpool.state, tpool.state, jpool, tpool)
    jpool.free_rows([1])
    tpool.free_rows([1])
    assert tpool.allocated_pages("k") == 0
    lens = np.array([64, 32], np.int32)
    js = jpool.admit_from_wire(jcomp, jnp.asarray(lens))
    ts = tpool.admit_from_wire(tcomp, torch.from_numpy(lens))
    assert_states_equal(js, ts, jpool, tpool)


def test_admission_errors_match_jax():
    """Page-escape overflow, pool exhaustion and a leaf that did not arrive
    as chunked streams raise ResidencyError in both packages."""
    # ~2% of k escapes: under the wire's per-chunk cap, over the page budget
    cache = make_cache(dense_shapes(L=1, B=1), 13)
    rng = np.random.default_rng(13)
    k = cache["k"].ravel()
    k[rng.choice(k.size, size=k.size // 50, replace=False)] = 1e30
    jc, tc, jpool, tpool, jcomp, tcomp, _ = both(cache, cb_from=["v"])
    lens = np.array([64], np.int32)
    with pytest.raises(JP.ResidencyError, match="escape"):
        jpool.admit_from_wire(jcomp, jnp.asarray(lens))
    with pytest.raises(TP.ResidencyError, match="escape"):
        tpool.admit_from_wire(tcomp, torch.from_numpy(lens))

    jc, tc, jpool, tpool, jcomp, tcomp, _ = both(make_cache(dense_shapes(), 5))
    lens = np.array([64, 64], np.int32)
    tpool.admit_from_wire(tcomp, torch.from_numpy(lens))
    with pytest.raises(TP.ResidencyError, match="exhausted"):
        tpool.admit_from_wire(tcomp, torch.from_numpy(lens))

    tpool2 = both(make_cache(dense_shapes(), 5))[3]
    with pytest.raises(TP.ResidencyError, match="arrived raw"):
        tpool2.admit_from_wire({"v": tcomp["v"]}, torch.from_numpy(lens))
    glob = dataclasses.replace(tcomp["k"], layout="global")
    with pytest.raises(TP.ResidencyError, match="layout"):
        tpool2.admit_from_wire({"k": glob, "v": tcomp["v"]}, torch.from_numpy(lens))
    with pytest.raises(TP.ResidencyError, match="not a multiple"):
        TP.KVPool.for_cache({k: v[:, :, :40] for k, v in tc.items()},
                            tpool2.codebook, get_backend("torch"), chunk=CHUNK,
                            page_bytes=2048)


@pytest.mark.parametrize("m,tp", [(128, 16), (288, 64), (1024, 32), (192, 80)])
def test_bytes_per_token_resident_matches_jax(m, tp):
    assert TP.bytes_per_token_resident(m, tp) == JP.bytes_per_token_resident(m, tp)


@pytest.mark.parametrize("arch,batch,max_seq,want", [
    ("smollm-135m", 8, 2160, (315_780_480, 398_131_200)),
    ("minicpm3-4b", 4, 1088, (126_684_352, 155_418_624)),
])
def test_full_width_pool_bytes(arch, batch, max_seq, want):
    """The resident footprint of the on-card main path, counted on a pool
    built over ``meta`` tensors (nothing allocated), with the JAX package's
    page granularity."""
    from repro.configs.base import get_config as jget
    from repro.models.kvcache import init_cache as jinit
    from repro_torch.models.kvcache import init_cache as tinit

    tcache = tinit(get_config(arch), batch, max_seq, device="meta")
    jcache = jax.eval_shape(lambda: jinit(jget(arch), batch, max_seq))
    assert TP.tokens_per_page_for(tcache, CHUNK) == \
        JP.tokens_per_page_for(jcache, CHUNK)
    cb = tcb.Codebook(fmt="bf16", exponents=tuple(range(112, 128)))
    pool = TP.KVPool.for_cache(tcache, cb, get_backend("torch"), chunk=CHUNK)
    assert (pool.hbm_bytes(), pool.raw_bytes()) == want


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    cfg = get_config("smollm-135m").reduced()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    _, st = TM.prefill(params, {"tokens": toks}, cfg, max_seq=32)
    flat = np.concatenate([bits(v).view(np.uint16).ravel() for v in st.cache.values()])
    cb = tcb.calibrate([flat], k=16)
    return cfg, params, {"tokens": toks}, cb


def test_resident_generate_serves_and_matches_raw_mostly(served):
    cfg, params, batch, cb = served
    eng = DisaggregatedEngine(cfg, params, cb, resident="compressed",
                              page_bytes=2048, device="cpu")
    out = eng.generate(batch, num_steps=6, max_seq=64)
    assert out.shape == (2, 7)
    assert eng.stats.resident_admits == 1 and eng.stats.resident_demotions == 0
    assert eng.stats.resident_ratio > 0
    assert eng.stats.resident_hbm_bytes == eng._pool.hbm_bytes()


def test_resident_generate_default_max_seq_stays_resident(served):
    cfg, params, batch, cb = served
    eng = DisaggregatedEngine(cfg, params, cb, resident="compressed",
                              page_bytes=2048, device="cpu")
    out = eng.generate(batch, num_steps=6)            # no max_seq on purpose
    assert out.shape == (2, 7)
    assert eng.stats.resident_admits == 1 and eng.stats.resident_demotions == 0
    tp = eng.resident_tokens_per_page()
    assert eng._pool.geom.max_seq == -(-(24 + 1 + 6) // tp) * tp


def test_demotion_is_bit_identical_to_raw(served):
    """An out-of-band codebook makes every element escape: the stream cannot
    be admitted, the batch demotes, and the tokens are the raw-resident
    engine's bit for bit."""
    cfg, params, batch, _ = served
    bad = tcb.Codebook(fmt="bf16", exponents=tuple(range(16)))
    eng_res = DisaggregatedEngine(cfg, params, bad, resident="compressed",
                                  page_bytes=2048, device="cpu")
    eng_raw = DisaggregatedEngine(cfg, params, bad, resident="raw", device="cpu")
    out_res = eng_res.generate(batch, num_steps=6, max_seq=64)
    out_raw = eng_raw.generate(batch, num_steps=6, max_seq=64)
    assert eng_res.stats.resident_demotions == 1
    assert eng_res.stats.resident_admits == 0
    assert torch.equal(out_res, out_raw)


@pytest.mark.parametrize("kw,match", [
    (dict(resident="nope"), "expected 'raw' or 'compressed'"),
    (dict(resident="compressed", n_chunks=2), "n_chunks=1"),
    (dict(resident="compressed", compress=False), "compress=True"),
])
def test_engine_argument_checks(served, kw, match):
    cfg, params, _, cb = served
    with pytest.raises(ValueError, match=match):
        DisaggregatedEngine(cfg, params, cb, device="cpu", **kw)


def test_flush_failure_midstream_demotes_to_own_raw_decode(served):
    """A ResidencyError from the first flush that has a full unmapped tail
    page demotes mid-generation.  The served tokens must equal the port's
    own raw decode run from the rehydrated state at that point, and that
    rehydration must equal the JAX package's rehydration of the same
    state."""
    cfg, params, batch, cb = served
    _, st0 = TM.prefill(params, batch, cfg, max_seq=64)
    tpool = TP.KVPool.for_cache(st0.cache, cb, get_backend("torch"),
                                chunk=CHUNK, page_bytes=2048)
    tp = tpool.geom.tokens_per_page
    tcomp, _ = tencode(TPlan.build(st0.cache, TTC(codebook=cb, chunk=CHUNK,
                                                  backend="torch")), st0.cache)
    rs = tpool.admit_from_wire(tcomp, st0.cache_len)
    orig = tpool.flush_full_tails
    seen = {}

    def failing(st):
        lens = st.cache_len.numpy()
        table0 = st.leaves["k"].page_table[0].numpy()
        if not seen and any(n > 0 and n % tp == 0 and table0[b, n // tp - 1] < 0
                            for b, n in enumerate(lens)):
            seen["state"] = TP.ResidentState(
                leaves={k: dataclasses.replace(v, tail=v.tail.clone())
                        for k, v in st.leaves.items()},
                cache_len=st.cache_len.clone(), geom=st.geom)
            seen["step"] = int(lens[0]) - 24
            raise TP.ResidencyError("injected flush failure")
        return orig(st)

    tpool.flush_full_tails = failing
    first = torch.tensor([3, 5], dtype=torch.int32)
    n = tp + 4
    toks, dst, demoted = TD.resident_decode_loop(params, first, rs, tpool, cfg, n)
    assert demoted and "state" in seen
    done = seen["step"]
    cache = tpool.rehydrate(seen["state"])
    from repro_torch.models.kvcache import DecodeState
    rest, _ = TD.decode_loop(params, toks[:, done - 1],
                             DecodeState(cache=cache,
                                         cache_len=seen["state"].cache_len),
                             cfg, n - done)
    assert torch.equal(toks[:, done:], rest)
    # the JAX package rehydrates the same state to the same bits
    jpool = JP.KVPool.__new__(JP.KVPool)       # rehydrate reads only the geometry
    jpool.geom = jax_geometry(tpool.geom)
    jstate = JP.ResidentState(
        leaves={k: jax_leaf(v) for k, v in seen["state"].leaves.items()},
        cache_len=jnp.asarray(seen["state"].cache_len.numpy()), geom=jpool.geom)
    for k, v in jpool.rehydrate(jstate).items():
        same(v, cache[k], f"rehydrate {k}")

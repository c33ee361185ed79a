"""Sharded serving of the two front ends across gloo ranks against the JAX
package's unsharded serving, on the CPU.

As for the other families (``tests/test_torch_serve_tp.py``, whose
docstring says why), the port's sharded steps (``serving/sharded.py``,
``prefill_step(tp=)``, ``serve_step(tp=)``) are held against the JAX
``prefill_step`` / ``serve_step`` without a policy, on the same parameters
(the JAX seeded init, each rank taking its blocks through
``params_from_jax(policy=)``) and the same numpy prompt, batch 4:

* reduced pixtral-12b (2 layers, d 128, 4 / 2 heads of 32, vocab 128):
  8 patches of 64 before 7 tokens, 15 cache positions of 24 slots.  At
  (1, 1, 2), case ``heads``, rank 0's span of 12 slots holds the patches
  and 4 tokens, rank 1's the last 3 tokens, the padding and every decoded
  token; at (1, 1, 3) the ``seq`` fallback's query blocks of 5 (rank 0's
  all patches, rank 1's straddling patches and text) and spans of 8;
  (1, 2, 2) the batch over ``data``; (2, 1, 2) under ``pd_disaggregated``,
  the hop ``xfer_chunked``;
* reduced hubert-xlarge (encoder-only, 2 layers, 4 / 2 heads of 32,
  vocab 128): 12 frames of 64.  (1, 1, 2) ``heads``; (1, 1, 3) the
  non-causal ``seq`` fallback (a block of 4 queries over all keys);
  (1, 2, 2); and (2, 1, 2), the hop of its empty cache: every rank's
  cache ``{}``, the first units and ``cache_len`` arriving on pod 1,
  which decodes nothing.

Bounds: the serve_tp file's ATOL 4e-2 / RTOL 2e-2 for the last logits,
every frame's logits (hubert), every cache block and the teacher-forced
``serve_step`` logits (pixtral, 4 steps on seeded tokens), for that file's
reasons (row-split products summed in f32 in rank order and rounded once,
the decode's merged partial softmaxes).  Held exactly: the first token or
unit, ``cache_len`` (patches + tokens, or frames), held parameter and
cache bytes (and ``init_cache(policy=)``), pod 1's shards bitwise pod
0's, the hop of a rank's own shard giving the bytes and
``TransferStats`` of the whole-cache hop, and the empty hop's plan (no
route, no segment, a stream of 0, no spec, the tensor granularity) and
stats (every count 0) against the JAX ``TransferPlan.build({}, ...)``
and the JAX session's transfer of ``{}``.  Greedy tokens are reported,
not held.
"""

import concurrent.futures
import dataclasses
import functools
import json

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import torch_ranks  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.distributed.sharding import ShardingPolicy as JPolicy  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.kvcache import DecodeState as JState  # noqa: E402
from repro.serving.decode import serve_step as jserve_step  # noqa: E402
from repro.serving.prefill import prefill_step as jprefill_step  # noqa: E402

ATOL, RTOL = 4e-2, 2e-2
PIX, HUB = "pixtral-12b", "hubert-xlarge"
B, SLOTS, STEPS = 4, 24, 4
TEXT, FRAMES = 7, 12
AXES = ("pod", "data", "model")
#: reference -> arch
REFS = {"pix": PIX, "hub": HUB}


def _serve(name, ref, shape, want):
    return dict(kind="serve", name=name, arch=REFS[ref], ref=ref,
                shape=list(shape), want=want)


def _hop(name, ref, variant, want):
    return dict(kind="hop", name=name, arch=REFS[ref], ref=ref,
                shape=[2, 1, 2], want=want, pd=True, variant=variant)


WORLDS = {
    2: [_serve("pix-112", "pix", (1, 1, 2), "heads"),
        _serve("hub-112", "hub", (1, 1, 2), "heads")],
    3: [_serve("pix-113-seq", "pix", (1, 1, 3), "seq"),
        _serve("hub-113-seq", "hub", (1, 1, 3), "seq")],
    4: [_serve("pix-122", "pix", (1, 2, 2), "heads"),
        _hop("pix-hop-chunked", "pix", "xfer_chunked", "heads"),
        _serve("hub-122", "hub", (1, 2, 2), "heads"),
        _hop("hub-hop-empty", "hub", "xfer_chunked", "heads")],
}
CASES = {c["name"]: (world, c) for world, cs in WORLDS.items() for c in cs}
SERVE = [n for n, (_, c) in CASES.items() if c["kind"] == "serve"]
PIX_SERVE = [n for n in SERVE if CASES[n][1]["arch"] == PIX]
HUB_SERVE = [n for n in SERVE if CASES[n][1]["arch"] == HUB]
#: ``python -m repro_torch.serving.sharded`` on the world of 4: pixtral's
#: disaggregated step, then hubert's prefill cell and its empty hop
CLI = (("--arch", PIX, "--reduced", "--device", "cpu", "--mesh", "2,1,2",
        "--variant", "xfer_chunked", "--prompt-len", "16", "--new-tokens",
        "4"),
       ("--arch", HUB, "--reduced", "--device", "cpu", "--mesh", "1,2,2",
        "--prompt-len", "16"),
       ("--arch", HUB, "--reduced", "--device", "cpu", "--mesh", "2,1,2",
        "--variant", "xfer_chunked", "--prompt-len", "16"))


def _cfg(arch):
    return jget(arch).reduced()


def _positions(arch):
    cfg = _cfg(arch)
    return TEXT + cfg.frontend_len if arch == PIX else FRAMES


@functools.lru_cache(maxsize=None)
def _steps(arch):
    cfg = _cfg(arch)
    return (jax.jit(functools.partial(jprefill_step, cfg=cfg, max_seq=SLOTS)),
            jax.jit(functools.partial(jserve_step, cfg=cfg)),
            jax.jit(functools.partial(JM.prefill, cfg=cfg, max_seq=SLOTS)))


@functools.lru_cache(maxsize=None)
def _prompt(ref):
    """The prompt as numpy: a vision prompt's tokens and its patches, an
    audio prompt's frames (the bf16 inputs as their bits)."""
    cfg = _cfg(REFS[ref])
    rng = np.random.default_rng(0)

    def bf16_bits(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    if REFS[ref] == HUB:
        return {"frames": bf16_bits(B, FRAMES, cfg.frontend_dim)}
    return {"patches": bf16_bits(B, cfg.frontend_len, cfg.frontend_dim),
            "tokens": rng.integers(0, cfg.vocab_size, (B, TEXT))
            .astype(np.int32)}


def _jax_batch(ref):
    return {k: jnp.asarray(v.view(jnp.bfloat16)) if v.dtype == np.uint16
            else jnp.asarray(v) for k, v in _prompt(ref).items()}


def _step_inputs(arch):
    """The teacher-forced steps' tokens (STEPS, B), drawn from a seed."""
    return np.random.default_rng(1).integers(0, _cfg(arch).vocab_size,
                                             (STEPS, B)).astype(np.int32)


def _run(params, ref, inputs):
    """The JAX unsharded prefill (hubert: and every frame's logits), then
    one ``serve_step`` a row of ``inputs`` (steps, B), or, where
    ``inputs`` is None, ``STEPS`` on its own greedy tokens."""
    arch = REFS[ref]
    prefill, step, frames = _steps(arch)
    batch = _jax_batch(ref)
    out = prefill(params, batch)
    res = {"first_token": np.asarray(out.first_token),
           "last_logits": np.asarray(out.last_logits, np.float32),
           "cache_len": np.asarray(out.state.cache_len),
           "cache": {k: np.asarray(v, np.float32)
                     for k, v in out.state.cache.items()},
           "cache_like": out.state.cache}
    if _cfg(arch).encoder_only:
        res["frame_logits"] = np.asarray(frames(params, batch)[0], np.float32)
        return res
    st = JState(cache=out.state.cache, cache_len=out.state.cache_len)
    fed, logits = inputs is not None, []
    tok, inputs = out.first_token, list(inputs) if fed else []
    for i in range(len(inputs) if fed else STEPS):
        if fed:
            tok = inputs[i]
        else:
            inputs.append(np.asarray(tok))
        lg, st = step(params, jnp.asarray(tok)[:, None], st)
        logits.append(np.asarray(lg, np.float32))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    res.update(greedy=np.stack(inputs[1:] + [np.asarray(tok)], 1),
               after={k: np.asarray(v, np.float32)
                      for k, v in st.cache.items()},
               step_logits=np.stack(logits))
    return res


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax.jit(JM.init_params, static_argnums=0)(_cfg(arch),
                                                    jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def jax_inputs(ref):
    """The arrays the ranks load: the parameters as bits, the prompt, the
    cache slots, the step inputs."""
    arch = REFS[ref]
    arrays = {**_prompt(ref), "max_seq": np.int64(SLOTS),
              "step_inputs": _step_inputs(arch)}
    for p, x in jax.tree_util.tree_flatten_with_path(jax_params(arch))[0]:
        key = "/".join(str(k.key) for k in p)
        x = np.asarray(x)
        arrays["params/" + key] = x.view(np.uint16) \
            if x.dtype == jnp.bfloat16 else x
    return arrays


@functools.lru_cache(maxsize=None)
def jax_ref(ref):
    """The JAX prefill and ``STEPS`` teacher-forced ``serve_step``s, and
    (``greedy_run``) ``STEPS`` on its own greedy tokens."""
    arch = REFS[ref]
    res = _run(jax_params(arch), ref, jax_inputs(ref)["step_inputs"])
    if not _cfg(arch).encoder_only:
        res["greedy_run"] = _run(jax_params(arch), ref, None)
    return res


def _run_world(world, tmp):
    ref_dir, out_dir = tmp / "ref", tmp / f"out{world}"
    out_dir.mkdir()
    (tmp / f"w{world}").mkdir()
    torch_ranks.run_world(torch_ranks.serve_tp_world, world,
                          tmp / f"w{world}", str(ref_dir), str(out_dir),
                          WORLDS[world], CLI if world == 4 else (), None,
                          timeout=150.0)
    return ([json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(world)],
            [np.load(out_dir / f"rank{r}.npz") for r in range(world)],
            [[(out_dir / f"cli{i}_rank{r}.txt").read_text()
              for r in range(world)] for i in range(len(CLI))]
            if world == 4 else [])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world run once for the module, concurrently: ``world ->
    (summaries, arrays, CLI outputs)`` rank by rank."""
    tmp = tmp_path_factory.mktemp("serve_frontends")
    (tmp / "ref").mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        list(ex.map(jax_params, (PIX, HUB)))
    for ref in REFS:
        np.savez(tmp / "ref" / f"{ref}.npz", **jax_inputs(ref))
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {w: ex.submit(_run_world, w, tmp) for w in WORLDS}
        for ref in REFS:            # the JAX runs while the ranks run
            jax_ref(ref)
        return {w: f.result() for w, f in futs.items()}


def _ranks(worlds, name):
    world, case = CASES[name]
    summaries, arrays, _ = worlds[world]
    pre = name + "/"
    return case, [(s[name], {k[len(pre):]: a[k] for k in a.files
                             if k.startswith(pre)}, r)
                  for r, (s, a) in enumerate(zip(summaries, arrays))]


def _bf16(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.int32) << 16).view(np.float32)


def _jax_block(x: np.ndarray, case, name: str, coord, like) -> np.ndarray:
    """``x``'s block at ``coord`` under the JAX policy's cache spec of
    ``name`` (the policy on an ``AbstractMesh`` of the case's shape)."""
    shape = tuple(case["shape"])
    sizes = dict(zip(AXES, shape))
    spec = JPolicy(AbstractMesh(shape, AXES),
                   pd_disaggregated=case.get("pd", False)
                   ).cache_specs(like)[name]
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) \
            else tuple(entry)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + coord[a]
        if n > 1:
            size = x.shape[d] // n
            x = x[(slice(None),) * d + (slice(idx * size, (idx + 1) * size),)]
    return x


def _cols(x: np.ndarray, summary) -> np.ndarray:
    if not summary["vocab_split"]:
        return x
    n = x.shape[-1] // summary["tp_size"]
    return x[..., summary["tp_rank"] * n:(summary["tp_rank"] + 1) * n]


@pytest.mark.parametrize("name", list(CASES))
def test_held_bytes_and_attention_case(worlds, name):
    case, ranks = _ranks(worlds, name)
    for s, _, r in ranks:
        assert s["case"] == case["want"], (r, s["case"])
        assert s["held_params"] == s["spec_params"], r
        assert s["held_cache"] == s["spec_cache"] == s["init_cache"], r
        if case["arch"] == HUB:
            assert s["held_cache"] == 0, r


@pytest.mark.parametrize("name", list(CASES))
def test_cache_len_counts_the_prompts_positions(worlds, name):
    """``cache_len`` after the prefill is patches + tokens (pixtral) or the
    frames (hubert) on every rank, as JAX's; on pod 1, after the steps it
    decoded from the ``cache_len`` that arrived (hubert: none)."""
    case, ranks = _ranks(worlds, name)
    want = jax_ref(case["ref"])["cache_len"]
    assert want.tolist() == [_positions(case["arch"])] * B
    for s, _, r in ranks:
        steps = len(s["tokens"][0]) if s.get("tokens") else 0
        assert s["cache_len"] == (want[s["rows"]] + steps).tolist(), r


@pytest.mark.parametrize("name", SERVE)
def test_prefill_logits_and_first_token(worlds, name):
    case, ranks = _ranks(worlds, name)
    ref = jax_ref(case["ref"])
    for s, a, r in ranks:
        rows = s["rows"]
        np.testing.assert_allclose(a["last_logits"],
                                   _cols(ref["last_logits"][rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        assert s["first_token"] == ref["first_token"][rows].tolist(), r
        assert s["greedy_first"] == s["first_token"], r


@pytest.mark.parametrize("name", PIX_SERVE)
def test_cache_blocks_match_jax_policy_slices(worlds, name):
    """Each rank's K/V blocks after the prefill and after the
    teacher-forced steps, against the JAX cache sliced by the JAX policy
    (the patches' positions first)."""
    case, ranks = _ranks(worlds, name)
    ref = jax_ref(case["ref"])
    for s, a, r in ranks:
        for leaf in ref["cache"]:
            for got, whole in ((a[leaf], ref["cache"][leaf]),
                               (a[leaf + "_after"], ref["after"][leaf])):
                want = _jax_block(whole, case, leaf, s["coord"],
                                  ref["cache_like"])
                assert got.shape == want.shape, (r, leaf, got.shape)
                np.testing.assert_allclose(_bf16(got), want, atol=ATOL,
                                           rtol=RTOL, err_msg=f"rank {r} {leaf}")


def test_patches_and_decoded_tokens_land_in_their_spans(worlds):
    """At (1, 1, 2) the 24 slots split 12 a rank: rank 0's span holds the
    8 patches and the first 4 tokens, rank 1's the last 3 tokens; the
    teacher-forced steps write positions 15-18, all in rank 1's span, and
    leave rank 0's block as the prefill left it."""
    _, ranks = _ranks(worlds, "pix-112")
    by = {s["coord"]["model"]: a for s, a, _ in ranks}
    for leaf in ("k", "v"):
        k0, k0_after = by[0][leaf], by[0][leaf + "_after"]
        k1, k1_after = by[1][leaf], by[1][leaf + "_after"]
        assert k0.shape[2] == k1.shape[2] == SLOTS // 2
        assert (k0 != 0).any(axis=(0, 1, 3, 4)).all()     # 15 > 12
        assert np.array_equal(k0, k0_after)
        filled = (k1 != 0).any(axis=(0, 1, 3, 4))
        assert filled.tolist() == [True] * 3 + [False] * 9
        filled = (k1_after != 0).any(axis=(0, 1, 3, 4))
        assert filled.tolist() == [True] * 7 + [False] * 5
        assert np.array_equal(k1_after[:, :, :3], k1[:, :, :3])


@pytest.mark.parametrize("name", PIX_SERVE)
def test_serve_step_teacher_forced(worlds, name):
    case, ranks = _ranks(worlds, name)
    ref = jax_ref(case["ref"])
    agree = []
    for s, a, r in ranks:
        rows = s["rows"]
        np.testing.assert_allclose(a["step_logits"],
                                   _cols(ref["step_logits"][:, rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        agree.append(float(np.mean(np.asarray(s["greedy"])
                                   == ref["greedy_run"]["greedy"][rows])))
    print(f"{name}: decode_loop tokens agreeing with JAX's: {agree}")


@pytest.mark.parametrize("name", HUB_SERVE)
def test_every_frames_vocab_columns(worlds, name):
    """Each rank's vocab columns of every frame's logits against JAX's
    prefill (the non-causal encoder; at (1, 1, 3) the vocab does not
    split and every rank holds all 128 columns); ``serve`` runs the
    prefill cell alone: no tokens, an empty cache of the frames' length."""
    case, ranks = _ranks(worlds, name)
    ref = jax_ref(case["ref"])
    assert ref["frame_logits"].shape == (B, FRAMES, _cfg(HUB).vocab_size)
    assert ref["cache"] == {}
    for s, a, r in ranks:
        rows = s["rows"]
        np.testing.assert_allclose(a["frame_logits"],
                                   _cols(ref["frame_logits"][rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        assert s["vocab_split"] == (case["shape"][2] != 3), r
        assert s["greedy"] is None and s["serve_cache"] == [], r
        assert s["serve_cache_len"] == [FRAMES] * len(rows), r


def test_init_cache_and_cache_like_count_the_patches():
    """``init_cache(policy=)`` and ``cache_like`` at an explicit
    ``max_seq``: the slots hold the patches and the tokens; a policy's
    block is its span of them; the encoder-only cache is ``{}``."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import kvcache as KC
    from repro_torch.serving import sharded as SV
    cfg = get_config(PIX).reduced()
    like = SV.cache_like(cfg, B, SLOTS, _positions(PIX))
    assert like["k"].shape == (2, B, SLOTS, 2, 32)
    pol = SH.ShardingPolicy({"pod": 1, "data": 1, "model": 2})
    blk = KC.init_cache(cfg, B, SLOTS, policy=pol)
    assert blk["k"].shape == (2, B, SLOTS // 2, 2, 32)
    hub = get_config(HUB).reduced()
    assert SV.cache_like(hub, B, SLOTS, FRAMES) == {}
    assert KC.init_cache(hub, B, SLOTS, policy=pol) == {}


@pytest.mark.parametrize("name", ["pix-hop-chunked", "hub-hop-empty"])
def test_hop_own_shards_bitwise_with_whole_cache_stats(worlds, name):
    _, ranks = _ranks(worlds, name)
    by = {(s["coord"]["pod"], s["coord"]["data"], s["coord"]["model"]): s
          for s, _, _ in ranks}
    for (pod, d, m), s in by.items():
        assert s["stats"] == s["whole_stats"], (pod, d, m)
        if pod == 1:
            src = by[(0, d, m)]
            assert s["sha"] == src["sha"] == s["whole_sha"], (d, m)
            assert s["stats"] == src["stats"]
            assert s["first_token"] == src["first_token"]
            assert s["side_bytes"] == src["side_bytes"] > 0


def test_hop_decode_pod_logits(worlds):
    """Pixtral: pod 0's prefill against JAX's, and pod 1's decode from
    the shards it received against JAX's steps fed pod 1's own tokens."""
    case, ranks = _ranks(worlds, "pix-hop-chunked")
    ref = jax_ref(case["ref"])
    dec = [s for s, _, _ in ranks if s["pod"] == 1]
    toks, first = np.asarray(dec[0]["tokens"]), dec[0]["first_token"]
    fed = _run(jax_params(PIX), "pix",
               np.concatenate([np.asarray(first)[:, None], toks[:, :-1]], 1).T)
    for s, a, r in ranks:
        rows = s["rows"]
        assert s["routes"] == {"k": "splitzip", "v": "splitzip"}, r
        if s["pod"] == 0:
            np.testing.assert_allclose(a["last_logits"],
                                       _cols(ref["last_logits"][rows], s),
                                       atol=ATOL, rtol=RTOL)
            assert s["first_token"] == ref["first_token"][rows].tolist(), r
            continue
        assert s["tokens"] == toks.tolist() and s["first_token"] == first
        assert s["received"] == ["k", "v"], r
        np.testing.assert_allclose(a["step_logits"],
                                   _cols(fed["step_logits"][:, rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")


def test_empty_hop_pinned_against_the_jax_plan(worlds):
    """Hubert's ``xfer_chunked`` cell: pod 0 ships its empty cache (a
    message of no unit), the first units and ``cache_len``; pod 1
    receives ``{}`` and the first units, JAX's, and decodes nothing.  The
    plan is the JAX ``TransferPlan.build({}, ...)``'s on the JAX policy's
    specs of ``{}``, and ``last_stats`` on both pods is the JAX session's
    transfer of ``{}``: 0 raw and 0 wire bytes, no chunk, no leaf."""
    from repro.core.codebook import DEFAULT_BF16_CODEBOOK as JBOOK
    from repro.serving.plan import TransferConfig as JConfig
    from repro.serving.plan import TransferPlan as JPlan
    case, ranks = _ranks(worlds, "hub-hop-empty")
    ref = jax_ref(case["ref"])
    mesh = AbstractMesh(tuple(case["shape"]), AXES)
    jtc = JConfig(codebook=JBOOK, chunk=1024, cap=64)
    jplan = JPlan.build({}, jtc, mesh=mesh, specs=JPolicy(
        mesh, pd_disaggregated=True).cache_specs({}))
    sess = JPlan.build({}, jtc).session()
    assert sess.transfer({}) == {}
    jstats = json.loads(json.dumps(dataclasses.asdict(sess.last_stats),
                                   default=str))
    want_plan = dict(routes=len(jplan.routes), segments=len(jplan.segments),
                     stream_len=jplan.stream_len,
                     in_specs=[list(sp) for sp in jplan.in_specs],
                     granularity=jplan.granularity)
    assert want_plan == dict(routes=0, segments=0, stream_len=0, in_specs=[],
                             granularity="tensor")
    for s, _, r in ranks:
        assert s["plan"] == want_plan, r
        assert s["routes"] == {} and s["records"] == 0, r
        assert s["held_cache"] == 0, r
        assert {k: s["stats"][k] for k in jstats} == jstats, r
        assert s["first_token"] == ref["first_token"][s["rows"]].tolist(), r
        if s["pod"] == 1:
            assert s["received"] == [] and s["tokens"] is None, r


def test_sharded_cli_serves_both_front_ends(worlds):
    """``python -m repro_torch.serving.sharded``: pixtral's disaggregated
    step prints each rank's hop and pod 1's tokens (B 2 x 4); hubert's
    prefill cell each data rank's first units, and its empty hop 0 raw
    and 0 wire bytes on every rank and pod 1's first units."""
    xfer, base, empty = worlds[4][2]
    hops = [ln for out in xfer for ln in out.splitlines() if " hop " in ln]
    assert len(hops) == 4 and all("raw bytes" in ln for ln in hops)
    toks = [ln for out in xfer for ln in out.splitlines() if "tokens" in ln]
    assert len(toks) == 1 and "'pod': 1" in toks[0]
    assert np.asarray(json.loads(toks[0].split("tokens ")[1])).shape == (2, 4)
    units = [ln for out in base for ln in out.splitlines() if "first units" in ln]
    assert len(units) == 2
    assert all(len(json.loads(u.split("first units ")[1])) == 1 for u in units)
    hops = [ln for out in empty for ln in out.splitlines() if " hop " in ln]
    assert len(hops) == 4
    assert all("hop 0 raw bytes, 0 wire bytes" in ln for ln in hops)
    units = [ln for out in empty for ln in out.splitlines()
             if "first units" in ln]
    assert len(units) == 1 and "'pod': 1" in units[0]
    assert len(json.loads(units[0].split("first units ")[1])) == 2

"""Sharded serving of Mamba-2 and of the RG-LRU hybrid across gloo ranks
against the JAX package's unsharded serving, on the CPU.

As for the other families (``tests/test_torch_serve_tp.py``, whose
docstring says why), the port's sharded steps (``serving/sharded.py``,
``prefill_step(tp=)``, ``serve_step(tp=)``) are held against the JAX
``prefill_step`` / ``serve_step`` without a policy, on the same parameters
(the JAX seeded init, each rank taking its blocks through
``params_from_jax(policy=)``) and the same numpy prompt, batch 4: reduced
mamba2-2.7b (16 heads of 16, d_state 16, conv channels C = 288, 2
layers) and reduced recurrentgemma-9b at 5 layers (one triple and 2 extra
blocks; 4 heads over one KV head, U = 128, window 8).  These states split
heads, channels or the window's KV heads, never the sequence, and each
rank's blocks are held against the JAX state sliced by the JAX policy's
``cache_specs`` on an ``AbstractMesh`` at the rank's coordinate.  The
cases:

* Mamba-2 (1, 1, 2): H, C and the ``in_proj`` columns split; (1, 1, 3): C
  splits 96 a rank while H, d_inner and ``in_proj``'s K do not; (1, 2, 2):
  the batch over ``data``; (2, 1, 2) under ``pd_disaggregated``, the hop
  ``xfer_chunked`` (the f32 ``ssm`` raw) and ``xfer_fp32`` (its hi halves
  through the codec, ``fp32_hilo``);
* the hybrid at a 12-position prompt: (1, 1, 2) case ``kv`` (one KV head
  does not split, so the window is replicated), U split; (1, 1, 3) case
  ``seq`` (12 splits over 3; every rank recomputes the window's K/V), U
  whole; (1, 2, 2); (2, 1, 2) with both variants; and a 6-position prompt,
  shorter than the window, through the (2, 1, 2) hop: the plan is built
  from the prompt's window (``serving/sharded.cache_like``), which is what
  the prefill leaves.

Bounds, each file's of the family: logits and the Mamba-2 states ATOL
4e-2 / RTOL 2e-2 (``tests/test_torch_ssm.py``: the same bf16 roundings in
another order, two layers deep, the row products' f32 sums in rank
order); the hybrid's cache ATOL 8e-2 (``tests/test_torch_hybrid.py``: the
RG-LRU's log-depth scan against ``associative_scan``, and the window's
K/V rounded from inputs an ulp apart).  Greedy tokens are reported, not
held (near ties); the first token is held equal to JAX's wherever JAX's
lead of its choice over the port's exceeds what the bound lets two logits
move (:func:`assert_first_token`: reduced recurrentgemma's 6-position
prompt has a row whose two best logits are one bf16 ulp apart).  The units hold
``mamba2_decode_tp`` and ``recurrent_block_step_tp`` against
``mamba2_decode`` / ``recurrent_block_step`` on the same whole state:
the f32 states within 1e-5, the conv blocks bitwise, the outputs within
the blocks' 2e-3 over 8e-3 |want| (a row product rounds its f32 sum
once, the whole product in another order).  Held exactly: held parameter
and state bytes (and ``init_cache(policy=)``), leaves replicated over
``model`` bitwise on every model rank (the window included), pod 1's
shards bitwise pod 0's, and the hop of a rank's own shard giving the
bytes and ``TransferStats`` of the whole-state hop.
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
ATOL_HYBRID = 8e-2
UNIT_STATE_ATOL = 1e-5
UNIT_OUT_ATOL = 2e-3
SSM, HYB = "mamba2-2.7b", "recurrentgemma-9b"
B, SLOTS, STEPS = 4, 24, 4
AXES = ("pod", "data", "model")
#: reference -> (arch, prompt length)
REFS = {"ssm": (SSM, 12), "hyb": (HYB, 12), "hyb6": (HYB, 6)}
OVER = {SSM: {}, HYB: {"num_layers": 5}}


def _serve(name, ref, shape, want=None):
    return dict(kind="serve", name=name, arch=REFS[ref][0], ref=ref,
                shape=list(shape), want=want, over=OVER[REFS[ref][0]])


def _hop(name, ref, variant, want=None):
    return dict(kind="hop", name=name, arch=REFS[ref][0], ref=ref,
                shape=[2, 1, 2], want=want, pd=True, variant=variant,
                over=OVER[REFS[ref][0]])


WORLDS = {
    2: [_serve("ssm-112", "ssm", (1, 1, 2)),
        _serve("hyb-112", "hyb", (1, 1, 2), "kv")],
    3: [_serve("ssm-113", "ssm", (1, 1, 3)),
        _serve("hyb-113-seq", "hyb", (1, 1, 3), "seq")],
    4: [_serve("ssm-122", "ssm", (1, 2, 2)),
        _hop("ssm-hop-chunked", "ssm", "xfer_chunked"),
        _hop("ssm-hop-fp32", "ssm", "xfer_fp32"),
        _serve("hyb-122", "hyb", (1, 2, 2), "kv"),
        _hop("hyb-hop-chunked", "hyb", "xfer_chunked", "kv"),
        _hop("hyb-hop-fp32", "hyb", "xfer_fp32", "kv"),
        _hop("hyb-short-hop", "hyb6", "xfer_chunked", "kv")],
}
CASES = {c["name"]: (world, c) for world, cs in WORLDS.items() for c in cs}
SERVE = [n for n, (_, c) in CASES.items() if c["kind"] == "serve"]
HOPS = [n for n, (_, c) in CASES.items() if c["kind"] == "hop"]
#: ``python -m repro_torch.serving.sharded`` on the world of 4: Mamba-2's
#: disaggregated step with the f32 state's hi halves through the codec,
#: then the hybrid's base cells
CLI = (("--arch", SSM, "--reduced", "--device", "cpu", "--mesh", "2,1,2",
        "--variant", "xfer_fp32", "--prompt-len", "16", "--new-tokens", "4"),
       ("--arch", HYB, "--reduced", "--device", "cpu", "--mesh", "1,2,2",
        "--prompt-len", "16", "--new-tokens", "4"))


def _cfg(arch):
    return dataclasses.replace(jget(arch).reduced(), **OVER[arch])


@functools.lru_cache(maxsize=None)
def _steps(arch):
    cfg = _cfg(arch)
    return (jax.jit(functools.partial(jprefill_step, cfg=cfg, max_seq=SLOTS)),
            jax.jit(functools.partial(jserve_step, cfg=cfg)))


def _prompt(ref):
    arch, s = REFS[ref]
    return np.random.default_rng(0).integers(0, _cfg(arch).vocab_size, (B, s)) \
        .astype(np.int32)


def _step_inputs(arch):
    """The teacher-forced steps' tokens (STEPS, B), drawn from a seed: no
    JAX run first, so the ranks start at once."""
    return np.random.default_rng(1).integers(0, _cfg(arch).vocab_size,
                                             (STEPS, B)).astype(np.int32)


def _run(params, ref, inputs):
    """The JAX unsharded prefill, then one ``serve_step`` a row of
    ``inputs`` (steps, B), or, where ``inputs`` is None, ``STEPS`` on its
    own greedy tokens."""
    arch = REFS[ref][0]
    prefill, step = _steps(arch)
    out = prefill(params, {"tokens": _prompt(ref)})
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
    return {"first_token": np.asarray(out.first_token),
            "greedy": np.stack(inputs[1:] + [np.asarray(tok)], 1),
            "last_logits": np.asarray(out.last_logits, np.float32),
            "cache": {k: np.asarray(v, np.float32)
                      for k, v in out.state.cache.items()},
            "after": {k: np.asarray(v, np.float32) for k, v in st.cache.items()},
            "step_logits": np.stack(logits),
            "cache_like": out.state.cache}


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax.jit(JM.init_params, static_argnums=0)(_cfg(arch),
                                                    jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def jax_inputs(ref):
    """The arrays the ranks load: the parameters as bits, the prompt, the
    cache slots, the step inputs."""
    arch = REFS[ref][0]
    arrays = {"tokens": _prompt(ref), "max_seq": np.int64(SLOTS),
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
    arch = REFS[ref][0]
    res = _run(jax_params(arch), ref, jax_inputs(ref)["step_inputs"])
    res["greedy_run"] = _run(jax_params(arch), ref, None)
    return res


def _run_world(world, tmp):
    ref_dir, out_dir = tmp / "ref", tmp / f"out{world}"
    out_dir.mkdir()
    (tmp / f"w{world}").mkdir()
    torch_ranks.run_world(torch_ranks.serve_tp_world, world,
                          tmp / f"w{world}", str(ref_dir), str(out_dir),
                          WORLDS[world], CLI if world == 4 else (),
                          "recurrent", timeout=150.0)
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
    tmp = tmp_path_factory.mktemp("serve_recurrent")
    (tmp / "ref").mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        list(ex.map(jax_params, (SSM, HYB)))
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


def _values(bits: np.ndarray) -> np.ndarray:
    """A leaf's values from its bits: bf16 as int16, f32 as int32."""
    if bits.dtype == np.int16:
        return (bits.astype(np.int32) << 16).view(np.float32)
    return bits.view(np.float32)


def _spec(case, name, like):
    shape = tuple(case["shape"])
    pol = JPolicy(AbstractMesh(shape, AXES),
                  pd_disaggregated=case.get("pd", False))
    return pol.cache_specs(like)[name]


def _jax_block(x: np.ndarray, case, name: str, coord, like) -> np.ndarray:
    """``x``'s block at ``coord`` under the JAX policy's cache spec of
    ``name`` (the policy on an ``AbstractMesh`` of the case's shape)."""
    sizes = dict(zip(AXES, case["shape"]))
    for d, entry in enumerate(_spec(case, name, like)):
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


def assert_first_token(got, want_logits, what):
    """``got`` (B,) is JAX's greedy choice on every row where JAX's largest
    logit leads the logit of ``got`` by more than twice the logits' bound
    (each may move by ``ATOL + RTOL |x|``); rows that differ inside it are
    printed."""
    want = np.argmax(want_logits, -1)
    top = want_logits[np.arange(len(want)), want]
    lead = top - want_logits[np.arange(len(want)), np.asarray(got)]
    ties = (np.asarray(got) != want) & (lead <= 2 * (ATOL + RTOL * np.abs(top)))
    if ties.any():
        print(f"{what}: first tokens {list(got)} against JAX's "
              f"{want.tolist()}, leads {lead[ties].tolist()} inside the bound")
    assert ((np.asarray(got) == want) | ties).all(), (what, got, want, lead)


def _state_atol(arch):
    return ATOL_HYBRID if arch == HYB else ATOL


@pytest.mark.parametrize("name", list(CASES))
def test_held_bytes_and_attention_case(worlds, name):
    case, ranks = _ranks(worlds, name)
    for s, _, r in ranks:
        if case["want"] is not None:
            assert s["case"] == case["want"], (r, s["case"])
        assert s["held_params"] == s["spec_params"], r
        assert s["held_cache"] == s["spec_cache"] == s["init_cache"], r


@pytest.mark.parametrize("name", SERVE)
def test_prefill_logits_and_first_token(worlds, name):
    case, ranks = _ranks(worlds, name)
    ref = jax_ref(case["ref"])
    for s, a, r in ranks:
        rows = s["rows"]
        np.testing.assert_allclose(a["last_logits"],
                                   _cols(ref["last_logits"][rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        assert_first_token(s["first_token"], ref["last_logits"][rows],
                           f"rank {r}")
        assert s["greedy_first"] == s["first_token"], r


@pytest.mark.parametrize("name", SERVE)
def test_state_blocks_match_jax_policy_slices(worlds, name):
    """Each rank's block of every state leaf after the prefill and after
    the teacher-forced steps, against the JAX state sliced by the JAX
    policy; the blocks of the splits the case names are a rank's part,
    not the whole."""
    case, ranks = _ranks(worlds, name)
    ref = jax_ref(case["ref"])
    like = ref["cache_like"]
    for s, a, r in ranks:
        for leaf in ref["cache"]:
            for got, whole in ((a[leaf], ref["cache"][leaf]),
                               (a[leaf + "_after"], ref["after"][leaf])):
                want = _jax_block(whole, case, leaf, s["coord"], like)
                assert got.shape == want.shape, (r, leaf, got.shape)
                np.testing.assert_allclose(
                    _values(got), want, atol=_state_atol(case["arch"]),
                    rtol=RTOL, err_msg=f"rank {r} {leaf}")


@pytest.mark.parametrize("name", SERVE)
def test_replicated_leaves_bitwise_across_model_ranks(worlds, name):
    """A leaf the policy keeps whole over ``model`` (the hybrid's window at
    one KV head; every leaf where nothing splits) holds the same bits on
    every model rank of a data coordinate, after the prefill and after
    the steps; a split leaf's blocks differ."""
    case, ranks = _ranks(worlds, name)
    like = jax_ref(case["ref"])["cache_like"]
    by_data = {}
    for s, a, _ in ranks:
        by_data.setdefault(s["coord"]["data"], []).append(a)
    for leaf in like:
        whole = "model" not in _spec(case, leaf, like)
        for arrays in by_data.values():
            for key in (leaf, leaf + "_after"):
                same = all(np.array_equal(arrays[0][key], x[key])
                           for x in arrays[1:])
                assert same == whole, (leaf, key)
    if case["want"] == "kv":
        assert "model" not in _spec(case, "attn_k", like)


@pytest.mark.parametrize("name", SERVE)
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


@pytest.mark.parametrize("name", HOPS)
def test_hop_own_shards_bitwise_with_whole_state_stats(worlds, name):
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


@pytest.mark.parametrize("name", HOPS)
def test_hop_routes_of_the_f32_states(worlds, name):
    """``xfer_chunked`` ships the f32 states raw; ``xfer_fp32`` sends their
    hi halves through the codec (``fp32_hilo``); the bf16 leaves go
    through SplitZip under both.  Every rank ships its block, a leaf
    replicated over ``model`` from every model rank, so each copy counts
    its bytes where it is sent (the two ranks' stats agree)."""
    case, ranks = _ranks(worlds, name)
    f32 = {"ssm"} if case["arch"] == SSM else {"rec_h", "extra_h"}
    want = "fp32_hilo" if case["variant"] == "xfer_fp32" else "raw"
    for s, _, r in ranks:
        assert {k: v for k, v in s["routes"].items() if k in f32} == \
            {k: want for k in f32}, (r, s["routes"])
        assert all(v == "splitzip" for k, v in s["routes"].items()
                   if k not in f32), (r, s["routes"])
        st = s["stats"]
        if want == "raw":
            assert st["raw_passthrough_bytes"] > 0 and not st["fp32_lo_wire_bytes"]
        else:
            assert st["fp32_lo_wire_bytes"] > 0 and not st["raw_passthrough_bytes"]


@pytest.mark.parametrize("name", HOPS)
def test_hop_decode_pod_logits(worlds, name):
    """Pod 0's prefill against JAX's, and pod 1's decode from the shards it
    received against JAX's steps fed pod 1's own tokens (its first token,
    then each greedy choice), every step."""
    case, ranks = _ranks(worlds, name)
    ref = jax_ref(case["ref"])
    dec = [(s, a) for s, a, _ in ranks if s["pod"] == 1]
    toks, first = np.asarray(dec[0][0]["tokens"]), dec[0][0]["first_token"]
    fed = _run(jax_params(case["arch"]), case["ref"],
               np.concatenate([np.asarray(first)[:, None], toks[:, :-1]], 1).T)
    for s, a, r in ranks:
        rows = s["rows"]
        if s["pod"] == 0:
            np.testing.assert_allclose(a["last_logits"],
                                       _cols(ref["last_logits"][rows], s),
                                       atol=ATOL, rtol=RTOL)
            assert_first_token(s["first_token"], ref["last_logits"][rows],
                               f"rank {r}")
            continue
        assert s["tokens"] == toks.tolist() and s["first_token"] == first
        np.testing.assert_allclose(a["step_logits"],
                                   _cols(fed["step_logits"][:, rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")


def test_short_prompt_hop_plans_the_prompts_window(worlds):
    """A prompt of 6 under the window of 8: the prefill leaves 6 window
    positions (as JAX's does), and the hop's plan, built from the prompt's
    window, moves exactly those blocks (held bytes and shard hashes in the
    hop tests); ``init_cache`` would allot min(window, max_seq) = 8."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving import sharded as SV
    cfg = dataclasses.replace(get_config(HYB).reduced(), num_layers=5)
    assert SV.cache_like(cfg, B, SLOTS, 6)["attn_k"].shape[2] == 6
    assert SV.cache_like(cfg, B, SLOTS)["attn_k"].shape[2] == 8
    assert SV.cache_like(cfg, B, SLOTS, 12)["attn_k"].shape[2] == 8
    ssm = get_config(SSM).reduced()
    assert {k: v.shape for k, v in SV.cache_like(ssm, B, SLOTS, 6).items()} \
        == {k: v.shape for k, v in SV.cache_like(ssm, B, SLOTS).items()}
    _, ranks = _ranks(worlds, "hyb-short-hop")
    like = jax_ref("hyb6")["cache_like"]
    assert like["attn_k"].shape[2] == 6
    for s, _, _ in ranks:
        assert s["held_cache"] == s["spec_cache"]


@pytest.mark.parametrize("world", list(WORLDS))
def test_recurrent_decode_units(worlds, world):
    """``mamba2_decode_tp`` and ``recurrent_block_step_tp`` against the
    whole steps on one whole state (module docstring's bounds); at 3
    ranks the RG-LRU's U = 128 does not split (the step runs whole)."""
    for s in worlds[world][0]:
        u = s["units"]
        m = u["mamba2"]
        assert m["state_max_abs"] <= UNIT_STATE_ATOL and m["conv_bitwise"]
        assert m["out_excess"] <= UNIT_OUT_ATOL
        assert m["split"] == {"heads": world != 3, "conv": True}
        if world == 3:
            assert u["rglru"] is None
            continue
        g = u["rglru"]
        assert g["state_max_abs"] <= UNIT_STATE_ATOL and g["conv_bitwise"]
        assert g["out_excess"] <= UNIT_OUT_ATOL


def test_sharded_cli_serves_both_families(worlds):
    """``python -m repro_torch.serving.sharded``: Mamba-2's disaggregated
    step under ``xfer_fp32`` prints each rank's hop and pod 1's tokens
    (B 2 x 4); the hybrid's base cells each data rank's row of tokens."""
    xfer, base = worlds[4][2]
    hops = [ln for out in xfer for ln in out.splitlines() if " hop " in ln]
    assert len(hops) == 4 and all("raw bytes" in ln for ln in hops)
    toks = [ln for out in xfer for ln in out.splitlines() if "tokens" in ln]
    assert len(toks) == 1 and "'pod': 1" in toks[0]
    assert np.asarray(json.loads(toks[0].split("tokens ")[1])).shape == (2, 4)
    rows = [ln for out in base for ln in out.splitlines() if "tokens" in ln]
    assert len(rows) == 2
    assert all(np.asarray(json.loads(r.split("tokens ")[1])).shape == (1, 4)
               for r in rows)

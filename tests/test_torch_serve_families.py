"""Sharded serving of the MLA and MoE families across gloo ranks against
the JAX package's unsharded serving, on the CPU.

As for the dense family (``tests/test_torch_serve_tp.py``, whose docstring
says why), the port's sharded steps (``serving/sharded.py``,
``prefill_step(tp=, ep=)``, ``serve_step(tp=, ep=)``) are held against the
JAX ``prefill_step`` / ``serve_step`` without a policy, on the same
parameters (the JAX seeded init, each rank taking its blocks through
``params_from_jax(policy=)``) and the same numpy prompt, batch 4 x 12:
reduced minicpm3-4b (4 heads; MLA ranks 32 / 16, nope / rope / v 16 / 8 /
16) and reduced qwen3-moe-30b-a3b (4 / 2 heads of 32, 8 experts top-2).
A rank's cache blocks are held against the JAX cache sliced by the JAX
policy's ``cache_specs`` on an ``AbstractMesh`` at the rank's coordinate
(for MLA the latent ``ckv`` / ``krope``, their positions over ``model``).
The cases:

* MLA (1, 1, 2): heads split, the latent cache's 24 slots split (rank 0's
  block the prompt, rank 1's padding and every decoded token); at 25
  slots, which do not split, the cache replicated over ``model``;
* MLA (1, 1, 3): 4 heads do not split, so the prefill takes the ``seq``
  fallback and the decode the replicated weights over the 3 cache blocks;
* MLA (1, 2, 2): the batch over ``data``; MLA (2, 1, 2) under
  ``pd_disaggregated``: pod 0 prefills and ships each rank's latent shard
  through the mesh hop (``xfer_chunked``, ``xfer_global``), pod 1 decodes
  from the shards it received;
* MoE (1, 1, 2): 4 experts a rank; (1, 2, 2): routing over ``data``, the
  experts over ``model``; (2, 1, 2) ``xfer_chunked``: each pod routes its
  own batch.

Bounds: ATOL 4e-2 / RTOL 2e-2 for the last logits, every cache block and
the teacher-forced decode logits (4 steps), the dense file's bound and
reasons: sums in other orders (the row products' f32 sums in rank order,
the merged partial softmax of a split cache: for MLA each rank's
unnormalised ``p`` rounded to bf16 and ``p . ckv`` accumulated in f32,
where JAX rounds the normalised ``p`` and the product) move a logit by a
few bf16 ulps of its terms; a wrong block, mask, position or slot moves
values by O(1).  Greedy tokens are reported, not held (near ties); the
first token is held.

Routing is not continuous (``tests/test_torch_expert_parallel.py``): a
token whose k-th and (k+1)-th router probabilities are closer than bf16
round-off can take another expert.  So each MoE rank records its top-k
experts (``torch_ranks.RouteRecorder``) and the JAX steps are replayed on
them (:func:`jax_forcing`: a forced (T, k) leaf rides the layer scan and
stands in for ``jax.lax.top_k`` inside the JAX ``moe_ffn``; the gates are
JAX's own probabilities there).  The choices that differ from JAX's own
routing are counted and printed, not held.  Held exactly: the routing
collectives (each rank's slots and FFN output rows bitwise those of one
process on its routing group's whole batch with every expert), each
layer's capacity the group's (decode: 8, as JAX's ``serve_step`` on the
whole batch), MLA's merged partial latent attention against whole-key
attention in f32 within 1e-5, held parameter and cache bytes (and
``init_cache(policy=)``), pod 1's shards bitwise pod 0's, and the hop of a
rank's own shard giving the bytes and ``TransferStats`` of the whole-cache
hop.  ``require_tp_serving`` passes every family, the front ends
included (Mamba-2 and the hybrid are held in
``tests/test_torch_serve_recurrent.py``, the front ends in
``tests/test_torch_serve_frontends.py``), and a MoE under ``tp`` without
``ep`` raises.
"""

import concurrent.futures
import contextlib
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
from repro.models import moe as JMOE  # noqa: E402
from repro.models.kvcache import DecodeState as JState  # noqa: E402
from repro.serving.decode import serve_step as jserve_step  # noqa: E402
from repro.serving.prefill import prefill_step as jprefill_step  # noqa: E402

ATOL, RTOL = 4e-2, 2e-2
MERGE_ATOL = 1e-5
MLA, MOE = "minicpm3-4b", "qwen3-moe-30b-a3b"
B, S, STEPS = 4, 12, 4
AXES = ("pod", "data", "model")
#: reference -> (arch, cache slots)
REFS = {"mla24": (MLA, 24), "mla25": (MLA, 25), "moe24": (MOE, 24)}


def _serve(name, ref, shape, want, **kw):
    return dict(kind="serve", name=name, arch=REFS[ref][0], ref=ref,
                shape=list(shape), want=want, moe=REFS[ref][0] == MOE, **kw)


def _hop(name, ref, variant):
    return dict(kind="hop", name=name, arch=REFS[ref][0], ref=ref,
                shape=[2, 1, 2], want="heads", pd=True, variant=variant,
                moe=REFS[ref][0] == MOE)


WORLDS = {
    2: [_serve("mla-112", "mla24", (1, 1, 2), "heads"),
        _serve("mla-112-whole", "mla25", (1, 1, 2), "heads"),
        _serve("moe-112", "moe24", (1, 1, 2), "heads")],
    3: [_serve("mla-113-seq", "mla24", (1, 1, 3), "seq")],
    4: [_serve("mla-122", "mla24", (1, 2, 2), "heads"),
        _hop("mla-hop-chunked", "mla24", "xfer_chunked"),
        _hop("mla-hop-global", "mla24", "xfer_global"),
        _serve("moe-122", "moe24", (1, 2, 2), "heads"),
        _hop("moe-hop-chunked", "moe24", "xfer_chunked")],
}
CASES = {c["name"]: (world, c) for world, cs in WORLDS.items() for c in cs}
SERVE = [n for n, (_, c) in CASES.items() if c["kind"] == "serve"]
HOPS = [n for n, (_, c) in CASES.items() if c["kind"] == "hop"]
MOES = [n for n, (_, c) in CASES.items() if c["moe"]]
#: ``python -m repro_torch.serving.sharded`` on the world of 4: MLA's
#: disaggregated step, then MoE's base cells
CLI = (("--arch", MLA, "--reduced", "--device", "cpu", "--mesh", "2,1,2",
        "--variant", "xfer_chunked", "--prompt-len", "16", "--new-tokens", "4"),
       ("--arch", MOE, "--reduced", "--device", "cpu", "--mesh", "1,2,2",
        "--prompt-len", "16", "--new-tokens", "4"))


def _cfg(arch):
    return jget(arch).reduced()


#: each forced MoE call's count of tokens whose forced experts are not
#: JAX's own top-k, as the calls run (read at call time: a jitted trace
#: keeps the callback it was traced with)
FLIPS = []


@contextlib.contextmanager
def jax_forcing():
    """The JAX ``moe_ffn`` routed to forced experts: a ``forced`` (T, k)
    leaf beside the FFN's parameters (it rides the layer scan) replaces
    ``jax.lax.top_k``'s choices, and the gates are the probabilities
    gathered there; each call appends to :data:`FLIPS` how many tokens'
    forced experts are not JAX's own top-k.  Active while a function is
    traced."""
    ffn, top_k = JMOE.moe_ffn, jax.lax.top_k

    def forced_ffn(p, x, cfg):
        idx = p["forced"]
        t = x.shape[0] * x.shape[1]
        probs = jax.nn.softmax(jnp.einsum(
            "td,de->te", x.reshape(t, -1).astype(jnp.float32), p["router"]), -1)
        own = top_k(probs, cfg.top_k)[1]
        differ = jnp.any(jnp.sort(own, -1) != jnp.sort(idx, -1), -1).sum()
        jax.debug.callback(lambda n: FLIPS.append(int(n)), differ)
        jax.lax.top_k = lambda probs, k: (
            jnp.take_along_axis(probs, idx, -1), idx)
        try:
            return ffn({k: v for k, v in p.items() if k != "forced"}, x, cfg)
        finally:
            jax.lax.top_k = top_k

    JMOE.moe_ffn = forced_ffn
    try:
        yield
    finally:
        JMOE.moe_ffn = ffn


@functools.lru_cache(maxsize=None)
def _steps(ref):
    """The jitted JAX ``prefill_step`` at the reference's slots and
    ``serve_step`` (each traced once a parameter structure: with and
    without the forced routing)."""
    arch, slots = REFS[ref]
    cfg = _cfg(arch)
    return (jax.jit(functools.partial(jprefill_step, cfg=cfg, max_seq=slots)),
            jax.jit(functools.partial(jserve_step, cfg=cfg)))


def _run(params, ref, inputs, forced=None):
    """The JAX unsharded prefill of the prompt at the reference's slots,
    then one ``serve_step`` a row of ``inputs`` (steps, B), or, where
    ``inputs`` is None, ``STEPS`` on its own greedy tokens; ``forced``
    (the prefill's (L, B S, k) top-k, the steps' (steps, L, B, k)) routes
    a MoE as given."""
    prefill, step = _steps(ref)
    toks = _prompt(_cfg(REFS[ref][0]))

    def with_forced(f):
        if forced is None:
            return params
        ffn = dict(params["layers"]["ffn"], forced=jnp.asarray(f, jnp.int32))
        return dict(params, layers=dict(params["layers"], ffn=ffn))

    FLIPS.clear()
    with jax_forcing() if forced is not None else contextlib.nullcontext():
        out = prefill(with_forced(None if forced is None else forced[0]),
                      {"tokens": toks})
        st = JState(cache=out.state.cache, cache_len=out.state.cache_len)
        fed, logits = inputs is not None, []
        tok, inputs = out.first_token, list(inputs) if fed else []
        for i in range(len(inputs) if fed else STEPS):
            if fed:
                tok = inputs[i]
            else:
                inputs.append(np.asarray(tok))
            lg, st = step(with_forced(None if forced is None else forced[1][i]),
                          jnp.asarray(tok)[:, None], st)
            logits.append(np.asarray(lg, np.float32))
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    jax.effects_barrier()
    return {"flips": list(FLIPS),"first_token": np.asarray(out.first_token),
            "inputs": np.stack(inputs),
            "greedy": np.stack(inputs[1:] + [np.asarray(tok)], 1),
            "last_logits": np.asarray(out.last_logits, np.float32),
            "cache": {k: np.asarray(v, np.float32)
                      for k, v in out.state.cache.items()},
            "after": {k: np.asarray(v, np.float32) for k, v in st.cache.items()},
            "step_logits": np.stack(logits) if logits else None,
            "cache_like": out.state.cache}


def _prompt(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)


def _step_inputs(cfg):
    """The teacher-forced steps' tokens (STEPS, B): any tokens serve, and
    drawn from a seed they need no JAX run, so the ranks start at once."""
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (STEPS, B)) \
        .astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    """The JAX seeded parameters of reduced ``arch`` (``init_params``,
    jitted: op by op it takes seconds)."""
    return jax.jit(JM.init_params, static_argnums=0)(_cfg(arch),
                                                    jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def jax_inputs(ref):
    """The JAX seeded parameters and the arrays the ranks load (parameters
    as bits, the prompt, the cache slots, the step inputs)."""
    arch, slots = REFS[ref]
    cfg = _cfg(arch)
    params = jax_params(arch)
    arrays = {"tokens": _prompt(cfg), "max_seq": np.int64(slots),
              "step_inputs": _step_inputs(cfg)}
    for p, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(k.key) for k in p)
        x = np.asarray(x)
        arrays["params/" + key] = x.view(np.uint16) \
            if x.dtype == jnp.bfloat16 else x
    return params, arrays


@functools.lru_cache(maxsize=None)
def jax_ref(ref):
    """The JAX unsharded prefill and ``STEPS`` ``serve_step``s on the step
    inputs (JAX's own routing), and (``greedy_run``) ``STEPS`` on its own
    greedy tokens."""
    params, arrays = jax_inputs(ref)
    res = _run(params, ref, arrays["step_inputs"])
    res["greedy_run"] = _run(params, ref, None)
    return res


def _run_world(world, tmp):
    ref_dir, out_dir = tmp / "ref", tmp / f"out{world}"
    out_dir.mkdir()
    (tmp / f"w{world}").mkdir()
    torch_ranks.run_world(torch_ranks.serve_tp_world, world,
                          tmp / f"w{world}", str(ref_dir), str(out_dir),
                          WORLDS[world], CLI if world == 4 else (),
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
    tmp = tmp_path_factory.mktemp("serve_families")
    (tmp / "ref").mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        list(ex.map(jax_params, (MLA, MOE)))
    for ref in REFS:
        np.savez(tmp / "ref" / f"{ref}.npz", **jax_inputs(ref)[1])
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


def _routes(ranks, key, pod):
    """The recorded top-k of the model-0 ranks of ``pod``, in data order:
    the prefill's (L, B S, k), the steps' (steps, L, B, k)."""
    got = sorted((s["coord"]["data"], a[f"route/{key}"]) for s, a, _ in ranks
                 if s["coord"]["model"] == 0 and s["coord"]["pod"] == pod)
    whole = np.concatenate([x for _, x in got], axis=2)
    return whole[0] if key == "prefill" else whole


#: case name -> its MoE replay (:func:`reference`)
REPLAYS = {}


def reference(worlds, name):
    """What a case is held against: for MLA the JAX run of the reference;
    for MoE the JAX run replayed on the case's recorded routing (and for a
    hop, fed pod 1's own tokens), with the count of choices that differ
    from JAX's own routing."""
    case, ranks = _ranks(worlds, name)
    params, arrays = jax_inputs(case["ref"])
    res = jax_ref(case["ref"])
    if not case["moe"]:
        return res if case["kind"] == "serve" else res["greedy_run"]
    if name not in REPLAYS:
        pre = _routes(ranks, "prefill", 0)
        if case["kind"] == "serve":
            inputs = list(arrays["step_inputs"])
            steps = _routes(ranks, "steps", 0)
        else:
            dec = sorted((s["coord"]["data"], s) for s, _, _ in ranks
                         if s["coord"]["pod"] == 1 and s["coord"]["model"] == 0)
            toks = np.concatenate([np.asarray(s["tokens"]) for _, s in dec])
            first = np.concatenate([np.asarray(s["first_token"])
                                    for _, s in dec])
            inputs = list(np.concatenate([first[:, None], toks[:, :-1]], 1).T
                          .astype(np.int32))
            steps = _routes(ranks, "steps", 1)
        out = _run(params, case["ref"], inputs, (pre, steps))
        flips = out["flips"]
        print(f"{name}: tokens routed otherwise than JAX's own top-k, a call "
              f"(prefill's layers, then each step's): {flips}")
        REPLAYS[name] = out
    return REPLAYS[name]


def _bf16(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.int32) << 16).view(np.float32)


def _jax_block(x: np.ndarray, case, name: str, coord, like) -> np.ndarray:
    """``x``'s block at ``coord`` under the JAX policy's cache spec of
    ``name`` (the policy on an ``AbstractMesh`` of the case's shape)."""
    shape = tuple(case["shape"])
    pol = JPolicy(AbstractMesh(shape, AXES),
                  pd_disaggregated=case.get("pd", False))
    spec = pol.cache_specs(like)[name]
    sizes = dict(zip(AXES, shape))
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
    """The rank's vocab columns of whole logits (all where the vocab does
    not split)."""
    if not summary["vocab_split"]:
        return x
    n = x.shape[-1] // summary["tp_size"]
    return x[..., summary["tp_rank"] * n:(summary["tp_rank"] + 1) * n]


@pytest.mark.parametrize("name", list(CASES))
def test_attention_case_and_held_bytes(worlds, name):
    case, ranks = _ranks(worlds, name)
    for s, _, r in ranks:
        assert s["case"] == case["want"], (r, s["case"])
        assert s["held_params"] == s["spec_params"], r
        assert s["held_cache"] == s["spec_cache"] == s["init_cache"], r


@pytest.mark.parametrize("name", SERVE)
def test_prefill_logits_and_first_token(worlds, name):
    case, ranks = _ranks(worlds, name)
    ref = reference(worlds, name)
    for s, a, r in ranks:
        rows = s["rows"]
        np.testing.assert_allclose(a["last_logits"],
                                   _cols(ref["last_logits"][rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        assert s["first_token"] == ref["first_token"][rows].tolist(), r
        assert s["greedy_first"] == s["first_token"], r


@pytest.mark.parametrize("name", SERVE)
def test_cache_blocks_match_jax_policy_slices(worlds, name):
    case, ranks = _ranks(worlds, name)
    ref = reference(worlds, name)
    m = REFS[case["ref"]][1]
    names = ("ckv", "krope") if not case["moe"] else ("k", "v")
    for s, a, r in ranks:
        for leaf in names:
            for got, whole in ((a[leaf], ref["cache"][leaf]),
                               (a[leaf + "_after"], ref["after"][leaf])):
                want = _jax_block(whole, case, leaf, s["coord"],
                                  ref["cache_like"])
                np.testing.assert_allclose(_bf16(got), want, atol=ATOL,
                                           rtol=RTOL, err_msg=f"rank {r} {leaf}")
            # the prefill's blocks hold zeros past the prompt, bitwise
            span = m // s["tp_size"] if s["cache_split"] else m
            start = s["tp_rank"] * span if s["cache_split"] else 0
            assert not a[leaf][:, :, max(0, S - start):].any(), (r, leaf)


@pytest.mark.parametrize("name", SERVE)
def test_serve_step_teacher_forced(worlds, name):
    case, ranks = _ranks(worlds, name)
    ref = reference(worlds, name)
    agree = []
    for s, a, r in ranks:
        rows = s["rows"]
        np.testing.assert_allclose(a["step_logits"],
                                   _cols(ref["step_logits"][:, rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        agree.append(float(np.mean(
            np.asarray(s["greedy"])
            == jax_ref(case["ref"])["greedy_run"]["greedy"][rows])))
    print(f"{name}: decode_loop tokens agreeing with JAX's: {agree}")


@pytest.mark.parametrize("name", HOPS)
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


@pytest.mark.parametrize("name", HOPS)
def test_hop_decode_pod_logits(worlds, name):
    """Pod 1's decode from the shards it received, held teacher-forced
    against JAX: for MLA while its greedy tokens are JAX's (then every
    step's input is the same), for MoE against the replay fed its own
    tokens and routing, every step."""
    case, ranks = _ranks(worlds, name)
    ref = reference(worlds, name)
    held = 0
    for s, a, r in ranks:
        rows = s["rows"]
        if s["pod"] == 0:
            np.testing.assert_allclose(a["last_logits"],
                                       _cols(ref["last_logits"][rows], s),
                                       atol=ATOL, rtol=RTOL)
            assert s["first_token"] == ref["first_token"][rows].tolist()
            continue
        n = STEPS
        if not case["moe"]:
            same = (np.asarray(s["tokens"]) == ref["greedy"][rows]).all(axis=0)
            n = STEPS if same.all() else int(np.argmin(same)) + 1
        np.testing.assert_allclose(a["step_logits"][:n],
                                   _cols(ref["step_logits"][:n, rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        held += n
    assert held >= 2


@pytest.mark.parametrize("name", MOES)
def test_moe_routing_collectives_bitwise(worlds, name):
    """Every MoE call of every rank: the slots of its choices and its FFN
    output rows bitwise those of one process on the routing group's whole
    batch with every expert; the capacity the whole batch's, as the JAX
    ``moe_ffn`` takes it (the prefill's over B S tokens, a decode step's
    over B: 8); the experts split over ``model`` (8 over 2); the group the
    data axis (a pod's, under ``pd_disaggregated``)."""
    case, ranks = _ranks(worlds, name)
    data = case["shape"][1]
    mc = _cfg(MOE).moe
    caps = {"prefill": JMOE.capacity(B * S, mc), "decode": JMOE.capacity(B, mc)}
    assert caps["decode"] == 8
    for s, _, r in ranks:
        rt = s["routing"]
        assert rt["calls"] > 0 and rt["slots_bitwise"] and rt["out_bitwise"], r
        assert rt["split_experts"] and rt["group_sizes"] == [data], (r, rt)
        want = ({"prefill", "decode"} if case["kind"] == "serve" else
                {"prefill"} if s["pod"] == 0 else {"decode"})
        assert rt["caps"] == sorted(caps[k] for k in want), (r, rt)
    reference(worlds, name)     # prints the choices that differ from JAX's


@pytest.mark.parametrize("world", list(WORLDS))
def test_latent_merge_equals_whole_attention(worlds, world):
    for s in worlds[world][0]:
        assert s["units"]["latent_merge_max_abs"] <= MERGE_ATOL


def test_sharded_cli_runs_both_families(worlds):
    """``python -m repro_torch.serving.sharded``: MLA's disaggregated step
    prints each rank's hop and pod 1's tokens (B 2 x 4); MoE's base cells
    each data rank's row of tokens."""
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


@pytest.mark.parametrize("arch", [MLA, MOE, "qwen3-moe-235b-a22b",
                                  "mamba2-2.7b", "recurrentgemma-9b",
                                  "pixtral-12b", "hubert-xlarge"])
def test_served_families_pass(arch):
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    M.require_tp_serving(get_config(arch))


def test_moe_under_tp_without_ep_raises():
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(MOE).reduced()
    lp = M.layer_params(M.init_params(cfg, torch.Generator().manual_seed(0))
                        ["layers"], 0)
    with pytest.raises(ValueError, match="needs ep="):
        M.ffn(lp, torch.zeros((1, 2, cfg.d_model), dtype=torch.bfloat16), cfg,
              tp=object())

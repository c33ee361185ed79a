"""Sharded serving of the dense family across gloo ranks against the JAX
package's unsharded serving, on the CPU.

The JAX ``prefill_step`` / ``serve_step`` under a ``ShardingPolicy`` do not
run on jax 0.9 (``with_sharding_constraint`` rejects Explicit axes; ROADMAP
queue 3), and GSPMD's contract is that sharding does not change the
function, so the port's sharded steps (``serving/sharded.py``,
``prefill_step(tp=)``, ``serve_step(tp=)``) are held against the JAX steps
without a policy, on the same parameters (the JAX seeded init, each rank
taking its blocks through ``params_from_jax(policy=)``) and the same numpy
prompt (reduced smollm-135m: 4 query / 2 KV heads of 32, 2 layers, d 128,
vocab 128; batch 4 x 12).  A rank's cache blocks are held against the JAX
cache sliced by the JAX policy's ``cache_specs`` on an ``AbstractMesh`` at
the rank's coordinate.  The cases:

* (1, 1, 2): heads split (case ``heads``), the cache's 24 slots split (rank
  0's block is the prompt, rank 1's padding and every decoded token); and
  at 25 slots, which do not split, the cache replicated over ``model``;
* (1, 1, 3): 4 heads do not split, so the ``seq`` fallback (each rank's
  query block of 4 over the keys up to its end; the cache's 24 slots in
  blocks of 8 take positions from ranks above), and ``attn_fallback=
  "none"``; the vocab and d_ff do not split either;
* (1, 1, 4): query heads split, KV heads not (case ``kv``), and (1, 2, 2):
  the batch over ``data``;
* (2, 1, 2) under ``pd_disaggregated``: pod 0 prefills and ships each
  rank's own cache shard through the mesh hop, pod 1 decodes from the
  shards it received; the dry-run's ``xfer_raw``, ``xfer_chunked`` and
  ``xfer_global`` configurations.

Bounds: the prefill bound of ``tests/test_torch_model.py``, ATOL 4e-2 /
RTOL 2e-2, for the last logits, every cache block and the teacher-forced
``serve_step`` logits (4 steps on the JAX run's own tokens), and why: the
single-process port already differs from JAX by up to one bf16 ulp of
an element's terms (that file's docstring), and sharding adds sums in
other orders: the row-split products are f32 sums of f32 parts in rank
order rounded once where JAX rounds one bf16 product, and a sharded
decode step merges the ranks' partial softmaxes (f32 running max, sum and
accumulator; ``p`` rounded to bf16 unnormalised) where JAX normalises
``p`` over all keys before it rounds.  Each moves a logit by a few bf16
ulps of its terms, far inside the bound; a wrong block, mask, position or
slot moves values by O(1).  Greedy tokens can flip at near ties under such
round-off, so they are reported (``decode_loop``'s agreement with JAX's),
not held; the first token is held (its margin at these inputs is far
above the bound).

Held exactly: the merge of partial attention equals whole-key attention
in f32 within 1e-5; the vocab-parallel argmax picks the whole vocabulary's
first index on forced ties; every rank holds the parameter and cache bytes
its specs give (``init_cache(policy=)`` too); the port's own draws carried
through ``params_from_jax(policy=)`` equal ``init_params(place=)``
bitwise; pod 1's shards are pod 0's bitwise, and the hop of a rank's own
shard gives the same bytes and the same ``TransferStats`` as the hop of
the whole cache.
"""

import concurrent.futures
import functools
import json

import pytest

jax = pytest.importorskip("jax")

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
MERGE_ATOL = 1e-5
ARCH = "smollm-135m"
B, S, STEPS = 4, 12, 4
AXES = ("pod", "data", "model")
#: reference -> cache slots
REFS = {"m24": 24, "m25": 25}


def _serve(name, shape, ref, want, attn_fallback="seq"):
    return dict(kind="serve", name=name, arch=ARCH, shape=list(shape),
                ref=ref, want=want, attn_fallback=attn_fallback)


def _hop(variant):
    return dict(kind="hop", name=f"hop-{variant}", arch=ARCH,
                shape=[2, 1, 2], ref="m24", want="heads", pd=True,
                variant=variant)


WORLDS = {
    2: [_serve("heads-112", (1, 1, 2), "m24", "heads"),
        _serve("heads-112-whole", (1, 1, 2), "m25", "heads")],
    3: [_serve("seq-113", (1, 1, 3), "m24", "seq"),
        _serve("none-113", (1, 1, 3), "m24", "none", attn_fallback="none")],
    4: [_serve("kv-114", (1, 1, 4), "m24", "kv"),
        _serve("heads-122", (1, 2, 2), "m24", "heads"),
        _hop("xfer_raw"), _hop("xfer_chunked"), _hop("xfer_global")],
}
CASES = {c["name"]: (world, c) for world, cs in WORLDS.items() for c in cs}
#: ``python -m repro_torch.serving.sharded`` (as torchrun runs it) on the
#: world of 4: the disaggregated step, then the base cells
CLI = (("--arch", ARCH, "--reduced", "--device", "cpu", "--mesh", "2,1,2",
        "--variant", "xfer_chunked", "--prompt-len", "16",
        "--new-tokens", "4"),
       ("--arch", ARCH, "--reduced", "--device", "cpu", "--mesh", "1,2,2",
        "--prompt-len", "16", "--new-tokens", "4"))
SERVE = [n for n, (_, c) in CASES.items() if c["kind"] == "serve"]
HOPS = [n for n, (_, c) in CASES.items() if c["kind"] == "hop"]


@functools.lru_cache(maxsize=None)
def jax_ref(ref):
    """The JAX unsharded prefill of the prompt at ``REFS[ref]`` slots and
    ``STEPS`` ``serve_step``s on its own greedy tokens: the arrays the
    ranks load (parameters as bits, the prompt, the step inputs) and the
    results they are held against."""
    cfg = jget(ARCH).reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)
    out = jax.jit(functools.partial(jprefill_step, cfg=cfg,
                                    max_seq=REFS[ref]))(params,
                                                        {"tokens": toks})
    step = jax.jit(functools.partial(jserve_step, cfg=cfg))
    st = JState(cache=out.state.cache, cache_len=out.state.cache_len)
    tok, inputs, logits = out.first_token, [], []
    for _ in range(STEPS):
        inputs.append(np.asarray(tok))
        lg, st = step(params, tok[:, None], st)
        logits.append(np.asarray(lg, np.float32))
        tok = jax.numpy.argmax(lg, axis=-1).astype(jax.numpy.int32)
    arrays = {"tokens": toks, "max_seq": np.int64(REFS[ref]),
              "step_inputs": np.stack(inputs)}
    for p, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(k.key) for k in p)
        arrays["params/" + key] = np.asarray(x).view(np.uint16)
    res = {"first_token": np.asarray(out.first_token),
           "last_logits": np.asarray(out.last_logits, np.float32),
           "cache": {k: np.asarray(v, np.float32)
                     for k, v in out.state.cache.items()},
           "after": {k: np.asarray(v, np.float32) for k, v in st.cache.items()},
           "step_logits": np.stack(logits), "greedy": np.stack(
               [np.asarray(t) for t in inputs[1:]] + [np.asarray(tok)], 1),
           "cache_like": out.state.cache}
    return arrays, res


def _run_world(world, tmp):
    ref_dir, out_dir = tmp / "ref", tmp / f"out{world}"
    ref_dir.mkdir(exist_ok=True)
    out_dir.mkdir()
    (tmp / f"w{world}").mkdir()
    torch_ranks.run_world(torch_ranks.serve_tp_world, world, tmp / f"w{world}",
                          str(ref_dir), str(out_dir), WORLDS[world],
                          CLI if world == 4 else (), timeout=150.0)
    return ([json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(world)],
            [np.load(out_dir / f"rank{r}.npz") for r in range(world)],
            [[(out_dir / f"cli{i}_rank{r}.txt").read_text()
              for r in range(world)] for i in range(len(CLI))]
            if world == 4 else [])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world run once for the module, concurrently: ``world ->
    (summaries, arrays)`` rank by rank."""
    tmp = tmp_path_factory.mktemp("serve_tp")
    (tmp / "ref").mkdir()
    for ref in REFS:
        np.savez(tmp / "ref" / f"{ref}.npz", **jax_ref(ref)[0])
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {w: ex.submit(_run_world, w, tmp) for w in WORLDS}
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


def _jax_block(x: np.ndarray, case, name: str, coord) -> np.ndarray:
    """``x``'s block at ``coord`` under the JAX policy's cache spec of
    ``name`` (the policy on an ``AbstractMesh`` of the case's shape)."""
    shape = tuple(case["shape"])
    pol = JPolicy(AbstractMesh(shape, AXES),
                  pd_disaggregated=case.get("pd", False),
                  attn_fallback=case["attn_fallback"] if "attn_fallback"
                  in case else "seq")
    like = jax_ref(case["ref"])[1]["cache_like"]
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
    ref = jax_ref(case["ref"])[1]
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
    ref = jax_ref(case["ref"])[1]
    m = REFS[case["ref"]]
    for s, a, r in ranks:
        for leaf in ("k", "v"):
            for got, whole in ((a[leaf], ref["cache"][leaf]),
                               (a[leaf + "_after"], ref["after"][leaf])):
                want = _jax_block(whole, case, leaf, s["coord"])
                np.testing.assert_allclose(_bf16(got), want, atol=ATOL,
                                           rtol=RTOL, err_msg=f"rank {r} {leaf}")
        # the prefill's blocks hold zeros past the prompt, bitwise
        span = m // s["tp_size"] if s["cache_split"] else m
        start = s["tp_rank"] * span if s["cache_split"] else 0
        past = max(0, S - start)
        assert not a["k"][:, :, past:].any() and not a["v"][:, :, past:].any()


@pytest.mark.parametrize("name", SERVE)
def test_serve_step_teacher_forced(worlds, name):
    case, ranks = _ranks(worlds, name)
    ref = jax_ref(case["ref"])[1]
    agree = []
    for s, a, r in ranks:
        rows = s["rows"]
        np.testing.assert_allclose(a["step_logits"],
                                   _cols(ref["step_logits"][:, rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        agree.append(float(np.mean(np.asarray(s["greedy"])
                                   == ref["greedy"][rows])))
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
    against JAX for as long as its greedy tokens are JAX's (then every
    step's input is the same)."""
    case, ranks = _ranks(worlds, name)
    ref = jax_ref(case["ref"])[1]
    held = 0
    for s, a, r in ranks:
        rows = s["rows"]
        if s["pod"] == 0:
            np.testing.assert_allclose(a["last_logits"],
                                       _cols(ref["last_logits"][rows], s),
                                       atol=ATOL, rtol=RTOL)
            continue
        toks = np.asarray(s["tokens"])
        same = (toks == ref["greedy"][rows]).all(axis=0)
        n = STEPS if same.all() else int(np.argmin(same)) + 1
        np.testing.assert_allclose(a["step_logits"][:n],
                                   _cols(ref["step_logits"][:n, rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        held += n
    assert held >= 2


@pytest.mark.parametrize("world", list(WORLDS))
def test_merge_partials_equals_whole_attention(worlds, world):
    for s in worlds[world][0]:
        assert s["units"]["merge_max_abs"] <= MERGE_ATOL


@pytest.mark.parametrize("world", list(WORLDS))
def test_vocab_argmax_forced_ties(worlds, world):
    want = [0, (world - 1) * 5 + 1, 9]
    for s in worlds[world][0]:
        assert s["units"]["argmax"] == s["units"]["argmax_whole"] == want


@pytest.mark.parametrize("world", list(WORLDS))
def test_params_from_jax_placed_equals_init_params_place(worlds, world):
    for s in worlds[world][0]:
        assert s["placed_draws"] and all(s["placed_draws"].values())


def test_sharded_cli_runs_both_cells(worlds):
    """``python -m repro_torch.serving.sharded``: the disaggregated step
    prints each hop's bytes on every rank and pod 1's tokens (B 2 x 4);
    the base cells print each data rank's row of tokens."""
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

"""Sharded serving under FSDP across gloo ranks, on the CPU: each layer's
parameter blocks gathered over ``data`` just before its products
(``distributed/fsdp.py``), held bitwise against the same world serving
with ``fsdp`` off, and the dense family against the JAX package.

One world of 4 ranks runs every case twice, ``ShardingPolicy(fsdp=False)``
then ``fsdp=True`` on the same mesh, the same seeded draws cut to each
policy's blocks (``serving/sharded.place_params``) and the same prompt:

* (1, 2, 2), ``serve`` (prefill, then ``STEPS`` greedy decode steps) of
  every family reduced: dense smollm-135m, MLA minicpm3-4b, MoE
  qwen3-moe-30b-a3b under ``ExpertParallel``, mamba2-2.7b,
  recurrentgemma-9b at 5 layers (a triple and two extra blocks, so the
  ``triples`` and ``extra`` stacks both gather), pixtral-12b (8 patches
  before 7 tokens) and hubert-xlarge (its prefill cell alone);
* (2, 2, 1) under ``pd_disaggregated``, ``disaggregated_step`` with
  ``xfer_chunked`` on dense smollm: pod 0 prefills and ships its shards,
  pod 1 decodes ``STEPS`` tokens, each pod gathering within itself.

Held bitwise, ``fsdp`` on against off on every rank: the first token, the
greedy tokens, the last logits, every step's logits, the cache blocks
after the prefill and after the steps; for the hop also its
``TransferStats``, the side message's bytes, the shards each pod-0 rank
sent and each pod-1 rank received, and pod 1's tokens and logits.  A
gather moves bits and adds no arithmetic, so nothing looser holds.

Held exactly: each rank's parameter bytes equal ``held_bytes`` under the
``fsdp`` specs (and under the unblocked specs with ``fsdp`` off); the
gathers' bytes equal the spec arithmetic
(``torch_ranks.fsdp_gathers``): a pass
gathers each layer's ``data``-split blocks in one all-gather (a triple
or an extra block of the hybrid is one layer), the embedding's leaves at
the first read (a vision prompt's ``embed`` and ``frontend_proj`` in one,
an audio prompt's ``frontend_proj``) and the head's (``final_norm`` with
``lm_head``, or with ``embed`` where tied: the table is gathered again at
that read) in one each, every block padded to 16 bytes.  So a pass of
reduced smollm is 4 all-gathers (2 layers); the prefill is one pass, and
each decode step another (the embedding read being ``embed`` alone).
With ``fsdp`` off nothing is gathered.

Against JAX: the dense ``fsdp`` run on numpy-seeded parameters
(``params_from_jax(policy=)``) and prompt, its first token exactly and
its last logits and decode logits (for as long as its greedy tokens are
JAX's) within ``tests/test_torch_serve_tp.py``'s bounds, ATOL 4e-2 /
RTOL 2e-2, for that file's reasons (the sharded sums' order).  The JAX
steps run without a policy: its sharded lowering does not run on jax
0.9.0 (ROADMAP queue 3).  ``python -m repro_torch.serving.sharded
--variant fsdp`` serves the same tokens as ``--variant base``.
"""

import concurrent.futures
import dataclasses
import functools
import json

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_ranks  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models.kvcache import DecodeState as JState  # noqa: E402
from repro.serving.decode import serve_step as jserve_step  # noqa: E402
from repro.serving.prefill import prefill_step as jprefill_step  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.distributed import fsdp as FS  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ATOL, RTOL = 4e-2, 2e-2
B, S, STEPS, MAX_SEQ = 4, 12, 3, 24
DENSE = "smollm-135m"
#: family -> its reduced config's arch, depth override and prompt positions
FAMILIES = {
    "dense": dict(arch=DENSE, ref="dense"),
    "mla": dict(arch="minicpm3-4b"),
    "moe": dict(arch="qwen3-moe-30b-a3b"),
    "ssm": dict(arch="mamba2-2.7b"),
    "hybrid": dict(arch="recurrentgemma-9b", over={"num_layers": 5}),
    "vlm": dict(arch="pixtral-12b", prompt=15),
    "audio": dict(arch="hubert-xlarge"),
}
CASES = [dict(kind="serve", name=fam, shape=[1, 2, 2], batch=B,
              prompt=c.get("prompt", S), max_seq=MAX_SEQ, steps=STEPS,
              seed=5, **{k: v for k, v in c.items() if k != "prompt"})
         for fam, c in FAMILIES.items()]
CASES.append(dict(kind="hop", name="hop", arch=DENSE, shape=[2, 2, 1],
                  variant="xfer_chunked", batch=B, prompt=S, max_seq=MAX_SEQ,
                  steps=STEPS, seed=7))
#: ``python -m repro_torch.serving.sharded`` on the world: the base cells,
#: then the same under ``--variant fsdp``
CLI = tuple(("--arch", DENSE, "--reduced", "--device", "cpu", "--mesh",
             "1,2,2", "--prompt-len", "16", "--new-tokens", "3")
            + (("--variant", v) if v else ()) for v in (None, "fsdp"))


def _numpy_params(cfg):
    """Seeded numpy parameters of ``cfg``'s shapes: bf16 leaves as their
    uint16 bits (norm scales near 1, the tables at 0.02, the rest at
    d_model ** -0.5, ``w_down`` at d_ff ** -0.5)."""
    rng = np.random.default_rng(0)
    out = {}
    for p, x in TR.flatten_with_path(TM.abstract_params(cfg))[0]:
        path = SH.path_str(p)
        name, shape = path.split("/")[-1], tuple(x.shape)
        z = rng.standard_normal(shape)
        if len(shape) - SH.stack_dims(path) == 1:
            a = 1.0 + 0.1 * z
        elif name in ("embed", "lm_head"):
            a = 0.02 * z
        else:
            a = z * (cfg.d_ff if name == "w_down" else cfg.d_model) ** -0.5
        t = torch.from_numpy(a.astype(np.float32)).to(x.dtype)
        out[path] = (t.view(torch.int16).numpy().view(np.uint16)
                     if x.dtype == torch.bfloat16 else t.numpy())
    return out


@functools.lru_cache(maxsize=None)
def ref_arrays():
    """The arrays the ranks load: numpy-seeded parameters (bf16 as bits,
    under ``params/<path>``), the prompt, the cache slots."""
    cfg = get_config(DENSE).reduced()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)
    return {"tokens": toks, "max_seq": np.int64(MAX_SEQ),
            **{"params/" + k: v for k, v in _numpy_params(cfg).items()}}


@functools.lru_cache(maxsize=None)
def jax_ref():
    """The JAX unsharded prefill and ``STEPS`` greedy ``serve_step``s on
    :func:`ref_arrays`."""
    arrays = ref_arrays()
    toks = arrays["tokens"]
    params: dict = {}
    for key, a in arrays.items():
        if not key.startswith("params/"):
            continue
        path = key[len("params/"):]
        node = params
        *keys, leaf = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                                 else a)
    jcfg = jget(DENSE).reduced()
    out = jax.jit(functools.partial(jprefill_step, cfg=jcfg,
                                    max_seq=MAX_SEQ))(params, {"tokens": toks})
    step = jax.jit(functools.partial(jserve_step, cfg=jcfg))
    st = JState(cache=out.state.cache, cache_len=out.state.cache_len)
    tok, logits, greedy = out.first_token, [], []
    for _ in range(STEPS):
        lg, st = step(params, tok[:, None], st)
        logits.append(np.asarray(lg, np.float32))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        greedy.append(np.asarray(tok))
    return {"first_token": np.asarray(out.first_token),
                    "last_logits": np.asarray(out.last_logits, np.float32),
                    "step_logits": np.stack(logits),
                    "greedy": np.stack(greedy, 1)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of 4 run once for the module, the JAX steps beside it:
    each rank's summary and arrays, the CLI's outputs."""
    tmp = tmp_path_factory.mktemp("serve_fsdp")
    ref_dir, out_dir = tmp / "ref", tmp / "out"
    ref_dir.mkdir()
    out_dir.mkdir()
    (tmp / "w").mkdir()
    np.savez(ref_dir / "dense.npz", **ref_arrays())
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(torch_ranks.run_world, torch_ranks.serve_fsdp_world,
                          4, tmp / "w", str(ref_dir), str(out_dir), CASES,
                          CLI, timeout=240.0)
        jax_ref()
        ranks.result()
    return ([json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(4)],
            [np.load(out_dir / f"rank{r}.npz") for r in range(4)],
            [[(out_dir / f"cli{i}_rank{r}.txt").read_text()
              for r in range(4)] for i in range(len(CLI))])


def _runs(world, name):
    return [(r, s[name]) for r, s in enumerate(world[0])]


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_fsdp_serving_is_the_unblocked_serving_bitwise(world, fam):
    for r, s in _runs(world, fam):
        on, off = s["on"], s["off"]
        for k in ("first", "tokens", "last_logits", "steps", "prefill_cache",
                  "cache", "cache_len"):
            assert on[k] == off[k], (fam, r, k)
        assert len(on["steps"]) == (0 if fam == "audio" else STEPS)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_fsdp_held_bytes_and_gathers_match_the_specs(world, fam):
    """Held bytes are the ``fsdp`` spec arithmetic (half the unblocked
    bytes or more: small leaves stay whole); the gathers' bytes and
    all-gathers are ``torch_ranks.fsdp_gathers``', received once from the
    other data rank; nothing is gathered with ``fsdp`` off."""
    c = FAMILIES[fam]
    want = torch_ranks.fsdp_gathers(c["arch"], (1, 2, 2), c.get("over"), STEPS)
    n = want["decode_steps"]
    sent = want["prefill"][0] + n * want["step"][0]
    calls = want["prefill"][1] + n * want["step"][1]
    assert calls == (1 + n) * (want["layer_calls"] + 2)
    for r, s in _runs(world, fam):
        on, off = s["on"], s["off"]
        assert on["held"] == on["spec"] and off["held"] == off["spec"], r
        assert off["held"] / 2 <= on["held"] < off["held"], r
        assert on["gather"] == [sent, sent, calls], (fam, r)
        assert off["gather"] == [0, 0, 0], (fam, r)


def test_fsdp_hop_is_the_unblocked_hop_bitwise(world):
    by = {}
    for r, s in _runs(world, "hop"):
        on, off = s["on"], s["off"]
        for k in ("pod", "stats", "side_bytes", "shards", "first", "tokens",
                  "steps"):
            assert on[k] == off[k], (r, k)
        c = s["coord"]
        by[(c["pod"], c["data"], c["model"])] = on
    for (pod, d, m), on in by.items():
        if pod == 1:
            src = by[(0, d, m)]
            assert on["shards"] == src["shards"], (d, m)
            assert on["stats"] == src["stats"] and on["first"] == src["first"]
            assert len(on["steps"]) == STEPS and on["side_bytes"] > 0


def test_fsdp_hop_gathers_within_each_pod(world):
    """Pod 0 gathers for its prefill, pod 1 for its decode steps, each over
    its own ``data`` pair: the bytes of the specs, held bytes exact."""
    want = torch_ranks.fsdp_gathers(DENSE, (2, 2, 1), steps=STEPS)
    for r, s in _runs(world, "hop"):
        on, off = s["on"], s["off"]
        got = (want["prefill"] if on["pod"] == 0 else
               (STEPS * want["step"][0], STEPS * want["step"][1]))
        assert on["gather"] == [got[0], got[0], got[1]], r
        assert off["gather"] == [0, 0, 0], r
        assert on["held"] == on["spec"] < off["held"] == off["spec"], r


def _cols(x, s):
    if not s["vocab_split"]:
        return x
    n = x.shape[-1] // s["tp_size"]
    return x[..., s["tp_rank"] * n:(s["tp_rank"] + 1) * n]


def test_fsdp_dense_serving_matches_jax(world):
    ref = jax_ref()
    held = 0
    for r, (s, a) in enumerate(zip(world[0], world[1])):
        s, rows = s["dense"], s["dense"]["rows"]
        assert s["on"]["first"] == ref["first_token"][rows].tolist(), r
        np.testing.assert_allclose(a["dense/last_logits"],
                                   _cols(ref["last_logits"][rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        toks = np.asarray(s["on"]["tokens"])
        same = (toks == ref["greedy"][rows]).all(axis=0)
        n = STEPS if same.all() else int(np.argmin(same)) + 1
        np.testing.assert_allclose(a["dense/step_logits"][:n],
                                   _cols(ref["step_logits"][:n, rows], s),
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        held += n
    assert held >= 4


def test_block_gather_is_the_identity_without_data_blocks():
    """No ``data`` axis of more than one rank, or ``fsdp`` off: no leaf to
    gather, and a layer comes back as given.  On (1, 2, 2) the gather's
    leaves are exactly those whose ``fsdp`` spec names ``data``: a leaf
    ``_add_fsdp`` leaves whole is skipped by its spec."""
    cfg = get_config(DENSE).reduced()
    like = TM.abstract_params(cfg)
    lp = TM.layer_params(like["layers"], 0)
    for sizes, fsdp in (({"pod": 1, "data": 1, "model": 2}, True),
                        ({"pod": 1, "data": 2, "model": 2}, False)):
        g = FS.BlockGather(SH.ShardingPolicy(sizes, fsdp=fsdp), like)
        assert g.specs == {} and g.layer(lp, "layers") is lp
        assert g.top(like, ("embed",))["embed"] is like["embed"]
        assert g.calls == 0 and g.comm.sent_bytes == 0
    sizes = {"pod": 1, "data": 2, "model": 2}
    pol = SH.ShardingPolicy(sizes, fsdp=True)
    g = FS.BlockGather(pol, like)
    flat = TR.flatten_with_path(like)[0]
    assert set(g.specs) == {
        SH.path_str(p) for p, x in flat if any(
            "data" in SH.entry_axes(e)
            for e in pol.spec_for_param(SH.path_str(p), tuple(x.shape)))}
    small = dataclasses.replace(cfg, d_model=6)   # norms under 4 x data
    g = FS.BlockGather(pol, TM.abstract_params(small))
    assert "layers/norm1" not in g.specs and "final_norm" not in g.specs


def test_sharded_cli_serves_fsdp(world):
    """``--variant fsdp`` prints each rank's gathers and the tokens of
    ``--variant base``, row by row."""
    base, fsdp = world[2]
    got = [[ln.split("tokens ")[1] for text in run for ln in text.splitlines()
            if " tokens " in ln] for run in (base, fsdp)]
    assert len(got[0]) == 2 and got[0] == got[1]
    gathers = [ln for out in fsdp for ln in out.splitlines()
               if "fsdp gathers" in ln]
    assert len(gathers) == 4
    assert not any("fsdp gathers" in ln for out in base
                   for ln in out.splitlines())

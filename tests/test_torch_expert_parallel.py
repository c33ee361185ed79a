"""The port's MoE training under the model and data axes (expert
parallelism with global-batch routing) and pods without the ring, across
gloo ranks on the CPU, against the JAX package.

The JAX step under a ``ShardingPolicy`` does not run on jax 0.9 (ROADMAP
queue 3), and GSPMD's contract is that sharding does not change the
function, so the port's step (``make_train_step(policy=)``,
``distributed/expert_parallel.py``) is held against
``jax.jit(make_train_step(cfg))`` without a policy (for a MoE case its
arithmetic, ``value_and_grad(loss_fn)`` then ``optimizer.update``, with
the routing replayed: below), on the same initial
state (the JAX seeded init, bitwise) and the same numpy global batches:
two steps of batch 8 x 16 at reduced qwen3-moe-30b-a3b (8 experts top-2)
with ``capacity_factor`` 1.0, where the JAX reference drops choices and a
data rank's own capacity (16 at data 2) is not the group's (32).  Cases:
(1, 1, 2) experts split; (1, 1, 3) 8 experts do not split, the FFN
replicated; (1, 2, 1) global routing over data; (1, 2, 2) FSDP on and
off; (2, 1, 1) without the ring, pods as a batch axis (MoE, and reduced
smollm-135m); (2, 2, 1) with ``grad_compress``, routing per pod, held
against the JAX step's pod split (``vmap(value_and_grad)`` over the
pods, ``compressed_cross_pod_mean``, ``OPT.update``) in a subprocess on 2
host devices.

Routing is not continuous.  A token whose k-th and (k+1)-th router
probabilities are closer than bf16 round-off moves can take another
expert; then its hidden state, the later positions of its row and every
gradient move by O(1) / T.  On these inputs the single-process port
already routes 1 of 128 tokens at layer 0 and 3 at layer 1 otherwise than
JAX: left to route for itself, its moments after one step land 33% from
JAX's, its second loss 5.2e-3 away, and after one step 477 of the 16,384
embedding elements have moved 1.5-2 lr the other way (parameters 4.7e-3
from JAX's, of the 5e-3 bound).  So the JAX step of a MoE case is made to
route as the sharded run did: each rank records its layers' top-k
experts, and the JAX ``moe_ffn`` takes them in place of
``jax.lax.top_k``'s (:func:`jax_forcing`; the gates are JAX's own
probabilities there, renormalized), a (T, k) leaf a layer riding the
layer scan beside the FFN's parameters.  Capacity, ranks within experts,
drops, the balance loss and every gradient stay JAX's.  Each case holds:

* against JAX so routed (the ring's case: its pod split, each pod routed
  as its ranks did): both steps' loss and cross-entropy within
  ``CE_ATOL`` = 2e-3, aux within ``AUX_RTOL`` = 2e-2, grad norm within
  rtol 5e-3 and lr exactly, and the state after each step, parameters
  within ``PARAM_RTOL`` = 5e-3 and AdamW moments within ``GRAD_RTOL`` =
  5e-2 (seen: 1.6e-3 and 2.5e-2 at most).  Reduced smollm (no routing)
  is held to the plain JAX step alike;
* against JAX routing for itself, the MoE cases without the ring: the
  first step's metrics and the parameters after it, within the same
  bounds (seen: 4.74e-3; the ring's case reads 5.2e-3 and is held only
  as routed);
* against the single-process port routed alike (a second witness; the
  ring's case one loss a pod, the pods' gradients averaged in f32): the
  metrics and the final state within the same bounds (seen: 1.1e-3 and
  2.2e-2);
* exactly: the routing collectives (below); FSDP on = off bitwise; every
  rank gathers the same state; the leaves replicated over ``model`` are
  bitwise the same on the ranks of one (pod, data) coordinate; a rank
  holds the bytes its specs give; the leaf-by-leaf placed init is bitwise
  ``shard_state`` of the whole one; no parameter is gathered over
  ``model``; each layer's capacity is the routing group's, and it drops.

The routing collectives alone: R gloo ranks given the blocks of one
(12, 8, 128) token set (capacity 24 over the group, 8-16 a rank) route
bitwise as ``route`` does on the whole (the same slots, drops, ``me``,
``fe`` and aux, and bitwise the same FFN output rows).  A rank's loss
is the mean of ``y . up`` over its rows plus 0.01 times the whole aux,
so its gradients carry R times the whole's share; at R a power of two
that scale is exact in bf16 and the data-reduced gradients land within
1e-5 of the whole batch's for the f32 router and the tokens (summation
order) and within 2^-8 for the bf16 expert weights (each rank's
gradient is rounded to bf16 before the f32 sum, as the step's are); at
R = 3 every bf16 intermediate rounds another value, within 1e-2.  All
within ``GRAD_RTOL`` of ``repro.models.moe.moe_ffn``'s on the same
inputs.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import textwrap

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_ranks  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.distributed.sharding import ShardingPolicy  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402

CE_ATOL, AUX_RTOL, GRAD_RTOL, PARAM_RTOL = 2e-3, 2e-2, 5e-2, 5e-3
CAPACITY_FACTOR = 1.0
OPT = dict(lr=3e-4, total_steps=2, warmup_steps=1)
BATCH, SEQ, STEPS, KV_BLOCK = 8, 16, 2, 16
MOE = "qwen3-moe-30b-a3b"
ROUTE_SHAPE = (12, 8)     # the routing collectives' (B, S) token set
# the launcher on 2 ranks: pods without the ring, a MoE config
SINGLE = ["--arch", "qwen3-moe-30b-a3b", "--reduced", "--batch", "4", "--seq",
          "16", "--device", "cpu", "--steps", "2"]
LAUNCH = SINGLE + ["--mesh", "2"]


def _case(name, arch, shape, fsdp=False, grad_compress=False):
    return dict(name=name, arch=arch, shape=list(shape), fsdp=fsdp,
                grad_compress=grad_compress, ref=arch)


# world size -> (its step cases, the meshes of its routing-collective runs);
# the world of 4 first, so that the JAX ring's subprocess, which replays
# its routing, runs beside the other worlds
WORLDS = {
    4: ([_case("moe-122-fsdp", MOE, (1, 2, 2), fsdp=True),
         _case("moe-122", MOE, (1, 2, 2)),
         _case("moe-221-ring", MOE, (2, 2, 1), grad_compress=True)],
        [(1, 4, 1), (1, 2, 2)]),
    2: ([_case("moe-112", MOE, (1, 1, 2)), _case("moe-121", MOE, (1, 2, 1)),
         _case("moe-211", MOE, (2, 1, 1)),
         _case("smollm-211", "smollm-135m", (2, 1, 1))],
        [(1, 2, 1), (1, 1, 2)]),
    3: ([_case("moe-113", MOE, (1, 1, 3))], [(1, 3, 1)]),
}
CASES = {c["name"]: (world, c) for world, (cs, _) in WORLDS.items() for c in cs}
# the MoE cases without the ring, held also against JAX's own routing
FREE = [n for n, (_, c) in CASES.items()
        if c["arch"] == MOE and not c["grad_compress"]]
ROUTES = {(world, ",".join(map(str, m))): m for world, (_, ms) in WORLDS.items()
          for m in ms}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _f32(bits: np.ndarray) -> np.ndarray:
    """A rank's leaf bits (int16: bf16, int32: f32) as f32 values."""
    if bits.dtype == np.int16:
        return (bits.astype(np.int32) << 16).view(np.float32)
    return bits.view(np.float32)


def _jax_config(arch):
    jc = jget(arch).reduced()
    if jc.moe is None:
        return jc
    return dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=CAPACITY_FACTOR))


def _bf16_bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


@functools.lru_cache(maxsize=None)
def jax_inputs(arch):
    """The JAX seeded initial state, the numpy global batches, and the
    arrays the ranks load."""
    jc = _jax_config(arch)
    state = JTS.init_state(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    batches = [{"tokens": rng.integers(0, jc.vocab_size, (BATCH, SEQ)).astype(np.int32),
                "labels": rng.integers(0, jc.vocab_size, (BATCH, SEQ)).astype(np.int32)}
               for _ in range(STEPS)]
    arrays = {f"batch{i}/{k}": v for i, b in enumerate(batches)
              for k, v in b.items()}
    for p, x in jax.tree_util.tree_flatten_with_path(state)[0]:
        arrays["state/" + jax.tree_util.keystr(p)] = _bf16_bits(x) \
            if x.dtype == jnp.bfloat16 else np.asarray(x)
    return state, batches, arrays


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _by_key(state):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(state)[0]}


@functools.lru_cache(maxsize=None)
def jax_ref(arch):
    """The JAX unsharded step's states after each step (leaves as f32 by
    keystr) and its metrics."""
    state, batches, _ = jax_inputs(arch)
    step = jax.jit(JTS.make_train_step(_jax_config(arch), JO.AdamWConfig(**OPT),
                                       None, kv_block=KV_BLOCK))
    s, states, metrics = state, [], []
    for b in batches:
        s, m = step(s, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(_by_key(s))
        metrics.append(_metrics(m))
    return states, metrics


def _forced(by_pod) -> np.ndarray:
    """One step's routes ``[pod][layer]`` -> (T, k) as a (pods, L, T, k)
    int32 array."""
    return np.stack([np.stack(layers) for layers in by_pod]).astype(np.int32)


@contextlib.contextmanager
def jax_forcing():
    """The JAX ``moe_ffn`` routed to forced experts: a ``forced`` (T, k)
    leaf beside the FFN's parameters (it rides the layer scan) replaces
    ``jax.lax.top_k``'s choices, and the gates are the probabilities
    gathered there.  Active while a function is traced."""
    ffn, top_k = JMOE.moe_ffn, jax.lax.top_k

    def forced_ffn(p, x, cfg):
        idx = p["forced"]
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
def _jax_forced_step(arch):
    """``jax.jit`` of the JAX step (``make_train_step``'s arithmetic:
    ``value_and_grad(loss_fn)``, ``optimizer.update``) with each MoE
    layer's experts given: ``step(state, batch, forced (L, T, k))``."""
    jc, opt_cfg = _jax_config(arch), JO.AdamWConfig(**OPT)

    def loss(params, batch, forced):
        layers = dict(params["layers"],
                      ffn=dict(params["layers"]["ffn"], forced=forced))
        return JM.loss_fn(dict(params, layers=layers), batch, jc,
                          kv_block=KV_BLOCK)

    def step(state, batch, forced):
        (total, (ce, aux)), grads = jax.value_and_grad(loss, has_aux=True)(
            state.params, batch, forced)
        params, opt, om = JO.update(opt_cfg, grads, state.opt, state.params)
        return JTS.TrainState(params=params, opt=opt), \
            {"loss": total, "ce": ce, "aux": aux, **om}
    return jax.jit(step)


def jax_replay(arch, routes):
    """The JAX unsharded step from the JAX initial state on the same
    batches, each MoE layer routed as ``routes`` (one routing group:
    ``[step][0][layer]``): the states after each step (leaves as f32 by
    keystr) and the metrics."""
    state, batches, _ = jax_inputs(arch)
    step = _jax_forced_step(arch)
    states, metrics = [], []
    with jax_forcing():
        for b, by_pod in zip(batches, routes):
            (forced,) = _forced(by_pod)
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            jnp.asarray(forced))
            states.append(_by_key(state))
            metrics.append(_metrics(m))
    return states, metrics


def _routes(name, world, out_dir):
    """The sharded run's top-k experts, ``[step][pod][layer]`` -> (T, k):
    each rank's records (``torch_ranks._ep_case``) in the batch's block
    order (model ranks hold the same tokens; model 0's are taken), split
    into the pods that route apart (the ring's) or one group."""
    _, case = CASES[name]
    pods, data, model = case["shape"]
    groups = pods if case["grad_compress"] else 1
    recs = {}
    for r in range(world):
        pod, d, m = np.unravel_index(r, (pods, data, model))
        if m == 0:
            recs[pod * data + d] = np.load(out_dir / f"{name}.rank{r}.npz")
    calls = len(recs[0].files)
    layers = calls // STEPS
    blocks = len(recs) // groups
    return [[[np.concatenate([recs[g * blocks + b][f"route/{i * layers + l}"]
                              for b in range(blocks)])
              for l in range(layers)] for g in range(groups)]
            for i in range(STEPS)]


def port_replay(arch, routes):
    """The single-process port's steps from the JAX initial state on the
    same batches, each MoE layer routed to the experts ``routes`` gives
    (``[step][pod][layer]``; :func:`_routes`): the gates are the replay's
    own probabilities at those experts.  With more than one pod each pod's
    slice of the batch is one loss, and the pods' gradients are averaged
    in f32 (the JAX step's pod split).  Returns the final leaves as f32 by
    keystr and the metrics."""
    from repro_torch.core import tree as TR
    from repro_torch.models.weights import train_state_from_jax
    from repro_torch.training import optimizer as TO
    state, batches, _ = jax_inputs(arch)
    tc = torch_ranks._moe_config(arch, CAPACITY_FACTOR)
    s = train_state_from_jax(jax.tree.map(np.asarray, state))
    opt_cfg = TO.AdamWConfig(**OPT)
    forced, orig = [], TMOE.top_k

    def replayed(probs, k):
        idx = torch.from_numpy(forced.pop(0)).to(torch.int64)
        return probs.gather(-1, idx), idx

    metrics = []
    TMOE.top_k = replayed
    try:
        for b, by_pod in zip(batches, routes):
            n = len(by_pod)
            rows = BATCH // n
            outs, grads = [], []
            for g, layers in enumerate(by_pod):
                forced[:] = list(layers)
                part = {k: torch.from_numpy(v[g * rows:(g + 1) * rows])
                        for k, v in b.items()}
                out, gr = TTS.value_and_grad(s.params, part, tc,
                                             kv_block=KV_BLOCK, remat=False)
                assert not forced
                outs.append(out)
                grads.append(TR.leaves(gr))
            mean = [(sum(x.float() for x in xs) / n).to(xs[0].dtype)
                    for xs in zip(*grads)]
            params, opt, om = TO.update(
                opt_cfg, TR.unflatten(TR.flatten_with_path(s.params)[1], mean),
                s.opt, s.params)
            s = TTS.TrainState(params=params, opt=opt)
            total = sum(float(o[0]) for o in outs) / n
            ce = sum(float(o[1][0]) for o in outs) / n
            aux = sum(float(o[1][1]) for o in outs) / n
            metrics.append({"loss": total, "ce": ce, "aux": aux,
                            **_metrics(om)})
    finally:
        TMOE.top_k = orig
    return {torch_ranks._keystr(p): x.float().numpy()
            for p, x in TR.flatten_with_path(s)[0]}, metrics


@functools.lru_cache(maxsize=None)
def jax_drops():
    """The JAX reference's dropped choices per layer on the first batch
    (the forward from the initial state): each expert's choices past its
    capacity, counted inside the JAX ``moe_ffn`` by a host callback."""
    state, batches, _ = jax_inputs(MOE)
    jc = _jax_config(MOE)
    seen, orig = [], JMOE.moe_ffn

    def counting(p, x, cfg):
        t = x.shape[0] * x.shape[1]
        cap = JMOE.capacity(t, cfg)
        probs = jax.nn.softmax(jnp.einsum(
            "td,de->te", x.reshape(t, -1).astype(jnp.float32), p["router"]), -1)
        idx = jax.lax.top_k(probs, cfg.top_k)[1].reshape(-1)
        counts = jnp.zeros((cfg.num_experts,), jnp.int32).at[idx].add(1)
        jax.debug.callback(lambda n: seen.append(int(n)),
                           jnp.maximum(counts - cap, 0).sum())
        return orig(p, x, cfg)

    JMOE.moe_ffn = counting
    try:
        jax.block_until_ready(jax.jit(lambda p, b: JM.loss_fn(
            p, b, jc, kv_block=KV_BLOCK, remat=False))(
            state.params, {k: jnp.asarray(v) for k, v in batches[0].items()}))
        jax.effects_barrier()
    finally:
        JMOE.moe_ffn = orig
    return seen


JAX_RING_SCRIPT = textwrap.dedent(r"""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_config
    from repro.launch.mesh import make_mesh
    from repro.models import model as M
    from repro.models import moe as MOE
    from repro.serving import session as JS
    from repro.training import grad_compress as GC
    from repro.training import optimizer as OPT
    from repro.training import train_step as TS

    _build = JS.TransferSession._build_ring_fn
    JS.TransferSession._build_ring_fn = lambda self, *a: jax.jit(_build(self, *a))
    ref_dir, out_dir = sys.argv[1], sys.argv[2]
    meta = json.load(open(os.path.join(ref_dir, "ring.json")))
    cfg = get_config(meta["arch"]).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=meta["capacity_factor"]))
    mesh = make_mesh((2,), ("pod",))
    state = TS.init_state(cfg, jax.random.PRNGKey(0))
    ref = np.load(os.path.join(ref_dir, "ring.npz"))
    opt_cfg = OPT.AdamWConfig(**meta["opt"])

    # each layer routed to the recorded experts: the forced (T, k) choices
    # ride the layer scan beside the FFN's parameters, and top_k gathers
    # the probabilities there
    ffn, top_k = MOE.moe_ffn, jax.lax.top_k

    def forced_ffn(p, x, c):
        idx = p["forced"]
        jax.lax.top_k = lambda probs, k: (
            jnp.take_along_axis(probs, idx, -1), idx)
        try:
            return ffn({k: v for k, v in p.items() if k != "forced"}, x, c)
        finally:
            jax.lax.top_k = top_k
    MOE.moe_ffn = forced_ffn

    def pod_loss(params, b, forced):
        layers = dict(params["layers"],
                      ffn=dict(params["layers"]["ffn"], forced=forced))
        return M.loss_fn(dict(params, layers=layers), b, cfg,
                         kv_block=meta["kv_block"])

    vg = jax.jit(jax.vmap(jax.value_and_grad(pod_loss, has_aux=True),
                          in_axes=(None, 0, 0)))
    metrics, states = [], {}
    for i in range(meta["steps"]):
        batch = {k: jnp.asarray(ref[f"batch{i}/{k}"]) for k in ("tokens", "labels")}
        split = jax.tree.map(lambda x: x.reshape(2, x.shape[0] // 2, *x.shape[1:]),
                             batch)
        (totals, (ces, auxs)), stacked = vg(state.params, split,
                                            jnp.asarray(ref[f"forced{i}"]))
        grads = GC.compressed_cross_pod_mean(stacked, mesh)
        params, opt, om = OPT.update(opt_cfg, grads, state.opt, state.params)
        state = TS.TrainState(params=params, opt=opt)
        metrics.append({"loss": float(jnp.mean(totals)), "ce": float(jnp.mean(ces)),
                        "aux": float(jnp.mean(auxs)),
                        "grad_norm": float(om["grad_norm"]), "lr": float(om["lr"])})
        for p, x in jax.tree_util.tree_flatten_with_path(state)[0]:
            states[f"step{i + 1}/" + jax.tree_util.keystr(p)] = np.asarray(
                x, np.float32)
    json.dump(metrics, open(os.path.join(out_dir, "ring_metrics.json"), "w"))
    np.savez(os.path.join(out_dir, "ring_states.npz"), **states)
    print("RING-JAX-OK")
""")


def _subprocess_env():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def jax_ring_ref(ref_dir, out_dir, routes):
    """The JAX step's pod split with the compressed ring, in a subprocess
    on 2 host devices, each MoE layer of each pod routed as ``routes``
    (``[step][pod][layer]``; :func:`_routes`): its states after each step
    (leaves as f32 by keystr) and metrics."""
    _, _, arrays = jax_inputs(MOE)
    np.savez(ref_dir / "ring.npz", **{k: v for k, v in arrays.items()
                                      if k.startswith("batch")},
             **{f"forced{i}": _forced(by_pod)
                for i, by_pod in enumerate(routes)})
    (ref_dir / "ring.json").write_text(json.dumps(
        {"arch": MOE, "capacity_factor": CAPACITY_FACTOR, "opt": OPT,
         "steps": STEPS, "kv_block": KV_BLOCK}))
    out = subprocess.run([sys.executable, "-c", JAX_RING_SCRIPT, str(ref_dir),
                          str(out_dir)], capture_output=True, text=True,
                         env=_subprocess_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    saved = np.load(out_dir / "ring_states.npz")
    states = [{k.split("/", 1)[1]: saved[k] for k in saved.files
               if k.startswith(f"step{i + 1}/")} for i in range(STEPS)]
    return states, json.loads((out_dir / "ring_metrics.json").read_text())


@functools.lru_cache(maxsize=None)
def route_inputs():
    """One layer's MoE parameters, a (B, S, d) token set and an upstream
    gradient (numpy, seeded), and the JAX ``moe_ffn``'s output, aux and
    gradients of the rows' mean of ``y . up`` plus 0.01 aux."""
    jc = _jax_config(MOE)
    d, mc = jc.d_model, jc.moe
    e, f = mc.num_experts, mc.d_ff_expert
    rng = np.random.default_rng(11)

    def bf16(shape, scale):
        return np.asarray(jnp.asarray(rng.standard_normal(shape) * scale,
                                      jnp.bfloat16))

    p = {"router": (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32),
         "w_gate_up": bf16((e, d, 2 * f), d ** -0.5),
         "w_down": bf16((e, f, d), f ** -0.5)}
    x, up = bf16(ROUTE_SHAPE + (d,), 1.0), bf16(ROUTE_SHAPE + (d,), 1.0)

    def loss(p_, x_):
        y, aux = JMOE.moe_ffn(p_, x_, mc)
        return (y.astype(jnp.float32) * up.astype(jnp.float32)).sum(-1).mean() \
            + 0.01 * aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    arrays = {"x": _bf16_bits(x), "up": _bf16_bits(up), "router": p["router"],
              "w_gate_up": _bf16_bits(p["w_gate_up"]),
              "w_down": _bf16_bits(p["w_down"]),
              "capacity_factor": np.float32(CAPACITY_FACTOR)}
    return arrays, np.asarray(y, np.float32), float(aux), \
        {k: np.asarray(v, np.float32) for k, v in grads.items()}


@pytest.fixture(scope="module")
def ring_refs():
    """``(pool, futures)``: the JAX pod split's subprocess for each ring
    case (``futures[name]``), started as soon as its world has recorded
    the run's routing."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool, {}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, ring_refs):
    """Each world run once for the module: ``world -> (ranks, rank 0's
    arrays, out dir)``.  The JAX references run in a thread meanwhile, and
    a ring case's after it."""
    cache = {}

    def run(world):
        if world not in cache:
            tmp = tmp_path_factory.mktemp(f"ep{world}")
            ref = tmp / "ref"
            ref.mkdir()
            cases, meshes = WORLDS[world]
            archs = sorted({c["ref"] for c in cases})
            for arch in archs:
                np.savez(ref / f"{arch}.npz", **jax_inputs(arch)[2])
                (ref / f"{arch}.json").write_text(json.dumps(
                    {"opt": OPT, "steps": STEPS, "kv_block": KV_BLOCK,
                     "capacity_factor": CAPACITY_FACTOR}))
            np.savez(ref / "route.npz", **route_inputs()[0])
            out = tmp / "ranks"
            out.mkdir()
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                refs = pool.submit(lambda: [jax_ref(a) for a in archs])
                torch_ranks.run_world(torch_ranks.ep_train_world, world, tmp,
                                      str(ref), str(out), cases, meshes,
                                      LAUNCH if world == 2 else None,
                                      timeout=300)
                refs.result()
            ranks = [json.loads((out / f"rank{r}.json").read_text())
                     for r in range(world)]
            cache[world] = ranks, np.load(out / "rank0.npz"), out
            pool, futures = ring_refs
            for c in cases:
                if c["grad_compress"]:
                    ring = tmp / "ring"
                    ring.mkdir()
                    futures[c["name"]] = pool.submit(
                        jax_ring_ref, ring, ring, _routes(c["name"], world, out))
        return cache[world]
    return run


# ---------------------------------------------------------------------------
# the routing collectives alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,mesh", list(ROUTES), ids=[
    f"{w}ranks-{m.replace(',', 'x')}" for w, m in ROUTES])
def test_routing_collectives_bitwise_and_against_jax(worlds, world, mesh):
    ranks, got, _ = worlds(world)
    _, jy, jaux, jgrads = route_inputs()
    shape = ROUTES[(world, mesh)]
    for r in ranks:
        run = r["route"][mesh]
        assert run["group_size"] == shape[1]
        assert run["split_experts"] == (shape[2] > 1 and 8 % shape[2] == 0)
        for k in ("slots_bitwise", "out_bitwise", "aux_bitwise", "me_bitwise",
                  "fe_bitwise"):
            assert run[k], (k, r["coord"] if "coord" in r else None)
        assert run["drops"] == run["drops_whole"] > 0
        if shape[1] > 1:
            assert run["cap_local"] != run["cap"]
        # a rank's loss is the mean over its rows plus the whole balance
        # term, so its gradients are n times the whole's share (module
        # docstring of distributed/expert_parallel.py); at a power of two
        # the scale is exact in bf16, else every bf16 intermediate of the
        # backward rounds another value (seen at 3 ranks: 3.5e-3 to 6.2e-3)
        exact = shape[1] & (shape[1] - 1) == 0
        assert run["x_grad_rel"] <= (1e-5 if exact else 1e-2)
        # the f32 router's within f32 summation order; each rank's bf16
        # expert gradient is rounded once before the sum, as in the step
        assert run["grad_rel"]["router"] <= (1e-5 if exact else 1e-2)
        assert max(run["grad_rel"][k] for k in ("w_gate_up", "w_down")) \
            <= (2 ** -8 if exact else 1e-2), run["grad_rel"]
        np.testing.assert_allclose(run["aux"], jaux, rtol=1e-6)
    rows = got[f"route{mesh}/rows"]
    b, s = ROUTE_SHAPE
    want = jy.reshape(b, s, -1)[rows[0]:rows[1]]
    assert rel(want, got[f"route{mesh}/out"]) <= 1e-2
    for k, g in jgrads.items():
        if k in ("router", "w_gate_up", "w_down"):
            assert rel(g, got[f"route{mesh}/grad/{k}"]) <= GRAD_RTOL, k


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _hold(name, got, runs, states, metrics, *, moments=True):
    """Every rank's metrics against a reference's, step by step as far as
    ``metrics`` goes (loss and ce within ``CE_ATOL``, aux within
    ``AUX_RTOL``, grad norm rtol 5e-3, lr exact), and rank 0's gathered
    states against ``states`` (``{prefix: leaves}``: ``"step1/"`` after
    the first step, ``""`` the final one): the parameters within
    ``PARAM_RTOL``, with ``moments`` the AdamW moments within
    ``GRAD_RTOL``."""
    assert len({r["sha"] for r in runs}) == 1
    for r in runs:
        for tm, jm in zip(r["metrics"], metrics):
            assert tm["lr"] == jm["lr"]
            assert abs(tm["loss"] - jm["loss"]) <= CE_ATOL, (tm, jm)
            assert abs(tm["ce"] - jm["ce"]) <= CE_ATOL, (tm, jm)
            np.testing.assert_allclose(tm["aux"], jm["aux"], rtol=AUX_RTOL)
            np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                       rtol=5e-3)
    for prefix, state in states.items():
        for k, x in state.items():
            mine = got[f"{name}/{prefix}{k}"]
            if k == ".opt.step":
                assert int(mine) == (1 if prefix else STEPS)
            elif k.startswith(".params"):
                assert rel(x, _f32(mine)) <= PARAM_RTOL, \
                    (prefix, k, rel(x, _f32(mine)))
            elif moments:
                assert rel(x, _f32(mine)) <= GRAD_RTOL, \
                    (prefix, k, rel(x, _f32(mine)))


@pytest.mark.parametrize("name", list(CASES))
def test_ep_step_matches_port_on_its_routing(worlds, name):
    """The second witness: the single-process port on the run's routing."""
    world, case = CASES[name]
    ranks, got, out = worlds(world)
    final, metrics = port_replay(case["ref"], _routes(name, world, out))
    _hold(name, got, [r[name] for r in ranks], {"": final}, metrics)


@pytest.mark.parametrize("name", list(CASES))
def test_ep_step_matches_jax_unsharded(worlds, ring_refs, name):
    """Both steps, and the state after each, against the JAX step
    unsharded (the ring's case: its pod split) within every bound of
    ``tests/test_torch_train.py``; a MoE case's JAX step routes each layer
    to the experts the sharded run chose (module docstring)."""
    world, case = CASES[name]
    ranks, got, out = worlds(world)
    if case["grad_compress"]:
        states, metrics = ring_refs[1][name].result()
    elif case["arch"] == MOE:
        states, metrics = jax_replay(case["ref"], _routes(name, world, out))
    else:
        states, metrics = jax_ref(case["ref"])
    assert len(metrics) == STEPS
    _hold(name, got, [r[name] for r in ranks],
          {"step1/": states[0], "": states[-1]}, metrics)


@pytest.mark.parametrize("name", FREE)
def test_ep_first_step_matches_jax_on_its_own_routing(worlds, name):
    """The first step against the JAX step routing for itself, from the
    shared initial state: its metrics, and the parameters after it within
    ``PARAM_RTOL`` (the flips move moments and the second step; module
    docstring); lr exact on both steps."""
    world, case = CASES[name]
    ranks, got, _ = worlds(world)
    runs = [r[name] for r in ranks]
    states, metrics = jax_ref(case["ref"])
    _hold(name, got, runs, {"step1/": states[0]}, metrics[:1], moments=False)
    for r in runs:
        assert [m["lr"] for m in r["metrics"]] == [m["lr"] for m in metrics]


def test_jax_reference_drops_and_group_capacity(worlds):
    """The JAX reference drops choices, and each case's layers used the
    routing group's capacity (32 over the global batch, 16 a pod under
    the ring), never a data rank's own (16 at data 2)."""
    assert sum(jax_drops()) > 0, jax_drops()
    mc = torch_ranks._moe_config(MOE, CAPACITY_FACTOR).moe
    want_global = TMOE.capacity(BATCH * SEQ, mc)
    assert (want_global, TMOE.capacity(BATCH * SEQ // 2, mc)) == (32, 16)
    for name, (world, case) in CASES.items():
        if case["arch"] != MOE:
            continue
        pods, data, _ = case["shape"]
        group = data * (1 if case["grad_compress"] else pods)
        want = TMOE.capacity(BATCH * SEQ // (pods if case["grad_compress"]
                                              else 1), mc)
        for r in worlds(world)[0]:
            layers = r[name]["layers"]
            assert [l["cap"] for l in layers] == [want] * len(layers), name
            assert {l["group_size"] for l in layers} == {group}, name
            assert all(l["dropped"] > 0 for l in layers), (name, layers)


@pytest.mark.parametrize("name", list(CASES))
def test_ep_placement_replicas_and_no_model_gathers(worlds, name):
    world, case = CASES[name]
    runs = [r[name] for r in worlds(world)[0]]
    by_coord = {}
    splits = case["shape"][2] > 1 and 8 % case["shape"][2] == 0
    for r in runs:
        assert r["held"] == r["spec_bytes"]
        assert r["placed_init_bitwise"]
        # parameters cross the model group never: only data gathers
        assert r["comm"]["gather"] == r["data_gather_bytes"]
        assert (r["data_gather_bytes"] > 0) == case["fsdp"]
        if case["arch"] == MOE:
            assert ("ep_gather" in r["comm"]) == splits
        c = r["coord"]
        by_coord.setdefault((c["pod"], c["data"]), set()).add(r["replicated_sha"])
    assert all(len(s) == 1 for s in by_coord.values()), by_coord


def test_ep_fsdp_on_and_off_bitwise(worlds):
    runs = worlds(4)[0]
    assert {r["moe-122-fsdp"]["sha"] for r in runs} == \
        {r["moe-122"]["sha"] for r in runs}
    for r in runs:
        assert r["moe-122-fsdp"]["held"] < r["moe-122"]["held"]


@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 3), (2, 2, 2)])
def test_moe_accepts_data_and_model_axes(shape):
    """A MoE config builds under data and model axes together, and where
    the experts do not split over model (the splits alone and the pod
    axis: ``tests/test_torch_shard_train.py``)."""
    TTS.make_train_step(tget(MOE).reduced(), policy=ShardingPolicy(
        dict(zip(("pod", "data", "model"), shape))))


def test_launcher_pods_without_ring_matches_single_process(worlds, capsys):
    """``--mesh 2`` without ``--grad-compress`` trains a MoE config through
    the policy step (raw sums over pod): its first loss is the
    single-process launcher's within ``CE_ATOL`` (the forward of a pod's
    rows is the same arithmetic; the second step may route otherwise)."""
    out = worlds(2)[2]
    lead, other = ((out / f"launch{r}.txt").read_text() for r in range(2))
    assert "done: 2 steps" in lead and other == ""
    LT.main(SINGLE)
    single = [float(v) for v in re.findall(r"loss (\S+)",
                                           capsys.readouterr().out)]
    pods = [float(v) for v in re.findall(r"loss (\S+)", lead)]
    assert len(pods) == len(single) == 2 and all(map(math.isfinite, pods))
    assert abs(pods[0] - single[0]) <= CE_ATOL


def test_launcher_moe_model_axis_without_ring_reaches_the_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4"):
        LT.main(["--arch", MOE, "--reduced", "--device", "cpu",
                 "--mesh", "2,1,2"])

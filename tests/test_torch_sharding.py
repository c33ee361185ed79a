"""The port's ``ShardingPolicy`` (``repro_torch.distributed.sharding``)
against the JAX one, spec entry for spec entry.

The JAX policy runs on a ``jax.sharding.AbstractMesh``, which needs no
device: parameter shapes come from ``jax.eval_shape`` on the JAX side and
from ``meta`` tensors on the port's (full width, nothing allocated), cache
shapes likewise.  Meshes (2, 2, 2) pod/data/model, (4, 2) data/model,
(2, 16, 16) pod/data/model and (16,) as a data and as a model axis, each
with ``fsdp``, ``pd_disaggregated`` and ``moe_dispatch_sharding`` on and
off.  A JAX spec entry that is a tuple of axes is a tuple in the port's
spec too; a kind the JAX policy declines (``None``) is ``None``.

One deliberate difference: the port strips the hybrid's stack dimensions
before the rules apply (two for ``triples/rec/``, one for ``extra/``), so
there its spec is the JAX rule applied to the block's own shape with
``None`` on each stack dimension; the JAX policy strips one for
``triples/`` and none for ``extra/`` and splits the row-split leaves
(``w_out``, ``mlp/w_down``) on a stack dimension
(:func:`test_jax_policy_splits_hybrid_stack_dimensions` pins it).

One subprocess on 8 host devices holds :func:`shard_slice` at every mesh
coordinate against ``NamedSharding(...).devices_indices_map``, tuple
entries included (row-major over the named axes, the first axis major).
"""

import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys
import textwrap

import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.distributed.sharding import ShardingPolicy as JPolicy  # noqa: E402
from repro.models import kvcache as JKV  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import kvcache as TKV  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "16data": ((16,), ("data",)),
          "16model": ((16,), ("model",))}
FLAGS = list(itertools.product((False, True), repeat=3))
CASES = [(m, f) for m in MESHES for f in FLAGS]
IDS = [f"{m}-fsdp{int(f[0])}-pd{int(f[1])}-moe{int(f[2])}" for m, f in CASES]
ARCHS = ARCH_IDS + ("qwen3-32b",)
FAMILY_CACHES = ("smollm-135m", "minicpm3-4b", "qwen3-moe-30b-a3b",
                 "mamba2-2.7b", "recurrentgemma-9b", "pixtral-12b",
                 "hubert-xlarge")


def policies(mesh, flags):
    shape, axes = MESHES[mesh]
    fsdp, pd, moe = flags
    kw = dict(fsdp=fsdp, pd_disaggregated=pd, moe_dispatch_sharding=moe)
    return (JPolicy(AbstractMesh(shape, axes), **kw),
            SH.ShardingPolicy(dict(zip(axes, shape)), **kw))


def jspec(spec):
    return None if spec is None else tuple(spec)


def jax_keyed(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): s
            for p, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


def port_keyed(specs, like):
    return {SH.path_str(p): s for (p, _), s in
            zip(TR.flatten_with_path(like)[0], SH.leaf_specs(specs, like))}


@functools.lru_cache(maxsize=None)
def jparams(arch):
    return jax.eval_shape(lambda: JM.init_params(jget(arch), jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def tparams(arch):
    return TM.init_params(tget(arch), torch.Generator(), "meta")


@pytest.mark.parametrize("mesh,flags", CASES, ids=IDS)
def test_axes_and_sizes_match_jax(mesh, flags):
    jp, tp = policies(mesh, flags)
    assert tp.dp_axes() == jp.dp_axes() and tp.fsdp_axes() == jp.fsdp_axes()
    assert tp.dp_size() == jp.dp_size() and tp.tp_size() == jp.tp_size()
    for dim in (1, 2, 6, 16, 24, 32, 512):
        for axes in (None, "model", ("data",), ("pod", "data"), ("data", "model")):
            assert tp._maybe(dim, axes) == jp._maybe(dim, axes), (dim, axes)


def block_rule(jp, path, shape):
    """The JAX policy's spec for the parameter at ``path`` of whole
    ``shape`` as the port places it: the JAX rule on the block's own shape
    for the hybrid's stacked recurrent leaves (``None`` on each stack
    dimension), the JAX spec itself elsewhere."""
    n = 2 if path.startswith("triples/rec/") else 1 if path.startswith("extra/") else 0
    if n == 0:
        return tuple(jp.spec_for_param(path, shape))
    # the leaf's name alone: a path the JAX rule strips nothing from
    return (None,) * n + tuple(jp.spec_for_param(path.split("/")[-1], shape[n:]))


@pytest.mark.parametrize("mesh,flags", CASES, ids=IDS)
def test_param_specs_match_jax(mesh, flags):
    """Every architecture at full width, and qwen3-32b: the JAX policy's
    specs, the hybrid's stacked recurrent leaves by the JAX rule on the
    block's shape (module docstring)."""
    jp, tp = policies(mesh, flags)
    for arch in ARCHS:
        shapes = {k: tuple(v.shape) for k, v in jax_keyed(jparams(arch)).items()}
        want = {k: block_rule(jp, k, shapes[k])
                for k in jax_keyed(jp.param_specs(jparams(arch)))}
        got = port_keyed(tp.param_specs(tparams(arch)), tparams(arch))
        assert got == want, arch


def test_jax_policy_splits_hybrid_stack_dimensions():
    """The difference, pinned: reduced recurrentgemma at 5 layers (one
    triple, 2 extra blocks) under a model axis of 2.  The JAX policy
    splits the row-split leaves on a stack dimension (the triple's pair
    of recurrent blocks, the extra blocks' stack), the port their rows
    (U for ``w_out``, F for ``mlp/w_down``); the column-split ``w_in``
    both on U."""
    jc = dataclasses.replace(jget("recurrentgemma-9b").reduced(), num_layers=5)
    tc = dataclasses.replace(tget("recurrentgemma-9b").reduced(), num_layers=5)
    jp = JPolicy(AbstractMesh((2,), ("model",)))
    tp = SH.ShardingPolicy({"model": 2})
    jshapes = jax.eval_shape(lambda: JM.init_params(jc, jax.random.PRNGKey(0)))
    jax_specs = {k: tuple(v) for k, v in jax_keyed(jp.param_specs(jshapes)).items()}
    port = port_keyed(tp.param_specs(TM.init_params(tc, torch.Generator(), "meta")),
                      TM.init_params(tc, torch.Generator(), "meta"))
    want_jax = {"triples/rec/block/w_out": (None, "model", None, None),
                "triples/rec/mlp/w_down": (None, "model", None, None),
                "extra/block/w_out": ("model", None, None),
                "extra/mlp/w_down": ("model", None, None),
                "triples/rec/block/w_in": (None, None, None, "model"),
                "extra/block/w_in": (None, None, "model")}
    want_port = {"triples/rec/block/w_out": (None, None, "model", None),
                 "triples/rec/mlp/w_down": (None, None, "model", None),
                 "extra/block/w_out": (None, "model", None),
                 "extra/mlp/w_down": (None, "model", None),
                 "triples/rec/block/w_in": (None, None, None, "model"),
                 "extra/block/w_in": (None, None, "model")}
    assert {k: jax_specs[k] for k in want_jax} == want_jax
    assert {k: port[k] for k in want_port} == want_port
    # every other leaf of the config: the same spec in both packages
    assert {k: v for k, v in port.items()
            if not k.startswith(("triples/rec/", "extra/"))} == \
        {k: v for k, v in jax_specs.items()
         if not k.startswith(("triples/rec/", "extra/"))}


@pytest.mark.parametrize("mesh,flags", CASES, ids=IDS)
def test_cache_specs_match_jax(mesh, flags):
    """Every family's cache, at a batch that divides the data-parallel
    axes and one that does not."""
    jp, tp = policies(mesh, flags)
    for arch in FAMILY_CACHES:
        for batch, seq in ((32, 256), (6, 100)):
            jc = jax.eval_shape(lambda: JKV.init_cache(jget(arch), batch, seq))
            tc = TKV.init_cache(tget(arch), batch, seq, device="meta")
            want = {k: tuple(v) for k, v in jax_keyed(jp.cache_specs(jc)).items()}
            assert port_keyed(tp.cache_specs(tc), tc) == want, (arch, batch)
            for name, shape in (("k", (4, batch, seq, 8, 64)), ("other", (3, batch)),
                                ("other", (7,))):
                assert tp.spec_for_cache(name, shape) == \
                    jspec(jp.spec_for_cache(name, shape)), (name, shape)


ACTIVATIONS = [
    ("btd", (32, 256, 512)), ("btd", (6, 100, 512)),
    ("btd_seq", (32, 256, 512)), ("btd_seq", (32, 100, 512)),
    ("bthd", (32, 256, 32, 64)), ("bthd", (32, 256, 24, 64)),
    ("bthd", (6, 100, 24, 64)), ("logits", (32, 256, 49152)),
    ("logits", (32, 49152)), ("logits", (6, 100, 151)),
    ("kvcache", (32, 256, 8, 64)), ("kvcache", (32, 256, 512)),
    ("kvcache", (6, 100, 3, 64)), ("state", (32, 64, 16, 128)),
    ("state", (6, 7)), ("tokens", (32, 256)), ("tokens", (6, 100)),
    ("moe_td", (8192, 2048)), ("moe_td", (6, 2048)), ("moe_te", (8192, 128)),
    ("moe_ecd", (128, 64, 2048)), ("moe_ecd", (7, 64, 2048)),
    ("moe_ecf", (128, 64, 768)),
]


@pytest.mark.parametrize("mesh,flags", CASES, ids=IDS)
def test_activation_specs_match_jax(mesh, flags):
    for fallback in ("seq", "none"):
        jp, tp = policies(mesh, flags)
        jp = JPolicy(jp.mesh, attn_fallback=fallback, fsdp=jp.fsdp,
                     moe_dispatch_sharding=jp.moe_dispatch_sharding,
                     pd_disaggregated=jp.pd_disaggregated)
        tp = SH.ShardingPolicy(tp.mesh, attn_fallback=fallback, fsdp=tp.fsdp,
                               moe_dispatch_sharding=tp.moe_dispatch_sharding,
                               pd_disaggregated=tp.pd_disaggregated)
        for kind, shape in ACTIVATIONS:
            assert tp.spec_for_activation(kind, shape) == \
                jspec(jp.spec_for_activation(kind, shape)), (kind, shape)
        with pytest.raises(KeyError):
            jp.spec_for_activation("no-such-kind", (2, 2))
        with pytest.raises(KeyError, match="unknown activation kind"):
            tp.spec_for_activation("no-such-kind", (2, 2))


def test_policy_scope_and_local_shapes():
    """Local shapes under a policy.  The port has no thread-local policy
    scope (``use_policy``): its only JAX reader, ``constrain``, is not
    ported, and the step takes its policy as an argument."""
    pol = SH.ShardingPolicy({"pod": 2, "data": 2, "model": 1}, fsdp=True)
    assert not hasattr(SH, "use_policy") and not hasattr(SH, "current_policy")
    assert SH.local_shape((8, 6, 4), (("pod", "data"), None, "model"),
                          pol.sizes) == (2, 6, 4)
    with pytest.raises(ValueError, match="does not divide"):
        SH.local_shape((6, 4), (("pod", "data"), None), pol.sizes)
    like = tparams("smollm-135m")
    specs = pol.param_specs(like)
    held = SH.held_bytes(like, specs, pol.sizes)
    whole = sum(x.numel() * x.element_size() for x in TR.leaves(like))
    assert held * 2 == whole      # every smollm leaf splits over data 2


def test_spec_trees_read_against_their_tree():
    tree = {"b": torch.zeros(4, 2), "a": [torch.zeros(3), torch.zeros(2, 2)]}
    specs = {"a": [(None,), ("data", None)], "b": (("pod", "data"), None)}
    assert SH.leaf_specs(specs, tree) == [(None,), ("data", None),
                                          (("pod", "data"), None)]
    with pytest.raises(ValueError):
        SH.leaf_specs({"a": [(None,)], "b": (None, None)}, tree)


JAX_SLICES = textwrap.dedent(r"""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("pod", "data", "model"))
    specs = json.loads(sys.argv[1])
    shape = (8, 12, 4)
    out = []
    for spec in specs:
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
        per = {}
        for coord in np.ndindex(2, 2, 2):
            dev = mesh.devices[coord]
            per[",".join(map(str, coord))] = [
                [s.start or 0, s.stop if s.stop is not None else n]
                for s, n in zip(idx[dev], shape)]
        out.append(per)
    print(json.dumps(out))
""")

SLICE_SPECS = [(("pod", "data"), None, None), ("data", "model", None),
               (None, ("data", "model"), "pod"), (("pod", "data", "model"),),
               (("model", "pod"), None, "data"), (None, None, None),
               ("pod", ("model", "data"), None)]


def test_shard_slice_matches_devices_indices_map():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", JAX_SLICES,
                          json.dumps(SLICE_SPECS)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    maps = json.loads(out.stdout.strip().splitlines()[-1])
    sizes = {"pod": 2, "data": 2, "model": 2}
    x = torch.arange(8 * 12 * 4, dtype=torch.int32).reshape(8, 12, 4)
    for spec, per in zip(SLICE_SPECS, maps):
        for key, bounds in per.items():
            coord = dict(zip(("pod", "data", "model"), map(int, key.split(","))))
            want = x[tuple(slice(a, b) for a, b in bounds)]
            got = SH.shard_slice(x, spec, sizes, coord)
            assert torch.equal(got, want), (spec, key)
            assert tuple(got.shape) == SH.local_shape(x.shape, spec, sizes)

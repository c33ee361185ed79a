"""The port's compressed ring all-reduce across 4 gloo ranks against JAX.

A JAX subprocess (4 host devices) runs ``grad_compress.
compressed_cross_pod_mean`` and ``session.ring_reduce`` on seeded
gradients and writes every device's own output buffer: the JAX ring
returns ``P()`` with ``check_vma=False``, so device r holds the sum it
accumulated itself, and with non-integer values the devices' f32 sums can
differ in the last bit.  The port's rank r is held against JAX device r,
bitwise (``tests/torch_ranks.py``):

* the small-integer gradients of ``tests/test_bulk_plane.py``'s
  ``RING_PARITY_SCRIPT``, compressed and raw: also bitwise equal to the
  mean, ``last_stats.leaf_ok == {"big": True}``;
* normal-valued gradients (bf16 normals, a codebook calibrated on them);
* a forced overflow: a leaf whose exponents spread over 80 binades at cap
  8 re-runs on the raw ring, and ``last_stats`` equals the JAX
  ``_ring_stats`` field by field.  Its f32 sums are inexact, and the JAX
  devices' buffers differ from each other: the port's ranks match them
  one by one.

The JAX session's ring program is jitted in the subprocess (the same
``shard_map`` body ``ring_reduce`` builds, compiled once instead of run op
by op); ``cross_pod_wire_bytes`` is compared in process.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_ranks  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.serving.plan import TransferConfig, TransferPlan  # noqa: E402
from repro_torch.training import grad_compress as GC  # noqa: E402

JAX_RING_SCRIPT = textwrap.dedent(r"""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_mesh
    from repro.serving import session as JS
    from repro.serving.plan import TransferConfig, TransferPlan
    from repro.training import grad_compress as GC

    _build = JS.TransferSession._build_ring_fn
    JS.TransferSession._build_ring_fn = lambda self, *a: jax.jit(_build(self, *a))
    out_dir = sys.argv[1]
    mesh = make_mesh((4,), ("pod",))
    rng = np.random.default_rng(7)
    res, meta = {}, {"keys": {}}
    def bits(x):
        return np.asarray(x).view(np.uint16)
    def per_device(x):
        by = {s.device: s.data for s in x.addressable_shards}
        return np.stack([bits(by[d]) for d in mesh.devices.reshape(-1)])
    small = {"w": jnp.asarray(rng.integers(-8, 8, size=(4, 128, 40)), jnp.bfloat16),
             "b": jnp.asarray(rng.integers(-8, 8, size=(4, 48)), jnp.bfloat16),
             "big": jnp.asarray(rng.integers(-4, 4, size=(4, 65536)), jnp.bfloat16)}
    normal = {"w": jnp.asarray(rng.normal(size=(4, 128, 40)), jnp.bfloat16),
              "big": jnp.asarray(rng.normal(size=(4, 32768)) * 0.01, jnp.bfloat16)}
    wide = {"wide": jnp.asarray(rng.normal(size=(4, 8192))
                                * 2.0 ** rng.integers(-40, 40, size=(4, 8192)),
                                jnp.bfloat16),
            "w": normal["w"]}
    for name, g in (("small", small), ("normal", normal), ("wide", wide)):
        meta["keys"][name] = sorted(g)
        for k, x in g.items():
            res[f"in/{name}/{k}"] = bits(x)
    cb = GC.calibrate_on_grads(jax.tree.map(lambda g: g[0], small))
    cb_n = GC.calibrate_on_grads(jax.tree.map(lambda g: g[0], normal))
    meta["codebook"], meta["codebook_normal"] = cb.to_json(), cb_n.to_json()
    for tag, kw in (("raw", {"compress": False}), ("comp", {"codebook": cb})):
        out = GC.compressed_cross_pod_mean(small, mesh, **kw)
        for k, x in out.items():
            res[f"out/small/{tag}/{k}"] = per_device(x)
        meta[f"small/{tag}"] = dataclasses.asdict(GC.last_stats)
    out = GC.compressed_cross_pod_mean(normal, mesh, codebook=cb_n)
    for k, x in out.items():
        res[f"out/normal/{k}"] = per_device(x)
    meta["normal"] = dataclasses.asdict(GC.last_stats)
    sess = TransferPlan.build(wide, TransferConfig(codebook=cb_n, chunk=256, cap=8),
                              mesh=mesh, specs=(P("pod"),) * 2).session()
    out = sess.ring_reduce(wide, ratio=1.3)
    for k, x in out.items():
        res[f"out/wide/{k}"] = per_device(x)
    meta["wide"] = dataclasses.asdict(sess.last_stats)
    meta["wire_bytes"] = {f"{n}/{c}": GC.cross_pod_wire_bytes(normal, n_pod=n, compress=c)
                          for n in (2, 4) for c in (True, False)}
    np.savez(os.path.join(out_dir, "ring.npz"), **res)
    with open(os.path.join(out_dir, "ring.json"), "w") as f:
        json.dump(meta, f)
    print("RING-JAX-OK")
""")


def _subprocess_env():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get(
        "PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ring")
    out = subprocess.run([sys.executable, "-c", JAX_RING_SCRIPT, str(d)],
                         capture_output=True, text=True, env=_subprocess_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return d, np.load(d / "ring.npz"), json.loads((d / "ring.json").read_text())


def test_ring_matches_jax_device_by_device(tmp_path, jax_ref):
    ref_dir, ref, meta = jax_ref
    out = tmp_path / "ranks"
    out.mkdir()
    torch_ranks.run_world(torch_ranks.ring_world, 4, tmp_path, str(ref_dir),
                          str(out), timeout=240)
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]
    # the per-device sums really differ: bf16 normals sum exactly in f32,
    # but the wide leaf's 80 binades do not, so its devices disagree in the
    # last bit somewhere and rank r matched device r, not one replicated
    # value
    dev = ref["out/wide/wide"]
    assert any(not np.array_equal(dev[0], dev[r]) for r in range(1, 4))
    for r in ranks:
        assert r["small/comp"]["leaf_ok"] == {"big": True}
        for case in ("small/raw", "small/comp", "normal", "wide"):
            assert r[case] == meta[case], case
        assert r["wide"]["leaf_ok"] == {"w": True, "wide": False}
        assert r["wide"]["raw_refetches"] == 1 and r["wide_hops"] == 3


def test_cross_pod_wire_bytes_matches_jax(jax_ref):
    _, ref, meta = jax_ref
    normal = {k: torch_ranks.to_torch(ref[f"in/normal/{k}"], "bfloat16")
              for k in meta["keys"]["normal"]}
    for n in (2, 4):
        for c in (True, False):
            assert GC.cross_pod_wire_bytes(normal, n_pod=n, compress=c) == \
                meta["wire_bytes"][f"{n}/{c}"]


def test_ring_refusals_and_single_pod(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s1",
                            rank=0, world_size=1)
    try:
        cb = tcb.DEFAULT_BF16_CODEBOOK
        grads = {"g": torch.arange(8, dtype=torch.float32).reshape(1, 8)
                 .to(torch.bfloat16)}
        data = make_mesh((1,), ("data",))
        out = GC.compressed_cross_pod_mean(grads, data)        # no 'pod'
        assert torch.equal(out["g"], grads["g"][0])
        plan = TransferPlan.build(grads, TransferConfig(codebook=cb),
                                  mesh=make_mesh((1,), ("pod",)))
        with pytest.raises(ValueError, match="'model' axis"):
            plan.session().ring_reduce(grads, axis="model")
        with pytest.raises(ValueError, match="needs a mesh plan"):
            TransferPlan.build(grads, TransferConfig(codebook=cb)).session() \
                .ring_reduce(grads)
        f32 = {"s": torch.ones(1, 64, dtype=torch.float32)}
        hilo = TransferPlan.build(f32, TransferConfig(codebook=cb,
                                                      compress_fp32=True),
                                  mesh=make_mesh((1,), ("pod",)))
        with pytest.raises(ValueError, match="fp32 hi/lo"):
            hilo.session().ring_reduce(f32)
        # one pod: no hop, the mean of its own row
        pod1 = GC.compressed_cross_pod_mean(grads, make_mesh((1,), ("pod",)))
        assert torch.equal(pod1["g"], grads["g"][0])
    finally:
        dist.destroy_process_group()

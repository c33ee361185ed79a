"""The port's reshard hop against the JAX session's (one process).

``session.reshard(tree, dst)`` ships every routed leaf through the
session's wire (framed and verified when the session carries ``verify=`` /
``faults=``), decodes, and places the result on ``dst``: None, one
device, or a pytree of devices (the counterpart of ``device_put`` onto
shardings).  Same seeded inputs as ``tests/test_torch_faults.py``: the
round trip is bitwise, and ``TransferStats`` equal the JAX session's
``reshard`` field by field under the same fault plan and ``verify=``.
"""

import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro_torch.core import tree as TR  # noqa: E402
from test_torch_faults import (SEEDED, assert_same_cache,  # noqa: E402
                               assert_same_stats, fault_plans, make_caches,
                               plans)


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_reshard_round_trip_bitwise(n_chunks):
    jc, tc, cb, tcb_ = make_caches(seed=6)
    jp, tp = plans(jc, tc, cb, tcb_, n_chunks=n_chunks, compress_fp32=True)
    js, ts = jp.session(), tp.session()
    out = ts.reshard(tc, None)
    assert_same_cache(jc, out)
    assert_same_cache(js.reshard(jc, None), ts.reshard(out, None))
    assert_same_stats(js.last_stats, ts.last_stats)


@pytest.mark.parametrize("verify", [True, False])
def test_reshard_stats_match_jax_under_faults(verify):
    jc, tc, cb, tcb_ = make_caches(seed=7)
    jp, tp = plans(jc, tc, cb, tcb_, compress_fp32=True)
    jfp, tfp = fault_plans(corrupt_chunks=(0,), drop_chunks=(2,), **SEEDED)
    js = jp.session(verify=True, faults=jfp)
    ts = tp.session(verify=True, faults=tfp)
    jo = js.reshard(jc, None, verify=verify)
    to = ts.reshard(tc, None, verify=verify)
    assert_same_cache(jo, to)
    assert_same_stats(js.last_stats, ts.last_stats)
    assert ts.last_stats.faults_injected > 0
    if verify:
        assert_same_cache(jc, to)
        assert ts.last_stats.refetches == ts.last_stats.verify_failures > 0


def test_reshard_places_on_dst():
    jc, tc, cb, tcb_ = make_caches(seed=8)
    _, tp = plans(jc, tc, cb, tcb_)
    sess = tp.session()
    cpu = torch.device("cpu")
    for dst in (cpu, "cpu", TR.unflatten(TR.flatten_with_path(tc)[1],
                                         [cpu] * len(TR.leaves(tc)))):
        out = sess.reshard(tc, dst)
        assert_same_cache(jc, out)
        assert all(x.device == cpu for x in TR.leaves(out))
    with pytest.raises(ValueError, match="devices for"):
        sess.reshard(tc, [cpu])
    with pytest.raises(ValueError, match="structure"):
        sess.reshard({"k": tc["k"]}, None)

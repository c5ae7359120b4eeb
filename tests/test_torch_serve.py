"""The port's serving front door (raft_tpu_torch.serve) over an index the
JAX package built: served results equal direct ``ivf_flat.search`` and
the JAX ``SearchServer``'s, pad rows never leak, admission and deadlines
fail with their typed errors, a warmed plan never re-measures its cap.
Also the import guard: the port imports neither JAX nor the JAX package.

Parity params: exact bins (``scan_bins=-1``) and a pinned cap no batch
can overflow, so the list- and probe-major routes return the same ids
whatever batch shape a request lands in. Tolerance: ids identical,
distances within rtol 1e-5 / atol 1e-5.
"""

import dataclasses
import gc
import os
import re
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from raft_tpu import serve as jserve
from raft_tpu.neighbors import ivf_bq as jbq
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import serialize as jser
from raft_tpu_torch import obs
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import plan as tplan
from raft_tpu_torch.neighbors import serialize as tser
from raft_tpu_torch.serve import (DeadlineExceeded, LoadController,
                                  RejectedError, SearchServer, ServeConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 10
SHAPES = (1, 8, 64)
EXACT = dict(n_probes=4, scan_bins=-1, probe_cap=64)
# request sizes: ragged, so most batches carry pad rows
SIZES = (3, 1, 5, 8, 2, 7, 1, 4, 6, 3, 9, 2, 5, 8)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(0)
    c = rng.normal(size=(24, 16)).astype(np.float32)
    x = (c[rng.integers(0, 24, 2000)]
         + rng.normal(size=(2000, 16))).astype(np.float32)
    q = (c[rng.integers(0, 24, 64)]
         + rng.normal(size=(64, 16))).astype(np.float32)
    jidx = jflat.build(x, jflat.IndexParams(n_lists=16, kmeans_n_iters=4))
    path = str(tmp_path_factory.mktemp("serve") / "flat.npz")
    jser.save_ivf_flat(jidx, path)
    return jidx, tser.load_ivf_flat(path, device="cpu"), q


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _requests(q):
    out, s = [], 0
    for n in SIZES:
        out.append(q[s:s + n])
        s += n
    return out


def _serve_all(srv, reqs):
    """Submit every request from its own thread; return results in
    request order."""
    res = [None] * len(reqs)

    def go(j):
        res[j] = srv.search(reqs[j], timeout=300)

    threads = [threading.Thread(target=go, args=(j,)) for j in
               range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return res


def test_served_equals_direct_search_and_jax_server(setup):
    jidx, tidx, q = setup
    reqs = _requests(q)
    srv = SearchServer.from_index(tidx, q[:8], K,
                                  params=tflat.SearchParams(**EXACT),
                                  config=ServeConfig(batch_sizes=SHAPES))
    try:
        served = _serve_all(srv, reqs)
    finally:
        srv.close()
    jsrv = jserve.SearchServer.from_index(
        jidx, q[:8], K, params=jflat.SearchParams(**EXACT),
        config=jserve.ServeConfig(batch_sizes=SHAPES))
    try:
        jserved = _serve_all(jsrv, reqs)
    finally:
        jsrv.close()
    for r, (d, i), (dj, ij) in zip(reqs, served, jserved):
        assert d.shape == i.shape == (r.shape[0], K)
        dd, id_ = tflat.search(tidx, r, K, tflat.SearchParams(**EXACT))
        np.testing.assert_array_equal(i, id_.numpy())
        np.testing.assert_allclose(d, dd.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(i, np.asarray(ij))
        np.testing.assert_allclose(d, np.asarray(dj), rtol=1e-5, atol=1e-5)


def test_pad_rows_do_not_leak(setup):
    _, tidx, q = setup
    srv = SearchServer.from_index(tidx, q[:8], K,
                                  params=tflat.SearchParams(**EXACT),
                                  config=ServeConfig(batch_sizes=SHAPES))
    try:
        before = obs.counter_sum(obs.snapshot(), "raft.serve.batch.padded_rows")
        d, i = srv.search(q[10:13])
        after = obs.counter_sum(obs.snapshot(), "raft.serve.batch.padded_rows")
    finally:
        srv.close()
    assert after - before == 5                  # 3 rows -> the 8-row shape
    assert i.shape == (3, K)
    _, want = tflat.search(tidx, q[10:13], K, tflat.SearchParams(**EXACT))
    np.testing.assert_array_equal(i, want.numpy())


def test_full_queue_rejects(setup):
    _, tidx, q = setup
    srv = SearchServer.from_index(
        tidx, q[:8], K, params=tflat.SearchParams(n_probes=4),
        config=ServeConfig(batch_sizes=(1, 8), max_queue=2, prewarm=False),
        start=False)
    futs = [srv.submit(q[j]) for j in range(3)]
    with pytest.raises(RejectedError, match="queue_full"):
        futs[2].result(timeout=10)
    srv.start()
    for f in futs[:2]:
        d, i = f.result(timeout=60)
        assert i.shape == (1, K)
    srv.close()
    with pytest.raises(RejectedError, match="closed"):
        srv.submit(q[0]).result(timeout=10)


def test_expired_deadline_raises(setup):
    _, tidx, q = setup
    srv = SearchServer.from_index(
        tidx, q[:8], K, params=tflat.SearchParams(n_probes=4),
        config=ServeConfig(batch_sizes=(1, 8), prewarm=False), start=False)
    before = obs.counter_sum(obs.snapshot(), "raft.serve.deadline.total")
    late = srv.submit(q[0], deadline_ms=1.0)
    ok = srv.submit(q[1])
    time.sleep(0.02)
    srv.start()
    try:
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=60)
        assert ok.result(timeout=60)[1].shape == (1, K)
    finally:
        srv.close()
    assert obs.counter_sum(obs.snapshot(),
                           "raft.serve.deadline.total") - before == 1


def test_warm_plans_never_remeasure_cap(setup):
    _, tidx, q = setup
    srv = SearchServer.from_index(tidx, q[:8], K,
                                  params=tflat.SearchParams(n_probes=4),
                                  config=ServeConfig(batch_sizes=SHAPES))
    try:
        before = obs.snapshot()
        _serve_all(srv, _requests(q))
        after = obs.snapshot()
    finally:
        srv.close()
    for name in ("raft.ivf_scan.resolve_cap.syncs", "raft.plan.cache.misses",
                 "raft.plan.build.total"):
        assert obs.counter_sum(after, name) == obs.counter_sum(before, name)
    assert (obs.counter_sum(after, "raft.serve.completed.total")
            - obs.counter_sum(before, "raft.serve.completed.total")
            == len(SIZES))


@pytest.fixture(scope="module")
def pq_index(setup, tmp_path_factory):
    """A JAX-built IVF-PQ index (raw corpus kept) loaded by the port."""
    _, _, q = setup
    rng = np.random.default_rng(1)
    c = rng.normal(size=(24, 16)).astype(np.float32)
    x = (c[rng.integers(0, 24, 2000)]
         + rng.normal(size=(2000, 16))).astype(np.float32)
    pidx = jpq.build(x, jpq.IndexParams(n_lists=16, kmeans_n_iters=4,
                                        pq_dim=4, pq_bits=6, keep_raw=True))
    path = str(tmp_path_factory.mktemp("serve") / "pq.npz")
    jser.save_ivf_pq(pidx, path)
    return tser.load_ivf_pq(path, device="cpu"), q


@pytest.mark.parametrize("where", ["always", "never"])
def test_pq_server_equals_direct_search(pq_index, where):
    # rescore on the device or on the host; probe_cap pinned so that
    # every batch shape keeps every probe and serves what a direct
    # search returns
    tidx, q = pq_index
    sp = tpq.SearchParams(n_probes=4, rescore_factor=4, probe_cap=64,
                          rescore_on_device=where)
    reqs = _requests(q)
    srv = SearchServer.from_index(tidx, q[:8], K, params=sp,
                                  config=ServeConfig(batch_sizes=SHAPES))
    try:
        before = obs.snapshot()
        served = _serve_all(srv, reqs)
        after = obs.snapshot()
    finally:
        srv.close()
    for name in ("raft.ivf_scan.resolve_cap.syncs", "raft.plan.cache.misses",
                 "raft.plan.build.total"):
        assert obs.counter_sum(after, name) == obs.counter_sum(before, name)
    for r, (d, i) in zip(reqs, served):
        dd, id_ = tpq.search(tidx, r, K, sp)
        np.testing.assert_array_equal(i, id_.numpy())
        np.testing.assert_allclose(d, dd.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def bq_index(setup, tmp_path_factory):
    """A JAX-built IVF-BQ index (raw corpus kept) loaded by the port."""
    _, _, q = setup
    rng = np.random.default_rng(2)
    c = rng.normal(size=(24, 16)).astype(np.float32)
    x = (c[rng.integers(0, 24, 2000)]
         + rng.normal(size=(2000, 16))).astype(np.float32)
    bidx = jbq.build(x, jbq.IndexParams(n_lists=16, kmeans_n_iters=4))
    path = str(tmp_path_factory.mktemp("serve") / "bq.npz")
    jser.save_ivf_bq(bidx, path)
    return tser.load_ivf_bq(path, device="cpu"), q


@pytest.mark.parametrize("where", ["always", "never"])
@pytest.mark.parametrize("rescore", [4, 40], ids=["fused", "unfused"])
def test_bq_server_equals_direct_search(bq_index, where, rescore):
    # kk = 40 (the fused scan) or 400 (the unfused scan + merge); the
    # re-rank on the device or on the host; probe_cap pinned so that
    # every batch shape serves what a direct search returns
    tidx, q = bq_index
    sp = tbq.SearchParams(n_probes=4, rescore_factor=rescore, probe_cap=64,
                          rescore_on_device=where)
    reqs = _requests(q)
    srv = SearchServer.from_index(tidx, q[:8], K, params=sp,
                                  config=ServeConfig(batch_sizes=SHAPES))
    try:
        before = obs.snapshot()
        served = _serve_all(srv, reqs)
        after = obs.snapshot()
    finally:
        srv.close()
    for name in ("raft.ivf_scan.resolve_cap.syncs", "raft.plan.cache.misses",
                 "raft.plan.build.total"):
        assert obs.counter_sum(after, name) == obs.counter_sum(before, name)
    for r, (d, i) in zip(reqs, served):
        dd, id_ = tbq.search(tidx, r, K, sp)
        np.testing.assert_array_equal(i, id_.numpy())
        np.testing.assert_allclose(d, dd.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_dropped_index_is_freed_without_gc(setup, pq_index, bq_index,
                                           family):
    # the index caches its plans; a plan holds the index's arrays, never
    # the index, so dropping the index frees it at once (no cyclic GC
    # pass) while a plan that is still held goes on serving
    if family == "flat":
        src, q = setup[1], setup[2]
        sp = tflat.SearchParams(**EXACT)
    elif family == "pq":
        src, q = pq_index
        sp = tpq.SearchParams(n_probes=4, rescore_factor=4, probe_cap=64,
                              rescore_on_device="always")
    else:
        src, q = bq_index
        sp = tbq.SearchParams(n_probes=4, rescore_factor=4, probe_cap=64,
                              rescore_on_device="always")
    fresh = dataclasses.replace(src, cap_cache={}, plan_cache={})
    plan = tplan.build_plan(fresh, q[:8], K, sp)
    d0, i0 = plan.search(q[:8])
    ref = weakref.ref(fresh)
    gc.disable()
    try:
        del fresh
        assert ref() is None
    finally:
        gc.enable()
    d1, i1 = plan.search(q[:8])
    assert torch.equal(i0, i1) and torch.equal(d0, d1)


def test_degradation_ladder_steps_down_and_up():
    ctl = LoadController(3, ServeConfig(degrade_watermark_ms=100.0,
                                        degrade_cooldown_ms=0.0))
    assert ctl.observe(0.2, 0) == 1
    assert ctl.observe(0.2, 0) == 2
    assert ctl.observe(0.2, 0) == 2
    assert ctl.observe(0.0, 0) == 1
    assert obs.snapshot()["gauges"]["raft.serve.degrade.level"] == 1


def test_port_imports_without_jax():
    code = ("import sys, importlib, pkgutil\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['raft_tpu'] = None\n"
            "import raft_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    raft_tpu_torch.__path__, 'raft_tpu_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "print(' '.join(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 30
    # the brute-force and pairwise slice, imported without JAX too
    assert {f"raft_tpu_torch.{m}" for m in (
        "distance._elementwise_cores", "distance.pairwise",
        "distance.kernels", "ops.elementwise_dist", "ops.fused_knn",
        "neighbors.processing", "neighbors.brute_force",
        "neighbors.epsilon_neighborhood", "neighbors.ball_cover",
        "spatial.knn")} <= mods


def test_port_sources_do_not_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|raft_tpu)"
                     r"(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "raft_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    pkg = {os.path.splitext(f)[0] for f in files}
    assert len(pkg) > 20
    for f in files:
        with open(f) as fh:
            src = fh.read()
        hits = [m.group(0).strip() for m in pat.finditer(src)]
        assert not hits, f"{f} imports {hits}"

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

import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu import serve as jserve
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import serialize as jser
from raft_tpu_torch import obs
from raft_tpu_torch.neighbors import ivf_flat as tflat
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
            "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


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

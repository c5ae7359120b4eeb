"""The port's distributed serving tier (``raft_tpu_torch.serve.dist`` and
``serve.merge``) against ``raft_tpu.serve``.

* the int8 merge codec — ``quantize_rows`` (codes, scales, zero points),
  ``dequantize_rows``, ``pack_pairs`` (the port's int32 words hold the
  JAX package's uint32 bits) and ``unpack_pairs``, and
  ``merge_wire_bytes``: equal bit for bit to the JAX package's on the
  same inputs;
* the compressed merge's per-query independence (a query's result does
  not depend on the batch it rode in) and its recall within 0.005 of
  the f32 merge's;
* ``DistributedSearchServer`` over eight logical CPU ranks: mixed-size
  requests served with ids equal to a direct
  ``distributed_ivf_flat_search(merge="int8")`` (``merge="f32"`` too),
  nothing prepared in steady state (``raft.parallel.plan.misses``,
  ``raft.plan.cache.misses``, ``raft.plan.build.total`` flat), the
  merge-ratio gauge <= 0.35, the ``serve.dist.dispatch`` fault site;
* failover: ``stall_shard(3)`` with ``ServeConfig(failover=True)``
  serves typed partial results (coverage = 1 - rank 3's row share, the
  quality detail ``"3"``) with no failed request, and recovers to the
  full mesh preparing nothing; without failover the stall fails typed;
* ``/healthz``'s ``dist`` section from both packages' ``_health_body`` on
  one gauge snapshot, and from a live endpoint over the server;
* ``loadgen``'s ``merge_bytes_by_rung`` against the JAX tool's (its
  ``--server dist --device cpu`` run is in ``tests/test_torch_api_parity.py``).
"""

import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.serve import merge as jmerge
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import parallel as tpar
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors.brute_force import brute_force_knn
from raft_tpu_torch.serve import (DistributedSearchServer, ServeConfig,
                                  ShardFailedError)
from raft_tpu_torch.serve import merge as tmerge
from raft_tpu_torch.testing import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
K = 10


def _csum(snap, name):
    return sum(v for k, v in snap["counters"].items()
               if k == name or k.startswith(name + "{"))


def _cdiff(before, after, name):
    return _csum(after, name) - _csum(before, name)


def _recall(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean([len(set(a[r]) & set(b[r])) / b.shape[1]
                          for r in range(len(a))]))


@pytest.fixture(scope="module")
def tm():
    m = tpar.make_mesh(devices=[CPU] * 8)
    yield m
    m.close()


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4000, 32)).astype(np.float32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def sharded(dataset, tm):
    x, _ = dataset
    idx = tflat.build(x, tflat.IndexParams(n_lists=16, kmeans_n_iters=4),
                      device="cpu")
    return tpar.shard_ivf_flat(idx, tm)


# n_lists 16 over 8 ranks: two local lists each; probing both scans the
# whole index, so the f32 merge equals the exact scan
EXHAUSTIVE = tflat.SearchParams(n_probes=2)
# the watchdog and a stall past it: eight logical CPU ranks share one
# interpreter, and a full-mesh dispatch on a loaded host can take
# hundreds of ms, so the watchdog sits well above that
WATCHDOG = dict(dispatch_timeout_ms=2500.0, retry_backoff_ms=1.0)
STALL_S = 3.5


class TestCodec:
    def _rows(self, seed):
        rng = np.random.default_rng(seed)
        d = (rng.standard_normal((16, 24)) * 3.0 + 40.0).astype(np.float32)
        i = rng.integers(0, 10_000, (16, 24)).astype(np.int32)
        i[0, :3] = -1
        i[5, :] = -1
        d = np.where(i >= 0, d, np.inf).astype(np.float32)
        d[7, :] = 12.5                      # a constant row (scale 1)
        return d, i

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_quantize_dequantize_bit_for_bit(self, seed):
        d, i = self._rows(seed)
        qj, sj, zj = jmerge.quantize_rows(jnp.asarray(d), jnp.asarray(i))
        qt, st, zt = tmerge.quantize_rows(torch.from_numpy(d),
                                          torch.from_numpy(i))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                      np.asarray(sj).view(np.uint32))
        np.testing.assert_array_equal(zt.numpy().view(np.uint32),
                                      np.asarray(zj).view(np.uint32))
        dj = np.asarray(jmerge.dequantize_rows(
            qj, np.asarray(sj)[:, None], np.asarray(zj)[:, None],
            jnp.asarray(i)))
        dt = tmerge.dequantize_rows(qt, st[:, None], zt[:, None],
                                    torch.from_numpy(i)).numpy()
        np.testing.assert_array_equal(dt.view(np.uint32),
                                      dj.view(np.uint32))
        assert np.all(np.isinf(dt[i < 0]))

    def test_pack_unpack_bit_for_bit(self):
        rng = np.random.default_rng(3)
        ids = rng.integers(0, tmerge.PACK_ID_SENTINEL - 1,
                           (32, 16)).astype(np.int32)
        ids[0, 0] = 0
        ids[1, 1] = tmerge.PACK_ID_SENTINEL - 1
        ids[2, :4] = -1
        qd = rng.integers(-127, 128, (32, 16)).astype(np.int8)
        wj = np.asarray(jmerge.pack_pairs(jnp.asarray(qd), jnp.asarray(ids)))
        wt = tmerge.pack_pairs(torch.from_numpy(qd), torch.from_numpy(ids))
        assert wt.dtype == torch.int32 and wj.dtype == np.uint32
        np.testing.assert_array_equal(wt.numpy().view(np.uint32), wj)
        q2, i2 = tmerge.unpack_pairs(wt)
        np.testing.assert_array_equal(q2.numpy(), qd)
        np.testing.assert_array_equal(i2.numpy(), ids)
        qj2, ij2 = jmerge.unpack_pairs(jnp.asarray(wj))
        np.testing.assert_array_equal(q2.numpy(), np.asarray(qj2))

    def test_wire_bytes_and_mode(self, monkeypatch):
        for args in ((128, 32, 8, "int8", 100_000), (128, 32, 8, "int8",
                                                     1 << 27),
                     (128, 32, 8, "f32", 0), (1, 32, 8, "int8", 10),
                     (128, 32, 1, "int8", 0), (7, 5, 3, "int8", 50)):
            assert tmerge.merge_wire_bytes(*args) == \
                jmerge.merge_wire_bytes(*args)
        pre, post = tmerge.merge_wire_bytes(128, 32, 8, "int8", 100_000)
        assert 0 < post / pre <= 0.35
        for v, want in (("f32", "f32"), ("INT8", "int8"), ("bogus", "int8"),
                        ("", "int8")):
            monkeypatch.setenv("RAFT_TPU_DIST_MERGE", v)
            assert tmerge.merge_mode() == jmerge.merge_mode() == want


class TestCompressedMerge:
    def test_int8_recall_within_0005_of_f32(self, dataset, sharded, tm):
        x, q = dataset
        _, ie = brute_force_knn(torch.from_numpy(x), torch.from_numpy(q), K,
                                device="cpu")
        sp = tflat.SearchParams(n_probes=1)
        _, i32 = tpar.distributed_ivf_flat_search(sharded, q, K, sp,
                                                  mesh=tm, merge="f32")
        _, i8 = tpar.distributed_ivf_flat_search(sharded, q, K, sp,
                                                 mesh=tm, merge="int8")
        assert _recall(i8, ie) >= _recall(i32, ie) - 0.005

    def test_int8_results_independent_of_batch(self, dataset, sharded, tm):
        """Ids equal whatever batch a query rides in (pad rows never
        leak); distances within 1e-6."""
        _, q = dataset
        d_all, i_all = tpar.distributed_ivf_flat_search(
            sharded, q[:24], K, EXHAUSTIVE, mesh=tm, merge="int8")
        for lo, hi in ((0, 1), (3, 11), (11, 24)):
            d, i = tpar.distributed_ivf_flat_search(
                sharded, q[lo:hi], K, EXHAUSTIVE, mesh=tm, merge="int8")
            np.testing.assert_array_equal(i.numpy(), i_all[lo:hi].numpy())
            # a one-row product may round apart from a many-row one
            np.testing.assert_allclose(d.numpy(), d_all[lo:hi].numpy(),
                                       rtol=1e-6)


def _server(sharded, tm, q, **cfg):
    merge = cfg.pop("merge", None)
    config = ServeConfig(batch_sizes=(1, 8, 32), max_wait_ms=1.0, **cfg)
    return DistributedSearchServer.from_sharded_index(
        sharded, q[:32], K, EXHAUSTIVE, mesh=tm, config=config, merge=merge)


class TestDistributedServer:
    SIZES = (3, 1, 5, 8, 2, 7, 1, 4, 6, 3, 9, 2, 5, 8)

    @pytest.mark.parametrize("merge", ["int8", "f32"])
    def test_served_equals_direct_and_steady_state(self, dataset, sharded,
                                                   tm, merge):
        _, q = dataset
        srv = _server(sharded, tm, q, merge=merge)
        try:
            before = tobs.snapshot()
            futs, lo = [], 0
            for s in self.SIZES:
                futs.append((lo, srv.submit(q[lo:lo + s])))
                lo += s
            got = [(lo, f.result(60)) for lo, f in futs]
            after = tobs.snapshot()
        finally:
            srv.close()
        for name in ("raft.parallel.plan.misses", "raft.plan.cache.misses",
                     "raft.plan.build.total"):
            assert _cdiff(before, after, name) == 0, name
        assert _cdiff(before, after, "raft.parallel.plan.hits") > 0
        assert _cdiff(before, after, "raft.serve.dist.batches") > 0
        # a query's result does not depend on its batch: one direct call
        d, i = tpar.distributed_ivf_flat_search(sharded, q[:lo], K,
                                                EXHAUSTIVE, mesh=tm,
                                                merge=merge)
        for start, (dd, ii) in got:
            n = ii.shape[0]
            np.testing.assert_array_equal(ii, i[start:start + n].numpy())
            np.testing.assert_allclose(dd, d[start:start + n].numpy(),
                                       rtol=1e-6)
        g = after["gauges"]
        assert g["raft.serve.dist.shards"] == 8
        if merge == "int8":
            assert 0 < g["raft.serve.dist.merge.ratio"] <= 0.35
        else:
            assert g["raft.serve.dist.merge.ratio"] == 1.0

    def test_dispatch_site_and_stall_without_failover(self, dataset,
                                                      sharded, tm):
        """A stalled shard without failover trips the watchdog: the
        request fails typed (``ShardFailedError``) after the retries."""
        _, q = dataset
        srv = _server(sharded, tm, q, **WATCHDOG, max_retries=1)
        try:
            with faults.stall_shard(3, seconds=STALL_S) as rule:
                with pytest.raises(ShardFailedError):
                    srv.search(q[:1], timeout=30)
                assert rule.hits >= 1
            d, i = srv.search(q[:1], timeout=30)
            assert (i >= 0).all()
        finally:
            srv.close()

    def test_failover_partial_and_recovery(self, dataset, sharded, tm):
        _, q = dataset
        srv = _server(sharded, tm, q, failover=True, failover_probe_ms=50.0,
                      **WATCHDOG, max_retries=2)
        sizes = np.asarray(sharded.list_sizes).astype(np.float64)
        want_cov = 1.0 - sizes[6:8].sum() / sizes.sum()
        try:
            before = tobs.snapshot()
            with faults.stall_shard(3, seconds=STALL_S):
                first = srv.search(q[:1], timeout=60)
                rest = [srv.submit(q[j:j + 1]) for j in range(1, 9)]
                rest = [f.result(30) for f in rest]
            mid = tobs.snapshot()
            for r in [first] + rest:
                assert r.partial
                assert r.coverage == pytest.approx(want_cov, abs=1e-4)
                assert (r.ids >= 0).all()
                # nothing from rank 3's lists
                lists3 = np.asarray(sharded.lists_indices)[6:8]
                assert not set(r.ids.ravel()) & set(lists3[lists3 >= 0])
            assert srv.excluded_ranks == (3,)
            # coverage-flagged quality samples name the excluded rank
            assert srv._quality_detail() == "3"
            assert _cdiff(before, mid, "raft.serve.failover.total") == 1
            assert _cdiff(before, mid, "raft.serve.failover.partial.total") \
                >= 9
            import time
            time.sleep(0.2)
            r = srv.search(q[:1], timeout=30)
            after = tobs.snapshot()
            assert not getattr(r, "partial", False)
            assert srv.excluded_ranks == ()
            assert _cdiff(mid, after, "raft.serve.failover.recovered.total") \
                == 1
            for name in ("raft.parallel.plan.misses",
                         "raft.plan.cache.misses", "raft.plan.build.total"):
                assert _cdiff(before, after, name) == 0, name
            assert after["gauges"]["raft.serve.failover.engaged"] == 0
        finally:
            srv.close()


class TestHealthzDist:
    def _snap(self, suspect):
        g = {"raft.serve.dist.shards": 8.0,
             "raft.serve.dist.merge.ratio": 0.1301,
             "raft.comms.health.suspect_rank{rank=5,session=default}":
                 float(suspect),
             "raft.comms.health.suspect_rank{rank=2,session=default}": 0.0}
        if suspect:
            g["raft.comms.health.suspects{session=default}"] = 1.0
        return {"gauges": g, "counters": {}, "histograms": {}}

    @pytest.mark.parametrize("suspect", [True, False])
    def test_health_body_equals_jax(self, suspect):
        from raft_tpu.obs import endpoint as jend
        from raft_tpu_torch.obs import endpoint as tend
        snap = self._snap(suspect)
        body = tend._health_body(snap)
        assert body == jend._health_body(snap)
        assert body["serve"]["dist"]["suspect_ranks"] == \
            ([5] if suspect else [])
        assert body["serve"]["dist"]["shards"] == 8

    def test_live_endpoint_dist_section(self, dataset, sharded, tm):
        """A live endpoint over the server names its mesh; the verdict
        (200 or 503) reads the process's other planes too, so only the
        ``dist`` section is held here."""
        from raft_tpu_torch.comms import suspects_from_gauges
        _, q = dataset
        srv = _server(sharded, tm, q)
        dbg = tobs.serve(port=0, searcher=srv)
        try:
            url = f"http://127.0.0.1:{dbg.port}/healthz"
            try:
                with urllib.request.urlopen(url, timeout=10) as r:
                    body = json.loads(r.read())
            except urllib.error.HTTPError as e:
                assert e.code == 503
                body = json.loads(e.read())
            dist = body["serve"]["dist"]
            assert dist["shards"] == 8
            assert dist["merge_ratio"] == \
                tobs.snapshot()["gauges"]["raft.serve.dist.merge.ratio"]
            assert dist["suspect_ranks"] == suspects_from_gauges(
                tobs.snapshot()["gauges"])
        finally:
            dbg.close()
            srv.close()


class TestLoadgenDist:
    def test_merge_bytes_by_rung_equals_jax(self):
        tools = os.path.join(REPO, "tools")
        sys.path.insert(0, tools)
        try:
            import loadgen as jloadgen
        finally:
            sys.path.remove(tools)
        from raft_tpu_torch.tools import loadgen as tloadgen
        diff = {"raft.serve.dist.merge.bytes_post{level=0}": 100.0,
                "raft.serve.dist.merge.bytes_post{level=1}": 40.0,
                "raft.serve.dist.merge.bytes_pre{level=0}": 900.0,
                "raft.serve.batch.total{level=0}": 3.0}
        assert tloadgen.merge_bytes_by_rung(diff) == \
            jloadgen.merge_bytes_by_rung(diff) == \
            {"rung_0": 100, "rung_1": 40}

"""Mesh-wide mutable serving (``MutableIndex.register_dist``,
``build_dist_serve_ladder``, ``DistributedSearchServer.from_mutable``) and
the mesh rebuild (``compact(mode="rebuild", mesh=...)``), against the JAX
package on its 8-device CPU mesh and the port's eight logical CPU ranks.

* both packages' ``MutableIndex`` over one IVF-Flat index (the JAX
  build handed to the port by ``index_from_numpy``), meshes registered,
  fed the same upserts, deletes, re-upserts and a fold-mode compaction:
  at every (shape, rung) the mesh-wide searches' ids are equal (the f32
  merge; distances within 1e-5 of the distance scale), and every
  ``raft.mutate.*`` and ``raft.plan.*`` counter delta is equal;
* the JAX package's ``TestDistributedMutable`` scenario through both
  packages' ``from_mutable`` servers; ``failover=True`` refused alike;
* the mesh rebuild, held to the port's own single-device rebuild (the
  JAX package's sharded trainer does not run on this jax): every live id
  in exactly one list, no deleted id, the lists :class:`Sharded`, ids
  equal to a search of the lists gathered (``gather_index``);
* on that list-sharded epoch: a fold (block by block) equal to a fold of
  the gathered index, ``MutableIndex.search``, ``warmup``, and a WAL
  checkpoint recovered to the same ids.

Counters are read from ``snapshot()``, never registered here under a
literal name (graftlint GL010/GL011 scan ``tests/``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu import mutate as jmutate
from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.core.error import LogicError as JLogicError
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu_torch import mutate as tmutate
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import parallel as tpar
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.mutate import compact as tcompact
from raft_tpu_torch.mutate.wal import MutationWAL
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors.brute_force import brute_force_knn
from test_torch_parallel import jmesh, tm  # noqa: F401

K = 5
N, DIM, N_LISTS = 2000, 16, 16
FLAT_FIELDS = ("centers", "lists_data", "lists_indices", "lists_norms",
               "list_sizes")
SHAPES, LADDER = (1, 8), (2, 1)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    q = rng.standard_normal((8, DIM)).astype(np.float32)
    new = rng.standard_normal((40, DIM)).astype(np.float32)
    return x, q, new


@pytest.fixture(scope="module")
def jidx(data):
    return jflat.build(data[0], jflat.IndexParams(n_lists=N_LISTS,
                                                  kmeans_n_iters=4))


def _port(jidx):
    return tflat.index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in FLAT_FIELDS},
        int(jidx.metric), jidx.size, float(jidx.scale), device="cpu")


def _deltas(before, after, prefixes=("raft.mutate.", "raft.plan.")):
    keys = set(before["counters"]) | set(after["counters"])
    return {k: after["counters"].get(k, 0) - before["counters"].get(k, 0)
            for k in keys if k.startswith(prefixes)
            and after["counters"].get(k, 0) != before["counters"].get(k, 0)}


def _close(dj, dt):
    dj, dt = np.asarray(dj), np.asarray(dt)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    scale = max(1.0, float(np.abs(dj[fin]).max()))
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=0, atol=1e-5 * scale)


def test_dist_searches_and_counters_equal_jax(jmesh, tm, data, jidx):
    x, q, new = data
    mods = {"jax": (jmutate, jflat, jobs, jmesh),
            "torch": (tmutate, tflat, tobs, tm)}
    m, ladders = {}, {}
    for p, (mut, fl, _, mesh) in mods.items():
        idx = jidx if p == "jax" else _port(jidx)
        m[p] = mut.MutableIndex(
            idx, k=K, params=fl.SearchParams(n_probes=2),
            config=mut.MutateConfig(delta_capacities=(64, 256)))
        ladders[p] = mut.build_dist_serve_ladder(
            m[p], q, mesh=mesh, shapes=SHAPES, probes_ladder=LADDER,
            merge="f32")

    def step(name, fn):
        out = {}
        for p, (_, _, obs, _) in mods.items():
            before = obs.snapshot()
            fn(m[p])
            res = {(s, r): ladders[p].plan_for(s, r)[1].search(q[:s],
                                                                block=True)
                   for s in SHAPES for r in range(len(LADDER))}
            out[p] = (res, _deltas(before, obs.snapshot()))
        for key, (dj, ij) in out["jax"][0].items():
            dt, it = out["torch"][0][key]
            np.testing.assert_array_equal(np.asarray(it), np.asarray(ij),
                                          err_msg=f"{name} {key}")
            _close(dj, dt)
        assert out["torch"][1] == out["jax"][1], name

    step("quiet", lambda mi: None)
    step("upsert", lambda mi: mi.upsert(new[:24]))
    step("delete", lambda mi: mi.delete(np.arange(0, 300, 10)))
    step("reupsert", lambda mi: mi.upsert(new[24:34] + 0.5,
                                          ids=np.arange(400, 410)))
    step("upsert_near", lambda mi: mi.upsert(q[:4] + 1e-3))
    step("compact", lambda mi: mi.compact())
    assert m["torch"].epoch == m["jax"].epoch == 1
    assert m["torch"].stats() == m["jax"].stats()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_from_mutable_scenario(jmesh, tm, data, jidx, pkg):
    """The JAX package's ``TestDistributedMutable`` scenario: an upsert
    found at once with no plan prepared, a delete gone, both surviving a
    compaction."""
    x, _, _ = data
    mut, serve, fl, obs, mesh = (
        (jmutate, jserve, jflat, jobs, jmesh) if pkg == "jax"
        else (tmutate, tserve, tflat, tobs, tm))
    rng = np.random.default_rng(6)
    q = rng.standard_normal((8, DIM)).astype(np.float32)
    idx = jidx if pkg == "jax" else _port(jidx)
    m = mut.MutableIndex(idx, k=5, params=fl.SearchParams(n_probes=2),
                         config=mut.MutateConfig(delta_capacities=(64,)))
    srv = serve.DistributedSearchServer.from_mutable(
        m, q, mesh=mesh, config=serve.ServeConfig(batch_sizes=(1, 8),
                                                  max_wait_ms=0.5))
    try:
        assert srv._quality_src is m
        _, i = srv.search(q[:1])
        ids = m.upsert(q[0:1] + 0.0001)
        before = obs.snapshot()
        _, i = srv.search(q[:1])
        assert int(ids[0]) in np.asarray(i)[0]
        misses = {k: v for k, v in _deltas(before, obs.snapshot(),
                                           ("raft.plan.cache.misses",
                                            "raft.parallel.plan.misses")
                                           ).items()}
        assert not misses
        victim = int(np.asarray(i)[0][1])
        m.delete([victim])
        _, i = srv.search(q[:1])
        assert victim not in np.asarray(i)[0]
        assert m.compact()
        _, i = srv.search(q[:1])
        got = np.asarray(i)[0]
        assert int(ids[0]) in got and victim not in got
    finally:
        srv.close()


def test_from_mutable_refuses_failover_like_jax(jmesh, tm, data, jidx):
    q = data[1]
    errs = []
    for mut, serve, fl, err, mesh, idx in (
            (jmutate, jserve, jflat, JLogicError, jmesh, jidx),
            (tmutate, tserve, tflat, LogicError, tm, _port(jidx))):
        m = mut.MutableIndex(idx, k=5, params=fl.SearchParams(n_probes=2))
        with pytest.raises(err) as e:
            serve.DistributedSearchServer.from_mutable(
                m, q, mesh=mesh, config=serve.ServeConfig(
                    batch_sizes=(1,), failover=True))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def _live(m):
    """The live corpus of a MutableIndex's main lists: {id: list}."""
    ids = m.index.lists_indices
    ids = ids.numpy() if isinstance(ids, tpar.Sharded) else ids.numpy()
    return {int(i): li for li, row in enumerate(ids) for i in row
            if i >= 0}


def _mutated(x, new, jidx, n_probes=N_LISTS):
    """A port MutableIndex over the JAX build with 40 upserts, 60
    deletes and 10 re-upserts applied → (index, deleted ids, live
    corpus {id: row})."""
    m = tmutate.MutableIndex(
        _port(jidx), k=K, params=tflat.SearchParams(n_probes=n_probes),
        config=tmutate.MutateConfig(delta_capacities=(64, 256)))
    corpus = {i: x[i] for i in range(N)}
    ids = m.upsert(new)
    corpus.update(zip(ids.tolist(), new))
    dead = list(range(3, 600, 10))
    m.delete(dead)
    for i in dead:
        corpus.pop(i, None)
    re_ids = np.arange(1000, 1010)
    m.upsert(new[:10] * 0.5, ids=re_ids)
    corpus.update(zip(re_ids.tolist(), new[:10] * 0.5))
    return m, dead, corpus


def _exact(corpus, q, k=K):
    ids = np.asarray(sorted(corpus))
    rows = np.stack([corpus[i] for i in ids])
    d, i = brute_force_knn(torch.from_numpy(rows), torch.from_numpy(q), k,
                           DistanceType.L2Expanded, device="cpu")
    return d.numpy(), ids[i.numpy()]


def test_mesh_rebuild_held_to_single_device(tm, data, jidx):
    x, q, new = data
    m, dead, corpus = _mutated(x, new, jidx)
    single, _, _ = _mutated(x, new, jidx)
    assert m.compact(mode="rebuild", mesh=tm)
    assert single.compact(mode="rebuild")
    assert m.epoch == single.epoch == 1
    idx = m.index
    assert isinstance(idx.lists_indices, tpar.Sharded)
    assert isinstance(idx.lists_data, tpar.Sharded)
    ids = idx.lists_indices.numpy()
    live = np.sort(ids[ids >= 0])
    np.testing.assert_array_equal(live, np.asarray(sorted(corpus)))
    single_ids = single.index.lists_indices.numpy()
    np.testing.assert_array_equal(live, np.sort(single_ids[single_ids >= 0]))
    assert not set(dead) & set(live.tolist())
    assert idx.list_sizes.numpy().sum() == live.size == idx.size
    # the whole probe: the sharded epoch, its lists gathered, the
    # single-device rebuild and the exact scan give one answer
    de, ie = _exact(corpus, q)
    d, i = m.search(q)
    np.testing.assert_array_equal(i.numpy(), ie)
    g = tpar.gather_index(idx)
    assert not isinstance(g.lists_indices, tpar.Sharded)
    _, ig = tflat.search(g, q, K, tflat.SearchParams(n_probes=N_LISTS,
                                                     scan_order="probe"))
    np.testing.assert_array_equal(ig.numpy(), ie)
    np.testing.assert_array_equal(single.search(q)[1].numpy(), ie)


def test_sharded_epoch_folds_searches_and_recovers(tm, data, jidx,
                                                   tmp_path):
    x, q, new = data
    m, dead, corpus = _mutated(x, new, jidx)
    wal_path = str(tmp_path / "wal.log")
    ckpt = str(tmp_path / "ckpt.npz")
    m.attach_wal(MutationWAL(wal_path), checkpoint_path=ckpt)
    assert m.compact(mode="rebuild", mesh=tm)
    sharded = m.index
    # the next fold, block by block, against a fold of the gathered lists
    rng = np.random.default_rng(3)
    more = rng.standard_normal((12, DIM)).astype(np.float32)
    ids = m.upsert(more)
    corpus.update(zip(ids.tolist(), more))
    gone = [5, 2001, 1003]
    m.delete(gone)
    for i in gone:
        corpus.pop(i, None)
    m.warmup(q, shapes=(8,))
    want = tcompact.fold(tpar.gather_index(sharded), more, ids, set(gone))
    assert m.compact()
    assert m.epoch == 2
    folded = m.index
    assert isinstance(folded.lists_indices, tpar.Sharded)
    np.testing.assert_array_equal(folded.lists_indices.numpy(),
                                  want.lists_indices.numpy())
    np.testing.assert_array_equal(folded.lists_data.numpy(),
                                  want.lists_data.numpy())
    assert folded.size == want.size == len(corpus)
    # MutableIndex.search and the warmed grid on the sharded epoch
    de, ie = _exact(corpus, q)
    _, i = m.search(q)
    np.testing.assert_array_equal(i.numpy(), ie)
    _, ig = tflat.search(tpar.gather_index(folded), q, K, tflat.SearchParams(
        n_probes=N_LISTS, scan_order="probe"))
    np.testing.assert_array_equal(ig.numpy(), ie)
    # the WAL checkpoint of the sharded epoch, recovered
    m.upsert(more[:2] + 3.0, ids=[7000, 7001])
    _, live_ids = m.search(q)
    r = tmutate.MutableIndex.recover(
        wal_path, k=K, checkpoint_path=ckpt, device="cpu",
        params=tflat.SearchParams(n_probes=N_LISTS),
        config=tmutate.MutateConfig(delta_capacities=(64, 256)))
    assert r.epoch == m.epoch and r.stats()["next_id"] == \
        m.stats()["next_id"]
    np.testing.assert_array_equal(r.search(q)[1].numpy(), live_ids.numpy())


def test_mesh_rebuild_served_mesh_wide(tm, data, jidx):
    """A served mutable index through the mesh rebuild: the next epoch's
    dist grid warmed before the swap (no plan on the serving path after
    it), its searches equal the single-device grid's at the whole
    probe."""
    x, q, new = data
    m, _, corpus = _mutated(x, new, jidx)
    ladder = tmutate.build_dist_serve_ladder(
        m, q, mesh=tm, shapes=(8,), probes_ladder=(N_LISTS,), merge="f32")
    plan = ladder.plan_for(8, 0)[1]
    assert plan.n_shards == 8 and plan.mesh is tm
    assert m.compact(mode="rebuild", mesh=tm)
    before = tobs.snapshot()
    _, i = plan.search(q, block=True)
    assert not _deltas(before, tobs.snapshot(),
                       ("raft.plan.cache.misses",
                        "raft.parallel.plan.misses"))
    np.testing.assert_array_equal(i.numpy(), _exact(corpus, q)[1])
    assert isinstance(m._dist_plan(8, 0)._index.lists_data, tpar.Sharded)
    assert dataclasses.is_dataclass(m.index)

"""The row-sharded multi-part IVF indexes (``raft_tpu_torch.parallel``'s
``distributed_ivf_*_build`` / ``*_search_parts``) and the cross-shard
merges above k = 256, against the JAX package on its 8-device CPU mesh
and the port's eight logical CPU ranks.

* the JAX package's ``TestDistributedIvfBuild`` scenarios through both
  packages: IVF-Flat at full probe equal to the exact search, every
  global id once at n = 1000, IVF-PQ recall, IVF-BQ rescored (exact
  distances) and estimator-only;
* each build's parts, from the JAX package's centres (and rotation and
  books) handed to the port: the ids in the same slots, ``parts_data``
  bit for bit, norms within 1e-6, PQ codes and BQ bits equal;
* each ``search_parts`` over the JAX package's build handed over by
  ``index_from_numpy(..., mesh=)``: ids equal (fp32 near-ties aside),
  distances within 1e-5; IVF-PQ at every ``lut_dtype``; IVF-BQ at kk =
  512;
* the unsupported metrics, storages and codebook kinds fail as the JAX
  package's ``expects`` do; a second search prepares no plan;
* the list-sharded search's f32 and int8 merges at k = 300 (a stable
  sort above kernel 2's bound) equal the JAX package's, and the plain
  selects hold that bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from raft_tpu import parallel as jpar
from raft_tpu.core.error import LogicError as JLogicError
from raft_tpu.neighbors import ivf_bq as jbq
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import parallel as tpar
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors.brute_force import brute_force_knn
from raft_tpu_torch.ops import select_k as sel_op
from raft_tpu_torch.parallel import kmeans as tpkm
from test_torch_parallel import _jax_flat, jmesh, tm  # noqa: F401

CPU = torch.device("cpu")
RTOL = 1e-5
_LUTS = {"float32": (torch.float32, jnp.float32),
         "bfloat16": (torch.bfloat16, jnp.bfloat16),
         "float8_e4m3fn": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _normal(seed, n, d, nq):
    """The JAX scenarios' data: ``jax.random.normal`` rows and queries."""
    key = jax.random.key(seed)
    db = np.asarray(jax.random.normal(key, (n, d)), np.float32)
    q = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (nq, d)),
                   np.float32)
    return db, q


def _np(a):
    return a.numpy() if isinstance(a, (torch.Tensor, tpar.Sharded)) \
        else np.asarray(a)


def _recall(ids, truth):
    ids, truth = _np(ids), _np(truth)
    k = truth.shape[1]
    return np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, truth)])


def _same_ids(dj, ij, dt, it, rtol=RTOL):
    """Ids equal wherever the two packages' distances leave no fp32
    near-tie: a differing slot must hold, in the other package's row, an
    id whose distance lies within ``rtol`` of the distance scale; the
    distances agree within ``rtol`` everywhere. Returns the number of
    slots that differ."""
    dj, ij, dt, it = _np(dj), _np(ij), _np(dt), _np(it)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    scale = max(1.0, float(np.abs(dj[fin]).max()))
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=0, atol=rtol * scale)
    bad = np.argwhere(ij != it)
    for r, c in bad:
        near = np.abs(dj[r] - dj[r, c]) <= 2 * rtol * scale
        assert it[r, c] in set(ij[r][near]) or \
            np.abs(dj[r, -1] - dj[r, c]) <= 2 * rtol * scale, (r, c)
    assert len(bad) <= max(2, ij.size // 500), len(bad)
    return len(bad)


# ---------------------------------------------------------------------
# the JAX package's scenarios, through both packages

def _pkg(name, jmesh, tm):
    if name == "jax":
        return jpar, jflat, jpq, jbq, jmesh
    return tpar, tflat, tpq, tbq, tm


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_flat_full_probe_equals_exact(jmesh, tm, pkg):
    par, flat, _, _, mesh = _pkg(pkg, jmesh, tm)
    db, q = _normal(0, 2048, 24, 32)
    didx = par.distributed_ivf_flat_build(
        db, flat.IndexParams(n_lists=16, kmeans_n_iters=3), mesh,
        axis="data")
    assert didx.parts_data.shape[0] == 8
    d, i = par.distributed_ivf_flat_search_parts(
        didx, q, 8, flat.SearchParams(n_probes=16))
    de, ie = brute_force_knn(torch.from_numpy(db), torch.from_numpy(q), 8,
                             DistanceType.L2Expanded, device="cpu")
    np.testing.assert_array_equal(_np(i), ie.numpy())
    np.testing.assert_allclose(_np(d), de.numpy(), rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_flat_build_ids_are_global(jmesh, tm, pkg):
    par, flat, _, _, mesh = _pkg(pkg, jmesh, tm)
    db, _ = _normal(1, 1000, 8, 1)          # not divisible by 8
    didx = par.distributed_ivf_flat_build(
        db, flat.IndexParams(n_lists=8, kmeans_n_iters=2), mesh,
        axis="data")
    ids = _np(didx.parts_indices)
    assert sorted(ids[ids >= 0].tolist()) == list(range(1000))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_pq_build_search_parts(jmesh, tm, pkg):
    par, _, pq, _, mesh = _pkg(pkg, jmesh, tm)
    db, q = _normal(2, 2048, 32, 32)
    didx = par.distributed_ivf_pq_build(
        db, pq.IndexParams(n_lists=16, kmeans_n_iters=3), mesh,
        axis="data")
    assert _np(didx.parts_codes).dtype == np.uint8
    d, i = par.distributed_ivf_pq_search_parts(
        didx, q, 10, pq.SearchParams(n_probes=16))
    _, ie = brute_force_knn(torch.from_numpy(db), torch.from_numpy(q), 10,
                            DistanceType.L2Expanded, device="cpu")
    assert _recall(i, ie) >= 0.5


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_bq_build_search_parts_rescored(jmesh, tm, pkg):
    par, _, _, bq, mesh = _pkg(pkg, jmesh, tm)
    db, q = _normal(3, 2048, 32, 32)
    didx = par.distributed_ivf_bq_build(
        db, bq.IndexParams(n_lists=16, kmeans_n_iters=3), mesh,
        axis="data")
    assert didx.parts_bits.shape[0] == 8
    ids = _np(didx.parts_indices)
    assert sorted(ids[ids >= 0].tolist()) == list(range(2048))
    d, i = par.distributed_ivf_bq_search_parts(
        didx, q, 10, bq.SearchParams(n_probes=16, rescore_factor=16))
    _, ie = brute_force_knn(torch.from_numpy(db), torch.from_numpy(q), 10,
                            DistanceType.L2Expanded, device="cpu")
    assert _recall(i, ie) >= 0.6
    want = ((db[_np(i)] - q[:, None, :]) ** 2).sum(2)
    np.testing.assert_allclose(_np(d), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_bq_estimator_only_no_raw(jmesh, tm, pkg):
    par, _, _, bq, mesh = _pkg(pkg, jmesh, tm)
    db, q = _normal(4, 1024, 32, 16)
    didx = par.distributed_ivf_bq_build(
        db, bq.IndexParams(n_lists=8, kmeans_n_iters=2, keep_raw=False),
        mesh, axis="data")
    assert didx.raw is None
    d, i = par.distributed_ivf_bq_search_parts(
        didx, q, 5, bq.SearchParams(n_probes=8))
    assert tuple(d.shape) == (16, 5) and tuple(i.shape) == (16, 5)
    assert (_np(i) >= 0).all()


# ---------------------------------------------------------------------
# the port's builds from the JAX package's trained state

def _handed(monkeypatch, jd, rot=None, books=None):
    """The port's trainers patched to the JAX build's centres (and
    rotation and books): k-means++ and the rotations draw differently by
    design."""
    c = torch.from_numpy(np.asarray(jd.centers))
    monkeypatch.setattr(tpkm, "distributed_kmeans_fit",
                        lambda *a, **k: (c, None, 0))
    if rot is not None:
        r = torch.from_numpy(np.asarray(rot))
        monkeypatch.setattr(tpq, "make_rotation_matrix",
                            lambda *a, **k: r)
    if books is not None:
        b = torch.from_numpy(np.asarray(books))
        monkeypatch.setattr(tpq, "_train_codebooks_per_subspace",
                            lambda *a, **k: b)


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct])
def test_flat_parts_equal_jax(jmesh, tm, monkeypatch, metric):
    db, _ = _normal(5, 2044, 16, 1)         # four pad rows on the last rank
    p = dict(n_lists=16, kmeans_n_iters=3, metric=metric)
    jd = jpar.distributed_ivf_flat_build(db, jflat.IndexParams(**p), jmesh)
    _handed(monkeypatch, jd)
    td = tpar.distributed_ivf_flat_build(db, tflat.IndexParams(**p), tm)
    assert td.parts_data.shape == jd.parts_data.shape
    np.testing.assert_array_equal(td.parts_indices.numpy(),
                                  np.asarray(jd.parts_indices))
    np.testing.assert_array_equal(td.parts_data.numpy(),
                                  np.asarray(jd.parts_data))
    np.testing.assert_allclose(td.parts_norms.numpy(),
                               np.asarray(jd.parts_norms), rtol=1e-6)
    assert td.size == jd.size and td.metric == metric


def test_pq_parts_equal_jax(jmesh, tm, monkeypatch):
    db, _ = _normal(6, 2048, 32, 1)
    p = dict(n_lists=16, kmeans_n_iters=3, pq_dim=8)
    jd = jpar.distributed_ivf_pq_build(db, jpq.IndexParams(**p), jmesh)
    _handed(monkeypatch, jd, jd.rotation_matrix, jd.pq_centers)
    td = tpar.distributed_ivf_pq_build(db, tpq.IndexParams(**p), tm)
    ids = np.asarray(jd.parts_indices)
    np.testing.assert_array_equal(td.parts_indices.numpy(), ids)
    ok = ids >= 0
    codes_eq = (td.parts_codes.numpy() == np.asarray(jd.parts_codes))[ok]
    assert codes_eq.mean() >= 0.9999
    np.testing.assert_allclose(td.parts_norms.numpy(),
                               np.asarray(jd.parts_norms), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.centers_rot.numpy(),
                               np.asarray(jd.centers_rot), rtol=1e-5,
                               atol=1e-5)


def test_bq_parts_equal_jax(jmesh, tm, monkeypatch):
    db, _ = _normal(7, 2048, 40, 1)         # two sign words, the last short
    p = dict(n_lists=16, kmeans_n_iters=3)
    jd = jpar.distributed_ivf_bq_build(db, jbq.IndexParams(**p), jmesh)
    _handed(monkeypatch, jd, jd.rotation_matrix)
    td = tpar.distributed_ivf_bq_build(db, tbq.IndexParams(**p), tm)
    np.testing.assert_array_equal(td.parts_indices.numpy(),
                                  np.asarray(jd.parts_indices))
    np.testing.assert_array_equal(td.parts_bits.numpy().view(np.uint32),
                                  np.asarray(jd.parts_bits))
    ok = np.asarray(jd.parts_indices) >= 0
    for f in ("parts_norms2", "parts_scales"):
        np.testing.assert_allclose(getattr(td, f).numpy()[ok],
                                   np.asarray(getattr(jd, f))[ok],
                                   rtol=1e-6)
    np.testing.assert_array_equal(td.raw, np.asarray(jd.raw))


# ---------------------------------------------------------------------
# the port's searches over the JAX package's builds

_FLAT_CACHE = {}


def _jax_flat_parts(jmesh, metric):
    if metric not in _FLAT_CACHE:
        db, q = _normal(8, 2048, 24, 40)
        jd = jpar.distributed_ivf_flat_build(db, jflat.IndexParams(
            n_lists=16, kmeans_n_iters=3, metric=metric), jmesh)
        _FLAT_CACHE[metric] = (jd, q)
    return _FLAT_CACHE[metric]


def _hand_over(jd, family, mesh):
    fields = {"ivf_flat": ("centers", "parts_data", "parts_indices",
                           "parts_norms"),
              "ivf_pq": ("centers", "centers_rot", "rotation_matrix",
                         "pq_centers", "parts_codes", "parts_indices",
                         "parts_norms"),
              "ivf_bq": ("centers", "centers_rot", "rotation_matrix",
                         "parts_bits", "parts_norms2", "parts_scales",
                         "parts_indices")}[family]
    arrays = {f: np.asarray(getattr(jd, f)) for f in fields}
    if family == "ivf_flat":
        return tflat.index_from_numpy(arrays, jd.metric, jd.size, mesh=mesh)
    if family == "ivf_pq":
        return tpq.index_from_numpy(arrays, jd.metric, jd.size, jd.pq_bits,
                                    mesh=mesh)
    return tbq.index_from_numpy(arrays, jd.metric, jd.size, raw=jd.raw,
                                mesh=mesh)


@pytest.mark.parametrize("n_probes", [4, 16])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded,
                                    DistanceType.InnerProduct,
                                    DistanceType.CosineExpanded])
def test_flat_search_parts_equal_jax(jmesh, tm, metric, n_probes):
    jd, q = _jax_flat_parts(jmesh, metric)
    td = _hand_over(jd, "ivf_flat", tm)
    assert isinstance(td, tpar.DistributedIvfFlat)
    assert td.parts_data.blocks[0].shape == (1,) + jd.parts_data.shape[1:]
    dj, ij = jpar.distributed_ivf_flat_search_parts(
        jd, q, 10, jflat.SearchParams(n_probes=n_probes))
    dt, it = tpar.distributed_ivf_flat_search_parts(
        td, q, 10, tflat.SearchParams(n_probes=n_probes))
    _same_ids(dj, ij, dt, it)


@pytest.mark.parametrize("lut", sorted(_LUTS))
def test_pq_search_parts_equal_jax(jmesh, tm, lut):
    db, q = _normal(9, 2048, 32, 40)
    jd = jpar.distributed_ivf_pq_build(db, jpq.IndexParams(
        n_lists=16, kmeans_n_iters=3), jmesh)
    td = _hand_over(jd, "ivf_pq", tm)
    t_lut, j_lut = _LUTS[lut]
    dj, ij = jpar.distributed_ivf_pq_search_parts(
        jd, q, 10, jpq.SearchParams(n_probes=8, lut_dtype=j_lut))
    dt, it = tpar.distributed_ivf_pq_search_parts(
        td, q, 10, tpq.SearchParams(n_probes=8, lut_dtype=t_lut))
    assert (it.numpy() == np.asarray(ij)).mean() >= 0.999
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("rescore_factor", [16, 0])
def test_bq_search_parts_kk512_equal_jax(jmesh, tm, rescore_factor):
    """k = 32 at ``rescore_factor`` 16: the ranks merge kk = 512
    estimator candidates (above kernel 2's bound) before the re-rank.
    The estimator alone (factor 0) is held at 1e-4: its products sum
    bf16-rounded operands in each package's own order."""
    db, q = _normal(10, 2048, 32, 24)
    jd = jpar.distributed_ivf_bq_build(db, jbq.IndexParams(
        n_lists=16, kmeans_n_iters=3), jmesh)
    td = _hand_over(jd, "ivf_bq", tm)
    sp = dict(n_probes=16, rescore_factor=rescore_factor)
    dj, ij = jpar.distributed_ivf_bq_search_parts(jd, q, 32,
                                                  jbq.SearchParams(**sp))
    dt, it = tpar.distributed_ivf_bq_search_parts(td, q, 32,
                                                  tbq.SearchParams(**sp))
    _same_ids(dj, ij, dt, it, rtol=RTOL if rescore_factor else 1e-4)


def _unsupported(x):
    """case -> (the JAX call, the port call)."""
    return {
        "flat_metric": (
            lambda m: jpar.distributed_ivf_flat_build(x, jflat.IndexParams(
                n_lists=8, metric=DistanceType.L1), m),
            lambda m: tpar.distributed_ivf_flat_build(x, tflat.IndexParams(
                n_lists=8, metric=DistanceType.L1), m)),
        "flat_storage": (
            lambda m: jpar.distributed_ivf_flat_build(x, jflat.IndexParams(
                n_lists=8, storage_dtype="bfloat16"), m),
            lambda m: tpar.distributed_ivf_flat_build(x, tflat.IndexParams(
                n_lists=8, storage_dtype="bfloat16"), m)),
        "pq_per_cluster": (
            lambda m: jpar.distributed_ivf_pq_build(x, jpq.IndexParams(
                n_lists=8, codebook_kind=jpq.CodebookGen.PER_CLUSTER), m),
            lambda m: tpar.distributed_ivf_pq_build(x, tpq.IndexParams(
                n_lists=8, codebook_kind=tpq.CodebookGen.PER_CLUSTER), m)),
        "pq_cosine": (
            lambda m: jpar.distributed_ivf_pq_build(x, jpq.IndexParams(
                n_lists=8, metric=DistanceType.CosineExpanded), m),
            lambda m: tpar.distributed_ivf_pq_build(x, tpq.IndexParams(
                n_lists=8, metric=DistanceType.CosineExpanded), m)),
        "bq_inner_product": (
            lambda m: jpar.distributed_ivf_bq_build(x, jbq.IndexParams(
                n_lists=8, metric=DistanceType.InnerProduct), m),
            lambda m: tpar.distributed_ivf_bq_build(x, tbq.IndexParams(
                n_lists=8, metric=DistanceType.InnerProduct), m)),
        "no_mesh": (
            lambda m: jpar.distributed_ivf_flat_build(x, None, None),
            lambda m: tpar.distributed_ivf_flat_build(x, None, None)),
    }


@pytest.mark.parametrize("case", sorted(_unsupported(None)))
def test_unsupported_fails_like_jax(jmesh, tm, case):
    x = _normal(11, 256, 8, 1)[0]
    jcall, tcall = _unsupported(x)[case]
    with pytest.raises(JLogicError) as ej:
        jcall(jmesh)
    with pytest.raises(LogicError) as et:
        tcall(tm)
    assert str(et.value) == str(ej.value)


def test_second_search_prepares_no_plan(jmesh, tm):
    jd, q = _jax_flat_parts(jmesh, DistanceType.L2Expanded)
    td = _hand_over(jd, "ivf_flat", tm)
    sp = tflat.SearchParams(n_probes=3)
    tpar.distributed_ivf_flat_search_parts(td, q, 7, sp)
    c0 = tobs.snapshot()["counters"]
    tpar.distributed_ivf_flat_search_parts(td, q, 7, sp)
    c1 = tobs.snapshot()["counters"]
    assert c1.get("raft.parallel.plan.misses", 0) == \
        c0.get("raft.parallel.plan.misses", 0)
    assert c1["raft.parallel.plan.hits"] == \
        c0.get("raft.parallel.plan.hits", 0) + 1


# ---------------------------------------------------------------------
# F15: the cross-shard merges above k = 256

@pytest.mark.parametrize("merge", ["f32", "int8"])
def test_list_sharded_merge_k300_equals_jax(jmesh, tm, merge):
    """k = 300 through both cross-shard merges of the list-sharded
    search (kernel 2 takes k <= 256; above it a stable sort, the same
    (value, column) order) against the JAX package's ``lax.top_k``."""
    db, q = _normal(12, 4096, 16, 24)
    t = tflat.build(db, tflat.IndexParams(n_lists=16, kmeans_n_iters=3),
                    device="cpu")
    sp = dict(n_probes=2)
    dt, it = tpar.distributed_ivf_flat_search(
        tpar.shard_ivf_flat(t, tm), q, 300, tflat.SearchParams(**sp),
        mesh=tm, merge=merge)
    dj, ij = jpar.distributed_ivf_flat_search(
        jpar.shard_ivf_flat(_jax_flat(t), jmesh), q, 300,
        jflat.SearchParams(**sp), mesh=jmesh, merge=merge)
    assert tuple(it.shape) == (24, 300)
    _same_ids(dj, ij, dt, it, rtol=1e-2 if merge == "int8" else RTOL)


@pytest.mark.parametrize("which", ["select_k_plain",
                                   "select_k_payload_plain"])
def test_plain_selects_hold_the_kernel_bound(which):
    """The plain versions reject k > 256 as the kernels do, so a CPU
    caller meets what a card caller would; the any-k select takes it."""
    v = torch.rand(4, 400)
    ids = torch.arange(400, dtype=torch.int32).repeat(4, 1)
    args = (v, 257) if which == "select_k_plain" else (v, ids, 257)
    with pytest.raises(ValueError, match="outside"):
        getattr(sel_op, which)(*args)
    d, i = sel_op.select_k_payload_any(v, ids, 300)
    want_d, want_i = torch.sort(v, dim=1, stable=True)
    assert torch.equal(d, want_d[:, :300])
    assert torch.equal(i, want_i[:, :300].to(torch.int32))

"""Parity of the port's IVF-BQ (raft_tpu_torch) with the JAX package's.

The JAX side runs its Pallas kernels in interpret mode; the port runs
its plain versions (CPU tensors). Inputs are made with numpy from
seeds; d = 48, so the second 32-bit word of every row is partial.
Search parity uses a JAX-built index loaded through the shared file
format (the two packages draw their random rotations differently).

Tolerances, and why:
* scans and searches: distances within rtol 1e-5 of the |qsub|^2 +
  norms2 scale for estimator scores (of the values themselves, at
  least 1e-5, for exact-rescore results) — both sides add the same
  exact +-bf16 products in f32 in another order; ids identical except
  where two candidates' scores lie within that tolerance (an f32
  near-tie the order can flip);
* build stages on the same inputs: sign bits equal on >= 99.99% of
  positions (the two f32 rotation products round near-zero components
  differently), norms2 and scales within rtol 1e-5; coarse centres
  within 1e-4 as in the IVF-Flat build test, and the rotation-invariant
  norms2 of the two builds within rtol 1e-3, what a 1e-4 centre shift
  moves |x - c|^2 by at most.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.distance.distance_types import DistanceType as JDT
from raft_tpu.neighbors import ivf_bq as jbq
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import serialize as jser
from raft_tpu.ops.pallas_ivf_scan import ivf_bq_scan_pallas
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import _ivf_scan as t_scan
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.neighbors import serialize as tser
from raft_tpu_torch.ops import ivf_bq_scan as bq_op

N, D, NQ, N_LISTS, K = 4000, 48, 64, 16, 10


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _tol(dj, scale):
    ref = np.abs(dj) if scale is None else np.asarray(scale, np.float64)
    ref = np.broadcast_to(ref, dj.shape)
    return 1e-5 * np.maximum(np.where(np.isfinite(ref), ref, 1.0), 1.0)


def _same(dt, it, dj, ij, scale=None):
    """Distances within the tolerance and +inf where JAX has +inf; ids
    equal on the filled slots, except that a slot may hold another
    candidate whose JAX-side score ties the slot's within the
    tolerance. A slot no candidate reached holds id -1 in the port; the
    JAX fused kernel leaves a filled slot's id there (its merge rounds
    run out of candidates and re-select an invalidated row)."""
    dt, dj = np.asarray(dt, np.float64), np.asarray(dj, np.float64)
    tol = _tol(dj, scale)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    assert (it[~fin] == -1).all()
    assert (np.abs(dt[fin] - dj[fin]) <= tol[fin]).all()
    for r, c in np.argwhere((it != ij) & fin):
        pos = np.flatnonzero(ij[r] == it[r, c])
        other = dj[r, pos[0]] if pos.size else dt[r, c]
        assert abs(other - dj[r, c]) <= tol[r, c], (r, c, it[r, c], ij[r, c])
    assert (it == ij)[fin].mean() >= 0.99


# --- (a) the scan kernels' plain versions against the Pallas kernels -----

def _scan_inputs(seed, nq=24, n_lists=16, max_list=300, n_probes=5,
                 probes=None):
    rng = np.random.default_rng(seed)
    w = -(-D // 32)
    q_rot = rng.normal(size=(nq, D)).astype(np.float32)
    centers_rot = rng.normal(size=(n_lists, D)).astype(np.float32)
    bits = rng.integers(0, 1 << 32, size=(n_lists, max_list, w),
                        dtype=np.uint64).astype(np.uint32)
    norms2 = rng.uniform(10, 90, size=(n_lists, max_list)).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, size=(n_lists, max_list)).astype(
        np.float32)
    sizes = rng.integers(0, max_list + 1, size=n_lists)
    sizes[0], sizes[1], sizes[2] = max_list, 0, 5     # full, empty, short
    ids = np.full((n_lists, max_list), -1, np.int32)
    nxt = 0
    for l, s in enumerate(sizes):
        ids[l, :s] = np.arange(nxt, nxt + s)
        nxt += s
    for a in (bits, norms2, scales):
        a[ids < 0] = 0
    if probes is None:
        probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                           for _ in range(nq)]).astype(np.int32)
    return q_rot, centers_rot, bits, norms2, scales, ids, probes


def _both_scans(inputs, metric, k, cap, bins, fused):
    q_rot, centers_rot, bits, norms2, scales, ids, probes = inputs
    dj, ij = ivf_bq_scan_pallas(
        jnp.asarray(q_rot), jnp.asarray(centers_rot), jnp.asarray(bits),
        jnp.asarray(norms2), jnp.asarray(scales), jnp.asarray(ids),
        jnp.asarray(probes), k, cap, bins=bins, metric=metric, fused=fused)
    t = [torch.from_numpy(a) for a in (q_rot, centers_rot)]
    dt, it = tbq.bq_scan(*t, torch.from_numpy(bits.view(np.int32)),
                         torch.from_numpy(norms2), torch.from_numpy(scales),
                         torch.from_numpy(ids), torch.from_numpy(probes), k,
                         cap, bins, metric, fused)
    # the score scale where f32 rounding lives: |qsub|^2 + norms2
    scale = ((np.abs(q_rot) + np.abs(centers_rot).max(0)) ** 2).sum(1).max() \
        + norms2.max()
    return dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij), scale


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bins", [128, 300, 7], ids=["auto", "exact", "7"])
def test_scan_plain_matches_pallas(metric, bins):
    # bins 128 = the auto rule min(max(128, 32 kk / n_probes), max_list)
    # at kk <= 256 and 5 probes; 300 = max_list (exact); 7 does not
    # divide max_list (pad rows)
    inputs = _scan_inputs(bins + (metric == "ip"))
    before = (bq_op.launches, bq_op.launches_fused)
    for fused, k in ((True, K), (True, 256), (False, K), (False, 300)):
        dt, it, dj, ij, scale = _both_scans(inputs, metric, k, 16, bins,
                                            fused)
        _same(dt, it, dj, ij, scale)
    assert (bq_op.launches, bq_op.launches_fused) == before   # CPU: plain


@pytest.mark.parametrize("fused", [True, False])
def test_scan_cap_overflow_drop_rule(fused):
    # every (list, probe-rank) class holds one query, so the slot order
    # is forced and the same pairs drop in both packages
    probes = np.array([[(q + p) % 16 for p in range(4)] for q in range(16)],
                      np.int32)
    inputs = _scan_inputs(5, nq=16, probes=probes)
    _, inv = t_scan._invert_probes(torch.from_numpy(probes), 16, 2)
    assert bool((inv >= 2).any()), "cap must overflow"
    dt, it, dj, ij, scale = _both_scans(inputs, "l2", K, 2, 16, fused)
    _same(dt, it, dj, ij, scale)


def test_estimates_go_negative_unclamped():
    # a row whose sign pattern matches the query exactly overshoots:
    # the estimate goes below 0 and must survive binning and merging
    q = np.ones((1, D), np.float32)
    bits = np.full((1, 8, 2), 0xFFFFFFFF, np.uint32)
    norms2 = np.full((1, 8), 1.0, np.float32)
    scales = np.full((1, 8), 2.0, np.float32)
    ids = np.arange(8, dtype=np.int32)[None, :]
    inputs = (q, np.zeros((1, D), np.float32), bits, norms2, scales, ids,
              np.zeros((1, 1), np.int32))
    for fused in (True, False):
        dt, it, dj, ij, scale = _both_scans(inputs, "l2", 4, 8, 8, fused)
        assert (dj < 0).all() and (dt < 0).all()
        _same(dt, it, dj, ij, scale)


def test_pack_and_unpack_match_jax():
    rng = np.random.default_rng(1)
    r = rng.normal(size=(500, D)).astype(np.float32)
    r[:, 31] = np.abs(r[:, 31])            # bit 31 set: a negative int32
    r[::7, 5] = 0.0                        # exact zeros count as >= 0
    bt = tbq._pack_bits(torch.from_numpy(r)).numpy()
    bj = np.asarray(jbq._pack_bits(jnp.asarray(r)))
    np.testing.assert_array_equal(bt.view(np.uint32), bj)
    assert (bt[:, 0] < 0).all()
    np.testing.assert_array_equal(
        tbq._unpack_pm1(torch.from_numpy(bt), D).numpy(),
        np.asarray(jbq._unpack_pm1(jnp.asarray(bj), D, jnp.float32)))


# --- (b) search on a JAX-built index loaded through the file format ------

def _data(seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(24, D)).astype(np.float32) * 2
    x = c[rng.integers(0, 24, N)] + rng.normal(size=(N, D))
    q = c[rng.integers(0, 24, NQ)] + rng.normal(size=(NQ, D))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _data()


METRICS = [DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
           DistanceType.InnerProduct, DistanceType.CosineExpanded]


@pytest.fixture(scope="module")
def indexes(data, tmp_path_factory):
    """metric -> (JAX index, port index loaded from the JAX file)."""
    x, _ = data
    out = {}
    for m in METRICS:
        jidx = jbq.build(x, jbq.IndexParams(n_lists=N_LISTS,
                                            metric=JDT(int(m)),
                                            kmeans_n_iters=4))
        path = str(tmp_path_factory.mktemp("bq") / f"bq_{int(m)}.npz")
        jser.save_ivf_bq(jidx, path)
        out[m] = (jidx, tser.load_ivf_bq(path, device="cpu"))
    return out


def _search_both(jidx, tidx, q, k, **sp):
    dj, ij = jbq.search(jidx, q, k, jbq.SearchParams(**sp))
    dt, it = tbq.search(tidx, q, k, tbq.SearchParams(**sp))
    return dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
@pytest.mark.parametrize("rescore,where", [(0, "never"), (4, "never"),
                                           (4, "always"), (30, "always")],
                         ids=["estimator", "host", "device", "kk300"])
def test_search_matches_jax(indexes, data, metric, rescore, where):
    jidx, tidx = indexes[metric]
    _, q = data
    dt, it, dj, ij = _search_both(jidx, tidx, q, K, n_probes=6,
                                  rescore_factor=rescore,
                                  rescore_on_device=where)
    assert it.dtype == np.int32 and dt.shape == (NQ, K)
    if rescore:
        _same(dt, it, dj, ij)
        return
    # estimator scores: the scale is |qsub|^2 + norms2 (for the ip core
    # the centre term's |q||c| joins it)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True) \
        if metric == DistanceType.CosineExpanded else q
    cn = np.asarray(jidx.centers)
    scale = ((np.abs(qn)[:, None, :] + np.abs(cn)[None]) ** 2).sum(-1).max(1)
    _same(dt, it, dj, ij, scale[:, None] + np.asarray(jidx.norms2).max())


def test_wide_kk_takes_the_unfused_kernel(indexes, data, monkeypatch):
    jidx, tidx = indexes[DistanceType.L2Expanded]
    _, q = data
    calls = []
    real = bq_op.bq_scan
    monkeypatch.setattr(bq_op, "bq_scan",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    dt, it, dj, ij = _search_both(jidx, tidx, q, 30, n_probes=6,
                                  rescore_factor=9)       # kk = 270 > 256
    assert calls
    _same(dt, it, dj, ij)


def test_batched_search_equals_one_batch(indexes, data, monkeypatch):
    _, tidx = indexes[DistanceType.L2Expanded]
    _, q = data
    sp = tbq.SearchParams(n_probes=6, probe_cap=64)
    d_full, i_full = tbq.search(tidx, q, K, sp)
    monkeypatch.setattr(tbq, "MAX_QUERY_BATCH", 24)
    d_b, i_b = tbq.search(tidx, q, K, sp)
    assert torch.equal(i_b, i_full)
    torch.testing.assert_close(d_b, d_full)


# --- (c) build parity ----------------------------------------------------

def test_build_stages_match_jax_on_same_inputs():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3000, D)).astype(np.float32)
    centers = rng.normal(size=(8, D)).astype(np.float32)
    labels = rng.integers(0, 8, 3000).astype(np.int32)
    # the JAX package's rotation, fed to both
    rot = np.array(jpq.make_rotation_matrix(D, D, force_random=True))
    pj, crj = jbq._encode_payload(jnp.asarray(x), jnp.asarray(centers),
                                  jnp.asarray(labels), jnp.asarray(rot))
    pt, crt = tbq._encode_payload(torch.from_numpy(x),
                                  torch.from_numpy(centers),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(rot))
    pj, pt = np.array(pj), pt.numpy()
    w = -(-D // 32)
    bj = np.unpackbits(pj[:, :w].view(np.uint8), bitorder="little")
    bt = np.unpackbits(pt[:, :w].view(np.uint8), bitorder="little")
    assert (bj == bt).mean() >= 0.9999
    for col in (w, w + 1):                     # norms2, scales
        np.testing.assert_allclose(pt[:, col].view(np.float32),
                                   pj[:, col].view(np.float32), rtol=1e-5)
    np.testing.assert_allclose(crt.numpy(), np.asarray(crj), rtol=1e-5,
                               atol=1e-5)
    # the bucketed payload splits the same way
    b3 = pj.reshape(10, 300, w + 2)
    for a, b in zip(tbq._split_payload(torch.from_numpy(b3), w),
                    jbq._split_payload(jnp.asarray(b3), w)):
        np.testing.assert_array_equal(a.numpy().view(np.uint32)
                                      if a.dtype == torch.int32
                                      else a.numpy(), np.asarray(b))


def test_port_build_matches_jax_build():
    # n > 65536 and trainset fraction 1.0: both packages draw the same
    # initial rows, so on separated blobs the lists are identical
    rng = np.random.default_rng(1)
    c = rng.normal(size=(8, D)).astype(np.float32) * 20
    x = (c[rng.integers(0, 8, 70000)]
         + rng.normal(size=(70000, D))).astype(np.float32)
    kw = dict(n_lists=8, kmeans_n_iters=3, kmeans_trainset_fraction=1.0,
              keep_raw=False)
    j = jbq.build(x, jbq.IndexParams(**kw))
    t = tbq.build(x, tbq.IndexParams(**kw), device="cpu")
    for f in ("list_sizes", "lists_indices"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    np.testing.assert_allclose(t.centers.numpy(), np.asarray(j.centers),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t.norms2.numpy(), np.asarray(j.norms2),
                               rtol=1e-3)
    assert t.bits.dtype == torch.int32 and t.bits.shape == j.bits.shape
    rot = t.rotation_matrix.numpy()
    np.testing.assert_allclose(rot @ rot.T, np.eye(D), atol=1e-5)
    assert t.raw is None


# --- (d) save and load, both directions --------------------------------

def test_save_roundtrip_both_directions(indexes, data, tmp_path):
    jidx, tidx = indexes[DistanceType.InnerProduct]
    _, q = data
    path = str(tmp_path / "from_port")             # no .npz suffix
    tser.save_ivf_bq(tidx, path)
    back = jser.load_ivf_bq(path)
    for f in ("centers", "centers_rot", "rotation_matrix", "bits", "norms2",
              "scales", "lists_indices", "list_sizes"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(jidx, f)))
    assert np.asarray(back.bits).dtype == np.uint32
    np.testing.assert_array_equal(back.raw, jidx.raw)
    assert (back.metric, back.size) == (jidx.metric, jidx.size)
    sp = dict(n_probes=6, rescore_factor=4)
    dj, ij = jbq.search(back, q, K, jbq.SearchParams(**sp))
    dt, it = tbq.search(tidx, q, K, tbq.SearchParams(**sp))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    tser.save_ivf_bq(tidx, path, include_raw=False)
    again = tser.load_ivf_bq(path, device="cpu")
    assert again.raw is None and torch.equal(again.bits, tidx.bits)
    torch.testing.assert_close(again.scales, tidx.scales)


# --- (e) features not ported yet, (f) the default device ---------------

def test_unported_features_raise(indexes, data):
    x, q = data
    _, tidx = indexes[DistanceType.L2Expanded]
    with pytest.raises(NotImplementedError, match="extend"):
        tbq.extend(tidx, x[:10])
    with pytest.raises(LogicError, match="scan_bins"):
        tbq.search(tidx, q, K, tbq.SearchParams(scan_bins=-1))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    x, _ = _data()
    with pytest.raises(LogicError, match="device='cpu'"):
        tbq.build(x, tbq.IndexParams(n_lists=4))
    with pytest.raises(LogicError, match="device='cpu'"):
        tbq.index_from_numpy({}, DistanceType.L2Expanded, 0)

"""Parity of the port's IVF-PQ (raft_tpu_torch) with the JAX package's.

The JAX side runs its Pallas kernels in interpret mode; the port runs
its plain versions (CPU tensors). Inputs are made with numpy from
seeds. Search parity uses a JAX-built index loaded through the shared
file format, so it is free of training noise.

Tolerances, and why:
* scans and searches: distances within rtol 1e-5 of the |qsub|^2 +
  code-norm scale (of the values themselves for exact-rescore results)
  — both sides add the same f32 products in another order (the TPU
  decodes rows and takes one dot product, the port regroups it per
  subspace); ids identical except where two candidates' scores lie
  within that tolerance (an f32 near-tie the order can flip);
* the "reconstruct" and "lut" scans: as the code scan (both sides take
  the same bf16 or f32 products and add them in another order);
* extend: list sizes, ids and codes identical (the new rows' labels and
  codes are argmins whose near-ties the data does not hold);
* build: centres within 1e-4 (the tolerance of the IVF-Flat build parity
  test); codebooks within 5e-3, because the grouped trainer's sums run
  in another order and one residual changing its nearest codeword among
  the ~1000 rows of a codeword moves that mean by ~1e-3; codes equal on
  >= 99.99% of (row, subspace) entries for the same reason.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from raft_tpu.distance.distance_types import DistanceType as JDT
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors.refine import refine as j_refine
from raft_tpu.neighbors import serialize as jser
from raft_tpu.ops._util import VMEM_LIMIT
from raft_tpu.ops.pallas_ivf_scan import ivf_pq_code_scan_pallas
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import _ivf_scan as t_scan
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import plan as tplan
from raft_tpu_torch.neighbors.refine import refine as t_refine
from raft_tpu_torch.neighbors import serialize as tser
from raft_tpu_torch.ops import ivf_pq_scan as pq_op
from raft_tpu_torch.ops._util import round_up

LUTS = {"f32": (jnp.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16),
        "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
N, D, NQ, N_LISTS, K = 3000, 16, 64, 16, 10


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _tol(dj, scale):
    ref = np.abs(dj) if scale is None else np.asarray(scale, np.float64)
    ref = np.broadcast_to(ref, dj.shape)
    return 1e-5 * np.maximum(np.where(np.isfinite(ref), ref, 1.0), 1.0)


def _close(dt, dj, scale=None):
    """Distances within rtol 1e-5 of ``scale`` (default: the values)."""
    dt, dj = np.asarray(dt, np.float64), np.asarray(dj, np.float64)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    assert (np.abs(dt[fin] - dj[fin]) <= _tol(dj, scale)[fin]).all()


def _same(dt, it, dj, ij, scale=None):
    """Ids equal, except that a slot may hold another candidate whose
    JAX-side score ties the slot's within the tolerance; then
    :func:`_close` on the distances."""
    dj64 = np.asarray(dj, np.float64)
    tol = _tol(dj64, scale)
    for r, c in np.argwhere(it != ij):
        pos = np.flatnonzero(ij[r] == it[r, c])
        other = dj64[r, pos[0]] if pos.size else float(dt[r, c])
        assert abs(other - dj64[r, c]) <= tol[r, c], (r, c, it[r, c],
                                                      ij[r, c])
    assert (it == ij).mean() >= 0.99
    _close(dt, dj, scale)


# --- (a) the scan kernels' plain versions against the Pallas kernels -----

def _scan_inputs(seed, per_cluster, pq_bits, nq=16, n_lists=8, pq_dim=4,
                 pq_len=4, max_list=60, n_probes=4):
    rng = np.random.default_rng(seed)
    rot = pq_dim * pq_len
    n_codes = 1 << pq_bits
    q_rot = rng.normal(size=(nq, rot)).astype(np.float32)
    centers_rot = rng.normal(size=(n_lists, rot)).astype(np.float32)
    books = rng.normal(size=(n_lists if per_cluster else pq_dim, n_codes,
                             pq_len)).astype(np.float32)
    codes = rng.integers(0, n_codes, size=(n_lists, max_list, pq_dim)
                         ).astype(np.uint8)
    sizes = rng.integers(0, max_list + 1, size=n_lists)
    sizes[0], sizes[1] = max_list, 0
    ids = np.full((n_lists, max_list), -1, np.int32)
    nxt = 0
    for l, s in enumerate(sizes):
        ids[l, :s] = np.arange(nxt, nxt + s)
        nxt += s
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    return q_rot, centers_rot, books, codes, ids, probes


def _norms(books, codes, ids, per_cluster, lut_t):
    b = torch.from_numpy(books)
    if lut_t == torch.float8_e4m3fn:
        b = b.to(lut_t).float()
    fn = tpq._norms_fn(per_cluster)
    return fn(torch.from_numpy(codes), b, torch.from_numpy(ids)).numpy()


def _jax_split(pq_dim, n_codes, rot_dim, cap, bins, mlp, f32_lut):
    """The JAX wrapper's sub-cell count for long lists (VMEM-derived)."""
    per_row = (pq_dim * n_codes * (4 if f32_lut else 2) + rot_dim * 4
               + round_up(max(cap, 8), 8) * 4 + pq_dim * 4)
    row_budget = max(bins, (VMEM_LIMIT // 3) // per_row)
    return -(-mlp // round_up(row_budget, bins))


def _both_scans(inputs, metric, lut, per_cluster, k, cap, bins, fused,
                internal="f32", sqrt=False):
    q_rot, centers_rot, books, codes, ids, probes = inputs
    lut_j, lut_t = LUTS[lut]
    norms = _norms(books, codes, ids, per_cluster, lut_t)
    int_j = jnp.bfloat16 if internal == "bf16" else jnp.float32
    dj, ij = ivf_pq_code_scan_pallas(
        jnp.asarray(q_rot), jnp.asarray(centers_rot), jnp.asarray(books),
        jnp.asarray(codes), jnp.asarray(norms), jnp.asarray(ids),
        jnp.asarray(probes), k, cap, bins=bins, sqrt=sqrt, lut_dtype=lut_j,
        internal_distance_dtype=int_j, metric=metric,
        per_cluster=per_cluster, fused=fused)
    t_books, round_q = pq_op.lut_operands(torch.from_numpy(books), lut_t)
    dt, it = tpq.code_scan(
        torch.from_numpy(q_rot), torch.from_numpy(centers_rot), t_books,
        round_q, torch.from_numpy(codes), torch.from_numpy(norms),
        torch.from_numpy(ids), torch.from_numpy(probes), k, cap, bins,
        sqrt, metric, per_cluster, internal == "bf16", fused)
    # the score scale where f32 rounding lives: |qsub|^2 + code norm
    scale = (np.abs(q_rot) ** 2).sum(1).max() + (
        np.abs(centers_rot) ** 2).sum(1).max() + norms.max()
    return dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij), scale


def _scan_parity(metric, lut, per_cluster, pq_bits, pq_dim, pq_len, seed):
    """Both scans' plain versions against the Pallas kernel, on CPU
    tensors (no kernel launch)."""
    inputs = _scan_inputs(seed, per_cluster, pq_bits, pq_dim=pq_dim,
                          pq_len=pq_len)
    cap, bins = 16, 16
    n_codes = 1 << pq_bits
    assert _jax_split(pq_dim, n_codes, pq_dim * pq_len, cap, bins,
                      round_up(60, bins), lut == "f32") == 1
    counters = ("launches", "launches_fused", "launches_f32",
                "launches_fused_f32")
    before = tuple(getattr(pq_op, c) for c in counters)
    for fused in (True, False):
        dt, it, dj, ij, scale = _both_scans(inputs, metric, lut,
                                            per_cluster, K, cap, bins,
                                            fused)
        _same(dt, it, dj, ij, scale)
    assert tuple(getattr(pq_op, c) for c in counters) == before


@pytest.mark.parametrize("pq_bits", [4, 8])
@pytest.mark.parametrize("per_cluster", [False, True],
                         ids=["per_subspace", "per_cluster"])
@pytest.mark.parametrize("lut", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_scan_plain_matches_pallas(metric, lut, per_cluster, pq_bits):
    _scan_parity(metric, lut, per_cluster, pq_bits, 4, 4,
                 pq_bits * 7 + per_cluster)


# (pq_dim, pq_len) beyond the base 4 x 4: pq_len 3, whose subspaces
# straddle the card kernel's 8-feature units and its 64-feature slices;
# rot_dim 264 > 256, where the card kernel streams the queries
SCAN_SHAPES = {"pq_len3": (24, 3), "rot264": (66, 4)}


@pytest.mark.parametrize("shape", sorted(SCAN_SHAPES))
@pytest.mark.parametrize("pq_bits", [4, 8])
@pytest.mark.parametrize("per_cluster", [False, True],
                         ids=["per_subspace", "per_cluster"])
@pytest.mark.parametrize("lut", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_scan_plain_matches_pallas_shapes(metric, lut, per_cluster, pq_bits,
                                          shape):
    pq_dim, pq_len = SCAN_SHAPES[shape]
    _scan_parity(metric, lut, per_cluster, pq_bits, pq_dim, pq_len,
                 pq_bits * 7 + per_cluster + pq_dim)


# rot_dim 768 at the default pq_dim (dim // 4 = 192) and 8 bits: a
# (192, 256) f32 table is 196,608 B, past the 160 KB the card's f32 body
# once held whole in shared memory
@pytest.mark.parametrize("per_cluster", [False, True],
                         ids=["per_subspace", "per_cluster"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_scan_plain_matches_pallas_f32_rot768(metric, per_cluster):
    _scan_parity(metric, "f32", per_cluster, 8, 192, 4, 768 + per_cluster)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_unfused_bf16_internal_and_wide_k(metric):
    # internal_distance_dtype bf16 rounds the unfused candidate scores;
    # k = 300 > 256 merges through the stable sort (the kernel-8 route)
    inputs = _scan_inputs(3, False, 8, n_lists=8, max_list=60, n_probes=8)
    for k, internal in ((K, "bf16"), (300, "f32")):
        dt, it, dj, ij, scale = _both_scans(inputs, metric, "bf16", False,
                                            k, 16, 64, False, internal)
        _same(dt, it, dj, ij, scale)


@pytest.mark.parametrize("fused", [True, False])
def test_scan_cap_overflow_drop_rule(fused):
    # every (list, probe-rank) class holds one query, so the slot order
    # is forced and the same pairs drop in both packages
    q_rot, centers_rot, books, codes, ids, _ = _scan_inputs(
        5, False, 8, nq=16, n_lists=16)
    probes = np.array([[(q + p) % 16 for p in range(4)] for q in range(16)],
                      np.int32)
    inputs = (q_rot, centers_rot, books, codes, ids, probes)
    _, inv = t_scan._invert_probes(torch.from_numpy(probes), 16, 2)
    assert bool((inv >= 2).any()), "cap must overflow"
    dt, it, dj, ij, scale = _both_scans(inputs, "l2", "bf16", False, K, 2,
                                        16, fused, sqrt=True)
    _same(dt, it, dj, ij, np.sqrt(scale))


def test_fp8_rounding_matches_ml_dtypes():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(size=4096) * s for s in (0.01, 1, 50)])
    # exact halfway points between neighbouring e4m3 values: ties to even
    grid = np.unique(np.asarray(jnp.arange(-448, 448.5, 0.5).astype(
        jnp.float8_e4m3fn).astype(jnp.float32)))
    mids = ((grid[1:] + grid[:-1]) / 2)
    v = np.concatenate([v, mids, -mids]).astype(np.float32)
    j = np.asarray(jnp.asarray(v).astype(jnp.float8_e4m3fn)
                   .astype(jnp.float32))
    t = torch.from_numpy(v).to(torch.float8_e4m3fn).float().numpy()
    np.testing.assert_array_equal(t, j)


# --- (b) search on a JAX-built index loaded through the file format ------

def _data(seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(24, D)).astype(np.float32)
    x = c[rng.integers(0, 24, N)] + rng.normal(size=(N, D))
    q = c[rng.integers(0, 24, NQ)] + rng.normal(size=(NQ, D))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _data()


BUILDS = {"l2": (JDT.L2Expanded, 0), "sqrt": (JDT.L2SqrtExpanded, 0),
          "ip": (JDT.InnerProduct, 0), "l2_pc": (JDT.L2Expanded, 1),
          "ip_pc": (JDT.InnerProduct, 1)}


@pytest.fixture(scope="module")
def indexes(data, tmp_path_factory):
    """name -> (JAX index, port index loaded from the JAX file)."""
    x, _ = data
    out = {}
    for name, (metric, kind) in BUILDS.items():
        jidx = jpq.build(x, jpq.IndexParams(
            n_lists=N_LISTS, metric=metric, kmeans_n_iters=4, pq_dim=4,
            pq_bits=6, keep_raw=True, codebook_kind=jpq.CodebookGen(kind)))
        path = str(tmp_path_factory.mktemp("pq") / f"{name}.npz")
        jser.save_ivf_pq(jidx, path)
        out[name] = (jidx, tser.load_ivf_pq(path, device="cpu"))
    return out


def _search_both(jidx, tidx, q, k, lut="bf16", **sp):
    lut_j, lut_t = LUTS[lut]
    dj, ij = jpq.search(jidx, q, k, jpq.SearchParams(
        scan_mode="codes", lut_dtype=lut_j, **sp))
    dt, it = tpq.search(tidx, q, k, tpq.SearchParams(lut_dtype=lut_t, **sp))
    return dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij)


@pytest.mark.parametrize("name", list(BUILDS))
@pytest.mark.parametrize("rescore,where", [(0, "never"), (4, "never"),
                                           (4, "always"), (30, "always")])
def test_search_matches_jax(indexes, data, name, rescore, where):
    jidx, tidx = indexes[name]
    _, q = data
    dt, it, dj, ij = _search_both(jidx, tidx, q, K, n_probes=6,
                                  rescore_factor=rescore,
                                  rescore_on_device=where)
    assert it.dtype == np.int32 and dt.shape == (NQ, K)
    _same(dt, it, dj, ij)


@pytest.mark.parametrize("lut", ["f32", "fp8"])
def test_search_lut_tiers_match_jax(indexes, data, lut):
    jidx, tidx = indexes["l2"]
    _, q = data
    dt, it, dj, ij = _search_both(jidx, tidx, q, K, lut=lut, n_probes=6)
    _same(dt, it, dj, ij)


def test_wide_kk_takes_the_unfused_kernel(indexes, data, monkeypatch):
    jidx, tidx = indexes["l2"]
    _, q = data
    calls = []
    real = pq_op.pq_scan
    monkeypatch.setattr(pq_op, "pq_scan",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    dt, it, dj, ij = _search_both(jidx, tidx, q, 30, n_probes=6,
                                  rescore_factor=9)       # kk = 270 > 256
    assert calls
    _same(dt, it, dj, ij)


def test_batched_search_equals_one_batch(indexes, data, monkeypatch):
    _, tidx = indexes["l2"]
    _, q = data
    sp = tpq.SearchParams(n_probes=6, probe_cap=64)
    d_full, i_full = tpq.search(tidx, q, K, sp)
    monkeypatch.setattr(tpq, "MAX_QUERY_BATCH", 24)
    d_b, i_b = tpq.search(tidx, q, K, sp)
    assert torch.equal(i_b, i_full)
    torch.testing.assert_close(d_b, d_full)


# --- (c) build parity ----------------------------------------------------

def test_port_build_matches_jax_build():
    # n > 65536 and trainset fraction 1.0: both packages draw the same
    # rows (coarse init, codebook trainset, initial codewords)
    rng = np.random.default_rng(2)
    c = rng.normal(size=(8, 16)).astype(np.float32) * 20
    x = (c[rng.integers(0, 8, 70000)]
         + rng.normal(size=(70000, 16))).astype(np.float32)
    kw = dict(n_lists=8, kmeans_n_iters=3, kmeans_trainset_fraction=1.0,
              pq_dim=4, pq_bits=6)
    j = jpq.build(x, jpq.IndexParams(**kw))
    t = tpq.build(x, tpq.IndexParams(**kw), device="cpu")
    for f in ("list_sizes", "lists_indices", "rotation_matrix"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    for f in ("centers", "centers_rot"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), atol=1e-4)
    np.testing.assert_allclose(t.pq_centers.numpy(),
                               np.asarray(j.pq_centers), atol=5e-3)
    same = t.codes.numpy() == np.asarray(j.codes)
    assert same.mean() >= 0.9999
    # the norms of rows whose codes agree agree to the codebooks' error
    rows = same.all(axis=2) & (t.lists_indices.numpy() >= 0)
    np.testing.assert_allclose(t.code_norms.numpy()[rows],
                               np.asarray(j.code_norms)[rows], rtol=1e-3)


def test_build_stages_match_jax_on_same_inputs():
    rng = np.random.default_rng(4)
    res = rng.normal(size=(5000, 16)).astype(np.float32)
    books = rng.normal(size=(4, 64, 4)).astype(np.float32)
    # encoding and code norms: exact on the same inputs
    codes_t = tpq._encode(torch.from_numpy(res), torch.from_numpy(books))
    codes_j = np.asarray(jpq._encode(jnp.asarray(res), jnp.asarray(books)))
    np.testing.assert_array_equal(codes_t.numpy(), codes_j)
    cb = np.array(codes_j).reshape(10, 500, 4)
    ids = np.arange(5000, dtype=np.int32).reshape(10, 500)
    ids[3, 250:] = -1
    np.testing.assert_allclose(
        tpq._code_norms(torch.from_numpy(cb), torch.from_numpy(books),
                        torch.from_numpy(ids)).numpy(),
        np.asarray(jpq._code_norms(jnp.asarray(cb), jnp.asarray(books),
                                   jnp.asarray(ids))), rtol=1e-6)
    pc = rng.normal(size=(10, 64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tpq._code_norms_per_cluster(torch.from_numpy(cb),
                                    torch.from_numpy(pc),
                                    torch.from_numpy(ids)).numpy(),
        np.asarray(jpq._code_norms_per_cluster(
            jnp.asarray(cb), jnp.asarray(pc), jnp.asarray(ids))), rtol=1e-6)
    # the grouped codebook trainer, one sweep from the same draws
    bt = tpq._train_codebooks_per_subspace(torch.from_numpy(res), 4, 4, 64,
                                           1, seed=9)
    bj = jpq._train_codebooks_per_subspace(jnp.asarray(res), 4, 4, 64, 1,
                                           seed=9)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-5)


# --- (d) save and load, both directions --------------------------------

def test_save_roundtrip_both_directions(indexes, data, tmp_path):
    jidx, tidx = indexes["ip"]
    _, q = data
    path = str(tmp_path / "from_port")             # no .npz suffix
    tser.save_ivf_pq(tidx, path)
    back = jser.load_ivf_pq(path)
    for f in ("centers", "centers_rot", "rotation_matrix", "pq_centers",
              "codes", "lists_indices", "list_sizes"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(jidx, f)))
    np.testing.assert_array_equal(back.raw, jidx.raw)
    assert (back.metric, back.size, back.pq_bits, back.codebook_kind) == (
        jidx.metric, jidx.size, jidx.pq_bits, jidx.codebook_kind)
    sp = dict(n_probes=6, rescore_factor=4)
    dj, ij = jpq.search(back, q, K, jpq.SearchParams(scan_mode="codes", **sp))
    dt, it = tpq.search(tidx, q, K, tpq.SearchParams(**sp))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    tser.save_ivf_pq(tidx, path, include_raw=False)
    again = tser.load_ivf_pq(path, device="cpu")
    assert again.raw is None and torch.equal(again.codes, tidx.codes)
    torch.testing.assert_close(again.code_norms, tidx.code_norms)


# --- (d2) extend, PER_CLUSTER builds, the other scan modes -------------

def _new_rows(n=600, seed=7):
    rng = np.random.default_rng(seed)
    c = np.random.default_rng(0).normal(size=(24, D)).astype(np.float32)
    return (c[rng.integers(0, 24, n)]
            + rng.normal(size=(n, D))).astype(np.float32)


def _same_index(t, j, fields=("list_sizes", "lists_indices", "codes")):
    for f in fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("name", ["l2", "l2_pc", "ip_pc"])
def test_extend_matches_jax(indexes, data, name):
    # one JAX-built index, carried across, extended in both packages with
    # the same rows: the same lists, ids, codes, norms and raw rows, and
    # the same search results
    jidx, tidx = indexes[name]
    _, q = data
    xn = _new_rows()
    je = jpq.extend(jidx, xn)
    te = tpq.extend(tidx, xn)
    assert te.size == je.size == N + len(xn)
    assert te.codebook_kind == tidx.codebook_kind
    _same_index(te, je)
    np.testing.assert_allclose(te.code_norms.numpy(),
                               np.asarray(je.code_norms), rtol=1e-6)
    np.testing.assert_array_equal(te.raw, je.raw)
    assert te.decoded is None and not te.cap_cache and not te.plan_cache
    dt, it, dj, ij = _search_both(je, te, q, K, n_probes=6,
                                  rescore_factor=4)
    _same(dt, it, dj, ij)


def test_extend_custom_ids_and_refusals(data):
    x, _ = data
    jidx = jpq.build(x, jpq.IndexParams(n_lists=N_LISTS, kmeans_n_iters=2,
                                        pq_dim=4, pq_bits=5))
    tidx = tpq.index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in tser._PQ_FIELDS},
        DistanceType.L2Expanded, jidx.size, jidx.pq_bits, device="cpu")
    xn = _new_rows(300, 9)
    ids = np.arange(10_000, 10_300, dtype=np.int32)[::-1].copy()
    _same_index(tpq.extend(tidx, xn, ids), jpq.extend(jidx, xn, ids))
    with pytest.raises(LogicError, match="non-negative"):
        tpq.extend(tidx, xn[:2], np.array([1, -1], np.int32))
    with pytest.raises(LogicError, match="dim mismatch"):
        tpq.extend(tidx, xn[:, :8])
    with pytest.raises(LogicError, match="bad new_indices"):
        tpq.extend(tidx, xn[:2], np.array([1, 2, 3], np.int32))


def test_extend_refuses_custom_ids_with_raw(indexes):
    _, tidx = indexes["l2"]
    with pytest.raises(LogicError, match="keep_raw=False"):
        tpq.extend(tidx, _new_rows(4), np.arange(4, dtype=np.int32))


def _jax_first(valid, n_codes, seed):
    """The JAX package's initial codeword positions for the masked
    per-cluster trainer (its ``jax.random`` draw, block by block)."""
    L, t = valid.shape
    chunk = jpq._list_chunk(L, t * n_codes)
    keys = jax.random.split(jax.random.key(seed), L // chunk)
    v = jnp.asarray(np.asarray(valid)).reshape(-1, chunk, t)
    out = [jnp.argsort(jax.random.uniform(keys[b], (chunk, t))
                       + jnp.where(v[b], 0.0, 2.0), axis=1)[:, :n_codes]
           for b in range(L // chunk)]
    return torch.from_numpy(np.asarray(jnp.concatenate(out)).astype(np.int64))


def test_per_cluster_stages_match_jax_on_same_inputs():
    rng = np.random.default_rng(11)
    L, M, pl, n_codes = 6, 300, 4, 32
    data = rng.normal(size=(L, M, pl)).astype(np.float32)
    valid = rng.random((L, M)) < 0.8
    valid[2] = False                                  # an empty list
    chunk = jpq._list_chunk(L, M * n_codes)
    bj = np.asarray(jpq._batched_masked_kmeans(
        jnp.asarray(data), jnp.asarray(valid), n_codes, 5,
        jax.random.key(3), chunk))
    bt = tpq._train_books_per_cluster(
        torch.from_numpy(data), torch.from_numpy(valid), n_codes, 5, chunk,
        _jax_first(valid, n_codes, 3))
    np.testing.assert_allclose(bt.numpy(), bj, atol=1e-5)
    # encoding, decoding and norms on the same books: exact
    bucketed = rng.normal(size=(L, 40, 16)).astype(np.float32)
    ct = tpq._encode_per_cluster(torch.from_numpy(bucketed), bt, 2)
    cj = np.asarray(jpq._encode_per_cluster(jnp.asarray(bucketed),
                                            jnp.asarray(bt.numpy()), 2))
    np.testing.assert_array_equal(ct.numpy(), cj)
    ids = np.arange(L * 40, dtype=np.int32).reshape(L, 40)
    ids[4, 30:] = -1
    dt = tpq._decode_lists(ct, bt, torch.from_numpy(ids), True)
    dj = jpq._decode_lists_per_cluster(jnp.asarray(cj), jnp.asarray(
        bt.numpy()), jnp.asarray(ids))
    np.testing.assert_array_equal(dt.float().numpy(),
                                  np.asarray(dj, np.float32))
    books = rng.normal(size=(4, n_codes, pl)).astype(np.float32)
    dt = tpq._decode_lists(ct, torch.from_numpy(books),
                           torch.from_numpy(ids), False)
    dj = jpq._decode_lists(jnp.asarray(cj), jnp.asarray(books),
                           jnp.asarray(ids))
    np.testing.assert_array_equal(dt.float().numpy(),
                                  np.asarray(dj, np.float32))


def test_per_cluster_build_matches_jax(monkeypatch):
    # n > 65536 and trainset fraction 1.0: the coarse stage draws the
    # same rows in both packages; each list's initial codewords are the
    # JAX package's draw, passed to the port's trainer
    rng = np.random.default_rng(2)
    c = rng.normal(size=(8, 16)).astype(np.float32) * 20
    x = (c[rng.integers(0, 8, 70000)]
         + rng.normal(size=(70000, 16))).astype(np.float32)
    kw = dict(n_lists=8, kmeans_n_iters=3, kmeans_trainset_fraction=1.0,
              pq_dim=4, pq_bits=6)
    j = jpq.build(x, jpq.IndexParams(
        codebook_kind=jpq.CodebookGen.PER_CLUSTER, **kw))
    monkeypatch.setattr(tpq, "_initial_codewords", _jax_first)
    t = tpq.build(x, tpq.IndexParams(
        codebook_kind=tpq.CodebookGen.PER_CLUSTER, **kw), device="cpu")
    assert t.codebook_kind == tpq.CodebookGen.PER_CLUSTER
    assert tuple(t.pq_centers.shape) == (8, 64, 4)
    for f in ("list_sizes", "lists_indices"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    np.testing.assert_allclose(t.centers.numpy(), np.asarray(j.centers),
                               atol=1e-4)
    np.testing.assert_allclose(t.pq_centers.numpy(),
                               np.asarray(j.pq_centers), atol=5e-3)
    same = t.codes.numpy() == np.asarray(j.codes)
    assert same.mean() >= 0.9999
    rows = same.all(axis=2) & (t.lists_indices.numpy() >= 0)
    np.testing.assert_allclose(t.code_norms.numpy()[rows],
                               np.asarray(j.code_norms)[rows], rtol=1e-3)


SCAN_CASES = [("reconstruct", "probe"), ("reconstruct", "list"),
              ("lut", "auto")]


@pytest.mark.parametrize("rescore", [0, 4])
@pytest.mark.parametrize("mode,order", SCAN_CASES,
                         ids=["-".join(c) for c in SCAN_CASES])
@pytest.mark.parametrize("name", ["l2", "sqrt", "ip", "l2_pc", "ip_pc"])
def test_scan_modes_match_jax(indexes, data, name, mode, order, rescore):
    # "reconstruct" list-major is L2 only: IP takes the probe-major scan
    # in both packages whatever scan_order says
    jidx, tidx = indexes[name]
    _, q = data
    sp = dict(n_probes=6, scan_mode=mode, scan_order=order,
              rescore_factor=rescore, probe_cap=64)
    dj, ij = jpq.search(jidx, q, K, jpq.SearchParams(**sp))
    dt, it = tpq.search(tidx, q, K, tpq.SearchParams(**sp))
    _same(dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij))
    if mode == "reconstruct":
        assert tidx.decoded.dtype == torch.bfloat16
        assert tidx.decoded_norms is tidx.code_norms
        np.testing.assert_array_equal(tidx.decoded.float().numpy(),
                                      np.asarray(jidx.decoded, np.float32))


def test_reconstruct_list_major_takes_the_inverted_scan(indexes, data,
                                                        monkeypatch):
    _, tidx = indexes["l2"]
    _, q = data
    calls = []
    real = t_scan.inverted_scan
    monkeypatch.setattr(t_scan, "inverted_scan",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    sp = tpq.SearchParams(n_probes=6, scan_mode="reconstruct")
    tpq.search(tidx, q, K, sp)                   # 64 x 6 >= 4 x 16: lists
    assert calls == [1]
    tpq.search(tidx, q[:8], K, sp)               # 8 queries: probe-major
    assert calls == [1]


@pytest.mark.parametrize("order", ["probe", "list"])
def test_reconstruct_plan_serves_like_search(indexes, data, order):
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    _, tidx = indexes["l2_pc"]
    _, q = data
    sp = tpq.SearchParams(n_probes=6, scan_mode="reconstruct",
                          scan_order=order, rescore_factor=4, probe_cap=64)
    srv = SearchServer.from_index(tidx, q[:8], K, params=sp,
                                  config=ServeConfig(batch_sizes=(1, 4, 8)))
    try:
        served = [srv.search(q[r:r + 3], timeout=300) for r in (0, 3, 30)]
    finally:
        srv.close()
    for r, (d, i) in zip((0, 3, 30), served):
        dd, ii = tpq.search(tidx, q[r:r + 3], K, sp)
        np.testing.assert_array_equal(np.asarray(i), ii.numpy())
        np.testing.assert_allclose(np.asarray(d), dd.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_per_cluster_and_extended_save_load_both_ways(indexes, data,
                                                      tmp_path):
    x, q = data
    # a port-built PER_CLUSTER index, read by the JAX package
    t = tpq.build(x, tpq.IndexParams(
        n_lists=N_LISTS, kmeans_n_iters=3, pq_dim=4, pq_bits=6,
        keep_raw=True, codebook_kind=tpq.CodebookGen.PER_CLUSTER),
        device="cpu")
    path = str(tmp_path / "pc.npz")
    tser.save_ivf_pq(t, path)
    back = jser.load_ivf_pq(path)
    assert back.codebook_kind == jpq.CodebookGen.PER_CLUSTER
    for f in tser._PQ_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      getattr(t, f).numpy())
    sp = dict(n_probes=6, rescore_factor=4)
    dj, ij = jpq.search(back, q, K, jpq.SearchParams(scan_mode="codes", **sp))
    dt, it = tpq.search(t, q, K, tpq.SearchParams(**sp))
    _same(dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij))
    # a JAX-extended index read by the port equals the port's extend; the
    # port's extended index read by the JAX package likewise
    jidx, tidx = indexes["l2_pc"]
    xn = _new_rows(200, 5)
    je, te = jpq.extend(jidx, xn), tpq.extend(tidx, xn)
    tpq.search(te, q[:4], K, tpq.SearchParams(scan_mode="reconstruct"))
    jser.save_ivf_pq(je, path)
    got = tser.load_ivf_pq(path, device="cpu")
    _same_index(got, je)
    np.testing.assert_array_equal(got.raw, te.raw)
    tser.save_ivf_pq(te, path)
    back = jser.load_ivf_pq(path)
    _same_index(te, back)
    assert back.size == je.size and back.decoded is None
    with np.load(path) as z:                     # the cache is not saved
        assert "decoded" not in z.files


# --- (e) refine ------------------------------------------------------------

@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded],
                         ids=lambda m: m.name)
def test_refine_matches_jax(data, metric):
    x, q = data
    rng = np.random.default_rng(3)
    cand = rng.integers(0, N, size=(NQ, 40)).astype(np.int32)
    cand[:, -3:] = -1
    dj, ij = j_refine(x, q, cand, K, metric=JDT(int(metric)))
    dt, it = t_refine(x, q, cand, K, metric=metric, device="cpu")
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(dt.numpy(), np.asarray(dj), (q ** 2).sum(1, keepdims=True)
           + (x ** 2).sum(1).max())


# --- (f) features not ported yet, (g) the default device ---------------

def test_unported_features_raise(indexes, data):
    # what stays refused: an unknown scan mode, the fp8 LUT tier outside
    # the code scan, and a serving plan for the "lut" scan
    _, q = data
    _, tidx = indexes["l2"]
    with pytest.raises(LogicError, match="scan_mode"):
        tpq.search(tidx, q, K, tpq.SearchParams(scan_mode="bogus"))
    for mode in ("reconstruct", "lut"):
        with pytest.raises(LogicError, match="float8_e4m3fn requires"):
            tpq.search(tidx, q, K, tpq.SearchParams(
                scan_mode=mode, lut_dtype=torch.float8_e4m3fn))
    with pytest.raises(LogicError, match="no serving plan"):
        tplan.build_plan(tidx, q[:8], K, tpq.SearchParams(scan_mode="lut"))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    x, _ = _data()
    with pytest.raises(LogicError, match="device='cpu'"):
        tpq.build(x, tpq.IndexParams(n_lists=4))
    with pytest.raises(LogicError, match="device='cpu'"):
        tpq.index_from_numpy({}, DistanceType.L2Expanded, 0, 8)
    with pytest.raises(LogicError, match="device='cpu'"):
        t_refine(x, x[:4], np.zeros((4, 8), np.int32), 2)


@pytest.mark.parametrize("dim,rot_dim,force", [(8, 8, False), (8, 8, True),
                                               (8, 12, True)])
def test_make_rotation_matrix_runs_where_asked(dim, rot_dim, force):
    """The rotation defaults to the card (through ``ensure_resources``) and
    runs on the CPU only when asked; the identity is JAX's, a forced
    rotation orthonormal, with rows past ``dim`` zero."""
    rot = tpq.make_rotation_matrix(dim, rot_dim, force, device="cpu")
    assert rot.device.type == "cpu" and rot.shape == (rot_dim, dim)
    if not force:
        np.testing.assert_array_equal(
            rot.numpy(), np.asarray(jpq.make_rotation_matrix(dim, rot_dim)))
    torch.testing.assert_close(rot[:dim] @ rot[:dim].T, torch.eye(dim),
                               rtol=0, atol=1e-5)
    assert not bool(rot[dim:].any())
    if torch.cuda.is_available():
        assert tpq.make_rotation_matrix(dim, rot_dim, force).is_cuda
    else:
        with pytest.raises(LogicError, match="device='cpu'"):
            tpq.make_rotation_matrix(dim, rot_dim, force)

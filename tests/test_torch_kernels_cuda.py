"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and ragged shapes. Every test needs an NVIDIA GPU and is
skipped without one. This file imports neither JAX nor the JAX package,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py -m cuda

Tolerance: selection is exact; distances within rtol 1e-5 of the
expanded-L2 scale (|x|^2 + |y|^2, for PQ |qsub|^2 + code norm, for BQ
|qsub|^2 + norms2) — fp32 with a different summation order — and ids
identical on random data, except (PQ, BQ, both IVF-Flat scans) where two
candidates tie within that tolerance; bf16 candidate scores within one
bf16 step (2^-8 of the scale; for the IVF-Flat list scan, the bf16
rounding of a score within rtol 1e-5 of the plain version's f32 score,
and results within one bf16 step of the plain score itself — up to 2^-7
of it — plus that rtol). The IVF-Flat scans' kernels take their
products as bf16x3 on the tensor cores, one accumulator per (query, row)
in the wgmma's order, and are held to their plain versions at bf16x3
(three full-f32 products summed): the same exact partial products
summed in another order. Fused L2-NN is held so at each tier (bf16x3 and
bf16 on the tensor cores, f32 on the CUDA cores), the IVF-BQ scans
(products of bf16 queries and the +-1 decode, one tensor-core pass)
likewise, as are the IVF-Flat scans on bf16 and int8 lists (one bf16
pass against the queries rounded to bf16; int8 times its scale) and
fused k-NN at d > 4096 (kernel 6, bf16x3 or bf16 on the tensor cores).
Two builds of one index at one seed on the card are bit-identical. An
index extended on the card matches the same extend on the CPU: ids and
list sizes identical, codes and search ids on >= 99.9% of entries (the
card's labels take kernel 1 at bf16x3, the CPU's f32, so a near-tie can
fall either way).
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.distance import _elementwise_cores as elt_cores
from raft_tpu_torch.neighbors import _ivf_scan, ivf_bq, ivf_flat, ivf_pq
from raft_tpu_torch.ops import elementwise_dist as elt_op
from raft_tpu_torch.ops import fused_knn as knn_op
from raft_tpu_torch.ops import fused_l2_nn as nn_op
from raft_tpu_torch.ops import ivf_bq_scan as bq_op
from raft_tpu_torch.ops import ivf_pq_scan as pq_op
from raft_tpu_torch.ops import ivf_scan as scan_op
from raft_tpu_torch.ops import select_k as sel_op

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


# kernel_precision -> (the plain version's arithmetic, the launch counter)
NN_TIERS = {"bf16x3": ("bf16x3", "launches"), "bf16": ("bf16", "launches"),
            "highest": ("f32", "launches_f32")}


@pytest.mark.parametrize("tier", sorted(NN_TIERS))
@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (37, 23, 8), (129, 65, 17),
                                   (300, 1000, 128), (257, 1000, 300),
                                   (1000, 4096, 128)])
def test_fused_l2_nn_matches_plain(dev, m, n, d, sqrt, tier):
    # the tensor-core kernel at bf16x3 and bf16 (d 300: the rows stream
    # with the centres; n 1000: a ragged last chunk of centres), the f32
    # body at "highest"; each against the plain version at its arithmetic
    rng = np.random.default_rng(m + n + d)
    x = _t(rng.normal(size=(m, d)).astype(np.float32), dev)
    y = _t(rng.normal(size=(n, d)).astype(np.float32), dev)
    precision, counter = NN_TIERS[tier]
    before = getattr(nn_op, counter)
    ik, dk = nn_op.fused_l2_nn(x, y, sqrt, tier)
    torch.cuda.synchronize()
    assert getattr(nn_op, counter) == before + 1
    ip, dp = nn_op.fused_l2_nn_plain(x, y, sqrt, precision)
    scale = ((x * x).sum(1) + (y * y).sum(1).max()).cpu().numpy()
    if sqrt:
        scale = np.sqrt(scale)
    np.testing.assert_array_equal(ik.cpu().numpy(), ip.cpu().numpy())
    assert (np.abs(dk.cpu().numpy() - dp.cpu().numpy())
            <= 1e-5 * scale).all()


@pytest.mark.parametrize("tier", sorted(NN_TIERS))
def test_fused_l2_nn_ties_exact(dev, tier):
    # integers in [-3, 3]: bf16 holds them (lo = 0), so every tier's
    # distances are exact and the lowest index wins each tie
    rng = np.random.default_rng(7)
    base = rng.integers(-3, 4, size=(6, 4)).astype(np.float32)
    y = _t(np.concatenate([base, base[::-1], base]), dev)
    x = _t(rng.integers(-3, 4, size=(200, 4)).astype(np.float32), dev)
    ik, dk = nn_op.fused_l2_nn(x, y, kernel_precision=tier)
    ip, dp = nn_op.fused_l2_nn_plain(x, y, False, NN_TIERS[tier][0])
    assert torch.equal(ik, ip) and torch.equal(dk, dp)


@pytest.mark.parametrize("k,n", [(1, 1), (7, 600), (96, 1024), (256, 256),
                                 (256, 3000), (33, 2500)])
def test_select_k_matches_plain_exactly(dev, k, n):
    rng = np.random.default_rng(k + n)
    v = rng.normal(size=(20, n)).astype(np.float32)
    v[3] = np.round(v[3])            # duplicates
    v[4, ::3] = np.inf               # +inf entries
    v[5, :] = np.inf
    v[6, 1::2] = np.nan              # NaN reads as +inf
    v = _t(v, dev)
    dk, ik = sel_op.select_k(v, k)
    dp, ip = sel_op.select_k_plain(v.cpu(), k)
    assert torch.equal(dk.cpu(), dp) and torch.equal(ik.cpu(), ip)


def _select_rows(rng, n):
    """Rows that stress the radix select's tie and key handling."""
    rows = [rng.normal(size=n),                       # distinct
            np.full(n, 0.5),                          # all equal
            rng.integers(0, 3, size=n) * 0.25,        # few levels: ties at k
            rng.choice([-0.0, 0.0, 1.0, -1.0], size=n),  # -0.0 beside +0.0
            np.where(rng.random(n) < 0.5, np.nan, rng.normal(size=n)),
            np.where(rng.random(n) < 0.5, np.inf, -np.inf),
            np.full(n, np.nan),
            # coarse-score-like: positive values crowding one top byte
            1000.0 + rng.random(n).astype(np.float32)]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("k,n", [(k, n) for n in (1, 255, 1024, 4096, 100_000)
                                 for k in (1, 96, 128, 256) if k <= n])
def test_select_k_radix_ties_and_keys(dev, k, n):
    rng = np.random.default_rng(k * 7 + n)
    v = _t(_select_rows(rng, n), dev)
    before = sel_op.launches
    dk, ik = sel_op.select_k(v, k)
    torch.cuda.synchronize()
    assert sel_op.launches == before + 1
    dp, ip = sel_op.select_k_plain(v.cpu(), k)
    assert torch.equal(dk.cpu(), dp) and torch.equal(ik.cpu(), ip)
    # one row alone (m = 1)
    dk1, ik1 = sel_op.select_k(v[2:3].contiguous(), k)
    assert torch.equal(dk1.cpu(), dp[2:3]) and torch.equal(ik1.cpu(), ip[2:3])


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("k", [1, 32, 256])
@pytest.mark.parametrize("n", [5, 16384, 16385, 160_000])
def test_select_k_payload_matches_plain(dev, n, k, sqrt):
    # the fused scans' pass B: staged rows up to 16384, unstaged above
    # (the fused brute force's ~156k), n < k filled with (+inf, -1); ties,
    # NaN and infinities (_select_rows), ids random with -1 at +inf
    rng = np.random.default_rng(n + k + sqrt)
    v = _select_rows(rng, n)
    ids = rng.integers(0, 1 << 30, size=v.shape).astype(np.int32)
    ids[np.isinf(v) & (v > 0)] = -1
    vt, it = _t(v, dev), _t(ids, dev)
    before = sel_op.launches_payload
    dk, ik = sel_op.select_k_payload(vt, it, k, sqrt)
    torch.cuda.synchronize()
    assert sel_op.launches_payload == before + 1
    # the plain version on the card: its sqrt is the card's (the CPU's
    # vectorised sqrt may differ by an ulp)
    dp, ip = sel_op.select_k_payload_plain(vt, it, k, sqrt)
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)


def _random_index(rng, n_lists, max_list, d, dev, metric="l2"):
    sizes = rng.integers(0, max_list + 1, size=n_lists)
    sizes[0] = max_list
    data = rng.normal(size=(n_lists, max_list, d)).astype(np.float32)
    ids = np.full((n_lists, max_list), -1, np.int32)
    nxt = 0
    for l, s in enumerate(sizes):
        ids[l, :s] = np.arange(nxt, nxt + s)
        nxt += s
    data[ids < 0] = 0.0
    norms = np.where(ids >= 0, (data ** 2).sum(-1), 0.0).astype(np.float32)
    centers = rng.normal(size=(n_lists, d)).astype(np.float32)
    return (_t(centers, dev), _t(data, dev), _t(norms, dev), _t(ids, dev))


def _scan_case(rng, d, cap, metric, dev, nq=32, n_probes=6):
    """A random 16-list index (40-row lists, list 0 full, list 1 with no
    rows at all) and ``nq`` queries inverted at ``cap``; above 128 slots
    the batch grows so that some list's table fills more than two query
    tiles (64 slots each)."""
    n_lists, max_list = 16, 40
    if cap > 128:
        nq = 256
    centers, data, norms, ids = _random_index(rng, n_lists, max_list, d, dev)
    ids[1] = -1
    q = _t(rng.normal(size=(nq, d)).astype(np.float32), dev)
    if cap > 128:  # skewed to the low lists: some list draws > 128 queries
        w = 1.0 / np.arange(1, n_lists + 1)
        probes = _t(np.stack([rng.choice(n_lists, n_probes, replace=False,
                                         p=w / w.sum())
                              for _ in range(nq)]).astype(np.int32), dev)
    else:
        probes = _ivf_scan.coarse_probes(q, centers, n_probes, kind=metric)
    qmap, inv_pos = _ivf_scan._invert_probes(probes, n_lists, cap)
    if cap == 8:
        assert bool((inv_pos >= cap).any()), "cap must overflow"
    if cap > 128:
        assert bool((qmap[:, 128:] >= 0).any()), "three query tiles"
    return q, data, norms, ids, probes, qmap, inv_pos


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [16, 13, 200, 300])
@pytest.mark.parametrize("bins", [0, -1, 7, 64, 128])
@pytest.mark.parametrize("k,cap", [(10, 32), (1, 32), (10, 8), (200, 32),
                                   (10, 200)])
def test_fused_scan_matches_plain(dev, metric, d, bins, k, cap):
    # bins 0 and -1 = every row of the 40-row lists (stripe mode, one
    # stripe), 7 (stripe, masked columns), 64 (fold), 128 > max_list;
    # d 200 = four feature slices, the last ragged; d 300 = five, too
    # many to keep resident: the queries stream with the rows
    rng = np.random.default_rng(d * 31 + k + cap)
    q, data, norms, ids, probes, qmap, inv_pos = _scan_case(
        rng, d, cap, metric, dev)
    sqrt = metric == "l2"
    before = scan_op.launches
    dk, ik = scan_op.fused_list_scan(q, data, norms, ids, probes, inv_pos,
                                     qmap, cap, k, bins, sqrt, metric)
    torch.cuda.synchronize()
    assert scan_op.launches == before + 1
    dp, ip = scan_op.fused_list_scan_plain(q, data, norms, ids, probes,
                                           inv_pos, qmap, cap, k, bins,
                                           sqrt, metric, "bf16x3")
    scale = float((q * q).sum(1).max() + norms.max())
    _near_tie_equal(dk, ik, dp, ip, 1e-5 * scale)


def _narrow_case(rng, d, cap, metric, dev, storage, nq=32):
    """``_scan_case``'s lists stored as ``storage`` by
    ``ivf_flat._quantize_lists`` (norms those of the stored rows)."""
    q, data, norms, ids, probes, qmap, inv_pos = _scan_case(
        rng, d, cap, metric, dev, nq=nq)
    data, norms, scale = ivf_flat._quantize_lists(data, norms, storage)
    return q, data, norms, ids, probes, qmap, inv_pos, scale


# each storage's kernel-3 launch counter (kernel 4: "launches_list_...")
NARROW_COUNTER = {"bfloat16": "launches_bf16", "int8": "launches_int8"}

# d 128 and 320 (queries streamed) take 16-byte row loads in both
# storages; 96 takes them too, its second feature slice ragged; 100 and 13
# load feature by feature (bf16 needs d % 8, int8 d % 16)
NARROW_D = [128, 96, 100, 13, 320]


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", NARROW_D)
@pytest.mark.parametrize("bins", [0, 7, 16, 32, 64])
@pytest.mark.parametrize("k,cap", [(10, 32), (10, 8), (200, 200)])
def test_narrow_fused_scan_matches_plain(dev, storage, metric, d, bins, k,
                                         cap):
    # Bf16Rows / Int8Rows in kernel 3: bins 0 (every row of the 40-row
    # lists) and 7 on the stripe epilogue, 16, 32 and 64 on the fold (G 2,
    # 4, 8); cap 8 drops pairs, cap 200 fills several query tiles of a list
    rng = np.random.default_rng(d * 13 + k + cap + bins + len(storage))
    q, data, norms, ids, probes, qmap, inv_pos, scale = _narrow_case(
        rng, d, cap, metric, dev, storage)
    assert data.dtype == getattr(torch, storage)
    sqrt = metric == "l2"
    key = NARROW_COUNTER[storage]
    before = (getattr(scan_op, key), scan_op.launches)
    dk, ik = scan_op.fused_list_scan(q, data, norms, ids, probes, inv_pos,
                                     qmap, cap, k, bins, sqrt, metric, scale)
    torch.cuda.synchronize()
    assert (getattr(scan_op, key), scan_op.launches) == (before[0] + 1,
                                                         before[1])
    dp, ip = scan_op.fused_list_scan_plain(q, data, norms, ids, probes,
                                           inv_pos, qmap, cap, k, bins,
                                           sqrt, metric, scale=scale)
    if sqrt:
        dk, dp = dk * dk, dp * dp
    tol = 1e-5 * float((q * q).sum(1).max() + norms.max())
    _near_tie_equal(dk, ik, dp, ip, tol)


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", NARROW_D)
@pytest.mark.parametrize("bins", [0, 7, 64, 128])
@pytest.mark.parametrize("cap", [32, 8, 200])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_narrow_list_scan_matches_plain(dev, storage, metric, d, bins, cap,
                                        out):
    # Bf16Rows / Int8Rows in kernel 4 at k = 300, out_bf16 for
    # internal_distance_dtype=bfloat16; held as test_list_scan_matches_plain
    rng = np.random.default_rng(d * 5 + cap + bins + len(storage))
    q, data, norms, ids, probes, qmap, inv_pos, scale = _narrow_case(
        rng, d, cap, metric, dev, storage, nq=48)
    k = 300
    rb, _ = scan_op.resolve_bins(bins, k, ids.shape[1])
    key = NARROW_COUNTER[storage].replace("launches", "launches_list")
    before = getattr(scan_op, key)
    ck, cik = scan_op.list_scan(q, data, norms, ids, qmap, rb, metric, out,
                                scale)
    torch.cuda.synchronize()
    assert getattr(scan_op, key) == before + 1
    assert ck.dtype == out and ck.shape == (ids.shape[0], cap, rb)
    tol = 1e-5 * float((q * q).sum(1).max() + norms.max())
    cp, cip = scan_op.list_scan_plain(q, data, norms, ids, qmap, rb, metric,
                                      torch.float32, scale=scale)
    if out == torch.bfloat16:
        fin = torch.isfinite(cp)
        assert bool(((ck.float() - cp).abs()
                     <= _bf16_step(ck) / 2 + tol)[fin].all())
        cp, cip = scan_op.list_scan_plain(q, data, norms, ids, qmap, rb,
                                          metric, out, scale=scale)
        _blocks_match(ck, cik, cp, cip, _bf16_step(cp) + tol)
    else:
        _blocks_match(ck, cik, cp, cip, tol)
    dk, ik = _ivf_scan.merge_candidates(ck, cik, probes, inv_pos, k, False,
                                        cap)
    dp, ip = _ivf_scan.merge_candidates(cp, cip, probes, inv_pos, k, False,
                                        cap)
    _near_tie_equal(dk, ik, dp, ip, tol + (_bf16_step(dp).cpu().numpy()
                                           if out == torch.bfloat16
                                           else 0.0))


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_narrow_search_on_card_matches_cpu(dev, storage):
    """A narrow index built on the CPU and carried to the card: both
    routes agree with the CPU's (one arithmetic for narrow rows on both
    devices); ``extend`` on the card keeps the storage and every id."""
    rng = np.random.default_rng(len(storage))
    c = rng.normal(size=(16, 32)).astype(np.float32) * 4
    x = (c[rng.integers(0, 16, 3000)]
         + rng.normal(size=(3000, 32))).astype(np.float32)
    q = (c[rng.integers(0, 16, 64)]
         + rng.normal(size=(64, 32))).astype(np.float32)
    cpu = ivf_flat.build(x, ivf_flat.IndexParams(
        n_lists=16, kmeans_n_iters=4, storage_dtype=storage), device="cpu")
    arrays = {f: getattr(cpu, f) if f == "lists_data"
              else getattr(cpu, f).numpy() for f in
              ("centers", "lists_data", "lists_indices", "lists_norms",
               "list_sizes")}
    gpu = ivf_flat.index_from_numpy(arrays, cpu.metric, cpu.size, cpu.scale,
                                    device=dev)
    assert gpu.lists_data.dtype == getattr(torch, storage)
    tol = 1e-5 * float((q ** 2).sum(1).max() + cpu.lists_norms.max())
    fused_key = NARROW_COUNTER[storage]
    for order, k, key in (("list", 10, fused_key),
                          ("list", 300, fused_key.replace("launches",
                                                          "launches_list")),
                          ("probe", 10, None)):
        sp = ivf_flat.SearchParams(n_probes=6, scan_order=order)
        before = getattr(scan_op, key) if key else None
        dg, ig = ivf_flat.search(gpu, q, k, sp)
        if key:
            assert getattr(scan_op, key) == before + 1
        dc, ic = ivf_flat.search(cpu, q, k, sp)
        _near_tie_equal(dg, ig, dc, ic, tol)
    grown = ivf_flat.extend(gpu, x[:200] + 0.5)
    assert grown.lists_data.dtype == gpu.lists_data.dtype
    ids = grown.lists_indices[grown.lists_indices >= 0]
    assert torch.equal(torch.sort(ids).values.cpu(),
                       torch.arange(3200, dtype=torch.int32))


@pytest.mark.parametrize("metric", [ivf_flat.DistanceType.L2Expanded,
                                    ivf_flat.DistanceType.InnerProduct,
                                    ivf_flat.DistanceType.CosineExpanded])
def test_search_on_card_matches_cpu(dev, metric):
    rng = np.random.default_rng(int(metric))
    c = rng.normal(size=(16, 16)).astype(np.float32) * 4
    x = (c[rng.integers(0, 16, 3000)]
         + rng.normal(size=(3000, 16))).astype(np.float32)
    q = (c[rng.integers(0, 16, 64)]
         + rng.normal(size=(64, 16))).astype(np.float32)
    cpu = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=16, metric=metric,
                                                 kmeans_n_iters=4),
                         device="cpu")
    arrays = {f: getattr(cpu, f).numpy() for f in
              ("centers", "lists_data", "lists_indices", "lists_norms",
               "list_sizes")}
    gpu = ivf_flat.index_from_numpy(arrays, metric, cpu.size, device=dev)
    for order in ("list", "probe"):
        sp = ivf_flat.SearchParams(n_probes=5, scan_order=order)
        before = scan_op.launches
        dg, ig = ivf_flat.search(gpu, q, 10, sp)
        assert (scan_op.launches > before) == (order == "list")
        dc, ic = ivf_flat.search(cpu, q, 10, sp)
        if order == "probe":  # plain torch on both devices, in f32
            np.testing.assert_array_equal(ig.cpu().numpy(), ic.numpy())
            np.testing.assert_allclose(dg.cpu().numpy(), dc.numpy(),
                                       rtol=1e-5, atol=1e-3)
        else:  # the fused kernel's bf16x3 products, the CPU's f32
            scale = float((q ** 2).sum(1).max() + cpu.lists_norms.max())
            _near_tie_equal(dg, ig, dc, ic, 1e-5 * scale)


def test_build_on_card_launches_fused_l2_nn(dev):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2000, 8)).astype(np.float32)
    before = nn_op.launches
    idx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=8,
                                                 kmeans_n_iters=3))
    assert idx.device.type == "cuda"
    assert nn_op.launches >= before + 4      # 3 sweeps + predict
    assert int(idx.list_sizes.sum()) == 2000


def _pq_case(rng, dev, pq_dim, bits, per_cluster, n_lists=16, max_list=100,
             nq=32, n_probes=6, pq_len=2, skew=False):
    rot = pq_dim * pq_len
    n_codes = 1 << bits
    sizes = rng.integers(0, max_list + 1, size=n_lists)
    sizes[0], sizes[1], sizes[2] = max_list, 0, 5     # full, empty, short
    ids = np.full((n_lists, max_list), -1, np.int32)
    nxt = 0
    for l, s in enumerate(sizes):
        ids[l, :s] = np.arange(nxt, nxt + s)
        nxt += s
    codes = rng.integers(0, n_codes, size=(n_lists, max_list, pq_dim)
                         ).astype(np.uint8)
    books = rng.normal(size=(n_lists if per_cluster else pq_dim, n_codes,
                             pq_len)).astype(np.float32)
    norms = ivf_pq._norms_fn(per_cluster)(
        torch.from_numpy(codes), torch.from_numpy(books),
        torch.from_numpy(ids)).numpy()
    q = rng.normal(size=(nq, rot)).astype(np.float32)
    centers_rot = rng.normal(size=(n_lists, rot)).astype(np.float32)
    # skewed to the low lists: some list draws more than 128 queries
    w = 1.0 / np.arange(1, n_lists + 1) if skew else np.ones(n_lists)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False,
                                  p=w / w.sum())
                       for _ in range(nq)]).astype(np.int32)
    scale = float((q ** 2).sum(1).max() + (centers_rot ** 2).sum(1).max()
                  + norms.max())
    return [_t(a, dev) for a in (q, centers_rot, books, codes, norms, ids,
                                 probes)], scale


def _near_tie_equal(dk, ik, dp, ip, tol):
    """Ids equal except where the slot's two candidates tie within tol
    (the kernel sums the same products in another order); ``tol`` a
    number or one per slot."""
    dk, ik, dp, ip = (a.cpu().numpy() for a in (dk, ik, dp, ip))
    tol = np.broadcast_to(np.asarray(tol, dtype=np.float64), dp.shape)
    fin = np.isfinite(dp)
    assert (np.isfinite(dk) == fin).all()
    assert (np.abs(dk[fin] - dp[fin]) <= tol[fin]).all()
    for r, c in np.argwhere(ik != ip):
        pos = np.flatnonzero(ip[r] == ik[r, c])
        other = dp[r, pos[0]] if pos.size else dk[r, c]
        assert abs(other - dp[r, c]) <= tol[r, c], (r, c)


def _bf16_step(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    x = x.float().abs()
    return torch.where(x > 0, torch.exp2(torch.floor(torch.log2(x)) - 7),
                       torch.zeros_like(x))


# the PQ tiers' routes on the card: lut dtype -> the launch counters of
# (kernel 9, kernel 8)
PQ_ROUTES = {torch.bfloat16: ("launches_fused", "launches"),
             torch.float8_e4m3fn: ("launches_fused", "launches"),
             torch.float32: ("launches_fused_f32", "launches_f32")}


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("pq_dim,bits,lut,pq_len", [
    (16, 4, torch.bfloat16, 2), (32, 8, torch.bfloat16, 2),
    (64, 8, torch.float32, 2), (64, 8, torch.float8_e4m3fn, 2),
    (24, 8, torch.bfloat16, 2), (32, 8, torch.bfloat16, 4),
    (16, 8, torch.float8_e4m3fn, 8), (64, 4, torch.bfloat16, 1),
    (24, 8, torch.bfloat16, 3), (64, 8, torch.bfloat16, 5)])
@pytest.mark.parametrize("k,bins,cap", [(1, 16, 32), (10, 128, 32),
                                        (256, 64, 32), (10, 16, 8),
                                        (10, 0, 32), (10, -1, 32),
                                        (10, 16, 200)])
@pytest.mark.parametrize("per_cluster", [False, True])
def test_pq_scans_match_plain(dev, metric, pq_dim, bits, lut, pq_len, k,
                              bins, cap, per_cluster):
    # bf16 and fp8 take the list-major kernels, float32 the pair-major f32
    # body. pq_len 4 (the served shape), 8, 2 and 1 decode whole
    # subspaces per 8-feature unit; pq_len 3 straddles units and slices;
    # rot_dim 320 (pq_len 5) streams the queries. Per-subspace books of 4
    # bits are staged in shared memory, of 8 bits read through L1; a
    # per-cluster book is always staged. bins 128 >
    # max_list 100: every list is shorter than its bins; bins 0 (auto)
    # and -1 (exact: one row a bin); list 1 is empty, list 2 holds 5
    # rows; cap 8 overflows; cap 200 with skewed probes fills more than
    # two query tiles (64 slots each) of a list. Per cluster, kernel 8
    # rounds its scores to bf16 (internal_distance_dtype)
    rng = np.random.default_rng(pq_dim * pq_len + bits + k + cap + bins)
    (q, cr, books, codes, norms, ids, probes), scale = _pq_case(
        rng, dev, pq_dim, bits, per_cluster, pq_len=pq_len,
        nq=256 if cap > 128 else 32, skew=cap > 128)
    qmap, inv_pos = _ivf_scan._invert_probes(probes, ids.shape[0], cap)
    if cap == 8:
        assert bool((inv_pos >= cap).any()), "cap must overflow"
    if cap > 128:
        assert bool((qmap[:, 128:] >= 0).any()), "three query tiles"
    bins, _ = scan_op.resolve_bins(bins, k, ids.shape[1])
    tb, round_q = pq_op.lut_operands(books, lut)
    args = (q, cr, tb, codes, norms, ids)
    sqrt = metric == "l2"
    round_out = per_cluster
    counters = PQ_ROUTES[lut]
    before = {c: getattr(pq_op, c) for c in sum(PQ_ROUTES.values(), ())}
    dk, ik = pq_op.pq_scan_fused(*args, probes, inv_pos, qmap, cap, k, bins,
                                 sqrt, metric, round_q, per_cluster)
    ck, cik = pq_op.pq_scan(*args, qmap, bins, metric, round_q, per_cluster,
                            round_out)
    torch.cuda.synchronize()
    assert {c: getattr(pq_op, c) - before[c] for c in before} == {
        c: int(c in counters) for c in before}
    dp, ip = pq_op.pq_scan_fused_plain(*args, qmap, k, bins, sqrt, metric,
                                       round_q, per_cluster)
    _near_tie_equal(dk, ik, dp, ip, 1e-5 * (np.sqrt(scale) if sqrt
                                            else scale))
    assert bool((ik[~torch.isfinite(dk)] == -1).all())
    cp, cip = pq_op.pq_scan_plain(*args, qmap, bins, metric, round_q,
                                  per_cluster, False)
    if round_out:
        # the kernel rounds a score within rtol 1e-5 of the plain f32 one;
        # against the plain version's own rounding, one bf16 step apart at
        # most (a rounding boundary between the two f32 sums)
        fin = torch.isfinite(cp)
        tol = _bf16_step(ck) / 2 + 1e-5 * scale
        assert bool(((ck - cp).abs() <= tol)[fin].all())
        cp, cip = pq_op.pq_scan_plain(*args, qmap, bins, metric, round_q,
                                      per_cluster, True)
        _blocks_match(ck, cik, cp, cip, _bf16_step(cp) + 1e-5 * scale)
    else:
        _blocks_match(ck, cik, cp, cip, 1e-5 * scale)


def test_pq_search_on_card_matches_cpu(dev):
    rng = np.random.default_rng(11)
    c = rng.normal(size=(16, 32)).astype(np.float32) * 4
    x = (c[rng.integers(0, 16, 4000)]
         + rng.normal(size=(4000, 32))).astype(np.float32)
    q = (c[rng.integers(0, 16, 64)]
         + rng.normal(size=(64, 32))).astype(np.float32)
    cpu = ivf_pq.build(x, ivf_pq.IndexParams(n_lists=16, kmeans_n_iters=4,
                                             pq_dim=16, keep_raw=True),
                       device="cpu")
    arrays = {f: getattr(cpu, f).numpy() for f in
              ("centers", "centers_rot", "rotation_matrix", "pq_centers",
               "codes", "lists_indices", "list_sizes")}
    gpu = ivf_pq.index_from_numpy(arrays, cpu.metric, cpu.size, cpu.pq_bits,
                                  raw=cpu.raw, device=dev)
    for rf, launched in ((4, "fused"), (30, "unfused")):
        sp = ivf_pq.SearchParams(n_probes=6, rescore_factor=rf,
                                 rescore_on_device="always")
        before = (pq_op.launches, pq_op.launches_fused)
        dg, ig = ivf_pq.search(gpu, q, 10, sp)
        after = (pq_op.launches, pq_op.launches_fused)
        assert after[launched == "fused"] > before[launched == "fused"]
        dc, ic = ivf_pq.search(cpu, q, 10, sp)
        # exact re-rank: the same ids on both devices
        np.testing.assert_array_equal(ig.cpu().numpy(), ic.numpy())
        np.testing.assert_allclose(dg.cpu().numpy(), dc.numpy(),
                                   rtol=1e-5, atol=1e-3)


def _blocks_match(ck, cik, cp, cip, tol):
    """Unfused candidate blocks (n_lists, cap, bins): the same empty
    pattern, ids -1 exactly there, distances within ``tol`` (a number or
    one per entry), ids equal on >= 99% of the filled entries (the rest
    near-ties)."""
    ck, cp = ck.float(), cp.float()
    fin = torch.isfinite(cp)
    assert torch.equal(torch.isfinite(ck), fin)
    assert torch.equal(cik[~fin], cip[~fin])
    if bool(fin.any()):
        assert bool(((ck - cp).abs() <= tol)[fin].all())
        assert float((cik[fin] == cip[fin]).double().mean()) >= 0.99


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [16, 13, 200, 300])
@pytest.mark.parametrize("bins", [0, -1, 7, 600, 64, 128])
@pytest.mark.parametrize("cap", [32, 8, 200])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_list_scan_matches_plain(dev, metric, d, bins, cap, out):
    # kernel 4 at k=300: auto bins = every row of the 40-row lists; 7
    # does not divide 40; 600 > 512 bins takes five bin chunks; 64 folds,
    # 128 > max_list; list 0 full, list 1 empty, short lists among the
    # rest; cap 8 overflows (the merge drops the overflow, the blocks just
    # hold fewer slots), cap 200 fills more than two query tiles of a list
    rng = np.random.default_rng(d * 7 + cap + (bins % 97))
    q, data, norms, ids, probes, qmap, inv_pos = _scan_case(
        rng, d, cap, metric, dev, nq=48)
    n_lists, k = ids.shape[0], 300
    rb, _ = scan_op.resolve_bins(bins, k, ids.shape[1])
    before = scan_op.launches_list
    ck, cik = scan_op.list_scan(q, data, norms, ids, qmap, rb, metric, out)
    torch.cuda.synchronize()
    assert scan_op.launches_list == before + 1
    assert ck.dtype == out and ck.shape == (n_lists, cap, rb)
    scale = float((q * q).sum(1).max() + norms.max())
    cp, cip = scan_op.list_scan_plain(q, data, norms, ids, qmap, rb, metric,
                                      torch.float32, "bf16x3")
    if out == torch.bfloat16:
        # the kernel rounds a score within rtol 1e-5 of the plain f32 one
        fin = torch.isfinite(cp)
        tol = _bf16_step(ck) / 2 + 1e-5 * scale
        assert bool(((ck.float() - cp).abs() <= tol)[fin].all())
        cp, cip = scan_op.list_scan_plain(q, data, norms, ids, qmap, rb,
                                          metric, out, "bf16x3")
        _blocks_match(ck, cik, cp, cip, _bf16_step(cp) + 1e-5 * scale)
    else:
        _blocks_match(ck, cik, cp, cip, 1e-5 * scale)
    # the merged search result, as ivf_flat.search returns it
    dk, ik = _ivf_scan.merge_candidates(ck, cik, probes, inv_pos, k, False,
                                        cap)
    dp, ip = _ivf_scan.merge_candidates(cp, cip, probes, inv_pos, k, False,
                                        cap)
    tol = 1e-5 * scale + (_bf16_step(dp).cpu().numpy()
                          if out == torch.bfloat16 else 0.0)
    _near_tie_equal(dk, ik, dp, ip, tol)


def test_wide_flat_search_on_card_matches_cpu(dev):
    rng = np.random.default_rng(5)
    c = rng.normal(size=(16, 16)).astype(np.float32) * 4
    x = (c[rng.integers(0, 16, 3000)]
         + rng.normal(size=(3000, 16))).astype(np.float32)
    q = (c[rng.integers(0, 16, 64)]
         + rng.normal(size=(64, 16))).astype(np.float32)
    cpu = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=16,
                                                 kmeans_n_iters=4),
                         device="cpu")
    arrays = {f: getattr(cpu, f).numpy() for f in
              ("centers", "lists_data", "lists_indices", "lists_norms",
               "list_sizes")}
    gpu = ivf_flat.index_from_numpy(arrays, cpu.metric, cpu.size, device=dev)
    sp = ivf_flat.SearchParams(n_probes=8, scan_order="list")
    before = scan_op.launches_list
    dg, ig = ivf_flat.search(gpu, q, 300, sp)
    assert scan_op.launches_list == before + 1
    dc, ic = ivf_flat.search(cpu, q, 300, sp)
    scale = float((q ** 2).sum(1).max() + cpu.lists_norms.max())
    _near_tie_equal(dg, ig, dc, ic, 1e-5 * scale)


def _bq_case(rng, dev, d, n_lists=16, max_list=100, nq=32, n_probes=6,
             skew=False):
    words = -(-d // 32)
    sizes = rng.integers(0, max_list + 1, size=n_lists)
    sizes[0], sizes[1], sizes[2] = max_list, 0, 5     # full, empty, short
    ids = np.full((n_lists, max_list), -1, np.int32)
    nxt = 0
    for l, s in enumerate(sizes):
        ids[l, :s] = np.arange(nxt, nxt + s)
        nxt += s
    bits = rng.integers(-(1 << 31), 1 << 31, size=(n_lists, max_list, words),
                        dtype=np.int64).astype(np.int32)
    norms2 = rng.uniform(0.5 * d, 1.5 * d, size=(n_lists, max_list)).astype(
        np.float32)
    scales = rng.uniform(0.5, 1.5, size=(n_lists, max_list)).astype(
        np.float32)
    for a in (bits, norms2, scales):
        a[ids < 0] = 0
    q = rng.normal(size=(nq, d)).astype(np.float32)
    centers_rot = rng.normal(size=(n_lists, d)).astype(np.float32)
    # skewed to the low lists: some list draws more than 128 queries
    w = 1.0 / np.arange(1, n_lists + 1) if skew else np.ones(n_lists)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False,
                                  p=w / w.sum())
                       for _ in range(nq)]).astype(np.int32)
    scale = float(((np.abs(q) + np.abs(centers_rot).max(0)) ** 2).sum(1).max()
                  + norms2.max())
    return [_t(a, dev) for a in (q, centers_rot, bits, norms2, scales, ids,
                                 probes)], scale


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [48, 128, 100, 13, 256, 200, 300])
@pytest.mark.parametrize("k,bins,cap", [(1, 16, 32), (10, 128, 32),
                                        (256, 64, 32), (10, 16, 8),
                                        (32, 7, 32), (10, 300, 32),
                                        (10, 100, 32), (10, 16, 200)])
def test_bq_scans_match_plain(dev, metric, d, k, bins, cap):
    # d 48: a partial second word and a partial slice; 13: one partial
    # word; 128 and 256: whole slices; 100 and 200: a partial last slice;
    # 300: five slices, the queries stream with the codes. bins 16 and 64
    # fold in registers; 7 (does not divide 100), 128, 300 (> max_list
    # 100) and 100 (= max_list: one row a bin, exact) take the stripes;
    # list 1 empty, list 2 holds 5 rows; cap 8 overflows; cap 200 with
    # skewed probes fills more than two query tiles (64 slots each) of a
    # list
    rng = np.random.default_rng(d + k + bins + cap)
    (q, cr, bits, n2, sc, ids, probes), scale = _bq_case(
        rng, dev, d, nq=256 if cap > 128 else 32, skew=cap > 128)
    qmap, inv_pos = _ivf_scan._invert_probes(probes, ids.shape[0], cap)
    if cap == 8:
        assert bool((inv_pos >= cap).any()), "cap must overflow"
    if cap > 128:
        assert bool((qmap[:, 128:] >= 0).any()), "three query tiles"
    args = (q, cr, bits, n2, sc, ids)
    b_f = (bq_op.launches, bq_op.launches_fused)
    dk, ik = bq_op.bq_scan_fused(*args, probes, inv_pos, qmap, cap, k, bins,
                                 metric)
    ck, cik = bq_op.bq_scan(*args, qmap, bins, metric)
    torch.cuda.synchronize()
    assert (bq_op.launches, bq_op.launches_fused) == (b_f[0] + 1,
                                                      b_f[1] + 1)
    dp, ip = bq_op.bq_scan_fused_plain(*args, qmap, k, bins, metric)
    _near_tie_equal(dk, ik, dp, ip, 1e-5 * scale)
    assert bool((ik[~torch.isfinite(dk)] == -1).all())
    cp, cip = bq_op.bq_scan_plain(*args, qmap, bins, metric)
    _blocks_match(ck, cik, cp, cip, 1e-5 * scale)


@pytest.mark.parametrize("metric", [ivf_flat.DistanceType.L2Expanded,
                                    ivf_flat.DistanceType.InnerProduct,
                                    ivf_flat.DistanceType.CosineExpanded])
def test_bq_search_on_card_matches_cpu(dev, metric):
    rng = np.random.default_rng(13)
    c = rng.normal(size=(16, 48)).astype(np.float32) * 4
    x = (c[rng.integers(0, 16, 4000)]
         + rng.normal(size=(4000, 48))).astype(np.float32)
    q = (c[rng.integers(0, 16, 64)]
         + rng.normal(size=(64, 48))).astype(np.float32)
    cpu = ivf_bq.build(x, ivf_bq.IndexParams(n_lists=16, metric=metric,
                                             kmeans_n_iters=4),
                       device="cpu")
    arrays = {f: getattr(cpu, f).numpy() for f in
              ("centers", "centers_rot", "rotation_matrix", "bits", "norms2",
               "scales", "lists_indices", "list_sizes")}
    arrays["bits"] = arrays["bits"].view(np.uint32)
    gpu = ivf_bq.index_from_numpy(arrays, cpu.metric, cpu.size, raw=cpu.raw,
                                  device=dev)
    for rf, launched in ((4, "fused"), (30, "unfused")):
        sp = ivf_bq.SearchParams(n_probes=6, rescore_factor=rf,
                                 rescore_on_device="always")
        before = (bq_op.launches, bq_op.launches_fused)
        dg, ig = ivf_bq.search(gpu, q, 10, sp)
        after = (bq_op.launches, bq_op.launches_fused)
        assert after[launched == "fused"] > before[launched == "fused"]
        dc, ic = ivf_bq.search(cpu, q, 10, sp)
        # exact re-rank: the same ids on both devices
        np.testing.assert_array_equal(ig.cpu().numpy(), ic.numpy())
        np.testing.assert_allclose(dg.cpu().numpy(), dc.numpy(),
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("metric,sqrt,precision", [
    ("l2", False, "bf16x3"), ("l2", True, "bf16x3"), ("ip", False, "bf16x3"),
    ("l2", False, "bf16"), ("ip", False, "bf16"), ("l2", False, "f32"),
    ("ip", False, "f32")])
@pytest.mark.parametrize("m,n,d,k", [(1, 1, 1, 1), (37, 23, 8, 5),
                                     (130, 5000, 17, 32), (65, 9000, 128, 1),
                                     (70, 3000, 64, 256), (20, 2500, 24, 300),
                                     (33, 700, 4097, 10), (9, 2100, 8192, 16)])
def test_fused_knn_matches_plain(dev, m, n, d, k, metric, sqrt, precision):
    rng = np.random.default_rng(m + n + d + k)
    x = _t(rng.normal(size=(m, d)).astype(np.float32), dev)
    y = _t(rng.normal(size=(n, d)).astype(np.float32), dev)
    _, tn, l_bins, kt = knn_op.geometry(m, n, d, k)
    # kernel 6 (d > 4096) or 5; the tensor cores, or the f32 body
    key = ("launches_ktiled" if kt else "launches") + \
        ("_f32" if precision == "f32" else "")
    before = getattr(knn_op, key)
    dk, ik = knn_op.fused_knn_cuda(x, y, k, metric, sqrt, tn, l_bins, kt,
                                   precision)
    torch.cuda.synchronize()
    assert getattr(knn_op, key) == before + 1
    dp, ip = knn_op.fused_knn_plain(x, y, k, metric, sqrt, tn, l_bins, kt,
                                    precision)
    assert ik.dtype == torch.int32 and dk.shape == (m, k)
    assert ((ik >= 0) & (ik < n)).all() or k > n
    if sqrt:
        dk, dp = dk * dk, dp * dp
    tol = 1e-5 * float(((x * x).sum(1).max() + (y * y).sum(1).max()))
    _near_tie_equal(dk, ik, dp, ip, tol)


# (m, n, d, tn, l_bins): bins of b = tn / l_bins rows through every route
# of the tensor-core epilogue: b = 1 (exact), 2, 4, 8..128 in registers,
# b > 128 carried across chunks, b not a power of two through shared
# memory (below and above a chunk), ragged n, queries past one block, and
# d past the resident-query limit (the queries stream with the rows)
TC_GEOMETRIES = [(40, 1000, 32, 1000, 1000), (50, 999, 16, 1000, 500),
                 (129, 2000, 20, 2000, 500), (20, 4100, 64, 4096, 512),
                 (70, 5000, 128, 4096, 128), (33, 9000, 128, 4096, 64),
                 (10, 4096, 48, 4096, 32), (17, 12000, 128, 4096, 8),
                 (25, 7000, 40, 3000, 10), (30, 3000, 24, 3000, 600),
                 (300, 3001, 72, 3008, 47), (9, 2000, 400, 1024, 64),
                 (12, 1500, 1000, 1024, 128), (5, 600, 4096, 600, 100)]


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("m,n,d,tn,l_bins", TC_GEOMETRIES)
def test_fused_knn_tc_bins_match_plain(dev, m, n, d, tn, l_bins, metric,
                                       precision):
    rng = np.random.default_rng(m * 3 + n + d)
    x = _t(rng.normal(size=(m, d)).astype(np.float32), dev)
    y = _t(rng.normal(size=(n, d)).astype(np.float32), dev)
    before = knn_op.launches
    got = knn_op.fused_knn_cuda(x, y, 10, metric, False, tn, l_bins, 0,
                                precision)
    torch.cuda.synchronize()
    assert knn_op.launches == before + 1
    want = knn_op.fused_knn_plain(x, y, 10, metric, False, tn, l_bins, 0,
                                  precision)
    tol = 1e-5 * float(((x * x).sum(1).max() + (y * y).sum(1).max()))
    _near_tie_equal(*got, *want, tol)


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [8192, 4100])
def test_fused_knn_ktiled_tc_matches_plain(dev, d, metric, precision):
    # kernel 6 on the tensor cores: the queries stream with the rows
    # (128 feature slices at d 8192; 4100 ends on a 4-feature slice), two
    # query blocks, a ragged last tile of the 1024-row geometry
    rng = np.random.default_rng(d + len(metric) + len(precision))
    m, n, k = 130, 2100, 16
    x = _t(rng.normal(size=(m, d)).astype(np.float32), dev)
    y = _t(rng.normal(size=(n, d)).astype(np.float32), dev)
    _, tn, l_bins, kt = knn_op.geometry(m, n, d, k)
    assert (tn, kt) == (1024, 2048)
    before = (knn_op.launches_ktiled, knn_op.launches_ktiled_f32)
    dk, ik = knn_op.fused_knn(x, y, k, metric, kernel_precision=precision)
    torch.cuda.synchronize()
    assert (knn_op.launches_ktiled, knn_op.launches_ktiled_f32) == \
        (before[0] + 1, before[1])
    dp, ip = knn_op.fused_knn_plain(x, y, k, metric, False, tn, l_bins, kt,
                                    precision)
    tol = 1e-5 * float(((x * x).sum(1).max() + (y * y).sum(1).max()))
    _near_tie_equal(dk, ik, dp, ip, tol)


def test_highest_launches_the_f32_body(dev):
    rng = np.random.default_rng(11)
    x = _t(rng.normal(size=(40, 32)).astype(np.float32), dev)
    y = _t(rng.normal(size=(3000, 32)).astype(np.float32), dev)
    before = (knn_op.launches, knn_op.launches_f32)
    dk, ik = knn_op.fused_knn(x, y, 8, kernel_precision="highest")
    torch.cuda.synchronize()
    assert (knn_op.launches, knn_op.launches_f32) == (before[0],
                                                      before[1] + 1)
    dp, ip = knn_op.fused_knn(x.cpu(), y.cpu(), 8, kernel_precision="highest")
    tol = 1e-5 * float(((x * x).sum(1).max() + (y * y).sum(1).max()))
    _near_tie_equal(dk, ik, dp, ip, tol)
    knn_op.fused_knn(x, y, 8)  # the card's default: the tensor cores
    torch.cuda.synchronize()
    assert (knn_op.launches, knn_op.launches_f32) == (before[0] + 1,
                                                      before[1] + 1)


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_fused_knn_exact_bins_equal_exact_scan(dev, precision):
    # one row a bin: the binned search is the exact k-NN. bf16x3 (the
    # card's default) drops lo.lo, at most 2^-18 |x||y| of x.y, so its
    # distances may sit 2^-18 (|x|^2 + |y|^2) further from the f32 scan's
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(50, 32)).astype(np.float32), dev)
    y = _t(rng.normal(size=(1000, 32)).astype(np.float32), dev)
    dk, ik = knn_op.fused_knn(x, y, 20, tn=1000, l_bins=1000,
                              kernel_precision=precision)
    full = ((x[:, None, :] - y[None]) ** 2).sum(-1)
    de, ie = torch.sort(full, dim=1, stable=True)
    tol = 1e-4
    if precision == "bf16x3":
        tol += 2.0 ** -18 * float((x * x).sum(1).max() + (y * y).sum(1).max())
    _near_tie_equal(dk, ik, de[:, :20], ie[:, :20].int(), tol)


ELT_CASES = [(t, False) for t in elt_cores.TAGS] + [("l2unexp", True)]


def _elt_data(rng, rows, d, kind):
    # "unit": uniform [0, 1) with zeros (the guards of canberra, js, kl);
    # "signed": uniform [-0.5, 1) with zeros (a <= 0, b <= 0, m <= 0);
    # "subnormal": "unit" with every third feature subnormal (~1e-40) or
    # zero in every row, so js takes lg2 of subnormal means and canberra
    # subnormal denominators. The subnormals share their features across
    # x and y: a ratio a / b of a normal over a subnormal would overflow
    # float32, where the reference's kl term is inf and the kernel's
    # finite (ROADMAP.md's known differences).
    v = rng.random((rows, d)).astype(np.float32)
    if kind == "signed":
        v = (1.5 * v - 0.5).astype(np.float32)
    v[np.abs(v) < 0.1] = 0.0
    if kind == "subnormal":
        tiny = (1e-40 * (0.5 + rng.random((rows, d)))).astype(np.float32)
        tiny[rng.random((rows, d)) < 0.3] = 0.0
        v[:, 2::3] = tiny[:, 2::3]
    return v


def _elt_check(got, want, tag):
    rtol = 1e-4 if tag in ("jensen_shannon", "kl") else 1e-5
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("kind", ["unit", "signed", "subnormal"])
@pytest.mark.parametrize("tag,sqrt", ELT_CASES)
@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (70, 65, 127), (33, 129, 5000),
                                   (128, 128, 32), (129, 257, 33),
                                   (1, 300, 4)])
def test_elementwise_dist_matches_plain(dev, tag, sqrt, m, n, d, kind):
    # 128 x 128 x 32: one whole tile, two whole chunks; 129 x 257 x 33:
    # ragged edge tiles and a one-feature last chunk; 1 x 300 x 4: one row,
    # the 16-byte loads of a chunk shorter than its 16 features
    rng = np.random.default_rng(m + n + d)
    x = _t(_elt_data(rng, m, d, kind), dev)
    y = _t(_elt_data(rng, n, d, kind), dev)
    before = elt_op.launches
    got = elt_op.elementwise_dist(x, y, tag, p=3.0, sqrt=sqrt)
    torch.cuda.synchronize()
    assert elt_op.launches == before + 1
    want = elt_op.elementwise_dist_plain(x, y, tag, p=3.0, sqrt=sqrt)
    _elt_check(got, want, tag)


@pytest.mark.parametrize("tag,sqrt", ELT_CASES)
def test_elementwise_dist_self_diagonal_is_zero(dev, tag, sqrt):
    # x against itself: every core's diagonal is exactly 0 in the plain
    # version, and in the kernel (jensen_shannon's and kl's logs of a, b and
    # the mean go through one lg2, so equal inputs cancel exactly)
    rng = np.random.default_rng(17)
    x = _elt_data(rng, 150, 70, "signed")
    x[:, 2::3] = _elt_data(rng, 150, 70, "subnormal")[:, 2::3]
    x = _t(x, dev)
    got = elt_op.elementwise_dist(x, x, tag, p=3.0, sqrt=sqrt)
    want = elt_op.elementwise_dist_plain(x, x, tag, p=3.0, sqrt=sqrt)
    torch.cuda.synchronize()
    assert bool((torch.diagonal(want) == 0).all())
    assert bool((torch.diagonal(got) == 0).all())
    _elt_check(got, want, tag)


@pytest.mark.parametrize("tag,sqrt", ELT_CASES)
@pytest.mark.parametrize("d", [6, 8])
def test_elementwise_dist_unaligned_rows(dev, tag, sqrt, d):
    # row-offset views whose pointers are not 16-byte aligned: d = 6 as
    # big[1:] (24 bytes in), d = 8 cut 4 bytes into a flat buffer (d % 4
    # == 0, yet the kernel must take its scalar loads)
    rng = np.random.default_rng(d)
    m, n = 131, 70
    if d == 6:
        x = _t(_elt_data(rng, m + 1, d, "unit"), dev)[1:]
        y = _t(_elt_data(rng, n + 1, d, "unit"), dev)[1:]
    else:
        x = _t(_elt_data(rng, 1, m * d + 1, "unit"), dev)[0, 1:].view(m, d)
        y = _t(_elt_data(rng, 1, n * d + 1, "unit"), dev)[0, 1:].view(n, d)
    assert x.data_ptr() % 16 and y.data_ptr() % 16 and x.is_contiguous()
    before = elt_op.launches
    got = elt_op.elementwise_dist(x, y, tag, p=3.0, sqrt=sqrt)
    torch.cuda.synchronize()
    assert elt_op.launches == before + 1
    _elt_check(got, elt_op.elementwise_dist_plain(x, y, tag, p=3.0,
                                                  sqrt=sqrt), tag)


def test_elementwise_hamming_on_integers_is_exact(dev):
    rng = np.random.default_rng(6)
    x = _t(rng.integers(0, 4, size=(90, 300)).astype(np.float32), dev)
    y = _t(rng.integers(0, 4, size=(70, 300)).astype(np.float32), dev)
    assert torch.equal(elt_op.elementwise_dist(x, y, "hamming"),
                       elt_op.elementwise_dist_plain(x, y, "hamming"))


def test_brute_force_entry_points_launch_on_card(dev):
    from raft_tpu_torch.neighbors import brute_force
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3000, 16)).astype(np.float32)
    q = rng.normal(size=(40, 16)).astype(np.float32)
    before = (knn_op.launches_f32, elt_op.launches)
    # the card's default is bf16x3; f32 on both sides compares like with
    # like ("highest", the f32 body)
    for metric in (brute_force.DistanceType.L2Expanded,
                   brute_force.DistanceType.CosineExpanded):
        dg, ig = brute_force.brute_force_knn(x, q, 10, metric, mode="fused",
                                             kernel_precision="highest")
        dc, ic = brute_force.brute_force_knn(x, q, 10, metric, mode="fused",
                                             kernel_precision="highest",
                                             device="cpu")
        np.testing.assert_array_equal(ig.cpu().numpy(), ic.numpy())
    dg, ig = brute_force.brute_force_knn(x, q, 10, brute_force.DistanceType.L1)
    dc, ic = brute_force.brute_force_knn(x, q, 10, brute_force.DistanceType.L1,
                                         device="cpu")
    np.testing.assert_array_equal(ig.cpu().numpy(), ic.numpy())
    assert knn_op.launches_f32 == before[0] + 2
    # one launch per db tile of the exact scan
    tiles = -(-3000 // brute_force._db_tile(40, 3000))
    assert tiles == 2 and elt_op.launches == before[1] + tiles


@pytest.mark.parametrize("m,n,d", [(33, 40, 7), (70, 129, 300)])
def test_elementwise_canberra_big_and_subnormal_denominators(dev, m, n, d):
    # |a| + |b| in (2^126, 2^128), where __fdividef alone returns 0, and
    # in the subnormal range, against the plain version's true ratio
    rng = np.random.default_rng(d)
    x = _elt_data(rng, m, d, "signed")
    y = _elt_data(rng, n, d, "signed")
    big = (2.0 ** 126 * (0.5 + rng.random((m + n, d)))).astype(np.float32)
    sign = np.where(rng.random((m + n, d)) < 0.5, -1.0, 1.0)
    x[:, 0::3] = (big[:m] * sign[:m])[:, 0::3]
    y[:, 0::3] = (big[m:] * sign[m:])[:, 0::3]
    tiny = (1e-40 * (0.5 + rng.random((m + n, d)))).astype(np.float32)
    x[:, 1::3] = tiny[:m, 1::3]
    y[:, 1::3] = -tiny[m:, 1::3]
    x, y = _t(x, dev), _t(y, dev)
    den = x[:, None, 0::3].abs() + y[None, :, 0::3].abs()
    assert float(den.max()) > 2.0 ** 126 and float(den.min()) < 2.0 ** 128
    got = elt_op.elementwise_dist(x, y, "canberra")
    want = elt_op.elementwise_dist_plain(x, y, "canberra")
    torch.cuda.synchronize()
    _elt_check(got, want, "canberra")


@pytest.mark.parametrize("d", [1, 2, 37])
def test_elementwise_minkowski_p0(dev, d):
    # every term |a - b|^0 is 1 (zero differences included), the sum is
    # the dim and its 1/0-th root +inf, or 1 at dim 1
    rng = np.random.default_rng(d)
    x = _t(_elt_data(rng, 20, d, "unit"), dev)
    y = torch.cat([x[:5], _t(_elt_data(rng, 30, d, "unit"), dev)])
    before = elt_op.launches
    got = elt_op.elementwise_dist(x, y, "minkowski", p=0.0)
    torch.cuda.synchronize()
    assert elt_op.launches == before + 1
    want = elt_op.elementwise_dist_plain(x, y, "minkowski", p=0.0)
    expect = torch.full_like(want, 1.0 if d == 1 else float("inf"))
    assert torch.equal(want, expect) and torch.equal(got, expect)


def _family_build(family, x, dev):
    """One build of ``family`` on the card at seed 0, as its ``IndexParams``
    default trainer draws it; the fields two builds must share."""
    if family == "ivf_flat":
        idx = ivf_flat.build(x, ivf_flat.IndexParams(
            n_lists=64, kmeans_n_iters=6), device=dev)
        return idx, ("centers", "lists_data", "lists_indices", "list_sizes")
    if family == "ivf_pq":
        idx = ivf_pq.build(x, ivf_pq.IndexParams(
            n_lists=64, kmeans_n_iters=6, pq_dim=16), device=dev)
        return idx, ("centers", "pq_centers", "codes", "lists_indices",
                     "list_sizes")
    if family == "ivf_pq_pc":
        idx = ivf_pq.build(x, ivf_pq.IndexParams(
            n_lists=64, kmeans_n_iters=6, pq_dim=16,
            codebook_kind=ivf_pq.CodebookGen.PER_CLUSTER), device=dev)
        return idx, ("centers", "pq_centers", "codes", "lists_indices",
                     "list_sizes")
    idx = ivf_bq.build(x, ivf_bq.IndexParams(n_lists=64, kmeans_n_iters=6),
                       device=dev)
    return idx, ("centers", "bits", "norms2", "lists_indices", "list_sizes")


@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq", "ivf_pq_pc",
                                    "ivf_bq"])
def test_builds_on_card_are_reproducible(dev, family):
    # two builds at one seed: bit-identical centres, lists and ids (the
    # trainers' sums run in a fixed order; index_add_ on the card did not)
    rng = np.random.default_rng(21)
    c = rng.normal(size=(64, 32)).astype(np.float32) * 3
    x = _t((c[rng.integers(0, 64, 70000)]
            + rng.normal(size=(70000, 32))).astype(np.float32), dev)
    a, fields = _family_build(family, x, dev)
    b, _ = _family_build(family, x, dev)
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _clustered(rng, n, d, nq):
    c = rng.normal(size=(16, d)).astype(np.float32) * 4
    x = (c[rng.integers(0, 16, n)] + rng.normal(size=(n, d))).astype(
        np.float32)
    q = (c[rng.integers(0, 16, nq)] + rng.normal(size=(nq, d))).astype(
        np.float32)
    return x, q


@pytest.mark.parametrize("per_cluster", [False, True])
def test_pq_extend_on_card_matches_cpu(dev, per_cluster):
    rng = np.random.default_rng(22)
    x, q = _clustered(rng, 5000, 32, 64)
    kind = ivf_pq.CodebookGen(int(per_cluster))
    cpu = ivf_pq.build(x[:4000], ivf_pq.IndexParams(
        n_lists=16, kmeans_n_iters=4, pq_dim=16, keep_raw=True,
        codebook_kind=kind), device="cpu")
    arrays = {f: getattr(cpu, f).numpy() for f in
              ("centers", "centers_rot", "rotation_matrix", "pq_centers",
               "codes", "lists_indices", "list_sizes")}
    gpu = ivf_pq.index_from_numpy(arrays, cpu.metric, cpu.size, cpu.pq_bits,
                                  codebook_kind=kind, raw=cpu.raw,
                                  device=dev)
    before = nn_op.launches
    ge = ivf_pq.extend(gpu, x[4000:])
    assert nn_op.launches > before               # predict on the card
    ce = ivf_pq.extend(cpu, x[4000:])
    for f in ("list_sizes", "lists_indices"):
        np.testing.assert_array_equal(getattr(ge, f).cpu().numpy(),
                                      getattr(ce, f).numpy())
    assert (ge.codes.cpu() == ce.codes).double().mean() >= 0.999
    np.testing.assert_array_equal(ge.raw, ce.raw)
    sp = ivf_pq.SearchParams(n_probes=6, rescore_factor=4,
                             rescore_on_device="always")
    dg, ig = ivf_pq.search(ge, q, 10, sp)
    dc, ic = ivf_pq.search(ce, q, 10, sp)
    assert (ig.cpu() == ic).double().mean() >= 0.999
    for mode in ("reconstruct", "lut"):
        spm = ivf_pq.SearchParams(n_probes=6, rescore_factor=4,
                                  scan_mode=mode, rescore_on_device="always")
        dg, ig = ivf_pq.search(ge, q, 10, spm)
        dc, ic = ivf_pq.search(ce, q, 10, spm)
        assert (ig.cpu() == ic).double().mean() >= 0.999, mode


@pytest.mark.parametrize("metric", [ivf_flat.DistanceType.L2Expanded,
                                    ivf_flat.DistanceType.CosineExpanded])
def test_bq_extend_on_card_matches_cpu(dev, metric):
    rng = np.random.default_rng(23)
    x, q = _clustered(rng, 5000, 48, 64)
    cpu = ivf_bq.build(x[:4000], ivf_bq.IndexParams(
        n_lists=16, metric=metric, kmeans_n_iters=4), device="cpu")
    arrays = {f: getattr(cpu, f).numpy() for f in
              ("centers", "centers_rot", "rotation_matrix", "bits", "norms2",
               "scales", "lists_indices", "list_sizes")}
    arrays["bits"] = arrays["bits"].view(np.uint32)
    gpu = ivf_bq.index_from_numpy(arrays, cpu.metric, cpu.size, raw=cpu.raw,
                                  device=dev)
    ge = ivf_bq.extend(gpu, x[4000:])
    ce = ivf_bq.extend(cpu, x[4000:])
    for f in ("list_sizes", "lists_indices"):
        np.testing.assert_array_equal(getattr(ge, f).cpu().numpy(),
                                      getattr(ce, f).numpy())
    assert (ge.bits.cpu() == ce.bits).double().mean() >= 0.999
    sp = ivf_bq.SearchParams(n_probes=6, rescore_factor=4,
                             rescore_on_device="always")
    before = bq_op.launches_fused
    dg, ig = ivf_bq.search(ge, q, 10, sp)
    assert bq_op.launches_fused > before
    dc, ic = ivf_bq.search(ce, q, 10, sp)
    assert (ig.cpu() == ic).double().mean() >= 0.999


@pytest.mark.parametrize("shape", [(3, 1, 64, 40), (5, 17, 300, 128)])
def test_bf16_dot_on_card_is_the_widened_product(dev, shape):
    # the reconstruct scans' product: one bf16 bmm into f32 on the card
    # against the CPU's widened f32 product of the same bf16 operands;
    # each product is exact in f32, so only the order of the f32 sums
    # differs: within 1e-5 of the sum of |products|
    b, m, n, d = shape
    rng = np.random.default_rng(b)
    a = torch.from_numpy(rng.normal(size=(b, m, d)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32))
    got = _ivf_scan.bf16_dot(a.to(dev), w.to(dev).bfloat16())
    assert got.dtype == torch.float32 and got.shape == (b, m, n)
    want = _ivf_scan.bf16_dot(a, w.bfloat16())
    mag = a.bfloat16().float().abs() @ w.bfloat16().float().abs() \
        .transpose(1, 2)
    assert ((got.cpu() - want).abs() <= 1e-5 * mag + 1e-30).all()


def _blob_rows(rng, n_blobs, n, d, spread):
    c = rng.normal(size=(n_blobs, d)).astype(np.float32) * spread
    return (c[rng.integers(0, n_blobs, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def test_kmeans_fit_on_card_matches_cpu(dev):
    # Lloyd k-means through kernel 1 (bf16x3) on the card against the
    # CPU's f32 plain version, from one row of each well-separated blob
    # (no row lies near two centres): labels identical, inertia within
    # 1e-3 relative; two fits on the card bit-identical, at Array and at
    # k-means++ init
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
    rng = np.random.default_rng(31)
    c = rng.normal(size=(16, 32)).astype(np.float32) * 8.0
    lab = rng.integers(0, 16, 20000)
    x = (c[lab] + rng.normal(size=(20000, 32))).astype(np.float32)
    c0 = x[[int(np.flatnonzero(lab == j)[0]) for j in range(16)]]
    params = KMeansParams(n_clusters=16, init=InitMethod.Array, max_iter=25)
    before = nn_op.launches
    cg, ig, ng = kmeans.fit(_t(x, dev), params, None, _t(c0, dev))
    assert nn_op.launches - before >= ng + 1
    cc, ic, nc = kmeans.fit(torch.from_numpy(x), params, None,
                            torch.from_numpy(c0))
    assert ng == nc
    np.testing.assert_array_equal(
        kmeans.predict(_t(x, dev), cg).cpu().numpy(),
        kmeans.predict(torch.from_numpy(x), cc).numpy())
    assert abs(float(ig) - float(ic)) <= 1e-3 * float(ic)
    cg2, ig2, _ = kmeans.fit(_t(x, dev), params, None, _t(c0, dev))
    assert torch.equal(cg, cg2) and torch.equal(ig, ig2)
    pp = [kmeans.fit(_t(x, dev), KMeansParams(n_clusters=16, seed=5,
                                              max_iter=5))[0]
          for _ in range(2)]
    assert torch.equal(*pp)


@pytest.mark.parametrize("metric", ["cityblock", "jensenshannon"])
def test_sparse_narrow_tier_is_dense_distance_on_card(dev, metric):
    # the narrow tier densifies the rows and launches kernel 7 on them:
    # bit-equal to pairwise_distance of the densified rows
    from raft_tpu_torch import sparse
    from raft_tpu_torch.distance import DISTANCE_TYPES, pairwise_distance
    rng = np.random.default_rng(32)
    a = rng.random((700, 300)).astype(np.float32)
    a[rng.random(a.shape) > 0.05] = 0.0
    b = rng.random((500, 300)).astype(np.float32)
    b[rng.random(b.shape) > 0.05] = 0.0
    ca, cb = sparse.dense_to_csr(_t(a, dev)), sparse.dense_to_csr(_t(b, dev))
    before = elt_op.launches
    got = sparse.pairwise_distance(ca, cb, DISTANCE_TYPES[metric])
    assert elt_op.launches > before
    want = pairwise_distance(ca.todense(), cb.todense(), metric)
    assert torch.equal(got, want)


def test_sparse_wide_tier_on_card_matches_cpu(dev):
    # the column-tiled tier on the card against the CPU: squared L2
    # within 1e-5 of the norms' scale (the tiles' f32 products sum in
    # another order), L1 within rtol 1e-5
    from raft_tpu_torch import sparse
    from raft_tpu_torch.distance import DistanceType
    rng = np.random.default_rng(33)
    a, b = (rng.random((m, 5000)).astype(np.float32) for m in (60, 45))
    a[rng.random(a.shape) > 0.01] = 0.0
    b[rng.random(b.shape) > 0.01] = 0.0
    scale = torch.from_numpy((a * a).sum(1)[:, None] + (b * b).sum(1)[None])
    for metric in (DistanceType.L2Expanded, DistanceType.L1):
        cpu = sparse.pairwise_distance(
            sparse.dense_to_csr(torch.from_numpy(a)),
            sparse.dense_to_csr(torch.from_numpy(b)), metric, col_tile=1024)
        card = sparse.pairwise_distance(
            sparse.dense_to_csr(_t(a, dev)), sparse.dense_to_csr(_t(b, dev)),
            metric, col_tile=1024).cpu()
        if metric == DistanceType.L2Expanded:
            assert ((card - cpu).abs() <= 1e-5 * scale).all()
        else:
            torch.testing.assert_close(card, cpu, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ["PAIRWISE", "KNN_GRAPH"])
def test_single_linkage_on_card_matches_cpu(dev, route):
    # n = 2000 in eight separate groups (the kNN graph at c = 2 falls
    # into components, so the fix-up runs on the card); small integer
    # coordinates make every squared distance exact in f32 in any order,
    # so children and labels must be identical to the CPU run
    from raft_tpu_torch.cluster import LinkageDistance, single_linkage
    rng = np.random.default_rng(34)
    x = rng.integers(0, 6, (2000, 16)).astype(np.float32)
    g = rng.integers(0, 8, 2000)
    x[np.arange(2000), g] += 40.0
    lg, cg = single_linkage(_t(x, dev), 8, LinkageDistance[route], 2)
    lc, cc = single_linkage(torch.from_numpy(x), 8, LinkageDistance[route], 2)
    assert torch.equal(cg.cpu(), cc) and torch.equal(lg.cpu(), lc)


def test_select_k_approx_launches_kernel_2(dev):
    from raft_tpu_torch.neighbors.selection import select_k
    v = torch.randn((128, 4096), device=dev)
    before = sel_op.launches
    da, ia = select_k(v, 128, mode="approx")
    assert sel_op.launches > before
    de, ie = select_k(v, 128)
    assert torch.equal(ia, ie) and torch.equal(da, de)


@pytest.mark.parametrize("tier", ["bf16x3", "highest"])
@pytest.mark.parametrize("n", [2, 16, 64])
@pytest.mark.parametrize("d", [2, 3, 16])
def test_fused_l2_nn_at_spectral_shapes(dev, tier, n, d):
    # the spectral partition's k-means shape: many rows, few centres of
    # few features (d 3: the unvectorised row loads); at 100k rows a
    # near-tie may fall either way, so ids agree on >= 99.9% of rows and
    # every distance is within rtol 1e-5 of the expanded-L2 scale
    m = 100_003
    g = torch.Generator(device=dev).manual_seed(n * 10 + d)
    x = torch.randn((m, d), generator=g, device=dev)
    y = torch.randn((n, d), generator=g, device=dev)
    precision, counter = NN_TIERS[tier]
    before = getattr(nn_op, counter)
    ik, dk = nn_op.fused_l2_nn(x, y, False, tier)
    assert getattr(nn_op, counter) == before + 1
    ip, dp = nn_op.fused_l2_nn_plain(x, y, False, precision)
    scale = (x * x).sum(1) + (y * y).sum(1)[ip.long()]
    assert float((ik == ip).double().mean()) >= 0.999
    assert bool(((dk - dp).abs() <= 1e-5 * scale).all())


def test_spectral_partition_on_card_launches_kernel_1(dev):
    from raft_tpu_torch import ops
    from raft_tpu_torch.random import make_blobs
    from raft_tpu_torch.sparse import COO, coo_to_csr, knn_graph
    from raft_tpu_torch.spectral import (analyze_modularity,
                                         analyze_partition,
                                         modularity_maximization, partition)
    x, _ = make_blobs(4000, 8, centers=4, seed=3, device=dev)
    coo = knn_graph(x, 10)
    graph = coo_to_csr(COO(coo.rows, coo.cols, torch.ones_like(coo.vals),
                           coo.shape))
    ops.reset_launch_counts()
    labels, evals, evecs = partition(graph, 4)
    assert ops.launch_counts()["fused_l2_nn"] > 0
    assert labels.device.type == "cuda" and evecs.shape == (4000, 4)
    assert int(labels.min()) >= 0 and int(labels.max()) < 4
    assert bool(torch.isfinite(evecs).all())
    assert bool((evals[1:] >= evals[:-1]).all())
    assert -1e-3 <= float(evals[0]) and float(evals[-1]) <= 2 + 1e-3
    cut, cost = analyze_partition(graph, labels, 4)
    assert bool(torch.isfinite(cut)) and bool(torch.isfinite(cost))
    ops.reset_launch_counts()
    labels, evals, _ = modularity_maximization(graph, 4)
    assert ops.launch_counts()["fused_l2_nn"] > 0
    assert evals.device.type == "cuda"
    assert -0.5 <= float(analyze_modularity(graph, labels, 4)) <= 1.0


# ---------------------------------------------------------------------
# The repaired primitives on the card: gather's out-of-range rows (no
# device-side assert), the by-key sums' dropped keys, discrete's draw.

def test_gather_out_of_range_on_card_raises_no_assert(dev):
    from raft_tpu_torch import matrix
    data = _t(np.arange(8, dtype=np.float32).reshape(4, 2), dev)
    idx = _t(np.array([0, 4, -1, -5, 1 << 30], np.int32), dev)
    got = matrix.gather(data, idx)
    torch.cuda.synchronize()
    want = torch.tensor([[0.0, 1.0], [np.nan, np.nan], [6.0, 7.0],
                         [np.nan, np.nan], [np.nan, np.nan]])
    torch.testing.assert_close(got.cpu(), want, equal_nan=True,
                               rtol=0, atol=0)
    got_i = matrix.gather(data.to(torch.int32), idx).cpu()
    assert (got_i[[1, 3, 4]] == torch.iinfo(torch.int32).min).all()
    kept = matrix.gather_if(data, idx[:3], _t(np.array([1, 0, 0], np.int32),
                                              dev), lambda s: s > 0)
    assert torch.equal(kept.cpu(), torch.tensor([[0.0, 1.0], [0.0, 0.0],
                                                 [0.0, 0.0]]))
    # the context survives: a kernel launches and agrees afterwards
    v = _t(np.random.default_rng(3).normal(size=(64, 512)).astype(
        np.float32), dev)
    before = sel_op.launches
    dk, ik = sel_op.select_k(v, 16)
    torch.cuda.synchronize()
    assert sel_op.launches == before + 1
    assert torch.equal(ik.cpu(), sel_op.select_k_plain(v.cpu(), 16)[1])


@pytest.mark.parametrize("keys", [[0, 1, 5, 1], [0, -1, 2, 1]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_by_key_sums_drop_out_of_range_keys_on_card(dev, keys, dtype):
    from raft_tpu_torch import linalg
    data = torch.arange(12, dtype=dtype).reshape(4, 3)
    k = torch.tensor(keys, dtype=torch.int32)
    for fn, d in ((linalg.reduce_rows_by_key, data),
                  (linalg.reduce_cols_by_key, data.T.contiguous())):
        got = fn(d.to(dev), k.to(dev), 3).cpu()
        assert torch.equal(got, fn(d, k, 3))


def test_discrete_on_card_matches_cpu_in_distribution(dev):
    from raft_tpu_torch import random as rnd
    for w in (np.zeros(8, np.float32),
              np.array([0.1, 0.0, 0.6, 0.3], np.float32)):
        counts = [np.bincount(rnd.discrete(rnd.RngState(7, device=d_),
                                           (40000,), w).cpu().numpy(),
                              minlength=len(w)) / 40000
                  for d_ in (dev, "cpu")]
        np.testing.assert_allclose(counts[0], counts[1], atol=0.02)
    n = 2 ** 24 + 3
    w = np.zeros(n, np.float32)
    w[[5, n - 1]] = 1.0
    d = rnd.discrete(rnd.RngState(8, device=dev), (4000,), w).cpu().numpy()
    assert set(np.unique(d)) == {5, n - 1}

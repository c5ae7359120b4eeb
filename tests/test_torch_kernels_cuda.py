"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and ragged shapes. Every test needs an NVIDIA GPU and is
skipped without one. This file imports neither JAX nor the JAX package,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py -m cuda

Tolerance: selection is exact; distances within rtol 1e-5 of the
expanded-L2 scale (|x|^2 + |y|^2) — fp32 with a different summation
order — and ids identical on random data.
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.neighbors import _ivf_scan, ivf_flat
from raft_tpu_torch.ops import fused_l2_nn as nn_op
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


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (37, 23, 8), (129, 65, 17),
                                   (300, 1000, 128)])
def test_fused_l2_nn_matches_plain(dev, m, n, d, sqrt):
    rng = np.random.default_rng(m + n + d)
    x = _t(rng.normal(size=(m, d)).astype(np.float32), dev)
    y = _t(rng.normal(size=(n, d)).astype(np.float32), dev)
    before = nn_op.launches
    ik, dk = nn_op.fused_l2_nn(x, y, sqrt)
    torch.cuda.synchronize()
    assert nn_op.launches == before + 1
    ip, dp = nn_op.fused_l2_nn_plain(x, y, sqrt)
    np.testing.assert_array_equal(ik.cpu().numpy(), ip.cpu().numpy())
    scale = ((x * x).sum(1) + (y * y).sum(1).max()).cpu().numpy()
    if sqrt:
        scale = np.sqrt(scale)
    assert (np.abs(dk.cpu().numpy() - dp.cpu().numpy())
            <= 1e-5 * scale).all()


def test_fused_l2_nn_ties_exact(dev):
    rng = np.random.default_rng(7)
    base = rng.integers(-3, 4, size=(6, 4)).astype(np.float32)
    y = _t(np.concatenate([base, base[::-1], base]), dev)
    x = _t(rng.integers(-3, 4, size=(200, 4)).astype(np.float32), dev)
    ik, dk = nn_op.fused_l2_nn(x, y)
    ip, dp = nn_op.fused_l2_nn_plain(x, y)
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


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [16, 13])
@pytest.mark.parametrize("bins", [0, -1, 7])
@pytest.mark.parametrize("k,cap", [(10, 32), (1, 32), (10, 8), (200, 32)])
def test_fused_scan_matches_plain(dev, metric, d, bins, k, cap):
    rng = np.random.default_rng(d * 31 + k + cap)
    nq, n_lists, max_list, n_probes = 32, 16, 40, 6
    centers, data, norms, ids = _random_index(rng, n_lists, max_list, d, dev)
    q = _t(rng.normal(size=(nq, d)).astype(np.float32), dev)
    probes = _ivf_scan.coarse_probes(q, centers, n_probes, kind=metric)
    qmap, inv_pos = _ivf_scan._invert_probes(probes, n_lists, cap)
    if cap == 8:
        assert bool((inv_pos >= cap).any()), "cap must overflow"
    sqrt = metric == "l2"
    dk, ik = scan_op.fused_list_scan(q, data, norms, ids, probes, inv_pos,
                                     qmap, cap, k, bins, sqrt, metric)
    dp, ip = scan_op.fused_list_scan_plain(q, data, norms, ids, probes,
                                           inv_pos, qmap, cap, k, bins,
                                           sqrt, metric)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(ik.cpu().numpy(), ip.cpu().numpy())
    fin = torch.isfinite(dp)
    assert torch.equal(torch.isfinite(dk), fin)
    scale = float((q * q).sum(1).max() + norms.max())
    err = (dk[fin] - dp[fin]).abs()
    assert float(err.max()) <= 1e-5 * scale if err.numel() else True


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
        np.testing.assert_array_equal(ig.cpu().numpy(), ic.numpy())
        np.testing.assert_allclose(dg.cpu().numpy(), dc.numpy(),
                                   rtol=1e-5, atol=1e-3)


def test_build_on_card_launches_fused_l2_nn(dev):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2000, 8)).astype(np.float32)
    before = nn_op.launches
    idx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=8,
                                                 kmeans_n_iters=3))
    assert idx.device.type == "cuda"
    assert nn_op.launches >= before + 4      # 3 sweeps + predict
    assert int(idx.list_sizes.sum()) == 2000

"""Parity of the port's brute-force k-NN (raft_tpu_torch.neighbors) with
the JAX package's: the fused binned kernel (kernels 5 and 6, the port's
plain version against the Pallas kernels in interpret mode), the exact
scan, parts and merges, haversine, the legacy ``spatial.knn`` forwards
and the ball cover, with its serializer and the type-dispatching
``save``/``load`` (both ways with the JAX package's files).

Inputs are made with numpy from a seed; the port runs on CPU tensors.
Tolerances: ids identical (random normal data has no ties); distances
within rtol 1e-5 of the expanded-L2 scale |x|^2 + |y|^2 (float32, another
summation order; for square-rooted distances, their squares), rtol 1e-5
/ atol 1e-5 elsewhere.
"""

import numpy as np
import pytest
import torch

from raft_tpu.distance.distance_types import DistanceType as JDT
from raft_tpu.neighbors import ball_cover as jbc
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.ops.pallas_fused_knn import _fused_knn_call as j_call
from raft_tpu.ops.pallas_fused_knn import fused_knn_pallas
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import ball_cover as tbc
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.ops import fused_knn as op
from raft_tpu_torch.spatial import knn as spatial_knn


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_knn(got, want, x, y, sqrt=False):
    (dt, it), (dj, ij) = got, want
    it, ij = it.numpy(), np.asarray(ij)
    np.testing.assert_array_equal(it, ij)
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[ij]
    if sqrt:
        scale = np.sqrt(scale)
    assert (np.abs(dt.numpy() - np.asarray(dj)) <= 1e-5 * scale).all()


def _assert_sqrt_close(d, want, q, x, ids):
    """Square-rooted expanded L2: the squares within rtol 1e-5 of
    |q|^2 + |x|^2 (a root near 0 magnifies the rounding of its square)."""
    scale = (q * q).sum(1)[:, None] + (x * x).sum(1)[ids]
    assert (np.abs(d.astype(np.float64) ** 2 - np.asarray(want, np.float64)
                   ** 2) <= 1e-5 * scale).all()


def test_fused_default_geometry_matches_jax_and_bins():
    # the JAX default geometry at d <= 512: tn 4096, 64 bins of 64 rows;
    # n = 10,000 leaves a ragged last tile
    x, y = _normal((32, 16), 1), _normal((10_000, 16), 2)
    assert op.geometry(32, 10_000, 16, 32) == (32, 4096, 64, 0)
    want = fused_knn_pallas(x, y, 32)
    got = op.fused_knn(_t(x), _t(y), 32)
    _assert_knn(got, want, x, y)
    # the binning is in the result: it drops true neighbours
    full = ((x[:, None, :] - y[None]) ** 2).sum(-1)
    exact = np.argsort(full, axis=1, kind="stable")[:, :32]
    assert (got[1].numpy() != exact).any()


@pytest.mark.parametrize("metric,sqrt,tn,l_bins,k", [
    ("l2", False, 64, 8, 10), ("ip", False, 40, 5, 7),
    ("l2", True, 64, 16, 10), ("l2", False, 48, 48, 12),
    ("ip", False, 24, 24, 30)])
def test_fused_small_geometries_match_jax(metric, sqrt, tn, l_bins, k):
    x, y = _normal((21, 9), tn), _normal((333, 9), l_bins)
    want = fused_knn_pallas(x, y, k, metric=metric, sqrt=sqrt, tm=8, tn=tn,
                            l_bins=l_bins)
    got = op.fused_knn(_t(x), _t(y), k, metric=metric, sqrt=sqrt, tm=8,
                       tn=tn, l_bins=l_bins)
    if metric == "l2":
        _assert_knn(got, want, x, y, sqrt)
    else:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
    if l_bins == tn:  # one row a bin: the exact k-NN
        s = (((x[:, None, :] - y[None]) ** 2).sum(-1) if metric == "l2"
             else -(x @ y.T))
        np.testing.assert_array_equal(
            got[1].numpy(), np.argsort(s, axis=1, kind="stable")[:, :k])


def test_ktiled_route_matches_jax():
    # d > 4096: kernel 6's geometry, tn 1024 with 64 bins of 16 rows
    x, y = _normal((16, 8192), 3), _normal((2048, 8192), 4)
    assert op.geometry(16, 2048, 8192, 10) == (16, 1024, 64, 2048)
    _assert_knn(op.fused_knn(_t(x), _t(y), 10), fused_knn_pallas(x, y, 10),
                x, y)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ktiled_bf16x3_matches_jax(monkeypatch, metric):
    """Kernel 6's arithmetic: at d = 4160 (KT slices of 2048, 2048, 64)
    and ``kernel_precision="bf16x3"``, the port's plain k-tiled product
    (three products of the hi/lo splits per slice, summed in f32) against
    the JAX package's ``_knn_kernel_ktiled`` taking the same bf16x3 split
    (interpret mode computes f32 whatever is asked, so its precision is
    pinned to the TPU's bf16x3 here). Tolerance: ids identical, distances
    within 1e-5 of |x|^2 + |y|^2 (exact products summed in another
    order)."""
    import raft_tpu.ops.pallas_fused_knn as pfk
    monkeypatch.setattr(pfk, "resolve_kernel_mode",
                        lambda name, interpret=False: "bf16x3")
    x, y = _normal((12, 4160), 24), _normal((1100, 4160), 25)
    assert op.geometry(12, 1100, 4160, 8)[3] == 2048
    want = fused_knn_pallas(x, y, 8, metric=metric,
                            kernel_precision="bf16x3")
    got = op.fused_knn(_t(x), _t(y), 8, metric=metric,
                       kernel_precision="bf16x3")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[np.asarray(want[1])]
    assert (np.abs(got[0].numpy() - np.asarray(want[0]))
            <= 1e-5 * scale).all()
    # bf16x3 is not f32: the port's plain f32 product differs somewhere
    f32 = op.fused_knn(_t(x), _t(y), 8, metric=metric,
                       kernel_precision="highest")
    assert not torch.equal(f32[0], got[0])


def test_ktiled_call_at_small_dim_matches_jax():
    x, y = _normal((16, 64), 5), _normal((300, 64), 6)
    want = j_call(x, y, 5, "l2", False, 16, 64, 16, True, kt=32)
    got = op._fused_knn_call(_t(x), _t(y), 5, "l2", False, 16, 64, 16, kt=32)
    _assert_knn(got, want, x, y)


def test_k_above_256_ranks_by_stable_sort():
    x, y = _normal((5, 8), 7), _normal((1200, 8), 8)
    want = fused_knn_pallas(x, y, 300)
    _assert_knn(op.fused_knn(_t(x), _t(y), 300), want, x, y)


def test_bf16_tier_rounds_both_operands():
    x, y = _normal((9, 24), 9), _normal((200, 24), 10)
    xr = _t(x).bfloat16().float().numpy()
    yr = _t(y).bfloat16().float().numpy()
    s = np.maximum((y * y).sum(1)[None] + (x * x).sum(1)[:, None]
                   - 2.0 * (xr @ yr.T), 0.0)
    d, i = op.fused_knn(_t(x), _t(y), 6, tn=200, l_bins=200,
                        kernel_precision="bf16")
    np.testing.assert_array_equal(i.numpy(),
                                  np.argsort(s, axis=1, kind="stable")[:, :6])
    for name in ("bf16", "default", "BF16"):
        for on_cuda in (False, True):
            assert op.resolve_precision(name, on_cuda) == "bf16"


def test_precision_mapping():
    # the JAX package's meanings (raft_tpu/core/precision.py
    # resolve_kernel_mode): None is the device's default, bf16x3 on the
    # card (as on the TPU), f32 on the CPU (as interpret mode computes)
    assert op.resolve_precision(None, True) == "bf16x3"
    assert op.resolve_precision(None, False) == "f32"
    for on_cuda in (False, True):
        assert op.resolve_precision("bf16x3", on_cuda) == "bf16x3"
        assert op.resolve_precision("highest", on_cuda) == "f32"
        assert op.resolve_precision("default", on_cuda) == "bf16"
        for bad in ("fp8", "high", "tf32"):
            with pytest.raises(ValueError):
                op.resolve_precision(bad, on_cuda)
    with pytest.raises(ValueError):
        op.fused_knn(_t(_normal((3, 4), 1)), _t(_normal((20, 4), 2)), 2,
                     kernel_precision="fp8")


@pytest.mark.parametrize("d", [1, 17, 128, 300])
def test_bf16x3_product_matches_jax_split_matmul(d):
    # the same three exact bf16 products summed in dot_nt_f32's order;
    # what differs is f32 summation order inside each product, at most
    # ~d * 2^-24 of sum |a_k b_k| <= |a||b| and in practice ~sqrt(d) *
    # 2^-24 of it, so rtol 1e-6 of |a||b| holds for d <= 300 with room
    from raft_tpu.ops._util import dot_nt_f32
    a, b = _normal((33, d), 40 + d), _normal((57, d), 41 + d)
    want = np.asarray(dot_nt_f32(a, b, "bf16x3"))
    got = op._product(_t(a), _t(b), 0, "bf16x3").numpy()
    scale = np.linalg.norm(a, axis=1)[:, None] * np.linalg.norm(b, axis=1)
    assert (np.abs(got - want) <= 1e-6 * scale).all()
    # and it is not the f32 product: the split drops lo.lo
    if d >= 17:
        assert not np.array_equal(got, op._product(_t(a), _t(b), 0).numpy())


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_bf16x3_fused_knn_matches_jax_split_distances(metric):
    # the slice at bf16x3: the JAX package's split product, the expanded
    # L2 (or -IP) scores and a stable selection against the port's plain
    # fused kernel, one row a bin (exact) and the default bins
    from raft_tpu.ops._util import dot_nt_f32
    x, y = _normal((21, 40), 42), _normal((1500, 40), 43)
    ip = np.asarray(dot_nt_f32(x, y, "bf16x3"))
    s = (-ip if metric == "ip" else np.maximum(
        (y * y).sum(1)[None] + (x * x).sum(1)[:, None] - 2.0 * ip, 0.0))
    want = np.argsort(s, axis=1, kind="stable")[:, :10]
    d, i = op.fused_knn(_t(x), _t(y), 10, metric, tn=1504, l_bins=1504,
                        kernel_precision="bf16x3")
    np.testing.assert_array_equal(i.numpy(), want)
    got = -d.numpy() if metric == "ip" else d.numpy()
    np.testing.assert_allclose(got, np.take_along_axis(s, want, 1),
                               rtol=1e-5, atol=1e-4)
    _, i_bins = op.fused_knn(_t(x), _t(y), 10, metric,
                             kernel_precision="bf16x3")
    _, i_f32 = op.fused_knn(_t(x), _t(y), 10, metric)
    assert (i_bins.numpy() == i_f32.numpy()).mean() > 0.99


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct,
                                    DistanceType.L1,
                                    DistanceType.CosineExpanded])
def test_exact_scan_matches_jax(metric, monkeypatch):
    x, q = _normal((700, 12), 11), _normal((40, 12), 12)
    want = jbf.brute_force_knn(x, q, 9, JDT(int(metric)), mode="exact")
    # tiles of 128 rows on the port's side: six merges with the carry
    monkeypatch.setattr(tbf, "_TILE_ELEMS", 40 * 128)
    d, i = tbf.brute_force_knn(x, q, 9, metric, mode="exact", device="cpu")
    np.testing.assert_array_equal(i.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(d.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("metric", [DistanceType.CosineExpanded,
                                    DistanceType.CorrelationExpanded,
                                    DistanceType.L2SqrtExpanded])
def test_fused_mode_matches_jax(metric):
    x, q = _normal((3000, 12), 13), _normal((24, 12), 14)
    want = jbf.brute_force_knn(x, q, 8, JDT(int(metric)), mode="fused")
    d, i = tbf.brute_force_knn(x, q, 8, metric, mode="fused", device="cpu")
    np.testing.assert_array_equal(i.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(d.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)


def test_knn_parts_translations_and_merge_match_jax():
    parts = [_normal((150, 6), 15), _normal((90, 6), 16), _normal((5, 6), 17)]
    q = _normal((11, 6), 18)
    for tr in (None, [1000, 0, 5000]):
        want = jbf.knn(parts, q, 7, JDT.L2Expanded, translations=tr)
        got = tbf.knn(parts, q, 7, DistanceType.L2Expanded, translations=tr,
                      device="cpu")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
    want = jbf.knn(parts, q, 7, JDT.InnerProduct)
    got = tbf.knn(parts, q, 7, DistanceType.InnerProduct, device="cpu")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # merge with -1 sentinels: a row whose parts hold fewer than k ids
    pd = [np.array([[0.5, np.inf], [0.1, 0.2]], np.float32),
          np.array([[0.3, np.inf], [0.05, 0.4]], np.float32)]
    pi = [np.array([[1, -1], [2, 3]], np.int32),
          np.array([[7, -1], [8, 9]], np.int32)]
    want = jbf.knn_merge_parts(pd, pi, 3)
    got = tbf.knn_merge_parts(pd, pi, 3, device="cpu")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_haversine_and_fused_l2_knn_match_jax():
    rng = np.random.default_rng(19)
    pts = rng.uniform(-1.2, 1.2, size=(300, 2)).astype(np.float32)
    want = jbf.haversine_knn(pts, pts[:20], 5)
    got = tbf.haversine_knn(pts, pts[:20], 5, device="cpu")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    x = _normal((400, 8), 20)
    for sqrt in (False, True):
        want = jbf.fused_l2_knn(x, x[:10], 4, sqrt=sqrt)
        got = tbf.fused_l2_knn(x, x[:10], 4, sqrt=sqrt, device="cpu")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_spatial_knn_forwards():
    x = _normal((500, 8), 21)
    assert spatial_knn.brute_force_knn is tbf.brute_force_knn
    assert spatial_knn.knn_merge_parts is tbf.knn_merge_parts
    params = ivf_flat.IndexParams(n_lists=8, kmeans_n_iters=3)
    idx = spatial_knn.approx_knn_build_index(x, params, device="cpu")
    assert isinstance(idx, ivf_flat.Index)
    sp = ivf_flat.SearchParams(n_probes=8)
    got = spatial_knn.approx_knn_search(idx, x[:6], 4, sp)
    want = ivf_flat.search(idx, x[:6], 4, sp)
    assert torch.equal(got[1], want[1])
    np.testing.assert_array_equal(got[1][:, 0].numpy(), np.arange(6))
    with pytest.raises(TypeError):
        spatial_knn.approx_knn_build_index(x, object(), device="cpu")
    with pytest.raises(TypeError):
        spatial_knn.approx_knn_search(object(), x[:6], 4)


@pytest.fixture(scope="module")
def ball_data():
    rng = np.random.default_rng(22)
    c = rng.normal(size=(10, 5)).astype(np.float32) * 4
    x = (c[rng.integers(0, 10, 900)] + rng.normal(size=(900, 5))).astype(
        np.float32)
    return x, jbc.build(x)


@pytest.mark.parametrize("prune,n_probes", [(True, 0), (False, 0),
                                            (True, 4)])
def test_ball_cover_on_jax_index_matches_jax(ball_data, prune, n_probes):
    x, jidx = ball_data
    tidx = tbc.index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in
         ("landmarks", "lists_data", "lists_indices", "radii")},
        int(jidx.metric), jidx.size, device="cpu")
    q = x[::37]
    want = jbc.knn_query(jidx, q, 6, n_probes=n_probes, prune=prune)
    got = tbc.knn_query(tidx, q, 6, n_probes=n_probes, prune=prune)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _assert_sqrt_close(got[0].numpy(), want[0], q, x, got[1].numpy())
    if n_probes == 0:
        want = jbc.all_knn_query(jidx, 3)
        got = tbc.all_knn_query(tidx, 3)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("metric", [DistanceType.L2SqrtExpanded,
                                    DistanceType.L2SqrtUnexpanded])
def test_ball_cover_own_build_is_exact(ball_data, metric):
    x, _ = ball_data
    idx = tbc.build(x, metric, device="cpu")
    assert idx.n_landmarks == 30 and idx.size == 900
    q = x[::23]
    d, i = tbc.knn_query(idx, q, 5)
    want = tbf.brute_force_knn(x, q, 5, DistanceType.L2SqrtExpanded,
                               device="cpu")
    np.testing.assert_array_equal(i.numpy(), want[1].numpy())
    _assert_sqrt_close(d.numpy(), want[0].numpy(), q, x, i.numpy())


BALL_FIELDS = ("landmarks", "lists_data", "lists_indices", "radii")


def test_ball_cover_save_load_both_ways(ball_data, tmp_path):
    from raft_tpu.neighbors import serialize as jser
    from raft_tpu_torch.neighbors import serialize as tser
    x, jidx = ball_data
    jser.save_ball_cover(jidx, str(tmp_path / "j.bin"))
    tidx = tser.load_ball_cover(str(tmp_path / "j.bin"), device="cpu")
    for f in BALL_FIELDS:
        np.testing.assert_array_equal(getattr(tidx, f).numpy(),
                                      np.asarray(getattr(jidx, f)))
    assert tidx.metric == int(jidx.metric) and tidx.size == jidx.size
    tser.save_ball_cover(tidx, str(tmp_path / "t.bin"))
    back = jser.load_ball_cover(str(tmp_path / "t.bin"))
    for f in BALL_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(jidx, f)))
    assert int(back.metric) == int(jidx.metric) and back.size == jidx.size
    # the loaded index answers: every row finds itself
    _, i = tbc.knn_query(tidx, _t(x[:20]), 1)
    np.testing.assert_array_equal(i.numpy()[:, 0], np.arange(20))


@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq", "ivf_bq",
                                    "ball_cover"])
def test_dispatch_save_load_both_ways(ball_data, tmp_path, family):
    import importlib
    from raft_tpu.neighbors import serialize as jser
    from raft_tpu_torch.neighbors import serialize as tser
    x, jidx = ball_data
    jmod = importlib.import_module(f"raft_tpu.neighbors.{family}")
    tmod = importlib.import_module(f"raft_tpu_torch.neighbors.{family}")
    if family != "ball_cover":
        extra = {"pq_dim": 5} if family == "ivf_pq" else {}
        jidx = jmod.build(x, jmod.IndexParams(n_lists=4, kmeans_n_iters=2,
                                              **extra))
    jser.save(jidx, str(tmp_path / "j.npz"))
    tidx = tser.load(str(tmp_path / "j.npz"), device="cpu")
    assert isinstance(tidx, tmod.BallCoverIndex if family == "ball_cover"
                      else tmod.Index)
    tser.save(tidx, str(tmp_path / "t.npz"))
    back = jser.load(str(tmp_path / "t.npz"))
    assert type(back) is type(jidx)
    fields = {"ball_cover": BALL_FIELDS,
              "ivf_flat": ("centers", "lists_data", "lists_indices",
                           "list_sizes"),
              "ivf_pq": ("centers", "pq_centers", "codes", "lists_indices"),
              "ivf_bq": ("centers", "bits", "scales", "lists_indices")}[family]
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(jidx, f)))
    with pytest.raises(TypeError):
        tser.save(object(), str(tmp_path / "x.npz"))


@pytest.mark.parametrize("fmt,item", [("host_ivf_flat", "item 7"),
                                      ("mutable", None)])
def test_load_of_unported_format_names_its_item(tmp_path, fmt, item):
    # formats the port once lacked (``item``: the ROADMAP.md queue 1 item
    # that ported the host-memory format) load through the dispatching
    # ``load`` now: the mutable format returns a MutableIndex, the
    # host-memory one a HostIvfFlat whose lists stay in host numpy
    from raft_tpu_torch import mutate
    from raft_tpu_torch.neighbors import host_memory, ivf_flat
    from raft_tpu_torch.neighbors import serialize as tser
    path = str(tmp_path / "f.npz")
    if item is not None:
        h = host_memory.to_host(ivf_flat.build(
            _normal((64, 4), 5), ivf_flat.IndexParams(
                n_lists=2, kmeans_n_iters=2), device="cpu"))
        tser.save(h, path)
        back = tser.load(path, device="cpu")
        assert isinstance(back, host_memory.HostIvfFlat)
        assert isinstance(back.lists_data, np.ndarray)
        for f in ("lists_data", "lists_norms", "lists_indices"):
            np.testing.assert_array_equal(getattr(back, f), getattr(h, f))
        assert torch.equal(back.centers, h.centers)
        return
    if item is None:
        x = _normal((64, 4), 5)
        m = mutate.MutableIndex(ivf_flat.build(
            x, ivf_flat.IndexParams(n_lists=2, kmeans_n_iters=2),
            device="cpu"), k=2)
        m.upsert(x[:2] + 1.0)
        m.delete([3])
        tser.save(m, path)
        back = tser.load(path, device="cpu")
        assert isinstance(back, mutate.MutableIndex)
        assert back.stats() == m.stats()


def test_cpu_tensor_takes_plain_version_without_launch():
    x = _t(_normal((6, 4), 23))
    before = (op.launches, op.launches_ktiled)
    op.fused_knn(x, x, 2)
    assert (op.launches, op.launches_ktiled) == before


def test_cuda_entry_refuses_cpu_tensors():
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        op.fused_knn_cuda(x, x, 2)
    with pytest.raises(ValueError, match="metric"):
        op.fused_knn(x, x, 2, metric="l1")

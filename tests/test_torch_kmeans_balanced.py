"""Parity of the port's balanced k-means (raft_tpu_torch) with the JAX
package's, on well-separated blobs (``n_clusters`` = number of blobs),
from the same initial rows.

Tolerance: labels identical, centres within rtol 1e-4 (per-cluster sums
reduce in a different order: the JAX ``segment_sum`` vs the port's
stable-sorted segment reduction). Small
``n`` uses explicit initial rows taken from the JAX package's own draw;
``build_hierarchical`` runs at ``n > 65536``, where both packages draw
the same numpy stream on their own.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.cluster import kmeans_balanced as jkm
from raft_tpu.util.host_sample import sample_rows as jax_sample_rows
from raft_tpu_torch.cluster import kmeans_balanced as tkm
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.ops import fused_l2_nn as nn_op
from raft_tpu_torch.util.host_sample import sample_rows, sample_rows_np
from raft_tpu_torch.util.segment import segment_sum


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _blobs(n_blobs, per_blob, d, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(n_blobs, d)).astype(np.float32) * spread
    lab = np.repeat(np.arange(n_blobs), per_blob)
    rng.shuffle(lab)
    x = c[lab] + rng.normal(size=(lab.size, d)).astype(np.float32)
    return x.astype(np.float32)


@pytest.mark.parametrize("seed,n_iters", [(0, 3), (1, 6)])
def test_balanced_kmeans_matches_jax(seed, n_iters):
    x = _blobs(8, 60, 16, seed)
    init = np.array(jax_sample_rows(x.shape[0], 8, seed))
    cj = np.asarray(jkm.balanced_kmeans(x, 8, n_iters=n_iters, seed=seed))
    ct = tkm._train_from(torch.from_numpy(x), 8, n_iters=n_iters,
                         seed=seed, init_idx=torch.from_numpy(init))
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-4, atol=1e-4)
    lj = np.asarray(jkm.predict(x, cj))
    lt = tkm.predict(torch.from_numpy(x), ct).numpy()
    np.testing.assert_array_equal(lt, lj)


def test_balancing_reseeds_like_jax():
    # a tiny stray group makes one cluster fall under the balance
    # threshold; both packages must re-seed it from the same worst row
    x = _blobs(4, 50, 8, 3)
    x = np.concatenate([x, x[:2] + 40.0]).astype(np.float32)
    init = np.asarray([0, 1, 2, x.shape[0] - 1], np.int64)
    cj = np.asarray(jkm._em(jnp.asarray(x), jnp.asarray(x[init]), 4, 4,
                            0.25))
    ct = tkm._train_from(torch.from_numpy(x), 4, n_iters=4,
                         init_idx=torch.from_numpy(init))
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-4, atol=1e-4)


def test_predict_matches_jax():
    x = _blobs(6, 40, 12, 5)
    c = x[::37][:6]
    np.testing.assert_array_equal(
        tkm.predict(torch.from_numpy(x), torch.from_numpy(c)).numpy(),
        np.asarray(jkm.predict(x, c)))


def test_build_hierarchical_flat_path_matches_jax():
    # n > 65536: the trainset subsample and the initial rows come from
    # the same numpy stream in both packages
    x = _blobs(8, 8800, 4, 2, spread=20.0)
    kw = dict(n_iters=3, max_train_points=66000, seed=4)
    cj = np.asarray(jkm.build_hierarchical(x, 8, **kw))
    before = nn_op.launches
    ct = tkm.build_hierarchical(torch.from_numpy(x), 8, **kw)
    assert nn_op.launches == before        # CPU tensors: no kernel
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        tkm.predict(torch.from_numpy(x), ct).numpy(),
        np.asarray(jkm.predict(x, cj)))


def test_two_level_path_counts_and_refusals():
    # the two-level path (n_clusters > 16384) is ported now: it counts
    # its path and balancing sweeps and returns every centre; too few
    # rows for its mesoclusters is a LogicError, as for the flat path
    from raft_tpu_torch import obs
    with pytest.raises(LogicError, match="n_clusters"):
        tkm.build_hierarchical(torch.zeros((10, 2)), 20000)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(16500, 2)).astype(np.float32))
    before = obs.snapshot()["counters"]
    c = tkm.build_hierarchical(x, 16400, n_iters=1)
    after = obs.snapshot()["counters"]
    assert c.shape == (16400, 2) and bool(torch.isfinite(c).all())
    key = "raft.kmeans_balanced.build.total{path=two_level}"
    rounds = "raft.kmeans_balanced.balancing_rounds"
    assert after.get(key, 0) - before.get(key, 0) == 1
    assert after[rounds] - before.get(rounds, 0) == 2


def test_two_level_matches_jax(monkeypatch):
    # 16385 clusters: 128 mesoclusters of 129 fine centres, then two
    # balancing sweeps. Both packages draw their initial rows from the
    # numpy stream (the JAX package's own draw for n > 65536; its
    # mesoclusters are smaller, so the test hands it that stream); its
    # assignments run in interpret mode, whose distances are the plain
    # version's bit for bit, so the reseeds pick the same rows.
    # Tolerance: centres within 1e-4 (as above; equal in practice)
    monkeypatch.setattr(jkm, "sample_rows", lambda n, m, seed: jnp.asarray(
        sample_rows_np(n, m, seed).astype(np.int32)))
    x = np.random.default_rng(0).normal(size=(65540, 8)).astype(np.float32)
    cj = np.asarray(jkm.build_hierarchical(x, 16385, n_iters=2))
    ct = tkm.build_hierarchical(torch.from_numpy(x), 16385, n_iters=2)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width", [1, 5])
def test_segment_sum_is_index_add_in_a_fixed_order(width):
    # the trainers' per-cluster sums: index_add_ within f32 rounding (on
    # the CPU both add a segment's rows in row order: equal), counts
    # exact, and two runs bit for bit the same
    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.normal(size=(5000, width)).astype(np.float32))
    x = x.reshape(-1) if width == 1 else x
    lab = torch.from_numpy(rng.integers(0, 300, 5000))
    lab[lab == 7] = 8                      # an empty segment
    sums, counts = segment_sum(x, lab, 300)
    ref = torch.zeros((300,) + tuple(x.shape[1:])).index_add_(0, lab, x)
    torch.testing.assert_close(sums, ref, rtol=1e-6, atol=1e-5)
    assert torch.equal(counts, torch.bincount(lab, minlength=300))
    assert float(sums[7].abs().sum()) == 0.0 and int(counts[7]) == 0
    again, _ = segment_sum(x, lab, 300)
    assert torch.equal(again, sums)


def test_sample_rows_is_the_jax_numpy_stream():
    n, m = 70000, 300
    np.testing.assert_array_equal(sample_rows_np(n, m, 9),
                                  np.asarray(jax_sample_rows(n, m, 9)))
    assert sample_rows(n, m, 9).dtype == torch.int64


def _train(entry, x, n_clusters, n_iters, prec):
    """Centres from one trainer entry point at ``prec`` (``None`` = the
    device's default, f32 here)."""
    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq
    xt = torch.from_numpy(x)
    if entry == "balanced_kmeans":
        return tkm.balanced_kmeans(xt, n_clusters, n_iters=n_iters, seed=1,
                                   kernel_precision=prec)
    if entry == "build_hierarchical":
        return tkm.build_hierarchical(xt, n_clusters, n_iters=n_iters,
                                      seed=1, kernel_precision=prec)
    mod = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq, "ivf_bq": ivf_bq}[entry]
    kw = {"pq_dim": 4} if entry == "ivf_pq" else {}
    return mod.build(x, mod.IndexParams(n_lists=n_clusters,
                                        kmeans_n_iters=n_iters,
                                        kmeans_kernel_precision=prec, **kw),
                     device="cpu").centers


def _partition_agreement(a, b):
    """Share of rows whose label in ``b`` is the most common ``b`` label
    of their ``a`` cluster (cluster numbers are arbitrary)."""
    return sum(int(torch.bincount(b[a == k]).max())
               for k in torch.unique(a)) / a.numel()


@pytest.mark.parametrize("prec", ["bf16x3", "bf16"])
@pytest.mark.parametrize("entry", ["balanced_kmeans", "build_hierarchical",
                                   "ivf_flat", "ivf_pq", "ivf_bq"])
def test_kernel_precision_reaches_the_assignment(monkeypatch, entry, prec):
    # a spy on the plain version records each assignment's arithmetic:
    # every EM sweep takes the tier asked for; predict (which the JAX
    # package calls without one) takes the device default, f32 here.
    # Two far-apart blobs, two clusters: EM's only fixed point from any
    # start is the blobs, so the tier may change the path but not the
    # result (with more clusters than two, a blob split between two
    # centres is stable, and its boundary's near-ties make the path, and
    # so the partition, depend on the last bits of each distance)
    x = _blobs(2, 240, 16, 21)
    sweeps = 5
    seen = []
    plain = nn_op.fused_l2_nn_plain

    def spy(xa, ya, sqrt=False, precision="f32"):
        seen.append(precision)
        return plain(xa, ya, sqrt, precision)

    monkeypatch.setattr(nn_op, "fused_l2_nn_plain", spy)
    centers = _train(entry, x, 2, sweeps, prec)
    predicts = 1 if entry.startswith("ivf") else 0   # the build's labels
    assert seen == [prec] * sweeps + ["f32"] * predicts
    monkeypatch.setattr(nn_op, "fused_l2_nn_plain", plain)
    ref = _train(entry, x, 2, sweeps, "highest")
    xt = torch.from_numpy(x)
    assert _partition_agreement(tkm.predict(xt, ref),
                                tkm.predict(xt, centers)) >= 0.99

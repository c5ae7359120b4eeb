"""Parity of the port's balanced k-means (raft_tpu_torch) with the JAX
package's, on well-separated blobs (``n_clusters`` = number of blobs),
from the same initial rows.

Tolerance: labels identical, centres within rtol 1e-4 (per-cluster sums
reduce in a different order: ``segment_sum`` vs ``index_add_``). Small
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
from raft_tpu_torch.ops import fused_l2_nn as nn_op
from raft_tpu_torch.util.host_sample import sample_rows, sample_rows_np


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
    ct = tkm.balanced_kmeans(torch.from_numpy(x), 8, n_iters=n_iters,
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
    ct = tkm.balanced_kmeans(torch.from_numpy(x), 4, n_iters=4,
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


def test_two_level_path_is_not_ported():
    x = torch.zeros((10, 2))
    with pytest.raises(NotImplementedError, match="two-level"):
        tkm.build_hierarchical(x, 20000)


def test_sample_rows_is_the_jax_numpy_stream():
    n, m = 70000, 300
    np.testing.assert_array_equal(sample_rows_np(n, m, 9),
                                  np.asarray(jax_sample_rows(n, m, 9)))
    assert sample_rows(n, m, 9).dtype == torch.int64

"""The port's random generation (``raft_tpu_torch.random``), held to the
properties ``tests/test_random.py`` checks on the JAX package's draws.

``torch.Generator`` and ``jax.random`` draw other bits from one seed, so
no draw is compared with the JAX package's; every check is statistical
or structural, on the CPU (``device="cpu"``): moments within the same
tolerances as ``tests/test_random.py`` (0.1 of max(1, |mean| + std) for
the mean and of max(1, std) for the std, 0.15 for the heavy tails),
ranges, reproducibility from a seed, distinct streams, labels and
cluster statistics of the blobs, exact linear recovery of the
regression targets (rtol 1e-4, atol 1e-3), the covariance of the
multi-variate gaussian (atol 0.1), and the R-MAT ranges and top-level
quadrant shares (within 0.01 of theta at 200,000 edges). Shapes, ranges
and dtypes are also compared with the JAX package's for the same
arguments.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu import random as jr
from raft_tpu_torch import random as tr
from raft_tpu_torch.random import (GeneratorType, RngState, make_blobs,
                                   make_regression, multi_variable_gaussian,
                                   permute, rmat_rectangular_gen,
                                   sample_without_replacement)

N = 20000
CPU = "cpu"


def _st(seed, **kw):
    return RngState(seed, device=CPU, **kw)


def _check_moments(x, mean, std, tol=0.1):
    x = np.asarray(x, dtype=np.float64)
    assert abs(x.mean() - mean) < tol * max(1.0, abs(mean) + std)
    assert abs(x.std() - std) < tol * max(1.0, std)


# name -> (draw(state), mean, std, tol)
MOMENTS = {
    "uniform": (lambda s: tr.uniform(s, (N,), -2.0, 2.0), 0.0,
                4.0 / np.sqrt(12), 0.1),
    "normal": (lambda s: tr.normal(s, (N,), mu=3.0, sigma=2.0), 3.0, 2.0,
               0.1),
    "exponential": (lambda s: tr.exponential(s, (N,), lambda_=2.0), 0.5,
                    0.5, 0.15),
    "gumbel": (lambda s: tr.gumbel(s, (N,)), 0.5772, np.pi / np.sqrt(6),
               0.15),
    "logistic": (lambda s: tr.logistic(s, (N,), 0.0, 1.0), 0.0,
                 np.pi / np.sqrt(3), 0.15),
    "laplace": (lambda s: tr.laplace(s, (N,)), 0.0, np.sqrt(2), 0.15),
    "rayleigh": (lambda s: tr.rayleigh(s, (N,), sigma=1.0),
                 np.sqrt(np.pi / 2), np.sqrt(2 - np.pi / 2), 0.15),
    "lognormal": (lambda s: tr.lognormal(s, (N,), 0.0, 0.25),
                  np.exp(0.25 ** 2 / 2),
                  np.sqrt((np.exp(0.0625) - 1) * np.exp(0.0625)), 0.1),
    "normalInt": (lambda s: tr.normalInt(s, (N,), 10, 3), 10.0, 3.0, 0.1),
}


@pytest.mark.parametrize("name", sorted(MOMENTS))
@pytest.mark.parametrize("seed", [0, 11])
def test_distribution_moments(name, seed):
    draw, mean, std, tol = MOMENTS[name]
    x = draw(_st(seed))
    assert x.shape == (N,) and x.device.type == CPU
    _check_moments(x.numpy(), mean, std, tol)


def test_ranges_and_dtypes_match_jax():
    u = tr.uniform(_st(0), (N,), -2.0, 2.0)
    assert float(u.min()) >= -2.0 and float(u.max()) < 2.0
    i = tr.uniformInt(_st(1), (N,), 5, 15)
    assert i.dtype == torch.int32 and int(i.min()) == 5 and int(i.max()) == 14
    assert tr.normalInt(_st(2), (8,), 0, 1).dtype == torch.int32
    assert float(tr.lognormal(_st(3), (N,), 0.0, 0.25).min()) > 0
    for name, args in (("uniform", ((3, 4),)), ("normal", ((3, 4),)),
                       ("bernoulli", ((5,), 0.3)),
                       ("scaled_bernoulli", ((5,), 0.5, 2.0)),
                       ("uniformInt", ((6,), 0, 3))):
        mine = getattr(tr, name)(_st(0), *args)
        ref = getattr(jr, name)(jr.RngState(0), *args)
        assert tuple(mine.shape) == tuple(ref.shape)
        assert str(mine.dtype).replace("torch.", "") == str(ref.dtype)


def test_bernoulli_and_scaled():
    x = tr.bernoulli(_st(4), (N,), prob=0.3)
    assert x.dtype == torch.bool
    assert abs(float(x.float().mean()) - 0.3) < 0.02
    s = tr.scaled_bernoulli(_st(5), (N,), 0.5, 2.0).numpy()
    assert set(np.unique(s)) == {-2.0, 2.0}
    assert abs((s < 0).mean() - 0.5) < 0.02


def test_normal_table_discrete_fill():
    x = tr.normalTable(_st(11), N, [0.0, 10.0, -5.0], [1.0, 2.0, 0.5])
    np.testing.assert_allclose(x.numpy().mean(axis=0), [0, 10, -5], atol=0.2)
    np.testing.assert_allclose(x.numpy().std(axis=0), [1, 2, 0.5], rtol=0.1)
    w = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    d = tr.discrete(_st(12), (100, 200), w)
    assert d.shape == (100, 200) and d.dtype == torch.int32
    counts = np.bincount(d.numpy().ravel(), minlength=4) / N
    np.testing.assert_allclose(counts, w, atol=0.03)
    np.testing.assert_array_equal(tr.fill(_st(0), (7,), 3.5).numpy(),
                                  np.asarray(jr.fill(jr.RngState(0), (7,),
                                                     3.5)))


# chi-squared at p = 0.001 with 7 degrees of freedom
CHI2_7_P001 = 24.32


def _discrete_zero(pkg):
    if pkg == "jax":
        return np.asarray(jr.discrete(jr.RngState(13), (N,),
                                      np.zeros(8, np.float32)))
    return tr.discrete(_st(13), (N,), np.zeros(8, np.float32)).numpy()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_discrete_all_zero_weights_draw_uniformly(pkg):
    """Weights clamped to 1e-37: all-zero weights draw each of the 8
    categories alike (chi-squared below its p = 0.001 bound), in both
    packages."""
    d = _discrete_zero(pkg)
    assert d.shape == (N,) and d.min() >= 0 and d.max() < 8
    counts = np.bincount(d, minlength=8)
    chi2 = ((counts - N / 8) ** 2 / (N / 8)).sum()
    assert chi2 < CHI2_7_P001, (counts, chi2)


def test_discrete_takes_more_than_2_24_categories():
    n = 2 ** 24 + 3
    w = np.zeros(n, np.float32)
    w[[5, n - 1]] = [1.0, 3.0]
    d = tr.discrete(_st(14), (4000,), w).numpy()
    assert d.dtype == np.int32 and set(np.unique(d)) == {5, n - 1}
    assert abs((d == n - 1).mean() - 0.75) < 0.03


def test_state_reproducible_streams_and_types():
    a = tr.normal(_st(42), (100,))
    assert torch.equal(a, tr.normal(_st(42), (100,)))
    st = _st(42)
    first, second = tr.normal(st, (100,)), tr.normal(st, (100,))
    assert torch.equal(first, a) and not torch.equal(first, second)
    assert st.subsequence == 2
    assert torch.equal(tr.normal(st.key_at(1), (100,)), second)
    st.advance(3)
    assert st.subsequence == 5
    draws = [tr.uniform(_st(1, type=t), (64,))
             for t in (GeneratorType.GenPhilox, GeneratorType.GenPC)]
    assert not torch.equal(*draws)
    # an int seed and a torch.Generator are keys too
    assert torch.equal(tr.uniform(7, (5,), device=CPU),
                       tr.uniform(7, (5,), device=CPU))
    g = torch.Generator().manual_seed(3)
    assert tr.uniform(g, (5,)).shape == (5,)


def test_sampling_and_permutation():
    idx = sample_without_replacement(_st(0), 100, 50).numpy()
    assert len(np.unique(idx)) == 50 and idx.min() >= 0 and idx.max() < 100
    w = np.zeros(100, np.float32)
    w[:10] = 1.0
    idx = sample_without_replacement(_st(1), 100, 10, w).numpy()
    assert set(idx.tolist()) == set(range(10))
    perm = permute(_st(2), 50)
    assert perm.dtype == torch.int32
    assert sorted(perm.tolist()) == list(range(50))
    arr = torch.arange(20) * 3
    perm, shuffled = permute(_st(3), array=arr)
    assert torch.equal(arr[perm.long()], shuffled)
    arr2 = torch.arange(12).reshape(3, 4)
    perm, shuffled = permute(_st(4), array=arr2, axis=1)
    assert torch.equal(arr2[:, perm.long()], shuffled)


def test_make_blobs_labels_and_statistics():
    x, y = make_blobs(n_samples=1000, n_features=8, centers=4, seed=0,
                      device=CPU)
    xj, yj = jr.make_blobs(n_samples=1000, n_features=8, centers=4, seed=0)
    assert x.shape == xj.shape and y.shape == yj.shape
    assert y.dtype == torch.int32 and set(y.unique().tolist()) <= set(range(4))
    assert float(x.abs().max()) < 10.0 + 8.0
    centers = np.array([[0.0, 0.0], [20.0, 20.0]], np.float32)
    x, y = make_blobs(n_samples=4000, n_features=2, centers=centers,
                      cluster_std=1.0, seed=_st(1))
    for c in range(2):
        pts = x.numpy()[y.numpy() == c]
        np.testing.assert_allclose(pts.mean(axis=0), centers[c], atol=0.2)
        np.testing.assert_allclose(pts.std(axis=0), [1, 1], rtol=0.15)
    # per-cluster std, no shuffle: the labels come in draw order
    x, y = make_blobs(4000, 2, centers, [0.5, 2.0], shuffle=False,
                      seed=_st(2))
    for c, s in enumerate((0.5, 2.0)):
        np.testing.assert_allclose(x.numpy()[y.numpy() == c].std(axis=0),
                                   [s, s], rtol=0.15)


def test_make_regression_exact_recovery_and_rank():
    x, y, w = make_regression(n_samples=200, n_features=10, n_informative=5,
                              noise=0.0, coef=True, bias=1.5, seed=_st(0))
    np.testing.assert_allclose((x @ w).numpy()[:, 0] + 1.5, y.numpy(),
                               rtol=1e-4, atol=1e-3)
    assert int((w != 0).sum()) == 5 and float(w.min()) >= 0.0
    x, y = make_regression(n_samples=100, n_features=50, effective_rank=5,
                           seed=_st(0))
    s = np.linalg.svd(x.numpy(), compute_uv=False)
    assert s[6] < s[0] * 0.5
    x, y = make_regression(50, 6, n_targets=3, noise=1.0, seed=_st(1))
    assert y.shape == (50, 3)


@pytest.mark.parametrize("method", ["cholesky", "eig"])
def test_multi_variable_gaussian_covariance(method):
    cov = np.array([[2.0, 0.8], [0.8, 1.0]], np.float32)
    mu = np.array([1.0, -1.0], np.float32)
    x = multi_variable_gaussian(_st(0), 20000, mu, cov, method=method).numpy()
    np.testing.assert_allclose(x.mean(axis=0), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.1)


THETA = (0.57, 0.19, 0.19, 0.05)


def test_rmat_ranges_skew_and_quadrant_shares():
    src, dst = rmat_rectangular_gen(_st(0), list(THETA), r_scale=8,
                                    c_scale=8, n_edges=200_000)
    s, d = src.numpy(), dst.numpy()
    assert src.dtype == torch.int32
    assert s.min() >= 0 and s.max() < 256 and d.min() >= 0 and d.max() < 256
    # top level: (row bit, col bit) a = (0, 0), b = (0, 1), c = (1, 0),
    # d = (1, 1)
    q = (s >> 7) * 2 + (d >> 7)
    np.testing.assert_allclose(np.bincount(q, minlength=4) / q.size, THETA,
                               atol=0.01)
    sj, dj = jr.rmat_rectangular_gen(jr.RngState(0), list(THETA), 8, 8,
                                     200_000)
    qj = (np.asarray(sj) >> 7) * 2 + (np.asarray(dj) >> 7)
    np.testing.assert_allclose(np.bincount(q, minlength=4) / q.size,
                               np.bincount(qj, minlength=4) / qj.size,
                               atol=0.01)


def test_rmat_rectangular_and_per_level_theta():
    src, dst = rmat_rectangular_gen(_st(1), [0.25, 0.25, 0.25, 0.25],
                                    r_scale=6, c_scale=9, n_edges=5000)
    assert int(src.max()) < 64 and int(dst.max()) < 512
    assert int(dst.max()) >= 256
    # per-level theta: only quadrant d at level 0, only a below it
    theta = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (4, 1))
    theta[0] = [0.0, 0.0, 0.0, 2.0]
    pairs = tr.rmat(_st(2), theta, 4, 4, 100)
    assert pairs.shape == (100, 2)
    assert set(pairs[:, 0].tolist()) == {8} and set(pairs[:, 1].tolist()) \
        == {8}
    sj, _ = jr.rmat_rectangular_gen(jr.RngState(2), jnp.asarray(theta), 4, 4,
                                    100)
    assert set(np.asarray(sj).tolist()) == {8}

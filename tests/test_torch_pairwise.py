"""Parity of the port's pairwise distances (raft_tpu_torch.distance) with
the JAX package's: the nine elementwise cores (kernel 7's plain version
against the Pallas ``_elt_kernel`` in interpret mode), every supported
metric name through ``pairwise_distance``, the Gram matrices and the
epsilon neighbourhood.

Inputs are made with numpy from a seed; the port runs on CPU tensors
(plain versions). Tolerances, both sides float32 with another summation
order: rtol 1e-5 / atol 1e-5 for the sums and maxima of differences
(l1, l2unexp, linf, canberra, braycurtis, minkowski); rtol 1e-4 /
atol 1e-5 for the logarithm cores (jensen_shannon, kl) and the expanded
(matmul) metrics, whose cancellation reaches 1e-5 of |x|^2 + |y|^2;
hamming on integer data exactly.
"""

import numpy as np
import pytest
import torch

from raft_tpu import distance as jdist
from raft_tpu.neighbors.epsilon_neighborhood import \
    eps_neighbors_l2sq as j_eps
from raft_tpu.ops.pallas_elementwise_dist import elementwise_dist_pallas
from raft_tpu_torch import distance as tdist
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance import _elementwise_cores as cores
from raft_tpu_torch.neighbors.epsilon_neighborhood import eps_neighbors_l2sq
from raft_tpu_torch.ops import elementwise_dist as op

LOG_CORES = ("jensen_shannon", "kl")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _data(m, n, d, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return (rng.integers(0, 4, size=(m, d)).astype(np.float32),
                rng.integers(0, 4, size=(n, d)).astype(np.float32))
    x = rng.random((m, d)).astype(np.float32)
    y = rng.random((n, d)).astype(np.float32)
    x[x < 0.1] = 0.0  # zeros exercise the canberra/js/kl guards
    y[y < 0.1] = 0.0
    return x, y


@pytest.mark.parametrize("tag,sqrt", [(t, False) for t in cores.TAGS]
                         + [("l2unexp", True)])
def test_cores_match_jax_kernel(tag, sqrt):
    # d = 45: not a multiple of the TPU's 128 lanes, nor of the 32-wide
    # feature chunk of the CUDA kernel
    x, y = _data(37, 29, 45, seed=len(tag))
    want = np.asarray(elementwise_dist_pallas(x, y, tag, p=3.0, sqrt=sqrt))
    got = op.elementwise_dist(torch.from_numpy(x), torch.from_numpy(y), tag,
                              p=3.0, sqrt=sqrt).numpy()
    assert got.dtype == np.float32 and got.shape == (37, 29)
    rtol = 1e-4 if tag in LOG_CORES else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5)


def test_hamming_on_integer_data_is_exact():
    x, y = _data(20, 33, 45, seed=9, integer=True)
    want = np.asarray(elementwise_dist_pallas(x, y, "hamming"))
    got = op.elementwise_dist(torch.from_numpy(x), torch.from_numpy(y),
                              "hamming").numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_version_row_tiles(monkeypatch):
    # a budget of one row tile of 8 rows: the plain version walks 5 tiles
    x, y = _data(37, 11, 7, seed=3)
    whole = op.elementwise_dist_plain(torch.from_numpy(x),
                                      torch.from_numpy(y), "braycurtis")
    monkeypatch.setattr(op, "_TILE_BUDGET_ELEMS", 8 * 11 * 7)
    assert op._row_tile(37, 11, 7) == 8
    tiled = op.elementwise_dist_plain(torch.from_numpy(x),
                                      torch.from_numpy(y), "braycurtis")
    assert torch.equal(whole, tiled)


def _kernel_forms(metric, x, y, p=3.0):
    """The CUDA kernel's arithmetic (``csrc/elementwise_dist.cu``) spelled
    in float32 torch: kl and jensen_shannon as split logs in log2 (each
    operand's taken once, guarded as staged; jensen_shannon's log(a / m)
    as log2(a + a) - log2(a + b)) with ln 2 at the finish, minkowski as
    exp2(p log2|a - b|), canberra as num * (1 / den) with den floored at
    2^-149 and both scaled by 2^24 below 2^-126 (``__fdividef``)."""
    a, b = x[:, None, :], y[None, :, :]
    zero = torch.zeros(())
    ln2 = float(np.log(2.0))
    if metric == "kl":
        pa = torch.where(a > 0, a, zero)
        la = torch.where(a > 0, torch.log2(a), zero)
        lb = torch.where(b > 0, torch.log2(b), zero)
        return ln2 * (pa * (la - lb)).sum(-1)
    if metric == "jensen_shannon":
        ab = a + b
        lab = torch.log2(torch.where(ab > 0, ab, 2.0))
        s = (torch.where(a > 0, a, zero)
             * (torch.where(a > 0, torch.log2(a + a), zero) - lab)
             + torch.where(b > 0, b, zero)
             * (torch.where(b > 0, torch.log2(b + b), zero) - lab)).sum(-1)
        return torch.sqrt(torch.clamp(0.5 * ln2 * s, min=0.0))
    if metric == "minkowski":
        s = torch.exp2(p * torch.log2((a - b).abs())).sum(-1)
        return s ** (1.0 / p)
    if metric == "canberra":
        den = torch.clamp(a.abs() + b.abs(), min=2.0 ** -149)
        scale = torch.where(den < 2.0 ** -126, 2.0 ** 24, 1.0)
        return ((a - b).abs() * scale
                * torch.reciprocal(den * scale)).sum(-1)
    raise ValueError(metric)


@pytest.mark.parametrize("metric", ["kl", "jensen_shannon", "minkowski",
                                    "canberra"])
def test_kernel_arithmetic_matches_jax_kernel(metric):
    # the kernel's rewritten forms and guards, which only run on the card,
    # held here against the Pallas kernel (interpret mode) and the plain
    # version at the card tests' tolerances, on data with zeros, negative
    # values and rows of x repeated in y
    rng = np.random.default_rng(11)
    x = (1.5 * rng.random((23, 37)) - 0.5).astype(np.float32)
    y = (1.5 * rng.random((19, 37)) - 0.5).astype(np.float32)
    x[np.abs(x) < 0.1] = 0.0
    y[np.abs(y) < 0.1] = 0.0
    y[3], y[11] = x[5], x[0]
    got = _kernel_forms(metric, torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    want = np.asarray(elementwise_dist_pallas(x, y, metric, p=3.0))
    plain = op.elementwise_dist_plain(torch.from_numpy(x),
                                      torch.from_numpy(y), metric, p=3.0)
    rtol = 1e-4 if metric in LOG_CORES else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=rtol,
                               atol=1e-5)
    # equal rows: every form, like the plain version, gives exactly 0
    for i, j in ((5, 3), (0, 11)):
        assert float(got[i, j]) == 0.0 and float(plain[i, j]) == 0.0


@pytest.mark.parametrize("metric", tdist.SUPPORTED_DISTANCES)
def test_pairwise_distance_matches_jax(metric):
    d = 2 if metric == "haversine" else 21
    x, y = _data(19, 23, d, seed=len(metric))
    if metric == "haversine":
        x, y = x - 0.5, y - 0.5  # radians around 0
    want = np.asarray(jdist.pairwise_distance(x, y, metric=metric, p=3.0))
    got = tdist.pairwise_distance(x, y, metric=metric, p=3.0,
                                  device="cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_distance_takes_a_distance_type_and_checks_shapes():
    x, y = _data(5, 6, 4, seed=1)
    got = tdist.distance(x, y, tdist.DistanceType.L1, device="cpu")
    want = np.abs(x[:, None, :] - y[None]).sum(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    with pytest.raises(LogicError):
        tdist.distance(x, y[:, :3], tdist.DistanceType.L1, device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        tdist.pairwise_distance(x, y, metric="nope", device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    x, y = _data(3, 3, 2, seed=0)
    with pytest.raises(LogicError, match="CUDA"):
        tdist.pairwise_distance(x, y)


@pytest.mark.parametrize("kernel", list(tdist.KernelType))
def test_gram_matrix_matches_jax(kernel):
    x, y = _data(13, 17, 9, seed=int(kernel))
    params = dict(kernel=int(kernel), degree=2, gamma=0.5, coef0=0.25)
    want = np.asarray(jdist.gram_matrix(
        x, y, jdist.KernelParams(kernel=jdist.KernelType(int(kernel)),
                                 degree=2, gamma=0.5, coef0=0.25)))
    got = tdist.gram_matrix(x, y, tdist.KernelParams(
        **{**params, "kernel": tdist.KernelType(int(kernel))}),
        device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_eps_neighbors_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    adj_j, deg_j = j_eps(x, x, 1.5)
    adj, deg = eps_neighbors_l2sq(x, x, 1.5, device="cpu")
    np.testing.assert_array_equal(adj.numpy(), np.asarray(adj_j))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(deg_j))
    assert deg.dtype == torch.int32


def test_cpu_tensor_takes_plain_version_without_launch():
    x, y = _data(6, 5, 4, seed=2)
    before = op.launches
    op.elementwise_dist(torch.from_numpy(x), torch.from_numpy(y), "l1")
    assert op.launches == before


def test_cuda_entry_refuses_cpu_tensors():
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        op.elementwise_dist_cuda(x, x, "l1")
    with pytest.raises(ValueError, match="unknown metric"):
        op.elementwise_dist(x, x, "cosine")

"""Parity of the port's spectral partitioning, modularity maximization
and linear assignment (``raft_tpu_torch.{spectral,solver}``) with the
JAX package's (``tests/test_spectral_solver.py``), on the CPU, from the
same numpy inputs.

Tolerances: on the planted-partition graphs of
``tests/test_spectral_solver.py`` (two and three dense communities),
eigenvalues within 1e-3 of the JAX package's (the two Lanczos runs
start from other random vectors) and an adjusted Rand index of 1.0
between the two packages' labels; the edge cut, cost and modularity of
one labeling within rtol 1e-5. The auction: the same assignment and
objective as the JAX package at n = 64 on integer costs (and at the
sizes of the JAX tests), the objective equal to scipy's optimum on
those costs.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax.numpy as jnp
import raft_tpu.sparse as jsp
import raft_tpu_torch.sparse as tsp
from raft_tpu import solver as jsolver
from raft_tpu import spectral as jspec
from raft_tpu_torch import solver as tsolver
from raft_tpu_torch import spectral as tspec
from raft_tpu_torch.stats import adjusted_rand_index

EIG_TOL = 1e-3


def _planted(seed, n_comm=2, n_per=12, p_in=0.9, p_out=0.05):
    """Planted-partition graph (``_two_cliques`` of
    ``tests/test_spectral_solver.py`` for two communities), chained so it
    is connected."""
    rng = np.random.default_rng(seed)
    n = n_comm * n_per
    truth = np.repeat(np.arange(n_comm), n_per)
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(i + 1, n):
            p = p_in if truth[i] == truth[j] else p_out
            if rng.random() < p:
                a[i, j] = a[j, i] = 1.0
    for c in range(n_comm - 1):
        e = (c + 1) * n_per
        a[e - 1, e] = a[e, e - 1] = 1.0
    return a, truth


def _graphs(a):
    j = jsp.dense_to_csr(a)
    t = tsp.CSR.from_numpy(np.asarray(j.indptr), np.asarray(j.indices),
                           np.asarray(j.data), a.shape, device="cpu")
    return j, t


GRAPHS = [(0, 2), (1, 2), (5, 2), (2, 3)]


def _ari(a, b):
    return float(adjusted_rand_index(torch.from_numpy(np.array(a)).long(),
                                     torch.from_numpy(np.array(b)).long()))


@pytest.mark.parametrize("seed,n_comm", GRAPHS)
@pytest.mark.parametrize("method", ["partition", "modularity_maximization"])
def test_spectral_matches_jax(seed, n_comm, method):
    a, truth = _planted(seed, n_comm)
    jg, tg = _graphs(a)
    lt, et, vt = getattr(tspec, method)(tg, n_comm)
    lj, ej, vj = getattr(jspec, method)(jg, n_comm)
    assert vt.shape == (a.shape[0], n_comm) and lt.dtype == torch.int32
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=EIG_TOL)
    assert _ari(lt.numpy(), lj) == 1.0
    assert _ari(lt.numpy(), truth) > 0.6
    if method == "partition":
        assert abs(float(et[0])) < EIG_TOL
        assert bool((et[1:] >= et[:-1]).all())


@pytest.mark.parametrize("seed,n_comm", GRAPHS)
def test_partition_quality_matches_jax(seed, n_comm):
    a, truth = _planted(seed, n_comm)
    jg, tg = _graphs(a)
    rand = np.random.default_rng(seed).integers(0, n_comm, len(truth))
    for lab in (truth, rand):
        cut, cost = tspec.analyze_partition(tg, torch.from_numpy(lab),
                                            n_comm)
        cut_j, cost_j = jspec.analyze_partition(jg, jnp.asarray(lab), n_comm)
        np.testing.assert_allclose(float(cut), float(cut_j), rtol=1e-5)
        np.testing.assert_allclose(float(cost), float(cost_j), rtol=1e-5)
        q = tspec.analyze_modularity(tg, torch.from_numpy(lab), n_comm)
        np.testing.assert_allclose(
            float(q), float(jspec.analyze_modularity(jg, jnp.asarray(lab),
                                                     n_comm)),
            rtol=1e-5, atol=1e-7)
    cross = sum(a[i, j] for i in range(len(truth))
                for j in range(i + 1, len(truth)) if truth[i] != truth[j])
    cut, _ = tspec.analyze_partition(tg, torch.from_numpy(truth), n_comm)
    assert float(cut) == pytest.approx(float(cross), rel=1e-5)


def _int_costs(n, seed):
    return np.random.default_rng(seed).integers(0, 1000, (n, n)).astype(
        np.float32)


@pytest.mark.parametrize("n,seed,maximize", [(64, 0, False), (64, 1, False),
                                             (64, 2, True), (4, 3, False),
                                             (16, 4, False), (48, 5, True)])
def test_auction_matches_jax(n, seed, maximize):
    cost = _int_costs(n, seed)
    rt, ct, ot = tsolver.linear_assignment(torch.from_numpy(cost), maximize)
    rj, cj, oj = jsolver.linear_assignment(cost, maximize)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert float(ot) == float(oj)
    ri, ci = linear_sum_assignment(cost, maximize=maximize)
    assert float(ot) == pytest.approx(float(cost[ri, ci].sum()), abs=1e-3)
    assert sorted(rt.tolist()) == list(range(n))
    np.testing.assert_array_equal(ct.numpy()[rt.numpy()], np.arange(n))


def test_auction_on_real_costs_near_optimum():
    cost = np.random.default_rng(6).random((48, 48)).astype(np.float32)
    _, _, obj = tsolver.linear_assignment(torch.from_numpy(cost))
    ri, ci = linear_sum_assignment(cost)
    np.testing.assert_allclose(float(obj), cost[ri, ci].sum(), rtol=1e-3,
                               atol=1e-3)


def test_class_api_and_rounds():
    n = 8
    cost = _int_costs(n, 7)
    lap = tsolver.LinearAssignmentProblem(n)
    obj = lap.solve(torch.from_numpy(cost))
    assert float(obj) == float(lap.get_primal_objective_value())
    ra = lap.get_row_assignment_vector().numpy()
    assert sorted(ra.tolist()) == list(range(n))
    np.testing.assert_array_equal(
        lap.get_col_assignment_vector().numpy()[ra], np.arange(n))
    assert 1 <= len(lap.rounds_per_phase) <= 6
    assert all(r >= 1 for r in lap.rounds_per_phase)
    ref = jsolver.LinearAssignmentProblem(n)
    assert float(ref.solve(cost)) == float(obj)

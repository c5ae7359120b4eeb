"""Parity of the port's matrix utilities, moments, regression metrics and
label utilities (``raft_tpu_torch.{matrix,stats,label}``) with the JAX
package's (``tests/test_matrix_stats_label.py``; the clustering metrics
are in ``tests/test_torch_cluster.py``), on the CPU, from the same numpy
inputs.

Tolerances: exact for gathers, sorts, argmax/argmin, diagonals, slices,
shifts, histograms, labels, ``make_monotonic`` and ``merge_labels``;
rtol 1e-5 (atol 1e-6) for the elementwise helpers, moments, covariance,
weighted means and regression metrics.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu import label as jlab
from raft_tpu import matrix as jm
from raft_tpu import stats as js
from raft_tpu_torch import label as tlab
from raft_tpu_torch import matrix as tm
from raft_tpu_torch import stats as ts
from raft_tpu_torch.core.resources import Resources

RTOL, ATOL = 1e-5, 1e-6

JAX = types.SimpleNamespace(M=jm, S=js, arr=jnp.asarray, res=None)
TORCH = types.SimpleNamespace(M=tm, S=ts, arr=lambda a: torch.from_numpy(
    np.array(a)), res=Resources("cpu"))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.random(s, dtype=np.float32)  # noqa: E731
    x = f(10, 4)
    x[3, 1] = 0.0
    x[5, 2] = -1e-16
    return dict(x=x, s=f(6, 6) - 0.5, p=f(5, 5) + 0.5, w4=f(4), w10=f(10),
                idx=np.array([3, 1, 7, 3], np.int32),
                st=np.array([1.0, 0.0, 1.0, 0.0], np.float32),
                v=np.arange(6, dtype=np.float32) - 2.0,
                ties=rng.integers(0, 3, (12, 5)).astype(np.float32),
                big=f(200, 6), vec=f(4) + 0.5,
                yc=rng.integers(0, 3, 100).astype(np.int32),
                yr=f(100), yp=f(100), odd=f(51))


# name -> (f(ns, d), exact)
CASES = {
    "gather": (lambda ns, d: ns.M.gather(d["x"], d["idx"]), True),
    "gather_transform": (lambda ns, d: ns.M.gather(
        d["x"], d["idx"], lambda i: 9 - i), True),
    "gather_if": (lambda ns, d: ns.M.gather_if(
        d["x"], d["idx"], d["st"], lambda s: s > 0.5), True),
    "col_wise_sort": (lambda ns, d: ns.M.col_wise_sort(d["ties"]), True),
    "col_wise_sort_values": (lambda ns, d: ns.M.col_wise_sort(
        d["ties"], return_index=False)[0], True),
    "argsort_cols": (lambda ns, d: ns.M.argsort_cols(d["ties"]), True),
    "copy": (lambda ns, d: ns.M.copy(d["x"]), True),
    "copy_upper_triangular": (lambda ns, d: ns.M.copy_upper_triangular(
        d["s"]), True),
    "matrix_init": (lambda ns, d: ns.M.matrix_init(3, 4, 2.5, res=ns.res),
                    True),
    "power": (lambda ns, d: ns.M.power(d["p"], 2.0), False),
    "ratio": (lambda ns, d: ns.M.ratio(d["p"]), False),
    "reciprocal": (lambda ns, d: ns.M.reciprocal(d["x"], 2.0), False),
    "reciprocal_setzero": (lambda ns, d: ns.M.reciprocal(
        d["x"], 1.0, True, 1e-15), False),
    "sqrt": (lambda ns, d: ns.M.sqrt(d["p"]), False),
    "sign_flip": (lambda ns, d: ns.M.sign_flip(d["s"]), True),
    "zero_small_values": (lambda ns, d: ns.M.zero_small_values(
        d["x"], 0.1), True),
    "line_power": (lambda ns, d: ns.M.line_power(d["p"][:, :4], d["vec"]),
                   False),
    "seq_root": (lambda ns, d: ns.M.seq_root(d["s"], 2.0), False),
    "sigmoid": (lambda ns, d: ns.M.sigmoid(d["s"]), False),
    "set_diagonal": (lambda ns, d: ns.M.set_diagonal(d["s"], d["v"]), True),
    "set_diagonal_wide": (lambda ns, d: ns.M.set_diagonal(
        d["x"].T, d["v"]), True),
    "get_diagonal": (lambda ns, d: ns.M.get_diagonal(d["s"]), True),
    "invert_diagonal": (lambda ns, d: ns.M.invert_diagonal(
        ns.M.set_diagonal(d["s"], d["v"])), False),
    "slice_matrix": (lambda ns, d: ns.M.slice_matrix(d["x"], 1, 2, 4, 4),
                     True),
    "col_right_shift": (lambda ns, d: ns.M.col_right_shift(d["x"], 3), True),
    "argmax_rows": (lambda ns, d: ns.M.argmax(d["ties"]), True),
    "argmax_cols": (lambda ns, d: ns.M.argmax(d["ties"], False), True),
    "argmin_rows": (lambda ns, d: ns.M.argmin(d["ties"]), True),
    "argmin_cols": (lambda ns, d: ns.M.argmin(d["ties"], along_rows=False),
                    True),
    "matrix_max_min": (lambda ns, d: (ns.M.matrix_max(d["s"]),
                                      ns.M.matrix_min(d["s"])), True),
    "mean": (lambda ns, d: ns.S.mean(d["big"]), False),
    "mean_rows": (lambda ns, d: ns.S.mean(d["big"], True), False),
    "sum_": (lambda ns, d: (ns.S.sum_(d["big"]), ns.S.sum_(d["big"], True)),
             False),
    "meanvar": (lambda ns, d: ns.S.meanvar(d["big"]), False),
    "meanvar_population": (lambda ns, d: ns.S.meanvar(d["big"], False),
                           False),
    "vars_mu": (lambda ns, d: ns.S.vars_(d["big"], ns.S.mean(d["big"]),
                                         False), False),
    "stddev": (lambda ns, d: ns.S.stddev(d["big"]), False),
    "mean_center": (lambda ns, d: ns.S.mean_center(d["big"]), False),
    "mean_center_rows": (lambda ns, d: ns.S.mean_center(
        d["x"], along_rows=True), False),
    "mean_add": (lambda ns, d: ns.S.mean_add(d["x"], d["w4"]), False),
    "cov": (lambda ns, d: ns.S.cov(d["big"]), False),
    "cov_unstable_population": (lambda ns, d: ns.S.cov(
        d["big"], sample=False, stable=False), False),
    "minmax": (lambda ns, d: ns.S.minmax(d["big"]), True),
    "row_weighted_mean": (lambda ns, d: ns.S.row_weighted_mean(
        d["x"], d["w4"]), False),
    "col_weighted_mean": (lambda ns, d: ns.S.col_weighted_mean(
        d["x"], d["w10"]), False),
    "dispersion": (lambda ns, d: ns.S.dispersion(d["x"], d["w10"] + 1.0),
                   False),
    "histogram_range": (lambda ns, d: ns.S.histogram(d["big"], 10, 0.0, 1.0),
                        True),
    "histogram_auto": (lambda ns, d: ns.S.histogram(d["big"], 7), True),
    "histogram_edges": (lambda ns, d: ns.S.histogram(
        ns.arr(np.repeat(np.arange(0, 1.01, 0.125, dtype=np.float32), 3)),
        8), True),
    "histogram_constant": (lambda ns, d: ns.S.histogram(
        ns.arr(np.full((9, 2), 3.0, np.float32)), 4), True),
    "accuracy": (lambda ns, d: ns.S.accuracy(d["yc"], d["yc"] * (
        d["yr"] > 0.1)), False),
    "r2_score": (lambda ns, d: ns.S.r2_score(d["yr"], d["yr"] + 0.1 * d[
        "yp"]), False),
    "mean_squared_error": (lambda ns, d: ns.S.mean_squared_error(
        d["yr"], d["yp"]), False),
    "regression_metrics": (lambda ns, d: ns.S.regression_metrics(
        d["yr"], d["yp"]), False),
    "regression_metrics_odd": (lambda ns, d: ns.S.regression_metrics(
        d["odd"], d["odd"] ** 2), False),
}


def _check(port, ref, exact):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        port, ref = [port[k] for k in sorted(port)], [ref[k]
                                                     for k in sorted(ref)]
    if isinstance(ref, (tuple, list)):
        for p, r in zip(port, ref):
            _check(p, r, exact)
        return
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    if exact:
        np.testing.assert_array_equal(p, r)
    else:
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matrix_and_stats_match_jax(case):
    fn, exact = CASES[case]
    d = _data()
    ref = fn(JAX, {k: JAX.arr(v) for k, v in d.items()})
    port = fn(TORCH, {k: TORCH.arr(v) for k, v in d.items()})
    _check(port, ref, exact)


def test_print_matrix_text(capsys):
    x = np.array([[1.5, -2.0], [0.25, 3.0]], np.float32)
    assert tm.print_matrix(torch.from_numpy(x), "m", ",") == \
        jm.print_matrix(x, "m", ",")


LABELS = {
    "sparse": np.array([10, 5, 10, 42, 5], np.int32),
    "negative": np.array([-3, 7, 7, -3, 0, 100], np.int32),
    "random": np.random.default_rng(2).integers(0, 50, 300).astype(np.int32),
}


@pytest.mark.parametrize("name", sorted(LABELS))
def test_unique_and_monotonic_match_jax(name):
    lab = LABELS[name]
    t = torch.from_numpy(lab)
    np.testing.assert_array_equal(tlab.get_unique_labels(t).numpy(),
                                  np.asarray(jlab.get_unique_labels(lab)))
    (mt, ct), (mj, cj) = tlab.make_monotonic(t), jlab.make_monotonic(lab)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    classes = np.unique(lab)[::2].copy()
    np.testing.assert_array_equal(
        tlab.make_monotonic(t, torch.from_numpy(classes))[0].numpy(),
        np.asarray(jlab.make_monotonic(lab, classes)[0]))


def _merge_case(seed, n, n_classes, p_mask):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_classes, n).astype(np.int32),
            rng.integers(0, n_classes, n).astype(np.int32),
            rng.random(n) < p_mask, n_classes)


@pytest.mark.parametrize("case", [
    (np.array([0, 0, 1, 1], np.int32), np.array([0, 1, 1, 2], np.int32),
     np.array([True] * 4), 4),
    (np.array([0, 1, 2, 3, 4], np.int32), np.array([1, 2, 3, 4, 0],
                                                   np.int32),
     np.array([True, False, True, True, False]), 5),
    _merge_case(3, 200, 40, 0.3), _merge_case(4, 500, 120, 0.8),
], ids=["bridge", "partial_mask", "random_sparse", "random_dense"])
def test_merge_labels_matches_jax(case):
    a, b, mask, n_classes = case
    port = tlab.merge_labels(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(mask), n_classes)
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(jlab.merge_labels(a, b, mask, n_classes)))

"""Parity of the port's dense linear algebra (``raft_tpu_torch.linalg``)
with the JAX package's (``tests/test_linalg.py``), on the CPU, from the
same numpy inputs.

Tolerances: BLAS, elementwise ops, reductions and norms within rtol
1e-5 (atol 1e-6); integer by-key sums exact. Factorisations within 1e-4,
compared where the factors are not unique through what is: QR by Q R
and QᵀQ, eigendecompositions by the eigenvalues and V diag(w) Vᵀ, SVDs
by the singular values and U diag(S) Vᵀ, least squares by the solution,
the Cholesky update by its factor; ``eig_jacobi`` against the JAX
package's Jacobi at the same ``tol`` and ``sweeps``. ``rsvd`` draws its
sketch from another generator than the JAX package's, so it is held to
its property: the spectrum and the matrix of an exact low-rank input,
within 1e-4 of float64 numpy.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu import linalg as jl
from raft_tpu_torch import linalg as tl
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.linalg import Apply, NormType

RTOL, ATOL = 1e-5, 1e-6
FACT = 1e-4

# each package's module, array type, callables and handle (data made
# from nothing: the port's on the CPU only when asked)
JAX = types.SimpleNamespace(L=jl, arr=jnp.asarray, add=jnp.add,
                            mul=jnp.multiply, sqrt=jnp.sqrt, max=jnp.maximum,
                            res=None)
TORCH = types.SimpleNamespace(L=tl, arr=lambda a: torch.from_numpy(
    np.array(a)), add=torch.add, mul=torch.mul, sqrt=torch.sqrt,
    max=torch.maximum, res=Resources("cpu"))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    if isinstance(ref, (tuple, list)):
        for p, r in zip(port, ref):
            _close(p, r, rtol, atol)
        return
    np.testing.assert_allclose(_np(port), _np(ref), rtol=rtol, atol=atol)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.random(s, dtype=np.float32) - 0.5  # noqa: E731
    return dict(a=f(24, 16), b=f(16, 12), c=np.ones((16, 16), np.float32),
                sq=f(16, 16), x=f(16), y=f(24), m=f(6, 4) + 1.5,
                n=f(6, 4) + 1.5, p=f(6, 4) + 1.5, vr=f(4), vc=f(6),
                keys_r=rng.integers(0, 3, 24).astype(np.int32),
                keys_c=rng.integers(0, 5, 16).astype(np.int32),
                w=f(24) + 1.0, ints=rng.integers(-50, 50, (24, 16)).astype(
                    np.int32), v=f(100),
                ar=np.arange(12, dtype=np.float32).reshape(4, 3),
                ar_i=np.arange(12, dtype=np.int32).reshape(4, 3),
                keys_big=np.array([0, 1, 5, 1], np.int32),
                keys_neg=np.array([0, -1, 2, 1], np.int32))


# name -> f(ns, d): the call on one package (ns) with inputs d
CASES = {
    "gemm": lambda ns, d: ns.L.gemm(d["a"], d["b"]),
    "gemm_alpha_beta_trans": lambda ns, d: ns.L.gemm(
        d["a"], d["a"], alpha=2.0, beta=3.0, c=d["c"], trans_a=True),
    "gemm_trans_b": lambda ns, d: ns.L.gemm(d["a"], d["sq"], trans_b=True),
    "gemv": lambda ns, d: ns.L.gemv(d["a"], d["x"], 0.5, 2.0, d["y"]),
    "gemv_trans": lambda ns, d: ns.L.gemv(d["a"], d["y"], trans=True),
    "axpy": lambda ns, d: ns.L.axpy(2.0, d["y"], d["y"]),
    "dot": lambda ns, d: ns.L.dot(d["x"], d["x"]),
    "transpose": lambda ns, d: ns.L.transpose(d["a"]),
    "add": lambda ns, d: ns.L.add(d["m"], d["n"]),
    "subtract": lambda ns, d: ns.L.subtract(d["m"], d["n"]),
    "multiply": lambda ns, d: ns.L.multiply(d["m"], d["n"]),
    "divide": lambda ns, d: ns.L.divide(d["m"], d["n"]),
    "power": lambda ns, d: ns.L.power(d["m"], d["n"]),
    "sqrt": lambda ns, d: ns.L.sqrt(d["m"]),
    "eltwise_add": lambda ns, d: ns.L.eltwise_add(d["m"], d["n"], d["p"]),
    "unary_op": lambda ns, d: ns.L.unary_op(d["m"], lambda v: v * 2),
    "binary_op": lambda ns, d: ns.L.binary_op(d["m"], d["n"],
                                              lambda a, b: a * b + 1),
    "ternary_op": lambda ns, d: ns.L.ternary_op(
        d["m"], d["n"], d["p"], lambda a, b, c: a * b - c),
    "map_": lambda ns, d: ns.L.map_(lambda a, b: a - 2 * b, d["m"], d["n"]),
    "map_reduce_add": lambda ns, d: ns.L.map_reduce(
        lambda v: v * v, ns.add, 0.0, d["v"]),
    "map_reduce_max": lambda ns, d: ns.L.map_reduce(
        lambda a, b: a * b, ns.max, -1.0, d["m"], d["n"]),
    "mean_squared_error": lambda ns, d: ns.L.mean_squared_error(
        d["m"], d["n"], 0.5),
    "init_arange": lambda ns, d: ns.L.init_arange(5, 2, 3, res=ns.res),
    "mvop_rows": lambda ns, d: ns.L.matrix_vector_op(
        d["m"], d["vr"], ns.add, Apply.ALONG_ROWS),
    "mvop_cols": lambda ns, d: ns.L.matrix_vector_op(
        d["m"], d["vc"], ns.mul, Apply.ALONG_COLUMNS),
    "mvop_bool": lambda ns, d: ns.L.matrix_vector_op(
        d["m"], d["vc"], bcast_along_rows=False),
    "linewise_rows": lambda ns, d: ns.L.linewise_op(
        d["m"], lambda a, u, v: a * u + v, True, d["vr"], d["vr"]),
    "linewise_cols": lambda ns, d: ns.L.linewise_op(
        d["m"], lambda a, u: a - u, False, d["vc"]),
    "reduce_lambdas": lambda ns, d: ns.L.reduce(
        d["a"], True, lambda v: v * v, final_op=ns.sqrt),
    "strided_max": lambda ns, d: ns.L.strided_reduction(d["a"],
                                                        reduce_op="max"),
    "coalesced_min_init": lambda ns, d: ns.L.coalesced_reduction(
        d["a"], reduce_op="min", init=-0.3),
    "reduce_add_init": lambda ns, d: ns.L.reduce(d["a"], False, init=1.5),
    "normalize_rows": lambda ns, d: ns.L.normalize_rows(d["a"]),
    "rows_by_key": lambda ns, d: ns.L.reduce_rows_by_key(
        d["a"], d["keys_r"], 3),
    "rows_by_key_weighted": lambda ns, d: ns.L.reduce_rows_by_key(
        d["a"], d["keys_r"], weights=d["w"]),
    "rows_by_key_int": lambda ns, d: ns.L.reduce_rows_by_key(
        d["ints"], d["keys_r"], 4),
    "cols_by_key": lambda ns, d: ns.L.reduce_cols_by_key(
        d["a"], d["keys_c"], 5),
    "cols_by_key_int": lambda ns, d: ns.L.reduce_cols_by_key(
        d["ints"], d["keys_c"]),
    # keys outside [0, n_keys): the JAX package's segment_sum drops the
    # row (float route: segment_sum, int route: index_add_)
    "rows_by_key_out_of_range": lambda ns, d: ns.L.reduce_rows_by_key(
        d["ar"], d["keys_big"], 3),
    "rows_by_key_negative": lambda ns, d: ns.L.reduce_rows_by_key(
        d["ar"], d["keys_neg"], 3),
    "rows_by_key_out_of_range_int": lambda ns, d: ns.L.reduce_rows_by_key(
        d["ar_i"], d["keys_big"], 3),
    "rows_by_key_negative_int": lambda ns, d: ns.L.reduce_rows_by_key(
        d["ar_i"], d["keys_neg"], 3),
    "cols_by_key_out_of_range": lambda ns, d: ns.L.reduce_cols_by_key(
        d["ar"].T, d["keys_big"], 3),
    "cols_by_key_negative_int": lambda ns, d: ns.L.reduce_cols_by_key(
        d["ar_i"].T, d["keys_neg"], 3),
}


def _both(case):
    d = _data()
    ref = CASES[case](JAX, {k: JAX.arr(v) for k, v in d.items()})
    port = CASES[case](TORCH, {k: TORCH.arr(v) for k, v in d.items()})
    return port, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_elementwise_blas_reduce_match_jax(case):
    port, ref = _both(case)
    if case.endswith("_int"):
        np.testing.assert_array_equal(_np(port), _np(ref))
    else:
        _close(port, ref)


@pytest.mark.parametrize("norm_type", list(NormType))
@pytest.mark.parametrize("along_rows", [True, False])
@pytest.mark.parametrize("sqrt", [False, True])
def test_norms_match_jax(norm_type, along_rows, sqrt):
    a = _data()["a"]
    ref = jl.norm(a, jl.NormType(int(norm_type)), along_rows, sqrt)
    _close(tl.norm(torch.from_numpy(a), norm_type, along_rows, sqrt), ref)
    fn = "row_norm" if along_rows else "col_norm"
    _close(getattr(tl, fn)(torch.from_numpy(a), norm_type, sqrt), ref)


def _sym(n, seed=1):
    a = np.random.default_rng(seed).random((n, n), dtype=np.float32)
    return (a + a.T) / 2


def _vwvt(w, v):
    v, w = _np(v).astype(np.float64), _np(w).astype(np.float64)
    return (v * w) @ v.T


def test_qr_matches_jax():
    a = _data()["a"]
    q, r = tl.qr_get_qr(torch.from_numpy(a))
    qj, rj = jl.qr_get_qr(a)
    _close(q @ r, np.asarray(qj) @ np.asarray(rj), FACT, FACT)
    _close(q.T @ q, np.eye(16), FACT, FACT)
    _close(tl.qr_get_q(torch.from_numpy(a)).abs(), np.abs(np.asarray(qj)),
           FACT, FACT)


@pytest.mark.parametrize("which", ["dc", "largest", "smallest"])
def test_eig_dc_matches_jax(which):
    a = _sym(12)
    t = torch.from_numpy(a)
    if which == "dc":
        (w, v), (wj, vj) = tl.eig_dc(t), jl.eig_dc(a)
    else:
        big = which == "largest"
        w, v = tl.eig_dc_selective(t, 3, largest=big)
        wj, vj = jl.eig_dc_selective(a, 3, largest=big)
    _close(w, wj, FACT, FACT)
    _close(_vwvt(w, v), _vwvt(wj, vj), FACT, FACT)


@pytest.mark.parametrize("n,tol,sweeps", [(8, 1e-6, 30), (12, 1e-7, 15),
                                          (5, 1e-3, 2)])
def test_eig_jacobi_matches_jax(n, tol, sweeps):
    a = _sym(n, n)
    w, v = tl.eig_jacobi(torch.from_numpy(a), tol=tol, sweeps=sweeps)
    wj, vj = jl.eig_jacobi(a, tol=tol, sweeps=sweeps)
    _close(w, wj, FACT, FACT)
    _close(_vwvt(w, v), _vwvt(wj, vj), FACT, FACT)
    _close(v.T @ v, np.eye(n), FACT, FACT)


@pytest.mark.parametrize("fn", ["svd_qr", "svd_eig", "svd_jacobi"])
def test_svd_matches_jax(fn):
    a = _data()["a"]
    u, s, v = getattr(tl, fn)(torch.from_numpy(a))
    uj, sj, vj = getattr(jl, fn)(a)
    _close(s, sj, FACT, FACT)
    _close(tl.svd_reconstruction(u, s, v), jl.svd_reconstruction(uj, sj, vj),
           FACT, FACT)


def test_svd_qr_without_factors():
    u, s, v = tl.svd_qr(torch.from_numpy(_data()["a"]), False, False)
    assert u is None and v is None and s.shape == (16,)


def test_rsvd_recovers_low_rank():
    rng = np.random.default_rng(3)
    a = (rng.random((50, 5)) @ rng.random((5, 30))).astype(np.float32)
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:5]
    for seed in (0, 7):
        u, s, v = tl.rsvd(torch.from_numpy(a), k=5, p=5, n_iter=3, seed=seed)
        assert u.shape == (50, 5) and v.shape == (30, 5)
        _close(s, s_ref, FACT, 0.0)
        _close(tl.svd_reconstruction(u, s, v), a, FACT, FACT * abs(a).max())


@pytest.mark.parametrize("solver", ["lstsq_svd_qr", "lstsq_svd_jacobi",
                                    "lstsq_eig", "lstsq_qr"])
def test_lstsq_matches_jax(solver):
    rng = np.random.default_rng(4)
    a = rng.random((40, 8), dtype=np.float32)
    b = a @ rng.random(8, dtype=np.float32) + 0.01 * rng.random(
        40, dtype=np.float32)
    port = getattr(tl, solver)(torch.from_numpy(a), torch.from_numpy(b))
    _close(port, getattr(jl, solver)(a, b), FACT, FACT)


def test_cholesky_r1_update_matches_jax():
    n = 6
    a = np.random.default_rng(5).random((n, n), dtype=np.float32)
    a = a @ a.T + n * np.eye(n, dtype=np.float32)
    lt = torch.zeros((0, 0))
    lj = jnp.zeros((0, 0), jnp.float32)
    for i in range(n):
        lt = tl.cholesky_r1_update(lt, torch.from_numpy(a[: i + 1, i]))
        lj = jl.cholesky_r1_update(lj, jnp.asarray(a[: i + 1, i]))
        _close(lt, lj, FACT, FACT)
    _close(lt @ lt.T, a, FACT, FACT * n)


def test_mdarray_views_and_factories_match_jax():
    from raft_tpu.core import mdarray as jmd
    from raft_tpu_torch.core import mdarray as tmd
    a = _data()["a"]
    # host values narrow to 32 bits as in the JAX package; tensors stay
    for host in (a.astype(np.float64), a.tolist()):
        t = tmd.as_array(host, "cpu")
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(jmd.as_array(
            host)))
    assert tmd.as_array(np.arange(3), "cpu").dtype == torch.int32
    x = torch.from_numpy(a)
    assert tmd.as_array(x) is x
    col = tmd.device_matrix_view(x, tmd.COL_MAJOR, torch.float32)
    jcol = jmd.device_matrix_view(a, jmd.COL_MAJOR)
    assert col.shape == tuple(jcol.shape) and col.extent(1) == 16
    np.testing.assert_array_equal(tmd.as_array(col).numpy(),
                                  np.asarray(jmd.as_array(jcol)))
    np.testing.assert_array_equal(tmd.flatten(col).numpy(),
                                  np.asarray(jmd.flatten(jcol)))
    np.testing.assert_array_equal(tmd.reshape(x, (16, 24)).numpy(),
                                  np.asarray(jmd.reshape(a, (16, 24))))
    with pytest.raises(Exception, match="rank-1"):
        tmd.device_vector_view(x)
    with pytest.raises(Exception, match="dtype"):
        tmd.device_matrix_view(x, dtype=torch.int32)
    cpu = Resources("cpu")
    m = tmd.make_device_matrix(cpu, 3, 5, layout=tmd.COL_MAJOR)
    assert m.shape == (5, 3) and m.device.type == "cpu" and not m.any()
    assert tmd.make_device_vector(cpu, 4, torch.int32).dtype == torch.int32
    assert tmd.input_device(None, [1.0], x) == x.device

"""The port's public signatures against the JAX package's.

For every module of ``raft_tpu_torch`` whose path also exists in
``raft_tpu`` (private modules aside), each public function and dataclass
defined in both must take every parameter (or field) of the JAX one,
with the same default, kind and relative order, so a caller written for
``raft_tpu`` never gets a ``TypeError``. A parameter the port adds must
be on :data:`ALLOWED_EXTRA`. Values the port does not implement raise
``NotImplementedError`` naming their ROADMAP.md item; values it
implements are honoured (the second half of this file).
"""

import dataclasses
import enum
import importlib
import inspect
import pathlib
import time

import numpy as np
import pytest
import torch

import raft_tpu_torch

PORT_ROOT = pathlib.Path(raft_tpu_torch.__file__).resolve().parent
REF_ROOT = PORT_ROOT.parent / "raft_tpu"

# parameters the port adds, and why: each names the torch device an
# entry point builds or loads on (the JAX package places arrays on its
# default device; the port runs on ``cuda`` unless the caller asks for
# the CPU, as the tests do)
_DEVICE = "the torch device to build, load or compute on"
ALLOWED_EXTRA = {
    ("core.resources", "ensure_resources", "device"):
        "the device of a fresh handle when res is None",
    ("distance.kernels", "gram_matrix", "device"): _DEVICE,
    ("distance.pairwise", "distance", "device"): _DEVICE,
    ("distance.pairwise", "pairwise_distance", "device"): _DEVICE,
    ("neighbors.ball_cover", "build", "device"): _DEVICE,
    ("neighbors.brute_force", "brute_force_knn", "device"): _DEVICE,
    ("neighbors.brute_force", "fused_l2_knn", "device"): _DEVICE,
    ("neighbors.brute_force", "haversine_knn", "device"): _DEVICE,
    ("neighbors.brute_force", "knn", "device"): _DEVICE,
    ("neighbors.brute_force", "knn_merge_parts", "device"): _DEVICE,
    ("neighbors.epsilon_neighborhood", "eps_neighbors_l2sq", "device"):
        _DEVICE,
    ("neighbors.ivf_bq", "build", "device"): _DEVICE,
    ("neighbors.ivf_flat", "build", "device"): _DEVICE,
    ("neighbors.ivf_pq", "build", "device"): _DEVICE,
    ("neighbors.ivf_pq", "make_rotation_matrix", "device"): _DEVICE,
    ("neighbors.plan", "SearchPlan", "device"):
        "the device the plan's operands live on",
    ("neighbors.refine", "refine", "device"): _DEVICE,
    ("neighbors.serialize", "load", "device"): _DEVICE,
    ("neighbors.serialize", "load_ball_cover", "device"): _DEVICE,
    ("neighbors.serialize", "load_ivf_bq", "device"): _DEVICE,
    ("neighbors.serialize", "load_ivf_flat", "device"): _DEVICE,
    ("neighbors.serialize", "load_ivf_pq", "device"): _DEVICE,
    ("spatial.knn", "approx_knn_build_index", "device"): _DEVICE,
    ("util.host_sample", "sample_rows", "device"): _DEVICE,
    ("core.mdarray", "as_array", "device"):
        "the device a host value is put on (a tensor stays where it is)",
    ("sparse.solver.lanczos", "lanczos_largest", "device"):
        "the device of an implicit operator (matvec and n, no matrix)",
    ("sparse.solver.lanczos", "lanczos_smallest", "device"):
        "the device of an implicit operator (matvec and n, no matrix)",
}
# the generators draw on the device of their generator; an int seed
# makes one on ``device`` (default cuda)
_DRAW = "the device of the generator an int seed makes"
ALLOWED_EXTRA.update({
    ("random.rng", name, "device"): _DRAW for name in (
        "uniform", "uniformInt", "normal", "normalInt", "normalTable",
        "fill", "bernoulli", "scaled_bernoulli", "gumbel", "lognormal",
        "logistic", "exponential", "rayleigh", "laplace", "discrete",
        "sample_without_replacement", "permute")})
ALLOWED_EXTRA.update({
    ("random.make_blobs", "make_blobs", "device"): _DRAW,
    ("random.make_regression", "make_regression", "device"): _DRAW,
    ("random.multi_variable_gaussian", "multi_variable_gaussian",
     "device"): _DRAW,
    ("random.rmat", "rmat_rectangular_gen", "device"): _DRAW,
    ("random.rmat", "rmat", "device"): _DRAW,
})


def _shared_modules():
    """Dotted paths (below the package) of the port's public modules that
    have a same-named module in the JAX package."""
    out = []
    for path in sorted(PORT_ROOT.rglob("*.py")):
        rel = path.relative_to(PORT_ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        if not parts or any(p.startswith("_") for p in parts):
            continue
        if (REF_ROOT / rel).with_suffix(".py").exists():
            out.append(".".join(parts))
    return out


def _cases():
    """(module, name) of every public function and dataclass defined in
    both packages' module."""
    cases = []
    for mod in _shared_modules():
        ref = importlib.import_module(f"raft_tpu.{mod}")
        port = importlib.import_module(f"raft_tpu_torch.{mod}")
        for name, obj in sorted(vars(ref).items()):
            if name.startswith("_") or getattr(obj, "__module__", None) \
                    != ref.__name__:
                continue
            if not (inspect.isfunction(obj) or dataclasses.is_dataclass(obj)):
                continue
            mine = getattr(port, name, None)
            if mine is not None and getattr(mine, "__module__", None) \
                    == port.__name__:
                cases.append((mod, name))
    return cases


def _norm(v):
    """A default in a form both packages share: dtypes by name, enums by
    class and member name, dataclass instances field by field, other
    callables (``lambda x: x``, ``jnp.add`` against ``torch.add``) by
    ``__name__``."""
    if isinstance(v, torch.dtype):
        return ("dtype", str(v).replace("torch.", ""))
    if isinstance(v, type) and (issubclass(v, np.generic)
                                or hasattr(v, "dtype")):
        return ("dtype", np.dtype(getattr(v, "dtype", v)).name)
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple((f.name, _norm(getattr(v, f.name)))
                      for f in dataclasses.fields(v)
                      if not f.name.startswith("_")))
    if v is inspect.Parameter.empty or v is dataclasses.MISSING:
        return ("required",)
    if callable(v) and not isinstance(v, type) and hasattr(v, "__name__"):
        return ("callable", v.__name__)
    return v


def _params(obj):
    """``{name: (kind, default)}`` of a function's parameters or a
    dataclass's public fields, in order."""
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            if f.name.startswith("_"):
                continue
            default = f.default
            if default is dataclasses.MISSING and \
                    f.default_factory is not dataclasses.MISSING:
                default = f.default_factory()
            out[f.name] = ("field", _norm(default))
        return out
    return {p.name: (p.kind, _norm(p.default))
            for p in inspect.signature(obj).parameters.values()}


@pytest.mark.parametrize("mod,name", _cases(),
                         ids=[f"{m}.{n}" for m, n in _cases()])
def test_port_accepts_reference_signature(mod, name):
    ref = _params(getattr(importlib.import_module(f"raft_tpu.{mod}"), name))
    port = _params(getattr(importlib.import_module(f"raft_tpu_torch.{mod}"),
                           name))
    missing = [p for p in ref if p not in port]
    assert not missing, f"{mod}.{name} lacks {missing}"
    for p, (kind, default) in ref.items():
        assert port[p] == (kind, default), \
            f"{mod}.{name}({p}): port {port[p]}, JAX {(kind, default)}"
    order = [p for p in port if p in ref]
    assert order == list(ref), f"{mod}.{name}: parameter order {order}"
    extra = [p for p in port if p not in ref
             and (mod, name, p) not in ALLOWED_EXTRA]
    assert not extra, f"{mod}.{name} adds {extra}, not on the allow-list"


def test_allow_list_is_used():
    """Every allow-list entry names a parameter the port really adds."""
    for mod, name, p in ALLOWED_EXTRA:
        assert (mod, name) in _cases()
        obj = getattr(importlib.import_module(f"raft_tpu_torch.{mod}"), name)
        ref = getattr(importlib.import_module(f"raft_tpu.{mod}"), name)
        assert p in _params(obj) and p not in _params(ref)


def test_core_helpers_exist():
    from raft_tpu_torch.core import error, resources
    with pytest.raises(error.LogicError, match="bad 3"):
        error.fail("bad %d", 3)
    assert resources.default_resources is not None
    cpu = resources.ensure_resources(None, "cpu")
    assert cpu.device.type == "cpu"
    assert resources.ensure_resources(cpu) is cpu


# ---------------------------------------------------------------------
# Values the port accepts by name but does not implement: each raises
# NotImplementedError (naming its ROADMAP.md item), never TypeError.

def _x(n=256, d=8):
    return torch.from_numpy(
        np.random.default_rng(0).normal(size=(n, d)).astype(np.float32))


def _unimplemented():
    """case -> (call, the ROADMAP.md item its message names)."""
    from raft_tpu_torch.serve.types import ServeConfig
    return {
        "ServeConfig.failover": (lambda: ServeConfig(failover=True),
                                 "item 6"),
        "ServeConfig.quality_sample_rate": (lambda: ServeConfig(
            quality_sample_rate=0.5), "item 4b"),
    }


@pytest.mark.parametrize("case", sorted(_unimplemented()))
def test_unimplemented_value_raises_not_implemented(case):
    call, item = _unimplemented()[case]
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md queue 1 {item}\b"):
        call()


# ---------------------------------------------------------------------
# Values the port implements: honoured as the JAX package does.

class _SlowOrFlakyPlan:
    """A fake plan: sleeps ``delay`` s, or fails its first ``fail_n``
    calls with ``ShardFailedError``."""

    def __init__(self, nq, delay=0.0, fail_n=0):
        self.nq, self.n_probes, self.delay, self.fail_n = nq, 4, delay, fail_n
        self.calls = 0

    def search(self, q, block=True):
        from raft_tpu_torch.serve import ShardFailedError
        self.calls += 1
        time.sleep(self.delay)
        if self.calls <= self.fail_n:
            raise ShardFailedError("injected")
        return np.zeros((self.nq, 2), np.float32), np.zeros((self.nq, 2),
                                                            np.int64)


def _serve_once(**cfg):
    """One request through a server on one fake plan → (outcome, the
    plan's calls)."""
    from raft_tpu_torch.serve import (PlanLadder, SearchServer, ServeConfig,
                                      ShardFailedError)
    kw = {k: cfg.pop(k) for k in ("delay", "fail_n") if k in cfg}
    plan = _SlowOrFlakyPlan(1, **kw)
    srv = SearchServer(PlanLadder((1,), (4,), {(1, 0): plan}, dim=3, k=2),
                       ServeConfig(batch_sizes=(1,), max_wait_ms=0.0, **cfg))
    try:
        srv.search(np.zeros((1, 3), np.float32), timeout=30)
        return "ok", plan.calls
    except ShardFailedError:
        return "ShardFailedError", plan.calls
    finally:
        srv.close()


def test_dispatch_timeout_ms_is_honoured():
    """A dispatch slower than ``dispatch_timeout_ms`` fails typed; the
    same dispatch without the watchdog completes."""
    assert _serve_once(delay=0.5, dispatch_timeout_ms=50.0)[0] == \
        "ShardFailedError"
    assert _serve_once(delay=0.05)[0] == "ok"


def test_max_retries_is_honoured():
    """Two failed dispatches: ``max_retries=2`` retries to success,
    ``max_retries=1`` gives up after two calls."""
    assert _serve_once(fail_n=2, max_retries=2, retry_backoff_ms=1.0) == \
        ("ok", 3)
    assert _serve_once(fail_n=2, max_retries=1, retry_backoff_ms=1.0) == \
        ("ShardFailedError", 2)


def test_walk_covers_the_failure_handling_modules():
    """The signature walk holds the fault harness, the logger and the
    serve types against their JAX namesakes; the serve types export the
    same names and error hierarchy."""
    from raft_tpu import serve as jserve
    from raft_tpu_torch import serve as tserve
    cases = set(_cases())
    for mod, name in (("testing.faults", "inject_fault"),
                      ("testing.faults", "delay_execute"),
                      ("testing.faults", "stall_shard"),
                      ("core.logger", "get_logger"),
                      ("core.logger", "set_callback"),
                      ("serve.types", "ServeConfig")):
        assert (mod, name) in cases
    tt = importlib.import_module("raft_tpu_torch.serve.types")
    jt = importlib.import_module("raft_tpu.serve.types")
    assert sorted(tt.__all__) == sorted(jt.__all__)
    for ns in (jserve, tserve):
        assert issubclass(ns.ShardFailedError, ns.DispatchError)
        assert ns.ShardFailedError("x", ranks=[3]).ranks == (3,)
        r = ns.SearchResult(1, 2, partial=True, coverage=0.25)
        assert tuple(r) == (1, 2) and (r.dists, r.ids) == (1, 2)
        assert (r.partial, r.coverage) == (True, 0.25)

def test_f32_kernel_precision_is_honoured():
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
    x = _x()
    base = fused_l2_nn(x, x[:16])
    for prec in (None, "highest"):
        kv = fused_l2_nn(x, x[:16], kernel_precision=prec)
        assert torch.equal(kv.key, base.key)
        assert torch.equal(kv.value, base.value)


def test_adaptive_centers_builds_the_same_index():
    """``adaptive_centers=True`` is accepted and, as in the JAX package,
    changes nothing: build and extend keep the centres fixed."""
    from raft_tpu_torch.neighbors import ivf_flat
    x = _x(512, 8)
    idx = {a: ivf_flat.build(x, ivf_flat.IndexParams(
        n_lists=8, kmeans_n_iters=2, adaptive_centers=a), device="cpu")
        for a in (False, True)}
    for f in ("centers", "lists_data", "lists_indices", "lists_norms",
              "list_sizes"):
        assert torch.equal(getattr(idx[True], f), getattr(idx[False], f))
    grown = ivf_flat.extend(idx[True], _x(64, 8) + 1.0)
    assert torch.equal(grown.centers, idx[True].centers)
    assert grown.size == 576


def test_res_is_honoured():
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_flat, selection
    x = _x(512, 8)
    index = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=8,
                                                   kmeans_n_iters=2),
                           device="cpu")
    sp = ivf_flat.SearchParams(n_probes=4)
    d0, i0 = ivf_flat.search(index, x[:20], 5, sp)
    d1, i1 = ivf_flat.search(index, x[:20], 5, sp, res=Resources("cpu"))
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    v0 = selection.select_k(x, 3)
    v1 = selection.select_k(x, 3, res=Resources("cpu"))
    assert torch.equal(v0[1], v1[1])


@pytest.mark.parametrize("nq,mb", [(5, 8), (20, 8), (16, 8)])
def test_batched_search_pad_partial_and_block(nq, mb):
    from raft_tpu_torch.neighbors.ann_types import batched_search
    q = _x(nq, 4)
    seen = []

    def one(qb):
        seen.append(qb.shape[0])
        return qb.sum(dim=1, keepdim=True), qb[:, :1].to(torch.int32)

    d, i = batched_search(one, q, max_batch=mb, pad_partial=True,
                          block=True)
    assert set(seen) == {mb}
    assert torch.equal(d, q.sum(dim=1, keepdim=True))
    assert torch.equal(i, q[:, :1].to(torch.int32))
    seen.clear()
    batched_search(one, q[:5], max_batch=mb)
    assert seen == [5]

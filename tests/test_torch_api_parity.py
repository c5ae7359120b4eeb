"""The port's public signatures against the JAX package's.

For every module of ``raft_tpu_torch`` whose path also exists in
``raft_tpu`` (private modules aside), each public function and dataclass
defined in both must take every parameter (or field) of the JAX one,
with the same default, kind and relative order, so a caller written for
``raft_tpu`` never gets a ``TypeError``. A parameter the port adds must
be on :data:`ALLOWED_EXTRA`. Values the port does not implement raise
``NotImplementedError`` (the second half of this file).
"""

import dataclasses
import enum
import importlib
import inspect
import pathlib

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
    ("neighbors.serialize", "load_ivf_bq", "device"): _DEVICE,
    ("neighbors.serialize", "load_ivf_flat", "device"): _DEVICE,
    ("neighbors.serialize", "load_ivf_pq", "device"): _DEVICE,
    ("spatial.knn", "approx_knn_build_index", "device"): _DEVICE,
    ("util.host_sample", "sample_rows", "device"): _DEVICE,
}


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
    class and member name, dataclass instances field by field."""
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
    from raft_tpu_torch.neighbors import selection
    from raft_tpu_torch.serve.types import ServeConfig
    x = _x()
    return {
        "select_k@approx": lambda: selection.select_k(
            x, 4, mode="approx", recall_target=0.9),
        "ServeConfig.dispatch_timeout_ms": lambda: ServeConfig(
            dispatch_timeout_ms=50.0),
        "ServeConfig.max_retries": lambda: ServeConfig(max_retries=2),
        "ServeConfig.failover": lambda: ServeConfig(failover=True),
        "ServeConfig.quality_sample_rate": lambda: ServeConfig(
            quality_sample_rate=0.5),
    }


@pytest.mark.parametrize("case", sorted(_unimplemented()))
def test_unimplemented_value_raises_not_implemented(case):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _unimplemented()[case]()


# ---------------------------------------------------------------------
# Values the port implements: honoured as the JAX package does.

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

"""The port's public signatures against the JAX package's.

For every module of ``raft_tpu_torch`` whose path also exists in
``raft_tpu`` (private modules aside), each public function, dataclass
and class constructor defined in both (exceptions, enums and
:data:`CTOR_EXEMPT` aside) must take every parameter (or field) of the
JAX one,
with the same default, kind and relative order, so a caller written for
``raft_tpu`` never gets a ``TypeError``. A parameter the port adds must
be on :data:`ALLOWED_EXTRA`. Values the port implements are honoured
(the second half of this file).
"""

import dataclasses
import enum
import importlib
import inspect
import os
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
    ("neighbors.host_memory", "build", "device"): _DEVICE,
    ("neighbors.host_memory", "build_streaming", "device"): _DEVICE,
    ("neighbors.ivf_bq", "build", "device"): _DEVICE,
    ("neighbors.ivf_flat", "build", "device"): _DEVICE,
    ("neighbors.ivf_pq", "build", "device"): _DEVICE,
    ("neighbors.ivf_pq", "make_rotation_matrix", "device"): _DEVICE,
    ("neighbors.plan", "SearchPlan", "device"):
        "the device the plan's operands live on",
    ("neighbors.refine", "refine", "device"): _DEVICE,
    ("neighbors.serialize", "load", "device"): _DEVICE,
    ("neighbors.serialize", "load_ball_cover", "device"): _DEVICE,
    ("neighbors.serialize", "load_host_ivf_flat", "device"): _DEVICE,
    ("neighbors.serialize", "load_ivf_bq", "device"): _DEVICE,
    ("neighbors.serialize", "load_ivf_flat", "device"): _DEVICE,
    ("neighbors.serialize", "load_ivf_pq", "device"): _DEVICE,
    ("neighbors.serialize", "load_mutable", "device"): _DEVICE,
    ("spatial.knn", "approx_knn_build_index", "device"): _DEVICE,
    ("util.host_sample", "sample_rows", "device"): _DEVICE,
    ("core.mdarray", "as_array", "device"):
        "the device a host value is put on (a tensor stays where it is)",
    ("sparse.solver.lanczos", "lanczos_largest", "device"):
        "the device of an implicit operator (matvec and n, no matrix)",
    ("sparse.solver.lanczos", "lanczos_smallest", "device"):
        "the device of an implicit operator (matvec and n, no matrix)",
    ("obs.quality", "ExactScorer", "device"):
        "the device the scorer's corpus chunks live and are scored on",
    ("fleet.replication", "bootstrap_replica", "device"):
        "the device a follower loads the primary's checkpoint onto",
    ("fleet.remote", "bootstrap_from_url", "device"):
        "the device a follower loads the primary's checkpoint onto",
    ("comms.bootstrap", "initialize_distributed", "backend"):
        "the torch.distributed backend: nccl on the card, gloo on the CPU "
        "only when asked",
}
# defaults the port sets apart, and why: (JAX default, port default)
DEFAULT_DIFFERS = {
    ("fleet.proc", "ProcessFleet", "platform"): (
        "cpu", "cuda", "daemons run on the card unless the caller asks "
        "for the CPU"),
    ("fleet.proc", "device_env", "platform"): (
        "cpu", "cuda", "the card's variables unless the caller asks for "
        "the CPU"),
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
    ("random.rng", "RngState", "device"): _DRAW,
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


# classes whose constructors differ by design, and why
CTOR_EXEMPT = {
    ("core.logger", "Logger"): "the default logger name is its package's",
    ("core.resources", "Resources"):
        "a torch device, not a JAX mesh and key (ensure_resources maps "
        "a caller's device)",
    ("obs.registry", "Counter"): "made by the registry, never by a caller",
    ("obs.registry", "Gauge"): "made by the registry, never by a caller",
}


def _walked(mod, name, obj) -> bool:
    """A function, a dataclass, or a class a caller constructs."""
    if inspect.isfunction(obj) or dataclasses.is_dataclass(obj):
        return True
    return (inspect.isclass(obj) and not issubclass(
        obj, (enum.Enum, BaseException)) and (mod, name) not in CTOR_EXEMPT)


def _cases():
    """(module, name) of every public function, dataclass and class
    constructor defined in both packages' module."""
    cases = []
    for mod in _shared_modules():
        ref = importlib.import_module(f"raft_tpu.{mod}")
        port = importlib.import_module(f"raft_tpu_torch.{mod}")
        for name, obj in sorted(vars(ref).items()):
            if name.startswith("_") or getattr(obj, "__module__", None) \
                    != ref.__name__:
                continue
            if not _walked(mod, name, obj):
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
        if (mod, name, p) in DEFAULT_DIFFERS:
            ref_default, port_default, _ = DEFAULT_DIFFERS[(mod, name, p)]
            assert default == ref_default
            default = port_default
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


def test_default_differences_are_used():
    """Every default the port sets apart names a parameter of both
    packages whose defaults really are the two listed."""
    for (mod, name, p), (ref_d, port_d, _) in DEFAULT_DIFFERS.items():
        assert (mod, name) in _cases()
        obj = getattr(importlib.import_module(f"raft_tpu_torch.{mod}"), name)
        ref = getattr(importlib.import_module(f"raft_tpu.{mod}"), name)
        assert _params(ref)[p][1] == ref_d and _params(obj)[p][1] == port_d


def test_walk_covers_the_fleet():
    """The signature walk holds every module of the fleet against its
    JAX namesake, and the package exports the JAX package's names."""
    from raft_tpu import fleet as jfleet
    from raft_tpu_torch import fleet as tfleet
    cases = set(_cases())
    for mod, name in (("fleet.replica", "Replica"),
                      ("fleet.router", "FleetConfig"),
                      ("fleet.router", "FleetRouter"),
                      ("fleet.rolling", "rolling_restart"),
                      ("fleet.replication", "WalApplier"),
                      ("fleet.replication", "Replicator"),
                      ("fleet.replication", "bootstrap_replica"),
                      ("fleet.transport", "ReplicaTransport"),
                      ("fleet.transport", "TransportClient"),
                      ("fleet.transport", "RemoteWalReader"),
                      ("fleet.transport", "serve_replica"),
                      ("fleet.transport", "wait_healthy"),
                      ("fleet.remote", "RemoteSearchClient"),
                      ("fleet.remote", "RemoteReplica"),
                      ("fleet.remote", "bootstrap_from_url"),
                      ("fleet.proc", "ProcessFleet"),
                      ("fleet.proc", "FleetProcess"),
                      ("fleet.proc", "device_env")):
        assert (mod, name) in cases, (mod, name)
    assert sorted(tfleet.__all__) == sorted(jfleet.__all__)


def test_core_helpers_exist():
    from raft_tpu_torch.core import error, resources
    with pytest.raises(error.LogicError, match="bad 3"):
        error.fail("bad %d", 3)
    assert resources.default_resources is not None
    cpu = resources.ensure_resources(None, "cpu")
    assert cpu.device.type == "cpu"
    assert resources.ensure_resources(cpu) is cpu


# ---------------------------------------------------------------------
# Values the port implements: honoured as the JAX package does.

def _x(n=256, d=8):
    return torch.from_numpy(
        np.random.default_rng(0).normal(size=(n, d)).astype(np.float32))


def _mutable():
    """A small CPU IVF-Flat index wrapped as a MutableIndex."""
    from raft_tpu_torch import mutate
    from raft_tpu_torch.neighbors import ivf_flat
    index = ivf_flat.build(_x(256, 8), ivf_flat.IndexParams(
        n_lists=4, kmeans_n_iters=2), device="cpu")
    return mutate.MutableIndex(index, k=3, config=mutate.MutateConfig(
        delta_capacities=(8,)))


def _fold(**kw):
    from raft_tpu_torch.mutate import compact
    m = _mutable()
    return lambda: compact.fold(m.index, _x(2, 8), [300, 301], [1], **kw)


def _cpu_mesh(n=4):
    from raft_tpu_torch import parallel
    return parallel.make_mesh(devices=[torch.device("cpu")] * n)


def _register_dist(mesh):
    m = _mutable()
    m.register_dist(mesh, "data", _x(4, 8), shapes=(1,))
    return m._dist_plan(1, 0).n_shards == 4


def _dist_ladder(mesh):
    from raft_tpu_torch import mutate
    ladder = mutate.build_dist_serve_ladder(_mutable(), _x(4, 8),
                                            mesh=mesh, shapes=(1,))
    d, i = ladder.plan_for(1, 0)[1].search(_x(1, 8), block=True)
    return tuple(i.shape) == (1, 3) and bool((i >= 0).all())


def _fold_mesh(mesh):
    from raft_tpu_torch.parallel import Sharded
    new = _fold(mode="rebuild", mesh=mesh)()
    ids = new.lists_indices.numpy()
    return (isinstance(new.lists_indices, Sharded) and new.size == 257
            and sorted(ids[ids >= 0].tolist())
            == [i for i in range(256) if i != 1] + [300, 301])


def _from_mutable(mesh):
    from raft_tpu_torch.serve import DistributedSearchServer, ServeConfig
    srv = DistributedSearchServer.from_mutable(
        _mutable(), _x(4, 8).numpy(), mesh=mesh,
        config=ServeConfig(batch_sizes=(1,), max_wait_ms=0.0))
    try:
        return tuple(srv.search(_x(1, 8).numpy(), timeout=30)[1].shape) \
            == (1, 3)
    finally:
        srv.close()


def _parts(family, mesh):
    """A multi-part build of ``family`` over 512 rows and one search of
    its parts at k = 3."""
    from raft_tpu_torch import parallel
    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq
    mod = {"flat": ivf_flat, "pq": ivf_pq, "bq": ivf_bq}[family]
    build = getattr(parallel, f"distributed_ivf_{family}_build")
    search = getattr(parallel, f"distributed_ivf_{family}_search_parts")
    kw = {"pq_bits": 4} if family == "pq" else {}
    didx = build(_x(512, 8), mod.IndexParams(n_lists=4, kmeans_n_iters=2,
                                             **kw), mesh)
    ids = didx.parts_indices.numpy()
    d, i = search(didx, _x(5, 8), 3, mod.SearchParams(n_probes=4))
    return (sorted(ids[ids >= 0].tolist()) == list(range(512))
            and tuple(i.shape) == (5, 3) and bool((i >= 0).all()))


_MESH_VALUES = {
    "MutableIndex.register_dist": _register_dist,
    "build_dist_serve_ladder": _dist_ladder,
    "fold(mesh=...)": _fold_mesh,
    "DistributedSearchServer.from_mutable": _from_mutable,
    "distributed_ivf_flat_build": lambda mesh: _parts("flat", mesh),
    "distributed_ivf_flat_search_parts": lambda mesh: _parts("flat", mesh),
    "distributed_ivf_pq_build": lambda mesh: _parts("pq", mesh),
    "distributed_ivf_pq_search_parts": lambda mesh: _parts("pq", mesh),
    "distributed_ivf_bq_build": lambda mesh: _parts("bq", mesh),
    "distributed_ivf_bq_search_parts": lambda mesh: _parts("bq", mesh),
}


@pytest.mark.parametrize("case", sorted(_MESH_VALUES))
def test_mesh_value_is_honoured(case):
    """The mesh-wide entry points (ROADMAP.md queue 1 item 6) run on a
    four-rank CPU mesh and answer as their JAX namesakes would."""
    mesh = _cpu_mesh()
    try:
        assert _MESH_VALUES[case](mesh)
    finally:
        mesh.close()



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


def _cpu_mesh_index():
    """A list-sharded CPU IVF-Flat index over 8 logical CPU ranks."""
    from raft_tpu_torch import parallel
    from raft_tpu_torch.neighbors import ivf_flat
    mesh = parallel.make_mesh(devices=[torch.device("cpu")] * 8)
    index = ivf_flat.build(_x(512, 8), ivf_flat.IndexParams(
        n_lists=8, kmeans_n_iters=2), device="cpu")
    return parallel.shard_ivf_flat(index, mesh), mesh


def test_failover_is_honoured():
    """``ServeConfig(failover=True)``: a shard stalled past the watchdog
    while its suspect gauge is up is excluded, and the request is served
    partial over the other seven (no error)."""
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import DistributedSearchServer, ServeConfig
    from raft_tpu_torch.testing import faults
    sidx, mesh = _cpu_mesh_index()
    cfg = ServeConfig(batch_sizes=(1,), max_wait_ms=0.0, failover=True,
                      failover_probe_ms=50.0, dispatch_timeout_ms=2500.0,
                      max_retries=1, retry_backoff_ms=1.0)
    srv = DistributedSearchServer.from_sharded_index(
        sidx, _x(4, 8).numpy(), 3, ivf_flat.SearchParams(n_probes=1),
        mesh=mesh, config=cfg)
    try:
        with faults.stall_shard(5, seconds=3.5):
            r = srv.search(_x(1, 8).numpy(), timeout=30)
        assert r.partial and 0.0 < r.coverage < 1.0
        assert srv.excluded_ranks == (5,)
    finally:
        srv.close()


def test_loadgen_server_dist_is_honoured(capsys):
    """``loadgen --server dist --device cpu`` serves the mesh-wide tier:
    every request completes and the report names each rung's merge
    bytes (the ``raft.serve.dist.*`` values)."""
    import json
    from raft_tpu_torch.tools import loadgen
    assert loadgen.main(["--server", "dist", "--device", "cpu", "--n",
                         "2000", "--dim", "8", "--n-lists", "8",
                         "--probes-ladder", "1", "--rate", "20",
                         "--duration", "1", "--k", "3"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["completed"] == report["offered"] > 0
    assert report["errors"] == 0
    assert report["merge_bytes_per_rung"].get("rung_0", 0) > 0
    assert report["serve_metrics"]["raft.serve.dist.queries"] > 0


def test_set_profile_tag_is_honoured(monkeypatch):
    """A server's sampled dispatches land in the profiler's ledger under
    the tag ``set_profile_tag`` gave it (``"server"`` by default); a
    fleet replica names its server."""
    from raft_tpu_torch import fleet
    from raft_tpu_torch.obs import profiler
    from raft_tpu_torch.serve import PlanLadder, SearchServer, ServeConfig
    tags = []
    monkeypatch.setattr(profiler, "tag_dispatch", tags.append)
    srv = SearchServer(PlanLadder((1,), (4,), {(1, 0): _SlowOrFlakyPlan(1)},
                                  dim=3, k=2),
                       ServeConfig(batch_sizes=(1,), max_wait_ms=0.0))
    try:
        srv.search(np.zeros((1, 3), np.float32), timeout=30)
        assert set(tags) == {"server"}
        fleet.Replica("r7", srv)
        tags.clear()
        srv.search(np.zeros((1, 3), np.float32), timeout=30)
        assert tags and set(tags) == {"r7"}
    finally:
        srv.close()


def test_duck_typed_blackbox_is_honoured():
    """A black box object (``flush(reason)`` and a ``dir``) is flushed on
    a kill and named in ``describe()``."""
    from raft_tpu_torch import fleet

    class Box:
        dir = "/boxes/r0"

        def __init__(self):
            self.reasons = []

        def flush(self, reason):
            self.reasons.append(reason)

    box = Box()
    rep = fleet.Replica("r0").set_blackbox(box)
    assert rep.describe()["blackbox"] == "/boxes/r0"
    rep.kill()
    assert box.reasons == ["kill"]


def test_replica_set_blackbox_directory_is_honoured(tmp_path):
    """A directory in place of a box: a black box of the replica's name
    is built there, named in ``describe()`` and flushed on a kill."""
    from raft_tpu_torch import fleet
    from raft_tpu_torch.obs import blackbox
    rep = fleet.Replica("r0").set_blackbox(str(tmp_path / "box"))
    assert rep.describe()["blackbox"] == str(tmp_path / "box")
    rep.kill()
    recs = blackbox.read_dump(str(tmp_path / "box"))
    assert {r["box"] for r in recs} == {"r0"}
    assert [r["data"]["reason"] for r in recs if r["kind"] == "meta"] == [
        "start", "kill"]


def test_process_fleet_blackbox_is_honoured(tmp_path, monkeypatch):
    """``ProcessFleet(blackbox=True)`` hands each daemon ``--blackbox
    <workdir>/<name>/blackbox``."""
    from raft_tpu_torch import fleet
    cmds = []

    class _Popen:
        def __init__(self, cmd, **kw):
            cmds.append((cmd, kw["cwd"]))

    monkeypatch.setattr(fleet.proc.subprocess, "Popen", _Popen)
    monkeypatch.setattr(fleet.ProcessFleet, "_handshake",
                        lambda self, name, popen, port_file: "http://x")
    pf = fleet.ProcessFleet(str(tmp_path), blackbox=True, spawn=False,
                            platform="cpu")
    pf._spawn_one(0, "r0", "primary", None)
    (cmd, cwd), = cmds
    i = cmd.index("--blackbox")
    assert cmd[i + 1] == str(tmp_path / "r0" / "blackbox")
    assert cwd == str(tmp_path / "r0")


def test_fleetd_blackbox_is_honoured(tmp_path):
    """``fleetd --blackbox <relative dir>`` spawned from another working
    directory than the repo's: the daemon's box lands under its own
    working directory, flushed at its start and its clean exit."""
    import subprocess
    import sys
    from raft_tpu_torch.obs import blackbox
    from raft_tpu_torch.fleet import TransportClient
    repo = str(PORT_ROOT.parent)
    env = dict(os.environ, PYTHONPATH=repo, CUDA_VISIBLE_DEVICES="")
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "raft_tpu_torch.fleet.fleetd", "--device",
         "cpu", "--name", "r5", "--n", "400", "--n-lists", "4",
         "--port-file", str(port_file), "--blackbox", "bb"],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        while not port_file.exists() and time.monotonic() < deadline:
            assert proc.poll() is None, "fleetd exited during startup"
            time.sleep(0.1)
        client = TransportClient(
            f"http://127.0.0.1:{int(port_file.read_text())}")
        assert client.stop(timeout=30)["stopping"]
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    recs = blackbox.read_dump(str(tmp_path / "bb"))
    reasons = [r["data"]["reason"] for r in recs if r["kind"] == "meta"]
    assert reasons[0] == "start" and reasons[-1] == "close"
    assert {r["box"] for r in recs} == {"r5"}


def test_quality_sample_rate_is_honoured():
    """Rate 1.0 samples every served query into the attached monitor;
    rate 0 attaches nothing."""
    from raft_tpu_torch.obs.quality import QualityConfig, QualityMonitor
    from raft_tpu_torch.serve import PlanLadder, SearchServer, ServeConfig

    class Exact:
        def topk(self, q, k):
            return np.tile(np.arange(k), (len(q), 1))

    def server(rate):
        return SearchServer(
            PlanLadder((1,), (4,), {(1, 0): _SlowOrFlakyPlan(1)}, dim=3,
                       k=2),
            ServeConfig(batch_sizes=(1,), max_wait_ms=0.0,
                        quality_sample_rate=rate))

    srv = server(1.0)
    try:
        mon = srv.attach_quality(QualityMonitor(
            Exact(), 1.0, QualityConfig(poll_ms=5.0)))
        for _ in range(3):
            srv.search(np.zeros((1, 3), np.float32), timeout=30)
        assert mon.drain(30.0)
        assert mon.stats()["samples"] == 3
        # the fake plan serves ids (0, 0): one of the exact (0, 1)
        assert mon.stats()["recall"] == 0.5
    finally:
        srv.close()
    srv = server(0.0)
    try:
        assert srv.enable_quality(np.zeros((4, 3), np.float32)) is None
        assert srv.quality is None
    finally:
        srv.close()


def test_walk_covers_quality_and_the_long_tail():
    """The signature walk holds the quality module, the series cap's
    registry and each long-tail util and core module against their JAX
    namesakes, the constructors among them."""
    cases = set(_cases())
    for mod, name in (("obs.quality", "ExactScorer"),
                      ("obs.quality", "QualityConfig"),
                      ("obs.quality", "QualityMonitor"),
                      ("obs.quality", "corpus_from_index"),
                      ("obs.registry", "counter"),
                      ("util.pow2_utils", "Pow2"),
                      ("util.pow2_utils", "round_up_pow2"),
                      ("util.seive", "Seive"),
                      ("util.scatter", "scatter"),
                      ("util.scatter", "scatter_if"),
                      ("util.cache", "VecCache"),
                      ("core.trace", "enable_tracing"),
                      ("core.trace", "push_range"),
                      ("core.memory", "memory_stats"),
                      ("core.memory", "hbm_stats"),
                      ("core.memory", "donate"),
                      ("core.interruptible", "synchronize"),
                      ("core.interruptible", "cancel"),
                      ("core.compile_cache", "enable"),
                      ("serve.batcher", "SearchServer")):
        assert (mod, name) in cases, (mod, name)
    for mod, name in (("mutate.types", "MutateConfig"),
                      ("mutate.program", "compile_mutate_program"),
                      ("mutate.program", "mutate_tail"),
                      ("mutate.compact", "fold"),
                      ("mutate.compactor", "Compactor"),
                      ("mutate.mutable", "MutableIndex"),
                      ("mutate.mutable", "build_serve_ladder"),
                      ("neighbors.serialize", "load_mutable")):
        assert (mod, name) in cases, (mod, name)
    for mod, name in CTOR_EXEMPT:
        assert (mod, name) not in cases
        assert inspect.isclass(getattr(importlib.import_module(
            f"raft_tpu_torch.{mod}"), name))


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

def _mutations(m):
    """The same acknowledged mutations into ``m``: upserts, a delete of a
    main row and of a delta row, a re-upsert → the upserted ids."""
    ids = m.upsert(_x(6, 8) + 3.0)
    m.delete([int(ids[0]), 5])
    m.upsert(_x(2, 8) - 3.0, ids=[int(ids[1]), 7])
    return ids


def test_attach_wal_is_honoured(tmp_path):
    """Mutations after ``attach_wal`` are in the log, fsync'd before they
    are applied: one record a mutation call, in call order."""
    from raft_tpu_torch.mutate.wal import MutationWAL
    m = _mutable()
    wal = MutationWAL(str(tmp_path / "m.wal"))
    assert m.attach_wal(wal, str(tmp_path / "ckpt.npz")) is m
    _mutations(m)
    recs = MutationWAL(str(tmp_path / "m.wal"), sync=False).replay()
    assert [r.op for r in recs] == [1, 2, 1]
    assert [r.seq for r in recs] == [1, 2, 3]
    np.testing.assert_array_equal(recs[1].ids, [m.index.size, 5])


def test_recover_is_honoured(tmp_path):
    """``recover`` replays the log onto the base index: the recovered
    index answers as the live one did."""
    from raft_tpu_torch import mutate
    from raft_tpu_torch.mutate.wal import MutationWAL
    m = _mutable()
    m.attach_wal(MutationWAL(str(tmp_path / "m.wal"), sync=False))
    _mutations(m)
    back = mutate.MutableIndex.recover(str(tmp_path / "m.wal"), k=3,
                                       base_index=m.index, config=m.cfg,
                                       sync=False)
    assert back.stats() == m.stats()
    q = _x(12, 8)
    assert torch.equal(back.search(q, block=True)[1],
                       m.search(q, block=True)[1])


def test_fold_stream_chunk_is_honoured():
    """A rebuild fold with ``stream_chunk > 0`` runs the host-streaming
    build: every live row lands in the lists once, the tombstoned row is
    gone and the delta rows carry their ids."""
    idx = _fold(mode="rebuild", stream_chunk=64)()
    ids = idx.lists_indices[idx.lists_indices >= 0].numpy()
    assert sorted(ids.tolist()) == [i for i in range(256) if i != 1] + \
        [300, 301]
    assert idx.size == 257 and idx.device.type == "cpu"


def test_walk_covers_durability_and_tiering():
    """The signature walk holds the WAL, the host-memory and the tiered
    modules against their JAX namesakes."""
    cases = set(_cases())
    for mod, name in (("mutate.wal", "MutationWAL"),
                      ("mutate.wal", "WalReader"),
                      ("mutate.wal", "WalRecord"),
                      ("mutate.wal", "read_raw"),
                      ("mutate.wal", "decode_stream"),
                      ("neighbors.host_memory", "HostIvfFlat"),
                      ("neighbors.host_memory", "to_host"),
                      ("neighbors.host_memory", "build"),
                      ("neighbors.host_memory", "build_streaming"),
                      ("neighbors.host_memory", "search"),
                      ("neighbors.tiered", "TieredConfig"),
                      ("neighbors.tiered", "TieredIndex"),
                      ("neighbors.tiered", "TieredPlan"),
                      ("neighbors.tiered", "build_plan"),
                      ("neighbors.tiered", "build_ladder"),
                      ("neighbors.tiered", "from_host"),
                      ("neighbors.tiered", "from_index"),
                      ("neighbors.serialize", "save_host_ivf_flat"),
                      ("neighbors.serialize", "load_host_ivf_flat")):
        assert (mod, name) in cases, (mod, name)


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

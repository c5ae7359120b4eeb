"""The port's communicator, mesh and bootstrap (``raft_tpu_torch.comms``,
``raft_tpu_torch.parallel.mesh``) against ``raft_tpu.comms``.

The same integer inputs go through every collective on the JAX package's
8-device CPU mesh (``shard_map``) and on the port's mesh of eight
logical CPU ranks, over the whole axis and over a two-group
``comm_split``: the results must be equal exactly. The compressed
allreduce is held to the exact one (relative error < 0.05, the JAX
package's bound) and to the JAX package's within 1e-5 of the exact
result's scale. Then the launcher, ``Session``, ``HostP2P`` and native KV
cases of ``tests/test_comms.py`` on the port; ``HealthMonitor``'s stale
rank detection; a two-process gloo world through
``initialize_distributed`` whose collectives equal the in-process
mesh's, and a three-process one whose float sums equal its bits (rank
order); a rank that raises or never arrives ending its peers' wait in
bounded time; and a default mesh on a host without a card raising.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import raft_tpu.comms as jcomms
import raft_tpu_torch.comms as tcomms
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.parallel import mesh as tmesh
from raft_tpu_torch.parallel.mesh import P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N = 8
# per-rank input: (8, 2) int32 rows of one (64, 2) arange
X = np.arange(N * 8 * 2, dtype=np.int32).reshape(N * 8, 2)
SPLIT = [r % 2 for r in range(N)]


@pytest.fixture(scope="module")
def jmesh():
    from raft_tpu.parallel import make_mesh
    return make_mesh(axis_names=("data",))


@pytest.fixture(scope="module")
def tm():
    m = tmesh.make_mesh(devices=[CPU] * N)
    yield m
    m.close()


def _ops():
    """name -> body(comms, v) over per-rank (8, 2) int32 ``v``, the same
    calls in either package."""
    def mod3(v):
        return v % 3 + 1

    return {
        "allreduce_sum": lambda c, v: c.allreduce(v),
        "allreduce_max": lambda c, v: c.allreduce(v, jcomms.ReduceOp.MAX),
        "allreduce_min": lambda c, v: c.allreduce(v, jcomms.ReduceOp.MIN),
        "allreduce_prod": lambda c, v: c.allreduce(mod3(v),
                                                   jcomms.ReduceOp.PROD),
        "bcast": lambda c, v: c.bcast(v, root=1),
        "reduce": lambda c, v: c.reduce(v, root=1),
        "allgather": lambda c, v: c.allgather(v),
        "allgatherv": lambda c, v: c.allgatherv(v[:3], [3, 3, 4, 3, 3, 3,
                                                        3, 3][:c.get_size()]),
        "gather": lambda c, v: c.gather(v, root=0),
        "gatherv": lambda c, v: c.gatherv(v[:3], [4] * c.get_size(), 0),
        "reducescatter": lambda c, v: c.reducescatter(v),
        "ring_permute": lambda c, v: c.ring_permute(v, 1),
        "ring_permute_3": lambda c, v: c.ring_permute(v, 3),
        "alltoall": lambda c, v: c.alltoall(v),
        "barrier_value": lambda c, v: c.barrier_value() + 0 * v[0, 0],
    }


FULL_ONLY = {
    "device_send_recv": lambda c, v: c.device_send_recv(
        v, [(i, (i + 3) % N) for i in range(N)]),
    "multicast_sendrecv": lambda c, v: c.multicast_sendrecv(
        v, [[(r + 1) % N, (r + 3) % N] for r in range(N)]),
}
CASES = ([(n, g) for n in _ops() for g in ("full", "split")]
         + [(n, "full") for n in FULL_ONLY])


def _jax_run(jmesh, body, split):
    c = jcomms.build_comms(jmesh)
    if split:
        c = c.comm_split(SPLIT)
    f = jax.jit(jax.shard_map(lambda v: body(c, v)[None], mesh=jmesh,
                              in_specs=JP("data"), out_specs=JP("data"),
                              check_vma=False))
    return np.asarray(f(jnp.asarray(X)))


def _port_run(tm, body, split):
    c = tcomms.build_comms(tm)
    if split:
        c = c.comm_split(SPLIT)
    out = tmesh.shard_map(lambda v: body(c, v)[None], tm, P("data"),
                          P("data"))(torch.from_numpy(X))
    return out.numpy()


@pytest.mark.parametrize("name,group", CASES)
def test_collective_equals_jax(jmesh, tm, name, group):
    """Every collective, whole axis and split: the port's per-rank
    results equal the JAX package's exactly (integers)."""
    body = {**_ops(), **FULL_ONLY}[name]
    want = _jax_run(jmesh, body, group == "split")
    got = _port_run(tm, body, group == "split")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", [
    "test_collective_allreduce", "test_collective_broadcast",
    "test_collective_reduce", "test_collective_allgather",
    "test_collective_gather", "test_collective_reducescatter",
    "test_pointToPoint_simple_send_recv", "test_commsplit"])
def test_collective_checks_true(jmesh, tm, name):
    """The in-library checks return True on both meshes."""
    assert getattr(jcomms, name)(jmesh) is True
    assert getattr(tcomms, name)(tm) is True


@pytest.mark.parametrize("split", [False, True])
def test_allreduce_quantized(jmesh, tm, split):
    """int8 two-stage allreduce: within 5% of the exact sum (the JAX
    package's bound), and within 1e-5 of the exact sum's scale of the
    JAX package's result."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 5.0, (N, 256)).astype(np.float32)
    jc = jcomms.build_comms(jmesh)
    tc = tcomms.build_comms(tm)
    if split:
        jc, tc = jc.comm_split(SPLIT), tc.comm_split(SPLIT)
    jf = jax.jit(jax.shard_map(
        lambda v: (jc.allreduce_quantized(v), jc.allreduce(v)), mesh=jmesh,
        in_specs=JP("data"), out_specs=(JP("data"), JP("data")),
        check_vma=False))
    ja, je = (np.asarray(a) for a in jf(jnp.asarray(x)))
    ta, te = tmesh.shard_map(
        lambda v: (tc.allreduce_quantized(v), tc.allreduce(v)), tm,
        P("data"), (P("data"), P("data")))(torch.from_numpy(x))
    ta, te = ta.numpy(), te.numpy()
    scale = np.abs(te).max()
    np.testing.assert_allclose(te, je, rtol=1e-5, atol=1e-5 * scale)
    assert np.abs(ta - te).max() / scale < 0.05
    assert np.abs(ta - ja).max() <= 1e-5 * scale


class TestCommsObject:
    def test_size_rank_split_equal_jax(self, jmesh, tm):
        for keys in (None, list(range(7, -1, -1))):
            for colors in (SPLIT, [0] * N):
                a = jcomms.build_comms(jmesh).comm_split(colors, keys)
                b = tcomms.build_comms(tm).comm_split(colors, keys)
                assert a.axis_index_groups == b.axis_index_groups
                assert a.get_size() == b.get_size()
        assert tcomms.build_comms(tm).get_size() == 8

    def test_get_rank_within_subgroup(self, tm):
        c = tcomms.build_comms(tm).comm_split(SPLIT)
        out = tmesh.shard_map(lambda: torch.tensor([c.get_rank()]), tm, (),
                              P("data"))()
        assert out.numpy().tolist() == [0, 0, 1, 1, 2, 2, 3, 3]

    def test_unequal_split_rejected(self, tm):
        with pytest.raises(LogicError):
            tcomms.build_comms(tm).comm_split([0, 0, 0, 1, 1, 1, 1, 1])

    def test_group_brackets_are_noops(self, tm):
        c = tcomms.build_comms(tm)
        assert c.group_start() is None and c.group_end() is None

    def test_collective_outside_shard_map_raises(self, tm):
        with pytest.raises(LogicError, match="shard_map"):
            tcomms.build_comms(tm).allreduce(torch.ones(2))

    def test_multicast_collision_rejected(self, tm):
        c = tcomms.build_comms(tm)
        with pytest.raises(LogicError, match="colliding"):
            tmesh.shard_map(lambda v: c.multicast_sendrecv(
                v, [[0]] * N), tm, P("data"), P("data"))(torch.ones(N, 1))

    def test_sync_stream_success_and_abort(self, tm):
        c = tcomms.build_comms(tm, abort_timeout_s=0.2)
        x = torch.ones(4) * 2
        assert c.sync_stream(x) == tcomms.Status.SUCCESS
        assert c.sync_stream(x, timeout_s=0.0) == tcomms.Status.SUCCESS

        class Never:
            def is_ready(self):
                return False

        assert c.sync_stream(Never(), timeout_s=0.05) == tcomms.Status.ABORT


class TestFailureBounds:
    """A rank that raises, or never arrives, ends every peer's wait in
    bounded time — never a hang."""

    def test_raising_rank_aborts_peers(self, tm):
        c = tcomms.build_comms(tm, abort_timeout_s=60.0)

        def body(v):
            if c.get_rank() == 3:
                raise ValueError("rank 3 failed")
            return c.allreduce(v)

        t0 = time.monotonic()
        with pytest.raises(ValueError, match="rank 3 failed"):
            tmesh.shard_map(body, tm, P("data"), P())(torch.ones(N))
        assert time.monotonic() - t0 < 5.0
        # the mesh serves the next run
        out = tmesh.shard_map(lambda v: c.allreduce(v), tm, P("data"),
                              P())(torch.ones(N))
        assert float(out[0]) == N

    def test_missing_rank_times_out_as_abort(self, tm):
        c = tcomms.build_comms(tm, abort_timeout_s=0.5)

        def body(v):
            if c.get_rank() == 5:     # never joins the collective
                return v
            return c.allreduce(v)

        fn = tmesh.shard_map(body, tm, P("data"), P())
        t0 = time.monotonic()
        with pytest.raises(tmesh.CollectiveTimeout) as e:
            fn(torch.ones(N))
        assert e.value.missing == (5,)
        assert time.monotonic() - t0 < 5.0
        st, out = c.dispatch_checked(fn, torch.ones(N))
        assert st == tcomms.Status.ABORT and out is None

    def test_dispatch_error_is_error(self, tm):
        c = tcomms.build_comms(tm)

        def bad():
            raise RuntimeError("a bug, not a lost peer")

        assert c.dispatch_checked(bad)[0] == tcomms.Status.ERROR

    def test_default_mesh_without_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(LogicError, match="no CUDA device"):
            tmesh.make_mesh()


class TestHealthMonitor:
    def _board(self):
        from raft_tpu_torch.comms.health import _InProcessBoard
        return _InProcessBoard()

    def test_all_alive_no_suspects(self):
        board = self._board()
        mons = [tcomms.HealthMonitor(r, 3, session="thm1", interval_s=0.05,
                                     stale_after_s=0.5, board=board).start()
                for r in range(3)]
        try:
            time.sleep(0.15)
            assert mons[0].suspect_ranks() == []
        finally:
            for m in mons:
                m.stop()

    def test_dead_rank_identified_and_gauged(self):
        from raft_tpu_torch import obs
        board = self._board()
        ms = [tcomms.HealthMonitor(r, 3, session="thm2", interval_s=0.05,
                                   stale_after_s=0.2, board=board).start()
              for r in range(3)]
        try:
            ms[2].stop()
            time.sleep(0.4)
            assert ms[0].suspect_ranks() == [2]
            assert ms[1].suspect_ranks() == [2]
            g = obs.snapshot()["gauges"]
            assert g["raft.comms.health.suspect_rank{rank=2,session=thm2}"] \
                == 1
            assert tcomms.suspects_from_gauges(
                {k: v for k, v in g.items() if "thm2" in k}) == [2]
        finally:
            ms[0].stop()
            ms[1].stop()

    def test_sync_stream_early_abort_names_suspects(self, tm):
        m0 = tcomms.HealthMonitor(0, 2, session="thm3", interval_s=0.02,
                                  stale_after_s=0.1,
                                  board=self._board()).start()

        class Never:
            def is_ready(self):
                return False

        t0 = time.monotonic()
        st = tcomms.build_comms(tm).sync_stream(Never(), timeout_s=30.0,
                                                monitor=m0)
        m0.stop()
        assert st == tcomms.Status.ABORT
        assert m0.last_suspects == [1]
        assert time.monotonic() - t0 < 5.0


class TestLauncherAndSession:
    def test_detect_priority_and_parsing(self):
        for env in ({}, {"SLURM_NTASKS": "4", "SLURM_PROCID": "2"},
                    {"OMPI_COMM_WORLD_SIZE": "3",
                     "OMPI_COMM_WORLD_RANK": "1"},
                    {"RAFT_TPU_NUM_PROCS": "2", "RAFT_TPU_PROC_ID": "0",
                     "RAFT_TPU_COORDINATOR": "h:123", "SLURM_NTASKS": "9",
                     "SLURM_PROCID": "8"},
                    {"SLURM_NTASKS": "x", "SLURM_NPROCS": "5",
                     "SLURM_PROCID": "1"}):
            assert dataclasses.astuple(tcomms.detect_launcher(env=env)) == \
                dataclasses.astuple(jcomms.detect_launcher(env=env))

    def test_multiprocess_requires_coordinator(self):
        with pytest.raises(LogicError):
            tcomms.build_launcher_resources(
                world=tcomms.LauncherWorld("slurm", 4, 1, None))

    def test_single_process_world_builds_resources(self):
        res = tcomms.build_launcher_resources(
            axis_names=("data", "model"), mesh_shape=(4, 2),
            devices=[CPU] * N,
            world=tcomms.LauncherWorld("single", 1, 0, None))
        assert res.comms_initialized
        assert res.get_comms().get_size() == 4
        assert res.get_subcomm("model").get_size() == 2
        c = res.get_comms()
        out = tmesh.shard_map(lambda v: c.allreduce(v), res.mesh,
                              P("data"), P())(torch.arange(4.0))
        assert float(out[0]) == 6.0
        res.mesh.close()

    def test_session_lifecycle(self):
        with tcomms.Session(axis_names=("data",), devices=[CPU] * N) as s:
            res = tcomms.local_handle(s.session_id)
            assert res.comms_initialized
            assert res.get_comms().get_size() == 8
            assert s.mesh.shape["data"] == 8
        with pytest.raises(LogicError):
            tcomms.local_handle(s.session_id)

    def test_2d_session_subcomms(self):
        with tcomms.Session(axis_names=("data", "model"), mesh_shape=(4, 2),
                            devices=[CPU] * N) as s:
            res = tcomms.local_handle(s.session_id)
            assert res.get_comms().get_size() == 4
            assert res.get_subcomm("model").get_size() == 2

    def test_session_host_p2p_cached_and_named(self):
        with tcomms.Session(name="tp2p-test", devices=[CPU] * 2) as s:
            p1 = s.host_p2p()
            assert p1 is s.host_p2p() and p1.session == "tp2p-test"


class TestHostP2P:
    def test_in_process_send_recv_and_ordering(self):
        from raft_tpu_torch.comms.host_p2p import _InProcessRegistry
        reg = _InProcessRegistry()
        r0 = tcomms.HostP2P(0, 2, registry=reg)
        r1 = tcomms.HostP2P(1, 2, registry=reg)
        s = r0.isend(b"hello", dest=1, tag=7)
        r = r1.irecv(source=0, tag=7)
        assert r1.waitall([s, r], timeout_s=2.0) == tcomms.Status.SUCCESS
        assert r.payload == b"hello"
        r0.isend(b"a-first", 1, tag=1)
        r0.isend(b"b", 1, tag=2)
        r0.isend(b"a-second", 1, tag=1)
        rb, ra1, ra2 = r1.irecv(0, tag=2), r1.irecv(0, tag=1), \
            r1.irecv(0, tag=1)
        assert r1.waitall([rb, ra1, ra2]) == tcomms.Status.SUCCESS
        assert (rb.payload, ra1.payload, ra2.payload) == \
            (b"b", b"a-first", b"a-second")

    def test_waitall_timeout_aborts(self):
        from raft_tpu_torch.comms.host_p2p import _InProcessRegistry
        r1 = tcomms.HostP2P(1, 2, registry=_InProcessRegistry())
        r = r1.irecv(source=0, tag=0)
        assert r1.waitall([r], timeout_s=0.05) == tcomms.Status.ABORT

    def test_default_registry_shared_in_process(self):
        a = tcomms.HostP2P(0, 2, session="tshared-default")
        b = tcomms.HostP2P(1, 2, session="tshared-default")
        a.isend(b"x", dest=1, tag=0)
        r = b.irecv(source=0, tag=0)
        assert b.waitall([r], timeout_s=2.0) == tcomms.Status.SUCCESS
        assert r.payload == b"x"


class TestNativeKV:
    """The native TCP broker (torch's C++ ``TCPStore``) behind the JAX
    package's client shape."""

    @pytest.fixture()
    def broker(self):
        with tcomms.NativeKVServer() as s:
            yield s

    def test_put_get_timeout_overwrite(self, broker):
        cl = tcomms.NativeKVClient("127.0.0.1", broker.port)
        cl.key_value_set("a", "v1")
        assert cl.blocking_key_value_get("a", 500) == "v1"
        # consumed: a second read times out, naming the deadline
        with pytest.raises(TimeoutError, match="DEADLINE"):
            cl.blocking_key_value_get("a", 50)
        cl.key_value_set("hb", "1")
        cl.key_value_set("hb", "2")
        assert cl.key_value_try_get("hb") == "2"
        assert cl.key_value_try_get("hb") == "2"
        assert cl.key_value_try_get("missing") is None
        with pytest.raises(ValueError, match="cap"):
            tcomms.NativeKVClient("127.0.0.1", broker.port,
                                  max_len=4).key_value_set("big", "12345")

    def test_second_server_adopts(self, broker):
        other = tcomms.NativeKVServer().start()
        assert other.port == broker.port and not other.owner
        other.stop()

    def test_host_p2p_and_health_over_native(self, broker):
        cl = tcomms.NativeKVClient("127.0.0.1", broker.port)
        a = tcomms.HostP2P(0, 2, session="tnative", client=cl)
        b = tcomms.HostP2P(1, 2, session="tnative", client=cl)
        a.isend(b"payload-x", dest=1, tag=3)
        req = b.irecv(source=0, tag=3)
        assert req.wait(5.0) == tcomms.Status.SUCCESS
        assert req.payload == b"payload-x"
        assert b.irecv(source=0, tag=9).wait(0.1) == tcomms.Status.ABORT
        m0 = tcomms.HealthMonitor(0, 2, session="tnative-h", interval_s=0.05,
                                  stale_after_s=0.3, client=cl).start()
        m1 = tcomms.HealthMonitor(1, 2, session="tnative-h", interval_s=0.05,
                                  stale_after_s=0.3, client=cl).start()
        try:
            time.sleep(0.15)
            assert m0.suspect_ranks() == []
            m1.stop()
            time.sleep(0.5)
            assert m0.suspect_ranks() == [1]
        finally:
            m0.stop()
            m1.stop()


_WORKER = textwrap.dedent("""
    import json, os, sys, time
    import torch
    from raft_tpu_torch import comms
    from raft_tpu_torch.parallel import mesh as tmesh
    from raft_tpu_torch.parallel.mesh import P
    w = comms.detect_launcher()
    res = comms.build_launcher_resources(devices=[torch.device("cpu")],
                                         world=w, abort_timeout_s=60.0)
    c = res.get_comms()
    assert res.mesh.is_process_mesh and c.get_size() == 2
    sys.path.insert(0, os.environ["BODY_DIR"])
    from body import collectives
    out = tmesh.shard_map(lambda v: collectives(c, v), res.mesh, P("data"),
                          P("data"))(torch.arange(8, dtype=torch.int32)
                                     .reshape(4, 2))
    p = comms.Session(name="gloo-p2p").init().host_p2p()
    peer = 1 - w.process_id
    p.isend(f"from-{w.process_id}".encode(), dest=peer, tag=3)
    r = p.irecv(source=peer, tag=3)
    assert p.waitall([r], timeout_s=30.0) == comms.Status.SUCCESS
    m = comms.HealthMonitor(w.process_id, 2, session="mp", interval_s=0.1,
                            stale_after_s=5.0).start()
    time.sleep(0.5)
    assert m.suspect_ranks() == [], m.last_suspects
    m.stop()
    print("RESULT", json.dumps({"out": out.numpy().tolist(),
                                "p2p": r.payload.decode()}), flush=True)
""")

_BODY = textwrap.dedent("""
    import torch
    def collectives(c, v):
        v = v.reshape(2, 2)
        return torch.stack([c.allreduce(v), c.allgather(v)[1],
                            c.alltoall(v), c.bcast(v, root=1),
                            c.ring_permute(v, 1),
                            torch.cat([c.reducescatter(v),
                                       c.reducescatter(v)])])[None]
""")


_FLOAT_WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    from raft_tpu_torch import comms
    from raft_tpu_torch.parallel import mesh as tmesh
    from raft_tpu_torch.parallel.mesh import P
    w = comms.detect_launcher()
    res = comms.build_launcher_resources(devices=[torch.device("cpu")],
                                         world=w, abort_timeout_s=60.0)
    c = res.get_comms()
    x = torch.from_numpy(np.load(os.environ["FLOAT_X"]))
    out = tmesh.shard_map(lambda v: c.allreduce(v), res.mesh, P("data"),
                          P("data"))(x)
    print("RESULT", json.dumps(out.numpy().view(np.int32).tolist()),
          flush=True)
""")


def _run_world(tmp_path, script: str, n_procs: int, extra_env: dict):
    """``script`` in ``n_procs`` processes joined through the launcher's
    ``RAFT_TPU_*`` world → each process's ``RESULT`` JSON."""
    (tmp_path / "world.py").write_text(script)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for i in range(n_procs):
        env = dict(os.environ, RAFT_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   RAFT_TPU_NUM_PROCS=str(n_procs), RAFT_TPU_PROC_ID=str(i),
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), **extra_env)
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp_path / "world.py")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    got = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err[-3000:])
        line = [ln for ln in out.decode().splitlines()
                if ln.startswith("RESULT ")][-1]
        got.append(json.loads(line[len("RESULT "):]))
    return got


def test_three_process_gloo_float_allreduce_in_rank_order(tmp_path):
    """A float32 sum whose value depends on the order of its terms
    ((1 + 1e8) - 1e8 is 0 in f32, (1e8 - 1e8) + 1 is 1), rotated over
    the elements so each element starts at another rank: three gloo
    processes give, bit for bit, the in-process three-rank mesh's
    rank-order sums."""
    base = np.array([1.0, 1e8, -1e8], np.float32)
    x = np.stack([np.concatenate([np.roll(base, -r), 3 * np.roll(base, r)])
                  for r in range(3)]).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    m3 = tmesh.make_mesh(devices=[CPU] * 3)
    c3 = tcomms.build_comms(m3)
    want = tmesh.shard_map(lambda v: c3.allreduce(v), m3, P("data"),
                           P("data"))(torch.from_numpy(x))
    m3.close()
    want = want.numpy().view(np.int32)
    got = _run_world(tmp_path, _FLOAT_WORKER, 3,
                     {"FLOAT_X": str(tmp_path / "x.npy")})
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(got[i])[0], want[i])


def test_two_process_gloo_equals_in_process(tmp_path):
    """Two processes join through ``initialize_distributed`` (the
    launcher's ``RAFT_TPU_*`` world, gloo on the CPU): allreduce,
    allgather, alltoall, bcast, ring_permute and reducescatter through
    ``torch.distributed`` equal the same body on an in-process two-rank
    mesh; host p2p over the store and heartbeats work across them."""
    (tmp_path / "body.py").write_text(_BODY)
    sys.path.insert(0, str(tmp_path))
    try:
        from body import collectives
    finally:
        sys.path.remove(str(tmp_path))
    m2 = tmesh.make_mesh(devices=[CPU] * 2)
    c2 = tcomms.build_comms(m2)
    want = tmesh.shard_map(lambda v: collectives(c2, v), m2, P("data"),
                           P("data"))(torch.arange(8, dtype=torch.int32)
                                      .reshape(4, 2)).numpy()
    m2.close()
    for i, got in enumerate(_run_world(tmp_path, _WORKER, 2,
                                       {"BODY_DIR": str(tmp_path)})):
        np.testing.assert_array_equal(np.asarray(got["out"])[0], want[i])
        assert got["p2p"] == f"from-{1 - i}"

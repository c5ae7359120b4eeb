"""The port's fleet over the wire (``raft_tpu_torch.fleet.transport``,
``remote``, ``proc`` and ``fleetd``) against the JAX package's, on the
CPU.

* Wire parity, in process, both ways: a port ``TransportClient`` against
  a JAX ``serve_replica`` and a JAX client against the port's: search
  answers (the ids of a direct search), the typed errors (429, 504, 503
  and 409 back to each package's own error classes), the same
  ``/rpc/wal/tail`` bytes and ``X-Raft-Wal-*`` headers, the same 410 gap
  body, the same ``/rpc/checkpoint`` bytes.
* A follower of each package bootstrapped over HTTP from a primary of
  the other, through a checkpointed fold: the primary's counters and
  ids.
* ``RemoteReplica``s of the port's router over both packages'
  transports, one of them closed mid-traffic: no failed request.
* Processes: three ``python -m raft_tpu_torch.fleet.fleetd`` daemons
  (``ProcessFleet(platform="cpu")``): a SIGKILL of the primary under
  traffic with no failed request, a promotion, writes on the new
  primary, the old primary respawned as a follower with the new
  primary's ids, the new primary killed and respawned over its own log
  with its writes.
* ``--device cuda`` on a machine without a card exits non-zero; the
  fleet modules import no JAX and nothing of ``raft_tpu``.

Data: 1500 x 16 rows around 8 centres from a numpy seed, the JAX
package's IVF-Flat build (8 lists) handed to the port by
``index_from_numpy``; every list probed, ids compared exactly, distances
across the packages within 2e-6 of ``|q|^2 + max |x|^2``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from raft_tpu import fleet as jfleet
from raft_tpu import mutate as jmutate
from raft_tpu import serve as jserve
from raft_tpu.mutate import wal as jwal
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu_torch import fleet as tfleet
from raft_tpu_torch import mutate as tmutate
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.mutate import wal as twal
from raft_tpu_torch.neighbors import ivf_flat as tflat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": types.SimpleNamespace(fleet=jfleet, mutate=jmutate,
                                 serve=jserve, wal=jwal, flat=jflat),
    "torch": types.SimpleNamespace(fleet=tfleet, mutate=tmutate,
                                   serve=tserve, wal=twal, flat=tflat),
}
BOTH = sorted(PKGS)
ACROSS = [("jax", "torch"), ("torch", "jax")]   # (server, client)
K = 4
FLAT_FIELDS = ("centers", "lists_data", "lists_indices", "lists_norms",
               "list_sizes")
_STATS = ("delta_used", "delta_live", "tombstones", "next_id", "id_base",
          "epoch")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


@pytest.fixture(scope="module")
def small_flat():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 4.0
    x = (centers[rng.integers(0, 8, 1500)]
         + rng.normal(size=(1500, 16)).astype(np.float32))
    return x, jflat.build(x, jflat.IndexParams(n_lists=8, kmeans_n_iters=3))


def _port(jidx):
    return tflat.index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in FLAT_FIELDS},
        int(jidx.metric), jidx.size, float(jidx.scale), device="cpu")


def _index(pkg, jidx):
    return jidx if pkg == "jax" else _port(jidx)


def _stats(m):
    return {k: m.stats()[k] for k in _STATS}


def _close_across(d_a, d_b, q, x):
    scale = (q * q).sum(1)[:, None] + float((x * x).sum(1).max())
    assert (np.abs(np.asarray(d_a) - np.asarray(d_b)) <= 2e-6 * scale).all()


def _raw(url, path):
    """GET → (status, body bytes, headers)."""
    try:
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.status, r.read(), dict(r.headers.items())
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers.items())


def _server(pkg, jidx, x):
    ns = PKGS[pkg]
    return ns.serve.SearchServer.from_index(
        _index(pkg, jidx), x[:8], K,
        params=ns.flat.SearchParams(n_probes=8),
        config=ns.serve.ServeConfig(batch_sizes=(1, 8), max_wait_ms=1.0))


# ---------------------------------------------------------------------------
# the wire, across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("server_pkg,client_pkg", ACROSS)
def test_search_answers_across_the_wire(small_flat, server_pkg,
                                        client_pkg):
    """One package's client, the other's transport over a real CPU
    index: the ids of a direct search on the serving side, and the same
    JSON keys and load snapshot keys from both transports."""
    x, jidx = small_flat
    srv = _server(server_pkg, jidx, x)
    tr = PKGS[server_pkg].fleet.serve_replica(searcher=srv)
    try:
        cli = PKGS[client_pkg].fleet.TransportClient(tr.url)
        for i in range(0, 48, 6):
            status, body = cli.search_raw(x[i:i + 1], k=K,
                                          deadline_ms=30_000.0)
            assert status == 200
            assert set(body) == {"distances", "ids", "partial", "load",
                                 "trace_id"}
            assert set(body["load"]) == {"queue_depth", "queued_rows",
                                         "inflight_rows", "shed_rate",
                                         "draining", "closed"}
            d, ids = srv.search(x[i:i + 1], timeout=30)
            assert body["ids"] == np.asarray(ids).tolist()
            np.testing.assert_allclose(body["distances"], np.asarray(d),
                                       rtol=1e-6)
        remote = PKGS[client_pkg].fleet.RemoteSearchClient(tr.url,
                                                           name="rc")
        try:
            d, ids = remote.submit(x[7:8], k=2).result(timeout=30)
            assert ids.shape == (1, 2) and ids.dtype == np.int32
            assert remote.load()["remote"] is True
        finally:
            remote.close()
    finally:
        tr.close()
        srv.close()


def test_search_ids_equal_across_packages(small_flat):
    """The port's daemon and the JAX package's answer one query list with
    the same ids (every list probed)."""
    x, jidx = small_flat
    got = {}
    for pkg in BOTH:
        srv = _server(pkg, jidx, x)
        tr = PKGS[pkg].fleet.serve_replica(searcher=srv)
        try:
            cli = tfleet.TransportClient(tr.url)
            rows = [cli.search_raw(x[i:i + 1], k=K)[1] for i in range(16)]
            got[pkg] = (np.asarray([r["ids"][0] for r in rows]),
                        np.asarray([r["distances"][0] for r in rows]))
        finally:
            tr.close()
            srv.close()
    np.testing.assert_array_equal(got["torch"][0], got["jax"][0])
    _close_across(got["torch"][1], got["jax"][1], x[:16], x)


class _FailingPlan:
    def __init__(self, nq, mode):
        self.nq, self.n_probes, self.mode = nq, 4, mode

    def search(self, q, block=True):
        if self.mode == "slow":
            time.sleep(0.3)
            return (np.zeros((self.nq, K), np.float32),
                    np.zeros((self.nq, K), np.int64))
        raise RuntimeError("plan exploded")


def _failing(pkg, mode, max_queue=64):
    ns = PKGS[pkg]
    ladder = ns.serve.PlanLadder((1,), (4,), {(1, 0): _FailingPlan(1, mode)},
                                 dim=4, k=K)
    return ns.serve.SearchServer(ladder, ns.serve.ServeConfig(
        batch_sizes=(1,), max_queue=max_queue, max_wait_ms=0.0))


class _Refuser:
    """A control object whose verbs refuse, as a follower refuses a
    write."""

    def state(self):
        return {"name": "x", "role": "follower", "state": "serving"}

    def upsert(self, rows, ids=None):
        raise ValueError("x is a follower — upsert goes to the primary")


@pytest.mark.parametrize("server_pkg,client_pkg", ACROSS)
def test_typed_errors_across_the_wire(server_pkg, client_pkg):
    """429, 504, 503, 409 and 404 each map back to the client package's
    own error class, whichever package serves."""
    cns, sns = PKGS[client_pkg], PKGS[server_pkg]
    q = np.zeros((1, 4), np.float32)
    seen = {}
    closed = _failing(server_pkg, "slow")
    closed.close()                              # sheds: 429
    slow = _failing(server_pkg, "slow")         # deadline: 504
    broken = _failing(server_pkg, "raise")      # anything else: 503
    trs = {name: sns.fleet.serve_replica(searcher=s, control=_Refuser())
           for name, s in (("closed", closed), ("slow", slow),
                           ("broken", broken))}
    bare = sns.fleet.serve_replica()            # no searcher, no control
    try:
        for name, exc in (("closed", cns.serve.RejectedError),
                          ("slow", cns.serve.DeadlineExceeded),
                          ("broken", cns.serve.DispatchError)):
            cli = cns.fleet.TransportClient(trs[name].url)
            if name == "slow":
                slow.submit(q)      # holds the dispatcher 0.3 s
            status, body = cli.search_raw(q, deadline_ms=50.0)
            seen[name] = (status, body["error"])
            remote = cns.fleet.RemoteSearchClient(trs[name].url)
            try:
                if name == "slow":
                    slow.submit(q)
                with pytest.raises(exc):
                    remote.search(q, deadline_ms=50.0)
            finally:
                remote.close()
        cli = cns.fleet.TransportClient(trs["broken"].url)
        assert cli.state()["role"] == "follower"
        with pytest.raises(cns.serve.DispatchError, match="HTTP 409"):
            cli.upsert(q)
        with pytest.raises(cns.serve.DispatchError, match="HTTP 404"):
            cns.fleet.TransportClient(bare.url).promote()
        assert cns.fleet.TransportClient(bare.url).search_raw(q)[0] == 404
    finally:
        for tr in list(trs.values()) + [bare]:
            tr.close()
        slow.close()
        broken.close()
    assert seen == {"closed": (429, "rejected"), "slow": (504, "deadline"),
                    "broken": (503, "dispatch")}


def test_wal_tail_and_checkpoint_bytes_equal_across(small_flat, tmp_path):
    """Both transports over one log and one checkpoint send the same
    bytes and headers: the log slice (from the start, positioned,
    bounded), the 410 gap, the checkpoint. Each package's client decodes
    the other's stream and writes the same checkpoint file."""
    x, jidx = small_flat
    wal_p, ckpt_p = str(tmp_path / "m.wal"), str(tmp_path / "m.ckpt")
    m = tmutate.MutableIndex(_port(jidx), k=K)
    m.attach_wal(twal.MutationWAL(wal_p, sync=False), checkpoint_path=ckpt_p)
    ids = m.upsert(x[:12] + 0.01)
    m.delete(np.asarray(ids[:3]))
    assert m.compact()
    m.upsert(x[20:26] + 0.04)
    m.delete([7, 9])
    trs = {pkg: PKGS[pkg].fleet.serve_replica(wal_path=wal_p,
                                              checkpoint_path=ckpt_p)
           for pkg in BOTH}
    try:
        last = twal.MutationWAL(wal_p, sync=False).replay()[-1].seq
        for path in ("/rpc/wal/tail?from_seq=0",
                     f"/rpc/wal/tail?from_seq={last - 2}&max_records=1",
                     f"/rpc/wal/tail?from_seq={last}",
                     "/rpc/wal/tail?from_seq=1"):
            got = {pkg: _raw(tr.url, path) for pkg, tr in trs.items()}
            assert got["torch"][0] == got["jax"][0], path
            assert got["torch"][1] == got["jax"][1], path
            for h in ("Content-Type", "X-Raft-Wal-Records",
                      "X-Raft-Wal-Last-Seq"):
                assert got["torch"][2].get(h) == got["jax"][2].get(h), h
        assert got["torch"][0] == 410
        assert json.loads(got["torch"][1])["error"] == "gap"
        with open(wal_p, "rb") as f:
            assert _raw(trs["torch"].url, "/rpc/wal/tail?from_seq=0")[1] \
                == f.read()
        ck = {pkg: _raw(tr.url, "/rpc/checkpoint") for pkg, tr in trs.items()}
        with open(ckpt_p, "rb") as f:
            assert ck["torch"][1] == ck["jax"][1] == f.read()
        side = json.loads(ck["torch"][2]["X-Raft-Checkpoint-Meta"])
        assert side["epoch"] == 1 and "X-Raft-Checkpoint-Meta" not in \
            ck["jax"][2]
        recs = twal.WalReader(wal_p).tail()
        for server_pkg, client_pkg in ACROSS:
            cli = PKGS[client_pkg].fleet.TransportClient(trs[server_pkg].url)
            back = cli.wal_tail(0)
            assert [(r.seq, r.op, r.ts, r.meta) for r in back] == \
                [(r.seq, r.op, r.ts, r.meta) for r in recs]
            dest = str(tmp_path / f"{client_pkg}_from_{server_pkg}.npz")
            assert cli.fetch_checkpoint(dest)
            with open(dest, "rb") as a, open(ckpt_p, "rb") as b:
                assert a.read() == b.read()
            with pytest.raises(PKGS[client_pkg].wal.WalGapError):
                cli.wal_tail(1)         # seq 2 was folded away
    finally:
        for tr in trs.values():
            tr.close()


@pytest.mark.parametrize("primary_pkg,follower_pkg", ACROSS)
def test_follower_bootstrapped_over_http_across(small_flat, tmp_path,
                                                primary_pkg, follower_pkg):
    """A primary of one package folds and takes more writes; a follower
    of the other bootstraps from its transport (checkpoint, then the
    tail) to the primary's counters and ids, and follows later writes."""
    x, jidx = small_flat
    pns, fns = PKGS[primary_pkg], PKGS[follower_pkg]
    wal_p, ckpt_p = str(tmp_path / "m.wal"), str(tmp_path / "m.ckpt")
    prim = pns.mutate.MutableIndex(_index(primary_pkg, jidx), k=K)
    prim.attach_wal(pns.wal.MutationWAL(wal_p, sync=False),
                    checkpoint_path=ckpt_p)
    ids = prim.upsert(x[:12] + 0.01)
    prim.delete(np.asarray(ids[:3]))
    assert prim.compact()
    prim.upsert(x[20:26] + 0.04)
    tr = pns.fleet.serve_replica(wal_path=wal_p, checkpoint_path=ckpt_p)
    try:
        kw = {"device": "cpu"} if follower_pkg == "torch" else {}
        m, reader, applier = fns.fleet.bootstrap_from_url(
            tr.url, K, str(tmp_path / "cache"), name="xf", **kw)
        q = x[:32]
        d_p, i_p = prim.search(q, block=True)
        d_f, i_f = m.search(q, block=True)
        assert _stats(m) == _stats(prim)
        np.testing.assert_array_equal(np.asarray(i_f), np.asarray(i_p))
        _close_across(d_f, d_p, q, x)
        prim.upsert(x[40:44] + 0.06)
        prim.delete([11])
        for rec in reader.tail():
            applier.apply(rec)
        _, i_p = prim.search(q, block=True)
        _, i_f = m.search(q, block=True)
        np.testing.assert_array_equal(np.asarray(i_f), np.asarray(i_p))
    finally:
        tr.close()


def test_router_over_both_packages_transports(small_flat):
    """The port's router over ``RemoteReplica``s of a JAX and a port
    transport; one transport closed mid-traffic: every request served."""
    x, jidx = small_flat
    srvs = {pkg: _server(pkg, jidx, x) for pkg in BOTH}
    trs = {pkg: PKGS[pkg].fleet.serve_replica(searcher=srvs[pkg])
           for pkg in BOTH}
    router = tfleet.FleetRouter(
        [tfleet.RemoteReplica(f"x_{pkg}", tr.url) for pkg, tr in trs.items()],
        tfleet.FleetConfig(max_retries=1, suspect_ms=60_000.0, seed=1))
    try:
        for i in range(8):
            router.search(x[i:i + 1], timeout=60)
        trs["jax"].close()
        for i in range(8, 24):
            _, ids = router.search(x[i:i + 1], timeout=60)
            assert ids[0, 0] == i
        assert router.suspects() in ((), ("x_jax",))
        body = router.report()
        assert {r["url"] for r in body["replicas"]} == \
            {tr.url for tr in trs.values()}
    finally:
        router.close()
        trs["torch"].close()
        for s in srvs.values():
            s.close()


# ---------------------------------------------------------------------------
# a peer that never answers
# ---------------------------------------------------------------------------


@pytest.fixture
def silent_url():
    """A port whose connections the kernel completes and nobody answers:
    a SIGKILLed daemon on the card while its device context is torn down
    (its sockets stay open until then)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    sock.listen(128)
    try:
        yield f"http://127.0.0.1:{sock.getsockname()[1]}"
    finally:
        sock.close()


def _elapsed(fn):
    t0 = time.monotonic()
    with pytest.raises(tserve.DispatchError) as e:
        fn()
    return time.monotonic() - t0, str(e.value)


def test_search_rpc_waits_no_longer_than_its_deadline(silent_url,
                                                      monkeypatch):
    """A search RPC to a silent peer gives up at its deadline plus the
    slack, not at the client's 30 s timeout; the peer then counts as down
    for ``refresh_s`` (search and load probe fail at once), and is asked
    again after it."""
    from raft_tpu_torch.fleet import remote as tremote
    monkeypatch.setattr(tremote, "_DEADLINE_SLACK_S", 0.1)
    cli = tfleet.RemoteSearchClient(silent_url, name="silent",
                                    timeout_s=30.0, refresh_s=0.5)
    q = np.zeros((1, 16), np.float32)
    try:
        took, _ = _elapsed(lambda: cli.search(q, k=K, deadline_ms=200.0))
        assert 0.25 <= took < 5.0
        took, msg = _elapsed(lambda: cli.search(q, k=K))
        assert took < 0.2 and "timed out within" in msg
        took, msg = _elapsed(cli.load)
        assert took < 0.2 and "timed out within" in msg
        time.sleep(0.6)
        took, msg = _elapsed(lambda: cli.search(q, k=K, deadline_ms=100.0))
        assert took >= 0.15 and "unreachable" in msg
    finally:
        cli.close()


def test_refused_connection_marks_no_peer_down():
    """A refused connection fails fast by itself: the next call goes to
    the wire again (a peer that sheds connections is not down)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    cli = tfleet.RemoteSearchClient(f"http://127.0.0.1:{port}",
                                    name="gone", refresh_s=60.0)
    q = np.zeros((1, 16), np.float32)
    try:
        for _ in range(2):
            took, msg = _elapsed(lambda: cli.search(q, k=K,
                                                    deadline_ms=5000.0))
            assert took < 5.0 and "unreachable" in msg
    finally:
        cli.close()


def test_router_does_not_queue_behind_a_silent_peer(small_flat,
                                                    silent_url):
    """A silent replica whose last load snapshot says idle draws traffic
    until its first RPC times out (0.5 s); the requests queued behind
    that one in its two-worker pool then fail at once and are retried on
    the live replica, instead of each waiting out a timeout of its own:
    no failed request, none slower than 1.5 s (four waves of 0.5 s
    without the down mark)."""
    x, jidx = small_flat
    srv = _server("torch", jidx, x)
    tr = tfleet.serve_replica(searcher=srv)
    silent = tfleet.RemoteReplica("silent", silent_url, timeout_s=0.5,
                                  refresh_s=30.0, pool_workers=2)
    silent.server._note_load({"load": {"queued_rows": 0,
                                       "inflight_rows": 0,
                                       "shed_rate": 0.0}})
    router = tfleet.FleetRouter(
        [silent, tfleet.RemoteReplica("live", tr.url)],
        tfleet.FleetConfig(max_retries=1, seed=3))
    lat, errors = [], []
    lock = threading.Lock()

    def traffic(t):
        for i in range(t, 32, 8):
            t0 = time.monotonic()
            try:
                _, ids = router.search(x[i:i + 1], timeout=60)
                assert ids[0, 0] == i
            except Exception as e:
                with lock:
                    errors.append(repr(e))
            with lock:
                lat.append(time.monotonic() - t0)

    threads = [threading.Thread(target=traffic, args=(t,), daemon=True)
               for t in range(8)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        router.close()
        tr.close()
        srv.close()
    assert errors == []
    assert len(lat) == 32
    assert max(lat) < 1.5, max(lat)


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def _daemon_device(pf, name):
    with open(os.path.join(pf.workdir, name, "daemon.log")) as f:
        lines = [ln for ln in f if "device " in ln and ": " in ln]
    return lines[-1].rsplit(": ", 1)[1].strip() if lines else None


def test_three_daemons_sigkill_promote_respawn(small_flat, tmp_path):
    """Three CPU daemons: the primary SIGKILLed under traffic (no failed
    request at max_retries=2), a follower promoted (its own log at the
    inherited seq), writes on it, the old primary respawned as its
    follower with the same ids, the new primary SIGKILLed and respawned
    over its own log with its writes."""
    n, dim = 800, 8
    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, dim)).astype(np.float32) * 3.0
    pf = tfleet.ProcessFleet(str(tmp_path), n_procs=3, n=n, dim=dim,
                             seed=0, n_lists=4, k=4, n_probes=4,
                             deadline_ms=20_000.0, platform="cpu",
                             startup_timeout_s=120.0)
    router = tfleet.FleetRouter(pf.replicas(), tfleet.FleetConfig(
        max_retries=2, suspect_ms=400.0, seed=0))
    try:
        assert {fp.name: _daemon_device(pf, fp.name)
                for fp in pf.processes()} == {"r0": "cpu", "r1": "cpu",
                                               "r2": "cpu"}
        # every daemon derived the same base index
        answers = {fp.name: fp.client.search_raw(q[:4], k=4)[1]["ids"]
                   for fp in pf.processes()}
        assert answers["r0"] == answers["r1"] == answers["r2"]
        for i in range(6):
            router.search(q[i:i + 1], timeout=60)

        stop = threading.Event()
        failures, done = [], [0]
        lock = threading.Lock()

        def traffic(t):
            i = t
            while not stop.is_set():
                try:
                    router.search(q[i % 64:i % 64 + 1], timeout=60)
                    with lock:
                        done[0] += 1
                except Exception as e:
                    with lock:
                        failures.append(repr(e))
                i += 3

        threads = [threading.Thread(target=traffic, args=(t,), daemon=True)
                   for t in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        pf.kill("r0")
        time.sleep(0.8)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert failures == [] and done[0] > 20

        out = pf.promote("r1")
        assert out["primary"] == "r1" and int(out["next_seq"]) >= 2
        new = pf.process("r1").client
        rows = q[:3] + 0.5
        new_ids = new.upsert(rows)
        assert len(new_ids) == 3 and min(new_ids) >= n
        assert new.delete([5]) == 1
        old = pf.respawn("r0", role="follower")
        assert old.client.state()["role"] == "follower"
        # the daemons' largest plan holds 8 rows
        probe = np.concatenate([rows, q[:5]])
        want = new.search_raw(probe, k=4)[1]["ids"]
        assert [new_ids[i] in want[i] for i in range(3)] == [True] * 3
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if old.client.search_raw(probe, k=4)[1]["ids"] == want:
                break
            time.sleep(0.1)
        assert old.client.search_raw(probe, k=4)[1]["ids"] == want

        pf.kill("r1")
        fp = pf.respawn("r1", role="primary")
        state = fp.client.state()
        assert state["role"] == "primary"
        assert int(state["wal_next_seq"]) > int(out["next_seq"])
        status, body = fp.client.search_raw(rows[:1], k=4)
        assert status == 200 and new_ids[0] in body["ids"][0]
    finally:
        router.close()
        pf.close()
    assert not any(fp.alive() for fp in pf.processes())


def test_respawn_repoints_the_federator(tmp_path):
    """F17: a daemon SIGKILLed and respawned through loadgen's chaos
    schedule is scraped by the federator at its new url, and its black
    box path is the new process's."""
    from raft_tpu_torch.obs import federation
    from raft_tpu_torch.tools import loadgen
    pf = tfleet.ProcessFleet(str(tmp_path), n_procs=3, n=800, dim=8,
                             seed=0, n_lists=4, k=4, n_probes=4,
                             deadline_ms=20_000.0, platform="cpu",
                             startup_timeout_s=120.0)
    router = tfleet.FleetRouter(pf.replicas(), tfleet.FleetConfig(
        max_retries=2, suspect_ms=400.0, seed=0))
    fed = federation.MetricsFederator(pf.urls(), interval_s=0.5,
                                      fleet=router)
    stop = threading.Event()
    try:
        assert fed.scrape_once()["errors"] == 0
        old = pf.process("r1").url
        chaos = loadgen.run_chaos_schedule(
            [(0.0, "kill_replica", "1", 0.2)], stop, router=router,
            proc_fleet=pf, federator=fed)
        chaos.join(timeout=180)
        assert not chaos.is_alive()
        fp = pf.process("r1")
        assert fp.alive() and fp.url != old
        assert fed.url_instances() == pf.urls()
        assert fed.scrape_once()["errors"] == 0
        assert fed.live_instances() == ["r0", "r1", "r2"]
        row = fed.report()["instances"]["r1"]
        assert row["state"] == "live"
        assert row["blackbox"] == os.path.join(fp.workdir, "blackbox")
    finally:
        stop.set()
        fed.close()
        router.close()
        pf.close()
    assert not any(fp.alive() for fp in pf.processes())


@pytest.fixture
def cutting_url():
    """A port that takes each request and closes its connection without
    an answer: a process killed under the request."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    sock.listen(128)
    stop = threading.Event()

    def serve():
        sock.settimeout(0.1)
        while not stop.is_set():
            try:
                conn, _ = sock.accept()
            except OSError:
                continue
            conn.settimeout(1.0)
            try:
                conn.recv(65536)
            except OSError:   # graftlint: disable=GL006
                # the close below is the point either way (justified)
                pass
            conn.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{sock.getsockname()[1]}"
    finally:
        stop.set()
        th.join(timeout=5)
        sock.close()


def test_cut_off_request_marks_the_peer_down_for_routing(cutting_url):
    """A connection closed on a request without an answer counts the
    peer down for routing for ``refresh_s``: the load probe fails at
    once (the router's duel reads +inf), while a search queued for it
    still goes to the wire (a saturated daemon drops the connections it
    has no handler thread for, and serves the next)."""
    cli = tfleet.RemoteSearchClient(cutting_url, name="cut", timeout_s=5.0,
                                    refresh_s=0.5)
    cli._note_load({"load": {"queued_rows": 0, "inflight_rows": 0,
                             "shed_rate": 0.0}})
    q = np.zeros((1, 16), np.float32)
    try:
        took, msg = _elapsed(lambda: cli.search(q, k=K))
        assert took < 2.0 and "unreachable" in msg
        took, msg = _elapsed(cli.load)
        assert took < 0.2 and "was cut off within" in msg
        took, msg = _elapsed(lambda: cli.search(q, k=K))
        assert "unreachable" in msg
        time.sleep(0.6)
        took, msg = _elapsed(cli.load)
        assert "unreachable" in msg
    finally:
        cli.close()


def test_refused_connection_drops_the_load_snapshot():
    """A refused connection marks nothing, but the snapshot of the last
    answer no longer stands for the peer: the next load probe asks (and
    is refused), where it would have reported an idle queue."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    cli = tfleet.RemoteSearchClient(f"http://127.0.0.1:{port}",
                                    name="gone", refresh_s=60.0)
    cli._note_load({"load": {"queued_rows": 0, "inflight_rows": 0,
                             "shed_rate": 0.0}})
    q = np.zeros((1, 16), np.float32)
    try:
        assert cli.load()["queued_rows"] == 0.0
        _elapsed(lambda: cli.search(q, k=K))
        took, msg = _elapsed(cli.load)
        assert "unreachable" in msg
    finally:
        cli.close()


def test_router_routes_nothing_to_a_cut_off_peer(small_flat, cutting_url):
    """A dead peer whose last load snapshot says idle wins the duels
    until a request to it is cut off; after that no request is routed
    there while the mark holds: one route to it, its retry answered by
    the live replica."""
    x, jidx = small_flat
    srv = _server("torch", jidx, x)
    tr = tfleet.serve_replica(searcher=srv)
    dead = tfleet.RemoteReplica("dead", cutting_url, refresh_s=60.0)
    dead.server._note_load({"load": {"queued_rows": 0,
                                     "inflight_rows": 0,
                                     "shed_rate": 0.0}})
    live = tfleet.RemoteReplica("live", tr.url)
    router = tfleet.FleetRouter([dead, live], tfleet.FleetConfig(
        max_retries=1, suspect_ms=0.0, seed=3))
    before = tobs.snapshot()
    try:
        live.server._note_load({"load": {"queued_rows": 64,
                                         "inflight_rows": 0,
                                         "shed_rate": 0.0}})
        for i in range(12):
            _, ids = router.search(x[i:i + 1], timeout=60)
            assert ids[0, 0] == i
    finally:
        router.close()
        tr.close()
        srv.close()
    after = tobs.snapshot()["counters"]
    routes = after.get("raft.fleet.route.total{replica=dead}", 0.0) - \
        before["counters"].get("raft.fleet.route.total{replica=dead}", 0.0)
    assert routes == 1.0


class _SlowSearcher:
    """A searcher whose searches take ``search_s`` and whose load reads
    take ``load_s``, counting the load reads."""

    def __init__(self, search_s=0.0, load_s=0.0):
        self.search_s, self.load_s = search_s, load_s
        self.load_calls = 0
        self._lock = threading.Lock()

    def search(self, queries, k=None, deadline_ms=None):
        time.sleep(self.search_s)
        n = np.asarray(queries).shape[0]
        return np.zeros((n, K), np.float32), np.zeros((n, K), np.int32)

    def load(self):
        with self._lock:
            self.load_calls += 1
        time.sleep(self.load_s)
        return {"queue_depth": 0, "queued_rows": 0, "inflight_rows": 0,
                "shed_rate": 0.0, "draining": False, "closed": False}


def test_daemon_server_answers_past_the_endpoint_bound():
    """A replica daemon's server answers 16 concurrent searches of 1.5 s
    each: none is dropped for want of a handler thread (the debug
    endpoint's bound of 8 drops those past it after 0.5 s, which a
    router reads as a failed search)."""
    tr = tfleet.serve_replica(searcher=_SlowSearcher(search_s=1.5))
    cli = tfleet.TransportClient(tr.url, timeout_s=20.0)
    q = np.zeros((1, 16), np.float32)
    out, lock = [], threading.Lock()

    def one():
        try:
            status, _ = cli.search_raw(q, k=K, timeout=20.0)
        except Exception as e:
            status = repr(e)
        with lock:
            out.append(status)

    threads = [threading.Thread(target=one, daemon=True)
               for _ in range(16)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        tr.close()
    assert out == [200] * 16, out


def test_load_probes_are_coalesced():
    """Sixteen threads that find no snapshot share one load probe: the
    peer answers one ``GET /rpc/load`` and every caller gets its
    snapshot."""
    srv = _SlowSearcher(load_s=0.3)
    tr = tfleet.serve_replica(searcher=srv)
    cli = tfleet.RemoteSearchClient(tr.url, name="probed", refresh_s=60.0)
    try:
        cli.load()
        per_probe = srv.load_calls
        assert per_probe >= 1
        with cli._lock:
            cli._snap = None
        srv.load_calls = 0
        got, lock = [], threading.Lock()

        def one():
            snap = cli.load()
            with lock:
                got.append(snap["queued_rows"])

        threads = [threading.Thread(target=one, daemon=True)
                   for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert got == [0.0] * 16
        assert srv.load_calls == per_probe
    finally:
        cli.close()
        tr.close()


def test_rows_handed_to_a_silent_peer_weigh_on_its_load(silent_url,
                                                        monkeypatch):
    """Rows this client has handed to a peer and not had back count in
    its load, whatever its last snapshot said: with one pool worker,
    three 2-row requests to a silent peer read as 2 rows in flight and
    4 queued, and the count returns to 0 once they fail."""
    from raft_tpu_torch.fleet import remote as tremote
    monkeypatch.setattr(tremote, "_DEADLINE_SLACK_S", 0.1)
    cli = tfleet.RemoteSearchClient(silent_url, name="silent",
                                    timeout_s=30.0, refresh_s=60.0,
                                    pool_workers=1)
    cli._note_load({"load": {"queued_rows": 0, "inflight_rows": 0,
                             "shed_rate": 0.0}})
    q = np.zeros((2, 16), np.float32)
    try:
        futs = [cli.submit(q, k=K, deadline_ms=500.0) for _ in range(3)]
        time.sleep(0.2)
        snap = cli.load()
        assert snap["inflight_rows"] == 2.0
        assert snap["queued_rows"] == pytest.approx(4.0, abs=1e-3)
        for f in futs:
            with pytest.raises(tserve.DispatchError):
                f.result(timeout=30)
        with cli._lock:
            assert cli._waiting_rows == 0 and cli._wire_rows == 0
    finally:
        cli.close()


def test_primary_sigkilled_mid_burst_fails_no_request(tmp_path):
    """The card's SIGKILL of the primary, on three CPU daemons, under a
    burst routed with one retry: the primary first stops answering with
    its sockets open (SIGSTOP: a process killed on the card keeps them
    open while its device context is torn down), then the SIGKILL closes
    every connection still waiting on it without an answer, and a
    follower is promoted. No request fails."""
    n, dim = 800, 8
    rng = np.random.default_rng(5)
    q = rng.normal(size=(64, dim)).astype(np.float32) * 3.0
    pf = tfleet.ProcessFleet(str(tmp_path), n_procs=3, n=n, dim=dim,
                             seed=0, n_lists=4, k=4, n_probes=4,
                             deadline_ms=60_000.0, platform="cpu",
                             startup_timeout_s=120.0)
    router = tfleet.FleetRouter(
        pf.replicas(timeout_s=10.0, pool_workers=4),
        tfleet.FleetConfig(max_retries=1, seed=1))
    stop = threading.Event()
    failures, done = [], [0]
    lock = threading.Lock()

    def traffic(t):
        i = t
        while not stop.is_set():
            try:
                router.search(q[i % 64:i % 64 + 1], timeout=60)
                with lock:
                    done[0] += 1
            except Exception as e:
                with lock:
                    failures.append(repr(e))
            i += 8

    threads = [threading.Thread(target=traffic, args=(t,), daemon=True)
               for t in range(8)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)
        os.kill(pf.process("r0").pid, signal.SIGSTOP)
        time.sleep(1.5)
        pf.kill("r0")
        assert pf.promote("r1")["primary"] == "r1"
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert failures == [], failures[:3]
        assert done[0] > 50
    finally:
        stop.set()
        router.close()
        pf.close()
    assert not any(fp.alive() for fp in pf.processes())


def test_fleetd_refuses_cuda_without_a_card(tmp_path):
    """``--device cuda`` where no card is visible: a non-zero exit before
    anything is built or served."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    port_file = str(tmp_path / "port")
    out = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.fleet.fleetd",
         "--device", "cuda", "--port-file", port_file],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not os.path.exists(port_file)


def test_fleet_imports_no_jax():
    code = ("import sys; import raft_tpu_torch.fleet, "
            "raft_tpu_torch.fleet.fleetd; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'raft_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

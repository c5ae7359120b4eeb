"""The port's fault injection and serving failure path
(``raft_tpu_torch.testing.faults``, the watchdog and retries of
``raft_tpu_torch.serve``) against the JAX package's
(``tests/test_faults.py``), with fake plans (no device work) and one
real IVF-Flat plan on the CPU.

Every scenario runs through both packages' ``SearchServer``; each
future must resolve alike (the result, or the exception's type) and
every ``raft.serve.*`` counter that both packages count must move by
the same amount. Timing is asserted as order with a margin of at least
3x (the deadline fails before a third of the retry budget has passed),
so a loaded machine does not flake it.
"""

import importlib
import time
import types

import numpy as np
import pytest

from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.testing import faults as jfaults
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.testing import faults

PKGS = {"jax": types.SimpleNamespace(serve=jserve, obs=jobs, faults=jfaults),
        "torch": types.SimpleNamespace(serve=tserve, obs=tobs,
                                       faults=faults)}


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _gauge(series):
    return tobs.snapshot()["gauges"].get(series, 0.0)


def _serve_deltas(before, after):
    """Delta of each ``raft.serve.*`` counter family (labels summed)."""
    out = {}
    for snap, sign in ((after, 1), (before, -1)):
        for series, v in snap["counters"].items():
            name = series.split("{", 1)[0]
            if name.startswith("raft.serve."):
                out[name] = out.get(name, 0.0) + sign * v
    return {k: v for k, v in out.items() if v}


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


class TestHarness:
    def test_inactive_is_noop(self):
        assert not faults.active()
        faults.inject("serve.execute", shape=8)

    def test_error_delay_scope_and_reset(self):
        with faults.inject_fault("site.a", action="error") as rule:
            assert faults.active()
            with pytest.raises(faults.FaultError):
                faults.inject("site.a")
            assert rule.hits == 1
            faults.inject("site.b")
        assert not faults.active()
        faults.inject("site.a")
        t0 = time.perf_counter()
        with faults.inject_fault("site.d", action="delay", seconds=0.05):
            faults.inject("site.d")
        assert time.perf_counter() - t0 >= 0.05

    def test_label_matching_scalar_and_containment(self):
        with faults.inject_fault("s", match={"ranks": 3}) as rule:
            faults.inject("s", ranks=(0, 1, 2))
            with pytest.raises(faults.FaultError):
                faults.inject("s", ranks=(2, 3))
            faults.inject("s")
            assert rule.hits == 1

    def test_max_hits_and_seeded_probability(self):
        with faults.inject_fault("s", max_hits=2) as rule:
            for _ in range(2):
                with pytest.raises(faults.FaultError):
                    faults.inject("s")
            faults.inject("s")
            assert rule.hits == 2

        def fires(seed):
            out = []
            with faults.inject_fault("p", probability=0.5, seed=seed):
                for _ in range(32):
                    try:
                        faults.inject("p")
                        out.append(False)
                    except faults.FaultError:
                        out.append(True)
            return out

        assert fires(7) == fires(7)
        assert any(fires(7)) and not all(fires(7))

    def test_stall_shard_raises_and_clears_suspect_gauge(self):
        series = 'raft.comms.health.suspect_rank{rank="5",session="chaos"}'
        with faults.stall_shard(5, seconds=0.01, session="chaos"):
            assert _gauge(series) == 0      # raised on the first hit
            faults.inject("serve.dist.dispatch", ranks=(4, 5))
            assert _gauge(series) == 1
        assert _gauge(series) == 0


# ---------------------------------------------------------------------------
# the failure path, scenario by scenario, through either package
# ---------------------------------------------------------------------------


class _FlakyPlan:
    """Fails the first ``fail_n`` dispatches (raising ``exc`` or
    returning ``status``), then serves row i's first value as its ids."""

    def __init__(self, nq, fail_n=0, exc=None, status=None, delay=0.0,
                 partial=False):
        self.nq, self.n_probes, self.k = nq, 8, 4
        self.fail_n, self.exc, self.status = fail_n, exc, status
        self.delay, self.calls = delay, 0
        if partial:
            self.partial, self.coverage = True, 0.5

    def search(self, q, block=True):
        self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        if self.calls <= self.fail_n:
            if self.status is not None:
                return self.status
            raise self.exc("injected")
        marker = np.asarray(q)[:, :1]
        return (np.repeat(marker.astype(np.float32), self.k, axis=1),
                np.repeat(marker.astype(np.int64), self.k, axis=1))


def _rows(n, base=0):
    out = np.zeros((n, 4), np.float32)
    out[:, 0] = np.arange(base, base + n, dtype=np.float32)
    return out


def _outcome(fut):
    try:
        r = fut.result(timeout=30)
    except Exception as e:
        return type(e).__name__
    return ("ok", type(r).__name__, int(r[1][0, 0]),
            getattr(r, "partial", False))


def _server(ns, plan_kw=None, poison=0, start=True, **cfg):
    """A server over fake plans at shapes (1, 4); ``poison`` makes that
    many ``plan_for`` calls raise (outside the dispatch path)."""
    kw = dict(plan_kw or {})
    if "exc" in kw:
        kw["exc"] = getattr(ns.serve, kw["exc"], None) or RuntimeError

    class Ladder(ns.serve.PlanLadder):
        boom = poison

        def plan_for(self, rows, rung):
            if self.boom:
                self.boom -= 1
                raise RuntimeError("poisoned ladder")
            return super().plan_for(rows, rung)

    ladder = Ladder(shapes=(1, 4), rungs=(8,), dim=4, k=4,
                    plans={(s, 0): _FlakyPlan(s, **kw) for s in (1, 4)})
    cfg.setdefault("max_wait_ms", 0.0)
    return ns.serve.SearchServer(
        ladder, ns.serve.ServeConfig(batch_sizes=(1, 4), **cfg), start=start)


def _then_ok(srv, first, base):
    """``first``'s outcome, then a fresh request's: the dispatcher lives
    on."""
    return [_outcome(first), _outcome(srv.submit(_rows(1, base=base)))]


def _deadline_in_backoff(ns, times):
    srv = _server(ns, dict(fail_n=99, exc="ShardFailedError"), start=False,
                  max_wait_ms=5.0, max_retries=2, retry_backoff_ms=400.0,
                  retry_backoff_mult=1.0)
    try:
        t0 = time.perf_counter()
        f_dead = srv.submit(_rows(1, base=1), deadline_ms=300.0)
        f_live = srv.submit(_rows(1, base=2))
        srv.start()
        out = [_outcome(f_dead)]
        times.append(time.perf_counter() - t0)
        out.append(_outcome(f_live))
        times.append(time.perf_counter() - t0)
        return out
    finally:
        srv.close()


def _with(srv, run):
    try:
        return run(srv)
    finally:
        srv.close()


# name -> f(ns, times) -> the outcomes of the scenario's requests
SCENARIOS = {
    "timeout": lambda ns, t: _with(_server(
        ns, dict(delay=1.0), dispatch_timeout_ms=100.0),
        lambda s: [_outcome(s.submit(_rows(1)))]),
    "retry_success": lambda ns, t: _with(_server(
        ns, dict(fail_n=2, exc="ShardFailedError"), max_retries=2,
        retry_backoff_ms=5.0), lambda s: [_outcome(s.submit(_rows(1, 42)))]),
    "exhausted": lambda ns, t: _with(_server(
        ns, dict(fail_n=3, exc="ShardFailedError"), max_retries=2,
        retry_backoff_ms=1.0),
        lambda s: _then_ok(s, s.submit(_rows(1)), 5)),
    "abort_status": lambda ns, t: _with(_server(
        ns, dict(fail_n=1, status=types.SimpleNamespace(name="ABORT"))),
        lambda s: _then_ok(s, s.submit(_rows(1, 7)), 9)),
    "not_retried": lambda ns, t: _with(_server(
        ns, dict(fail_n=1, exc="RuntimeError"), max_retries=3,
        dispatch_timeout_ms=1000.0),
        lambda s: _then_ok(s, s.submit(_rows(1)), 6)),
    "deadline_in_backoff": _deadline_in_backoff,
    "crash_guard": lambda ns, t: _with(_server(ns, poison=1), lambda s: (
        _then_ok(s, s.submit(_rows(1)), 3))),
    "injected_delay": lambda ns, t: _with(_server(
        ns, dispatch_timeout_ms=200.0, max_retries=1, retry_backoff_ms=1.0),
        lambda s: _injected(ns, s)),
    "partial": lambda ns, t: _with(_server(ns, dict(partial=True)),
                                   lambda s: [_outcome(s.submit(_rows(2)))]),
}


def _injected(ns, srv):
    with ns.faults.delay_execute(1000.0, max_hits=1) as rule:
        out = [_outcome(srv.submit(_rows(1, base=11)))]
    return out + [rule.hits]


def _run(pkg, scenario):
    ns = PKGS[pkg]
    times = []
    before = ns.obs.snapshot()
    outcomes = SCENARIOS[scenario](ns, times)
    return outcomes, _serve_deltas(before, ns.obs.snapshot()), times


# the port's outcomes and counter deltas (the JAX package must agree:
# test_failure_path_matches_jax)
EXPECTED = {
    "timeout": (["ShardFailedError"], {
        "raft.serve.dispatch.timeouts.total": 1,
        "raft.serve.retry.exhausted.total": 1,
        "raft.serve.errors.total": 1}),
    "retry_success": ([("ok", "tuple", 42, False)], {
        "raft.serve.retry.total": 2, "raft.serve.retry.success.total": 1,
        "raft.serve.completed.total": 1}),
    "exhausted": (["ShardFailedError", ("ok", "tuple", 5, False)], {
        "raft.serve.retry.total": 2, "raft.serve.retry.exhausted.total": 1,
        "raft.serve.completed.total": 1}),
    "abort_status": (["ShardFailedError", ("ok", "tuple", 9, False)], {
        "raft.serve.retry.exhausted.total": 1,
        "raft.serve.completed.total": 1}),
    "not_retried": (["RuntimeError", ("ok", "tuple", 6, False)], {
        "raft.serve.errors.total": 1, "raft.serve.completed.total": 1}),
    "deadline_in_backoff": (["DeadlineExceeded", "ShardFailedError"], {
        "raft.serve.deadline.total": 1, "raft.serve.retry.total": 2,
        "raft.serve.retry.exhausted.total": 1}),
    "crash_guard": (["DispatchError", ("ok", "tuple", 3, False)], {
        "raft.serve.dispatcher.errors": 1, "raft.serve.completed.total": 1}),
    "injected_delay": ([("ok", "tuple", 11, False), 1], {
        "raft.serve.dispatch.timeouts.total": 1,
        "raft.serve.retry.total": 1, "raft.serve.retry.success.total": 1}),
    "partial": ([("ok", "SearchResult", 0, True)], {
        "raft.serve.failover.partial.total": 1}),
}


class TestWatchdogAndRetry:
    @pytest.mark.parametrize("scenario", sorted(EXPECTED))
    def test_outcomes_and_counters(self, scenario):
        outcomes, deltas, _ = _run("torch", scenario)
        want_out, want_deltas = EXPECTED[scenario]
        assert outcomes == want_out
        for name, v in want_deltas.items():
            assert deltas.get(name, 0) == v, (name, deltas)
        if scenario == "retry_success":
            assert "raft.serve.retry.exhausted.total" not in deltas
        if scenario == "not_retried":     # never a retry, never a timeout
            assert not {"raft.serve.retry.total",
                        "raft.serve.dispatch.timeouts.total"} & set(deltas)

    def test_deadline_fails_before_the_retry_budget_drains(self):
        """Deadline 300 ms inside the first 400 ms backoff: the request
        fails at the first failure, with 2 x 400 ms of retries to come
        for its batch-mate."""
        _, _, (t_dead, t_live) = _run("torch", "deadline_in_backoff")
        assert t_dead * 3 < 2 * 0.4 <= t_live, (t_dead, t_live)

    def test_real_plan_through_the_watchdog(self):
        """An IVF-Flat plan on the CPU, served through the helper thread
        under an injected timeout and a retry, gives a direct
        ``plan.search``'s ids."""
        from raft_tpu_torch.neighbors import ivf_flat
        rng = np.random.default_rng(0)
        x = rng.normal(size=(600, 8)).astype(np.float32)
        index = ivf_flat.build(x, ivf_flat.IndexParams(
            n_lists=8, kmeans_n_iters=2), device="cpu")
        srv = tserve.SearchServer.from_index(
            index, x[:8], 5, ivf_flat.SearchParams(n_probes=4),
            tserve.ServeConfig(batch_sizes=(8,), max_wait_ms=0.0,
                               dispatch_timeout_ms=300.0, max_retries=1,
                               retry_backoff_ms=1.0))
        try:
            with faults.delay_execute(1500.0, max_hits=1):
                d, i = srv.search(x[:8], timeout=30)
            _, i_ref = srv.ladder.plan_for(8, 0)[1].search(x[:8])
            np.testing.assert_array_equal(i, i_ref.numpy())
        finally:
            srv.close()


def test_crash_guard_logs_alike():
    """The crash guard logs one ERROR line through each package's
    logger; a callback sink on the singleton sees the same level and
    text from the port's subsystem logger."""
    # the modules (each package's core exports the singleton under the
    # module's name)
    jlog, tlog = (importlib.import_module(f"{p}.core.logger")
                  for p in ("raft_tpu", "raft_tpu_torch"))
    seen = {}
    for pkg, log in (("jax", jlog), ("torch", tlog)):
        got = seen[pkg] = []
        # the line without its time stamp ("[time] [LEVEL] message")
        log.set_callback(lambda lvl, msg, got=got: got.append(
            (lvl, msg.split("] ", 1)[1])))
        try:
            _run(pkg, "crash_guard")
        finally:
            log.set_callback(None)
    assert seen["torch"] == seen["jax"]
    assert [lvl for lvl, _ in seen["torch"]] == [tlog.ERROR]
    assert "crash guard" in seen["torch"][0][1]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_failure_path_matches_jax(scenario):
    port_out, port_d, _ = _run("torch", scenario)
    ref_out, ref_d, _ = _run("jax", scenario)
    assert port_out == ref_out
    port_names, ref_names = ({n.split("{", 1)[0] for n in o.snapshot()[
        "counters"]} for o in (tobs, jobs))
    shared = (port_d.keys() | ref_d.keys()) & port_names & ref_names
    assert set(EXPECTED[scenario][1]) <= shared
    assert {n: port_d.get(n, 0) for n in shared} == \
        {n: ref_d.get(n, 0) for n in shared}

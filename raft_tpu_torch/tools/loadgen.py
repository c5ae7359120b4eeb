"""Open-loop load generator for ``raft_tpu_torch.serve`` (counterpart of
the JAX package's ``tools/loadgen.py``; the same arguments, plus
``--device``).

Closed-loop clients (each waiting for its answer before sending the
next) cannot overload a server: their arrival rate collapses to the
service rate, hiding every queueing pathology. This tool generates
OPEN-loop traffic: Poisson arrivals at a configured rate, submitted
through ``SearchServer.submit`` without waiting, deadlines optional,
the arrival process a population of independent users presents. Run it
as a module; it serves on the card unless ``--device cpu``:

    # steady load against a synthetic index
    python -m raft_tpu_torch.tools.loadgen --rate 200 --duration 5

    # the overload demo: calibrate sustainable throughput, then offer
    # 2x it and watch the degradation ladder hold p99 while n_probes
    # (and recall) step down, and step back up as the queue drains
    python -m raft_tpu_torch.tools.loadgen --demo

    # three replicas behind a router, one killed mid-run, each with a
    # black box the doctor reads back
    python -m raft_tpu_torch.tools.loadgen --fleet 3 \
        --chaos kill_replica:1@t+5s+30s --blackbox /tmp/bb

    # three fleetd daemons, one SIGKILLed, a federating aggregator
    python -m raft_tpu_torch.tools.loadgen --fleet-procs 3 --federate \
        --blackbox on --chaos kill_replica:1@t+8s+30s

``--server dist`` serves the mesh-wide tier: the index list-sharded
over a mesh of every card, one rank each, or of eight logical ranks on
a lone card or (``--device cpu``) the CPU, through a
``DistributedSearchServer`` with the int8 cross-shard merge; with
``--chaos`` it also pre-warms the partial-mesh failover. Its report
gains ``merge_bytes_per_rung``.

Reports land as one JSON line: offered/completed/shed/deadline counts,
achieved QPS, accepted-latency p50/p99, and the ``raft.serve.*``
metrics diff of the run (batch occupancy, degrade steps, per-level
batch counts).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time
from typing import Optional

import numpy as np

# logical ranks of the --server dist mesh on a lone card or the CPU
DIST_LOGICAL_RANKS = 8


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a sequence."""
    if not xs:
        return float("nan")
    xs = sorted(xs)
    rank = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[rank]


def parse_chaos_spec(spec: str, default_duration_s: float = 5.0):
    """Parse a chaos schedule like ``stall_shard:3@t+10s,
    kill_compactor@t+20s`` → sorted ``(t_offset_s, kind, arg,
    duration_s)`` events. Grammar per event:
    ``<kind>[:<arg>]@t+<seconds>s[+<duration>s]`` with kinds
    ``stall_shard`` (arg = rank), ``kill_compactor``,
    ``fail_transfer`` (arg = times, default 1), ``delay_execute``
    (arg = ms) and ``kill_replica`` (arg = replica index; requires
    ``--fleet`` or ``--fleet-procs``: the replica dies without draining
    at the offset and is revived after the duration)."""
    known = ("stall_shard", "kill_compactor", "fail_transfer",
             "delay_execute", "kill_replica")
    events = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name_arg, _, when = part.partition("@")
        if not when.startswith("t+"):
            raise ValueError(f"chaos event {part!r}: need '@t+<sec>s'")
        when = when[2:]
        dur = default_duration_s
        if "+" in when:
            when, dur_s = when.split("+", 1)
            dur = float(dur_s.rstrip("s"))
        t_off = float(when.rstrip("s"))
        kind, _, arg = name_arg.partition(":")
        if kind not in known:
            raise ValueError(f"chaos event {part!r}: unknown kind "
                             f"{kind!r} (known: {', '.join(known)})")
        events.append((t_off, kind, arg or None, dur))
    return sorted(events)


def run_chaos_schedule(events, stop: threading.Event,
                       router=None, revive_fn=None,
                       proc_fleet=None, federator=None) -> threading.Thread:
    """Drive the fault harness on a schedule: a daemon thread enters
    each event's scope at its offset and exits it after its duration
    (or when ``stop`` is set: faults never outlive the run).
    ``kill_replica`` events need ``router`` (a
    :class:`raft_tpu_torch.fleet.FleetRouter`); ``revive_fn()`` builds
    the replacement server the killed replica rejoins with after the
    event's duration (None = the replica stays dead). With
    ``proc_fleet`` (a :class:`raft_tpu_torch.fleet.ProcessFleet`) the
    kill is a real ``SIGKILL`` to the replica's OS process: the router
    is told nothing and must discover the death through dispatch errors
    (suspect → re-route), and the revival is a real respawn (the router
    replica re-points at the new process's url, and so does
    ``federator``, a :class:`raft_tpu_torch.obs.federation.MetricsFederator`
    over the fleet, with the new process's black-box path)."""
    from contextlib import ExitStack, contextmanager
    from raft_tpu_torch.testing import faults

    @contextmanager
    def _replica_kill(idx):
        rep = router.replicas[int(idx)]
        rep.kill()      # no drain — a crash, not a deploy
        try:
            yield
        finally:
            if revive_fn is not None:
                rep.begin_bootstrap()
                rep.set_server(revive_fn())
                rep.mark_serving()

    @contextmanager
    def _proc_kill(idx):
        from raft_tpu_torch.fleet import RemoteSearchClient
        name = f"r{int(idx)}"
        role = proc_fleet.process(name).role
        proc_fleet.kill(name)       # SIGKILL — the real thing
        try:
            yield
        finally:
            # respawn the slot (a promoted/primary slot restarts over
            # its own WAL; a follower re-bootstraps over the wire) and
            # re-point the router's replica at the NEW process
            fp = proc_fleet.respawn(name, role=role)
            rep = router.replica(name)
            rep.mark_down()
            rep.begin_bootstrap()
            rep.set_server(RemoteSearchClient(fp.url, name=name))
            rep.mark_serving()
            if federator is not None:
                # the respawn listens on a new port: scrape it there
                federator.add_instance(name, fp.url)
                federator.set_blackbox_path(
                    name, os.path.join(fp.workdir, "blackbox"))

    def _enter(stack, kind, arg, dur):
        if kind == "stall_shard":
            return stack.enter_context(
                faults.stall_shard(int(arg), seconds=max(dur, 30.0)))
        if kind == "kill_compactor":
            return stack.enter_context(faults.kill_compactor())
        if kind == "fail_transfer":
            return stack.enter_context(
                faults.fail_transfer(times=int(arg or 1)))
        if kind == "kill_replica":
            if proc_fleet is not None:
                return stack.enter_context(_proc_kill(int(arg or 0)))
            if router is None:
                raise ValueError("chaos kill_replica needs --fleet "
                                 "or --fleet-procs")
            return stack.enter_context(_replica_kill(int(arg or 0)))
        return stack.enter_context(
            faults.delay_execute(float(arg or 10.0)))

    def loop():
        t0 = time.perf_counter()
        live = []      # (deadline, stack)
        pending = list(events)
        while (pending or live) and not stop.is_set():
            now = time.perf_counter() - t0
            while pending and pending[0][0] <= now:
                t_off, kind, arg, dur = pending.pop(0)
                stack = ExitStack()
                _enter(stack, kind, arg, dur)
                live.append((t_off + dur, stack))
            for deadline, stack in list(live):
                if now >= deadline:
                    stack.close()
                    live.remove((deadline, stack))
            time.sleep(0.02)
        for _, stack in live:
            stack.close()

    t = threading.Thread(target=loop, daemon=True, name="raft-chaos")
    t.start()
    return t


def run_open_loop(server, query_pool: np.ndarray, rate_qps: float,
                  duration_s: float, nq: int = 1,
                  k: Optional[int] = None,
                  deadline_ms: Optional[float] = None,
                  seed: int = 0, drain_timeout_s: float = 60.0,
                  mutator=None, mutate_frac: float = 0.0) -> dict:
    """Offer Poisson traffic at ``rate_qps`` requests/s for
    ``duration_s``; every request draws ``nq`` consecutive rows from
    ``query_pool``. With ``mutator`` (a
    :class:`raft_tpu_torch.mutate.MutableIndex`) and ``mutate_frac`` > 0,
    each arrival is a WRITE with that probability instead — an upsert
    of one pool row (or, every 4th write, a delete of a previously
    upserted id): the mixed read/write traffic a live corpus actually
    sees. Returns the accounting + latency report."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.serve import DeadlineExceeded, RejectedError

    rng = random.Random(seed)
    pool_n = query_pool.shape[0]
    lock = threading.Lock()
    latencies, outcomes = [], {"ok": 0, "partial": 0, "shed": 0,
                               "deadline": 0, "error": 0}
    writes = {"upserts": 0, "deletes": 0, "write_rejects": 0}
    written_ids = []
    pending = []
    before = obs.snapshot()
    t0 = time.perf_counter()
    t_next = t0
    offered = 0
    while True:
        now = time.perf_counter()
        if now - t0 >= duration_s:
            break
        if now < t_next:
            time.sleep(min(t_next - now, 0.005))
            continue
        t_next += rng.expovariate(rate_qps)
        s = rng.randrange(0, max(1, pool_n - nq))
        if mutator is not None and rng.random() < mutate_frac:
            # mutation arrival: inline host-side apply (mutations are
            # lock + numpy + one async transfer: microseconds)
            from raft_tpu_torch.mutate import DeltaFullError
            try:
                if written_ids and writes["upserts"] % 4 == 3:
                    writes["deletes"] += mutator.delete(
                        [written_ids.pop(0)])
                else:
                    ids = mutator.upsert(query_pool[s:s + 1])
                    written_ids.append(int(ids[0]))
                    writes["upserts"] += 1
            except DeltaFullError:
                writes["write_rejects"] += 1
            continue
        t_sub = time.perf_counter()
        fut = server.submit(query_pool[s:s + nq], k=k,
                            deadline_ms=deadline_ms)
        offered += 1

        def _done(f, t_sub=t_sub):
            try:
                res = f.result()
            except RejectedError:
                kind = "shed"
            except DeadlineExceeded:
                kind = "deadline"
            except Exception:
                kind = "error"
            else:
                # a flagged-partial answer (a degraded mesh) is
                # availability, counted separately from full results
                kind = ("partial" if getattr(res, "partial", False)
                        else "ok")
            with lock:
                outcomes[kind] += 1
                if kind in ("ok", "partial"):
                    latencies.append(time.perf_counter() - t_sub)

        fut.add_done_callback(_done)
        pending.append(fut)
    # drain: every future must resolve (no hangs is part of the serving
    # contract — a stuck future here is a bug, not load)
    deadline = time.perf_counter() + drain_timeout_s
    for f in pending:
        try:
            f.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:
            pass
    wall = time.perf_counter() - t0
    diff = obs.snapshot_diff(before, obs.snapshot())
    with lock:
        answered = outcomes["ok"] + outcomes["partial"]
        report = {
            "offered": offered,
            "offered_qps": round(offered / wall, 1),
            "completed": answered,
            "partial": outcomes["partial"],
            "shed": outcomes["shed"],
            "deadline_expired": outcomes["deadline"],
            "errors": outcomes["error"],
            # availability = answered (full or flagged-partial) over
            # everything offered: the chaos runs' acceptance figure
            "availability": round(answered / max(1, offered), 6),
            "partial_fraction": round(
                outcomes["partial"] / max(1, answered), 6),
            "achieved_qps": round(answered * nq / wall, 1),
            "p50_ms": round(percentile(latencies, 50) * 1e3, 2),
            "p99_ms": round(percentile(latencies, 99) * 1e3, 2),
            "serve_metrics": {
                k_: v for k_, v in diff.get("counters", {}).items()
                if k_.startswith("raft.serve.")},
        }
        if mutator is not None and mutate_frac > 0:
            report["mutate"] = dict(
                writes, mutate_metrics={
                    k_: v for k_, v in diff.get("counters", {}).items()
                    if k_.startswith("raft.mutate.")})
        tiered = tiered_report(diff)
        if tiered is not None:
            report["tiered"] = tiered
    return report


def tiered_report(diff: dict) -> Optional[dict]:
    """Tiered-serving columns out of a run's counters diff: tier hit
    rate, the fraction of the cold-fetch wall hidden under the hot-tier
    scan, and the achieved transfer bandwidth. None when no tiered index
    served the run."""
    from raft_tpu_torch import obs
    cnt = diff.get("counters", {})

    def c(name):
        return sum(v for k_, v in cnt.items()
                   if k_.split("{")[0] == name)

    hot = c("raft.tiered.probes.hot")
    cold = c("raft.tiered.probes.cold")
    if hot + cold <= 0:
        return None
    fetch_b = c("raft.tiered.fetch.bytes")
    fetch_s = c("raft.tiered.fetch.seconds")
    overlap_s = c("raft.tiered.overlap.seconds")
    g = obs.snapshot()["gauges"]
    return {
        "hit_rate": round(hot / (hot + cold), 4),
        "overlap_frac": (round(overlap_s / fetch_s, 4)
                         if fetch_s > 0 else None),
        "fetch_mb": round(fetch_b / 1e6, 2),
        "fetch_mb_s": (round(fetch_b / 1e6 / fetch_s, 1)
                       if fetch_s > 0 else None),
        "promotions": int(c("raft.tiered.promotions.total")),
        "demotions": int(c("raft.tiered.demotions.total")),
        "budget_mb": round(
            g.get("raft.tiered.budget.bytes", 0.0) / 2 ** 20, 2),
        "hot_lists": int(g.get("raft.tiered.hot.lists", 0.0)),
    }


def measure_sustainable_qps(server, query_pool: np.ndarray, nq: int = 1,
                            seconds: float = 1.0) -> float:
    """Closed-loop calibration: one caller in a tight loop, the serving
    rate with zero queueing. The overload demo offers a multiple of
    this."""
    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() - t0 < seconds:
        server.search(query_pool[done % 8: done % 8 + nq])
        done += 1
    return done / (time.perf_counter() - t0)


def dist_devices(device) -> list:
    """The ``--server dist`` mesh's devices: every card once when there
    are several, else :data:`DIST_LOGICAL_RANKS` logical ranks on the
    one card, or on the CPU when it is asked for."""
    import torch
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * DIST_LOGICAL_RANKS
    from raft_tpu_torch.core.resources import Resources
    Resources(dev)  # raises without a card
    n = torch.cuda.device_count()
    if n > 1:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * DIST_LOGICAL_RANKS


def _blobs(n: int, dim: int, device):
    """The demo's synthetic corpus and 512-row query pool (two seeds, one
    centre count) → ``(x on device, queries as host numpy)``."""
    from raft_tpu_torch.random import make_blobs
    x, _ = make_blobs(n_samples=n, n_features=dim,
                      centers=max(8, n // 200), seed=0, device=device)
    q, _ = make_blobs(n_samples=512, n_features=dim,
                      centers=max(8, n // 200), seed=1, device=device)
    return x, q.cpu().numpy()


def _build_demo_server(n: int, dim: int, n_lists: int, k: int,
                       probes_ladder, deadline_ms: float,
                       server: str = "single",
                       mutate_frac: float = 0.0,
                       chaos: bool = False,
                       quality_sample: float = 0.0,
                       tiered_frac: Optional[float] = None,
                       device="cuda"):
    from raft_tpu_torch import serve
    from raft_tpu_torch.neighbors import ivf_flat

    x, q = _blobs(n, dim, device)
    cfg = serve.ServeConfig(
        batch_sizes=(1, 8, 32), max_queue=256, max_wait_ms=2.0,
        probes_ladder=tuple(probes_ladder),
        default_deadline_ms=deadline_ms,
        degrade_watermark_ms=200.0, upgrade_watermark_ms=20.0,
        degrade_cooldown_ms=50.0,
        # chaos runs exercise the failure handling: the watchdog and the
        # retry budget
        dispatch_timeout_ms=500.0 if chaos else 0.0,
        max_retries=2 if chaos else 0,
        # and, on the mesh, the pre-warmed partial-mesh failover
        failover=bool(chaos and server == "dist"),
        failover_probe_ms=500.0,
        # reservoir-sample served queries for shadow-exact recall: the
        # live-recall column
        quality_sample_rate=quality_sample)
    if server == "dist":
        # the mesh-wide tier: the index list-sharded over the mesh,
        # served through the distributed ladder with the int8 merge
        from raft_tpu_torch.parallel import make_mesh, shard_ivf_flat
        mesh = make_mesh(devices=dist_devices(device))
        n_shards = mesh.shape["data"]
        if n_lists % n_shards:
            n_lists = max(n_shards, n_lists // n_shards * n_shards)
        index = ivf_flat.build(x, ivf_flat.IndexParams(
            n_lists=n_lists, kmeans_n_iters=4), device=device)
        params = ivf_flat.SearchParams(n_probes=probes_ladder[0])
        srv = serve.DistributedSearchServer.from_sharded_index(
            shard_ivf_flat(index, mesh), q[:32], k=k, params=params,
            mesh=mesh, config=cfg)
        if quality_sample > 0:
            srv.enable_quality(x)
        return srv, q, None
    index = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=n_lists,
                                                   kmeans_n_iters=4),
                           device=device)
    params = ivf_flat.SearchParams(n_probes=probes_ladder[0])
    if tiered_frac is not None:
        # the tiered demo: pin hot_frac of the list payload in device
        # memory, stage the rest from host RAM under the hot-tier scan;
        # the report gains a 'tiered' section (hit rate, overlap
        # fraction, fetch MB/s)
        from raft_tpu_torch.neighbors import tiered
        tindex = tiered.from_index(
            index, tiered.TieredConfig(hot_frac=tiered_frac))
        srv = serve.SearchServer.from_index(tindex, q[:32], k=k,
                                            params=params, config=cfg)
        if quality_sample > 0:
            srv.enable_quality(x)
        return srv, q, None
    if mutate_frac > 0:
        # mixed read/write traffic: serve a MutableIndex and run a
        # background compactor; writes land in the delta segment, the
        # open loop interleaves them with searches
        from raft_tpu_torch import mutate
        mindex = mutate.MutableIndex(index, k=k, params=params)
        srv = serve.SearchServer.from_index(mindex, q[:32], k=k,
                                            config=cfg)
        if quality_sample > 0:
            # the ground truth is the pre-mutation corpus; the epoch
            # listener still compares fold against fold
            srv.enable_quality(x)
        return srv, q, mindex
    srv = serve.SearchServer.from_index(index, q[:32], k=k,
                                        params=params, config=cfg)
    if quality_sample > 0:
        srv.enable_quality(x)
    return srv, q, None


def _build_fleet(n: int, dim: int, n_lists: int, k: int,
                 probes_ladder, deadline_ms: float, n_replicas: int,
                 chaos: bool = False,
                 tiered_frac: Optional[float] = None,
                 device="cuda"):
    """N single-host replicas over ONE built index behind a
    :class:`raft_tpu_torch.fleet.FleetRouter` (the one-card fleet: real
    deployments put each replica on its own card; here they share it,
    and the index). Returns ``(router, query_pool, build_server_fn)``:
    ``build_server_fn`` is what a ``kill_replica`` chaos event revives
    with."""
    from raft_tpu_torch import fleet, serve
    from raft_tpu_torch.neighbors import ivf_flat

    x, q = _blobs(n, dim, device)
    index = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=n_lists,
                                                   kmeans_n_iters=4),
                           device=device)
    del x
    if tiered_frac is not None:
        # one shared TieredIndex: every replica serves the same
        # placement, so the per-replica federation rows show the same
        # tiered gauges (an index a replica is the real deployment)
        from raft_tpu_torch.neighbors import tiered
        index = tiered.from_index(
            index, tiered.TieredConfig(hot_frac=tiered_frac))
    params = ivf_flat.SearchParams(n_probes=probes_ladder[0])
    cfg = serve.ServeConfig(
        batch_sizes=(1, 8, 32), max_queue=256, max_wait_ms=2.0,
        probes_ladder=tuple(probes_ladder),
        default_deadline_ms=deadline_ms)

    def build_server():
        return serve.SearchServer.from_index(index, q[:32], k=k,
                                             params=params, config=cfg)

    reps = [fleet.Replica(f"r{i}", build_server())
            for i in range(n_replicas)]
    router = fleet.FleetRouter(
        reps, fleet.FleetConfig(max_retries=max(1, int(chaos)),
                                suspect_ms=500.0 if chaos else 2000.0,
                                default_deadline_ms=deadline_ms))
    return router, q, build_server


def profile_report(router=None) -> Optional[dict]:
    """Resource-observability columns for a loadgen report: the measured
    duty cycle and peak device memory of the run, the columns that say
    whether shed traffic was a HOST bottleneck (low duty cycle: the card
    sat idle while the queue grew) or a DEVICE one (duty cycle ~1). With
    a fleet ``router``, adds the per-replica duty cycles. None when the
    profiler is not attached (``--profile-sample 0``)."""
    from raft_tpu_torch.obs import profiler
    rep = profiler.report()
    if not rep.get("enabled"):
        return None
    hbm_peak = max((d.get("peak_bytes", 0) or 0
                    for d in rep["hbm"].values()), default=0)
    out = {
        "duty_cycle": rep["duty_cycle"],
        "hbm_peak_mb": round(hbm_peak / 2 ** 20, 2),
        "device_s": rep["device_s"],
        "host_s": rep["host_s"],
        "sample_rate": rep["rate"],
    }
    if router is not None:
        out["per_replica"] = {
            row["name"]: row.get("duty_cycle")
            for row in router.report()["replicas"]}
    return out


def fleet_route_share(counters_diff: dict) -> dict:
    """Per-replica route share out of a counters diff (the
    ``raft.fleet.route.total{replica=...}`` series)."""
    routes = {}
    for key, v in counters_diff.items():
        if key.startswith("raft.fleet.route.total{"):
            name = key.split("replica=")[1].rstrip("}").split(",")[0]
            routes[name] = routes.get(name, 0) + int(v)
    total = max(1, sum(routes.values()))
    return {name: round(c / total, 4)
            for name, c in sorted(routes.items())}


def merge_bytes_by_rung(metrics_diff: dict) -> dict:
    """Per-rung compressed merge bytes out of a ``raft.serve.*`` counters
    diff (the ``raft.serve.dist.merge.bytes_post{level=r}`` series): what
    each degradation rung costs on the wire, next to p99."""
    out = {}
    for key, v in metrics_diff.items():
        if key.startswith("raft.serve.dist.merge.bytes_post{"):
            level = key.split("level=")[1].rstrip("}").split(",")[0]
            out[f"rung_{level}"] = out.get(f"rung_{level}", 0) + int(v)
    return out


def _run_fleet_procs(args, chaos_events, ladder) -> int:
    """The ``--fleet-procs N`` run: N replica daemons as OS processes
    (``python -m raft_tpu_torch.fleet.fleetd``, on ``--device``) behind
    RemoteReplicas and one FleetRouter. The same open loop, but a
    ``kill_replica`` chaos event is a real SIGKILL, the federation
    section scrapes N distinct registries, and the dead replica's
    forensics are ITS OWN process's crash-durable black box, read back
    through the doctor."""
    import tempfile

    from raft_tpu_torch import fleet, obs
    from raft_tpu_torch.random import make_blobs

    workdir = tempfile.mkdtemp(prefix="raft_loadgen_procs_")
    chaos = bool(chaos_events)
    if args.blackbox:
        # daemons flush their boxes on a tight cadence, so even a short
        # run's SIGKILL leaves recent records on disk
        os.environ.setdefault("RAFT_TPU_BLACKBOX_INTERVAL", "0.5")
    if args.device == "cuda":
        # build every kernel here once: the daemons (and a respawn) only
        # load them
        from raft_tpu_torch.ops import _build
        _build.build_all()
    pf = fleet.ProcessFleet(
        workdir, n_procs=args.fleet_procs, n=args.n, dim=args.dim,
        seed=args.seed, n_lists=args.n_lists, k=args.k,
        n_probes=min(ladder), deadline_ms=args.deadline_ms or 5000.0,
        platform=args.device, blackbox=bool(args.blackbox))
    router = fleet.FleetRouter(
        pf.replicas(),
        fleet.FleetConfig(max_retries=max(1, int(chaos)),
                          suspect_ms=500.0 if chaos else 2000.0))
    # the daemons built their index from the same (n, dim, seed,
    # n_lists) blobs on the same device: regenerate the pool to query
    # in-distribution
    x, _ = make_blobs(n_samples=args.n, n_features=args.dim,
                      centers=max(2, args.n_lists), cluster_std=2.0,
                      seed=args.seed, device=args.device)
    q = x.cpu().numpy()
    del x
    federator, agg = None, None
    if args.federate:
        # each process owns a separate registry: federation sums
        # distinct instances (unlike the in-process --fleet run, where
        # every endpoint exports one registry)
        from raft_tpu_torch.obs import federation as _federation
        federator = _federation.MetricsFederator(
            pf.urls(), interval_s=0.5, fleet=router).start()
        for fp in pf.processes():
            federator.set_blackbox_path(
                fp.name, os.path.join(fp.workdir, "blackbox"))
        agg = obs.serve(federator=federator, fleet=router)
    stop = threading.Event()
    chaos_t = (run_chaos_schedule(chaos_events, stop, router=router,
                                  proc_fleet=pf, federator=federator)
               if chaos_events else None)
    before = obs.snapshot()
    try:
        report = run_open_loop(
            router, q, rate_qps=args.rate, duration_s=args.duration,
            nq=args.nq, deadline_ms=args.deadline_ms or None,
            seed=args.seed)
    finally:
        stop.set()
        if chaos_t is not None:
            chaos_t.join(timeout=60.0)
    diff = obs.snapshot_diff(before, obs.snapshot())
    cnt = diff.get("counters", {})
    report["fleet"] = {
        "replicas": args.fleet_procs,
        "processes": pf.describe()["processes"],
        "route_share": fleet_route_share(cnt),
        "retries": int(sum(
            v for k_, v in cnt.items()
            if k_.startswith("raft.fleet.retry.total"))),
        "unroutable": int(sum(
            v for k_, v in cnt.items()
            if k_.startswith("raft.fleet.unroutable.total"))),
        "killed": int(sum(
            v for k_, v in cnt.items()
            if k_.startswith("raft.fleet.proc.killed.total"))),
    }
    if chaos_events:
        report["chaos"] = {"schedule": args.chaos}
    if federator is not None:
        federator.scrape_once()
        fed_rep = federator.report()
        # each instance's OWN raft.plan.cache.misses: the fleet-wide
        # no-compile check reads these rows
        misses = {}
        for fam in federator.merged():
            if fam.name == "raft_plan_cache_misses_total":
                for s in fam.samples:
                    inst = dict(s.labels).get("instance")
                    if inst:
                        misses[inst] = misses.get(inst, 0) \
                            + int(s.value)
        report["federation"] = {
            "instances": {name: row["state"] for name, row
                          in fed_rep["instances"].items()},
            "stale": federator.stale_instances(),
            "plan_cache_misses_by_instance": misses,
            "instances_share_registry": False,
            "scrape_overhead_frac":
                fed_rep["scrape_overhead"]["frac"],
        }
    if args.blackbox and chaos_events and any(
            e[1] == "kill_replica" for e in chaos_events):
        # the post-mortem across a process boundary: the SIGKILLed
        # daemon's own crash-durable dump, read back through the
        # offline doctor from its workdir
        from raft_tpu_torch.tools import doctor as _doctor
        killed = [e for e in chaos_events if e[1] == "kill_replica"]
        name = f"r{int(killed[0][2] or 0)}"
        dump_dir = os.path.join(workdir, name, "blackbox")
        try:
            diag = _doctor.diagnose_dump(dump_dir)
            report["blackbox"] = {
                "dir": workdir,
                "killed_replica": {
                    "name": name, "dump_dir": dump_dir,
                    "dump_readable": diag["records"] > 0,
                    "verdict": diag["verdict"],
                },
            }
        except Exception as e:
            report["blackbox"] = {"dir": workdir,
                                  "killed_replica": {
                                      "name": name, "error": repr(e)}}
    print(json.dumps(report), flush=True)
    router.close()
    if federator is not None:
        federator.close()
        agg.close()
    pf.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000,
                    help="synthetic index rows")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--n-lists", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nq", type=int, default=1,
                    help="queries per request")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="offered request rate (Poisson, requests/s)")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--deadline-ms", type=float, default=0.0)
    ap.add_argument("--probes-ladder", type=str, default="32,16,8",
                    help="comma-separated descending n_probes rungs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--server", choices=("single", "dist"),
                    default="single",
                    help="serving tier: 'single' = one-device "
                         "SearchServer; 'dist' = DistributedSearchServer "
                         "over a mesh of every card (eight logical "
                         "ranks on a lone card or the CPU), the index "
                         "list-sharded, the int8 merge")
    ap.add_argument("--fleet", type=int, default=0,
                    help="serve through N replica servers behind a "
                         "power-of-two-choices FleetRouter: the report "
                         "gains per-replica route shares; combine with "
                         "--chaos kill_replica:<i>@t+... for the "
                         "availability-through-replica-kill row. The "
                         "replicas share this process's card; real "
                         "fleets put each on its own")
    ap.add_argument("--federate", action="store_true",
                    help="with --fleet: one debug endpoint per replica "
                         "plus a federating aggregator over them; the "
                         "report gains a 'federation' section (fleet "
                         "QPS from summed counters vs the router's, "
                         "per-instance staleness, the aggregator's "
                         "scrape overhead). In-process replicas share "
                         "ONE registry, so the summed/router ratio "
                         "reads ~N: the sum semantics made visible. "
                         "With --fleet-procs each daemon's own "
                         "registry is scraped")
    ap.add_argument("--tiered", type=float, default=None,
                    metavar="HOT_FRAC",
                    help="serve a TieredIndex pinning HOT_FRAC of the "
                         "list payload in device memory; cold lists "
                         "stage from host RAM under the hot-tier scan "
                         "and the report gains a 'tiered' section (hit "
                         "rate, overlap fraction, fetch MB/s). Composes "
                         "with --fleet (replicas share one placement) "
                         "and --federate")
    ap.add_argument("--mutate-frac", type=float, default=0.0,
                    help="fraction of arrivals that are WRITES "
                         "(upsert/delete against a MutableIndex with a "
                         "background compactor) instead of searches: "
                         "mixed read/write traffic; single server only")
    ap.add_argument("--quality-sample", type=float, default=None,
                    help="shadow-exact recall sampling rate in [0, 1]: "
                         "sampled queries replay through an exact "
                         "scorer off the serving path and the report "
                         "gains a live_recall column (default: 0, or "
                         "0.25 under --demo)")
    ap.add_argument("--profile-sample", type=float, default=None,
                    help="resource-profiler sampling rate in [0, 1]: "
                         "sampled dispatches split host vs device time "
                         "and the report gains duty_cycle/hbm_peak_mb "
                         "columns, with per-replica rows under --fleet "
                         "(default: 0, or 0.25 under --demo)")
    ap.add_argument("--demo", action="store_true",
                    help="overload demo: offer 2x the calibrated "
                         "sustainable rate and show the ladder holding "
                         "p99 while recall steps down; the report "
                         "includes live recall and the SLO burn rates")
    ap.add_argument("--chaos", type=str, default=None,
                    help="fault schedule driven during the run, e.g. "
                         "'delay_execute:50@t+1s,kill_compactor@t+2s' "
                         "(kinds: stall_shard:<rank>, kill_compactor, "
                         "fail_transfer[:times], delay_execute:<ms>, "
                         "kill_replica:<i>). Enables the watchdog and "
                         "the retry budget; the report carries "
                         "availability, partial fraction and the "
                         "raft.serve.retry.* diffs")
    ap.add_argument("--chaos-duration", type=float, default=5.0,
                    help="default duration (s) of each chaos event "
                         "without an explicit '+<dur>s' suffix")
    ap.add_argument("--blackbox", type=str, default=None,
                    help="black-box dump directory: attach the "
                         "metrics-history sampler and a crash-durable "
                         "black box for the run and write a dump at "
                         "run end. Under --fleet each replica gets its "
                         "own box at <dir>/<name> (flushed by "
                         "Replica.kill: a --chaos kill_replica's dump "
                         "is read back through the doctor in the "
                         "report); under --fleet-procs each daemon "
                         "keeps its own at <workdir>/<name>/blackbox")
    ap.add_argument("--fleet-procs", type=int, default=0,
                    help="serve through N replica DAEMONS (OS "
                         "processes running raft_tpu_torch.fleet."
                         "fleetd behind the fleet RPC transport) with "
                         "RemoteReplicas under one FleetRouter. --chaos "
                         "kill_replica:<i> sends a real SIGKILL to the "
                         "process (respawned after the event's "
                         "duration); --federate scrapes each process's "
                         "own /metrics; --blackbox reads the dead "
                         "process's crash-durable dump back through "
                         "the doctor")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="build and serve on the card (default) or, "
                         "only when asked, the CPU")
    args = ap.parse_args(argv)
    if args.tiered is not None and not 0.0 <= args.tiered <= 1.0:
        ap.error("--tiered HOT_FRAC must be in [0, 1]")
    if args.tiered is not None and (args.server == "dist"
                                    or args.mutate_frac):
        ap.error("--tiered rides the single-device (or --fleet) "
                 "SearchServer path: --server dist / --mutate-frac "
                 "compose at the library level, not in this tool")
    if args.mutate_frac and args.server == "dist":
        ap.error("--mutate-frac rides the single-device server "
                 "(DistributedSearchServer.from_mutable is the "
                 "library-level mesh path)")
    if args.fleet and (args.server == "dist" or args.mutate_frac
                       or args.demo):
        ap.error("--fleet rides the plain single-server open loop "
                 "(each replica is its own SearchServer; --server "
                 "dist / --mutate-frac / --demo compose at the "
                 "library level, not in this tool)")
    if args.fleet and args.fleet < 2:
        ap.error("--fleet needs >= 2 replicas (1 replica is just "
                 "--server single)")
    if args.fleet_procs and args.fleet:
        ap.error("--fleet-procs replaces --fleet (processes, not "
                 "in-process replicas): pick one")
    if args.fleet_procs and args.fleet_procs < 2:
        ap.error("--fleet-procs needs >= 2 processes (1 process is "
                 "just --server single behind a port)")
    if args.fleet_procs and (args.server == "dist" or args.mutate_frac
                             or args.demo or args.tiered is not None):
        ap.error("--fleet-procs rides the plain open loop over "
                 "remote replicas (--server dist / --mutate-frac / "
                 "--demo / --tiered compose at the library level, "
                 "not in this tool)")
    if args.federate and not (args.fleet or args.fleet_procs):
        ap.error("--federate aggregates replica endpoints: it needs "
                 "--fleet N or --fleet-procs N")
    chaos_events = (parse_chaos_spec(args.chaos, args.chaos_duration)
                    if args.chaos else None)
    if chaos_events and any(e[1] in ("kill_compactor", "fail_transfer")
                            for e in chaos_events) \
            and not args.mutate_frac:
        ap.error("--chaos kill_compactor/fail_transfer need a mutable "
                 "serving path: add --mutate-frac (> 0)")
    if chaos_events and any(e[1] == "kill_replica"
                            for e in chaos_events) \
            and not (args.fleet or args.fleet_procs):
        ap.error("--chaos kill_replica needs --fleet N or "
                 "--fleet-procs N")
    if args.fleet_procs and chaos_events and any(
            e[1] != "kill_replica" for e in chaos_events):
        ap.error("--fleet-procs chaos supports kill_replica only "
                 "(in-process fault hooks cannot reach another "
                 "process)")
    if chaos_events and args.demo:
        ap.error("--chaos rides the plain open-loop run (the demo's "
                 "calibration phase would skew the event offsets)")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            ap.error("--device cuda: no CUDA device here (pass "
                     "--device cpu to run on the CPU)")

    ladder = tuple(int(s) for s in args.probes_ladder.split(","))
    quality_sample = (args.quality_sample if args.quality_sample
                      is not None else (0.25 if args.demo else 0.0))
    profile_sample = (args.profile_sample if args.profile_sample
                      is not None else (0.25 if args.demo else 0.0))
    if profile_sample > 0:
        from raft_tpu_torch.obs import profiler
        profiler.enable_profiling(profile_sample)
    if args.fleet_procs:
        # the multi-process fleet: real daemons, real SIGKILLs, one
        # registry a process
        return _run_fleet_procs(args, chaos_events, ladder)
    if args.fleet:
        # the fleet front door: N replicas, one router; run_open_loop
        # drives it unchanged (the same submit() shape)
        from raft_tpu_torch import obs
        router, q, build_server = _build_fleet(
            args.n, args.dim, args.n_lists, args.k, ladder,
            args.deadline_ms, args.fleet, chaos=bool(chaos_events),
            tiered_frac=args.tiered, device=args.device)
        endpoints, federator, agg = [], None, None
        if args.federate:
            # one scrape target per replica and one aggregator
            # federating them. The replicas share this process's
            # registry, so each endpoint exports the same body: the
            # federated sum reads ~N x the router's own counters, the
            # sum semantics shown, not a bug (reported below as
            # instances_share_registry)
            from raft_tpu_torch.obs import federation as _federation
            endpoints = [obs.serve() for _ in range(args.fleet)]
            federator = _federation.MetricsFederator(
                {f"r{i}": e.url for i, e in enumerate(endpoints)},
                interval_s=0.5, fleet=router).start()
            agg = obs.serve(federator=federator, fleet=router)
        boxes = {}
        if args.blackbox:
            # one box per replica, so a kill_replica chaos kill leaves
            # ITS forensics behind: Replica.kill() flushes the attached
            # box on the death path. The history cadence scales with the
            # run length, so even a sub-second run banks a few frames.
            from raft_tpu_torch.obs import blackbox as _blackbox
            from raft_tpu_torch.obs import history as _history
            _history.enable_history(
                interval_s=min(1.0, max(0.1, args.duration / 20.0)))
            for rep in router.replicas:
                box = _blackbox.BlackBox(
                    os.path.join(args.blackbox, rep.name),
                    box=rep.name, history=_history.history(),
                    fleet=router).start()
                rep.set_blackbox(box)
                if federator is not None:
                    federator.set_blackbox_path(rep.name, box.dir)
                boxes[rep.name] = box
        stop = threading.Event()
        chaos_t = (run_chaos_schedule(chaos_events, stop,
                                      router=router,
                                      revive_fn=build_server)
                   if chaos_events else None)
        before = obs.snapshot()
        try:
            report = run_open_loop(
                router, q, rate_qps=args.rate,
                duration_s=args.duration, nq=args.nq,
                deadline_ms=args.deadline_ms or None, seed=args.seed)
        finally:
            stop.set()
            if chaos_t is not None:
                chaos_t.join(timeout=10.0)
        diff = obs.snapshot_diff(before, obs.snapshot())
        cnt = diff.get("counters", {})
        report["fleet"] = {
            "replicas": args.fleet,
            "route_share": fleet_route_share(cnt),
            "retries": int(sum(
                v for k_, v in cnt.items()
                if k_.startswith("raft.fleet.retry.total"))),
            "unroutable": int(sum(
                v for k_, v in cnt.items()
                if k_.startswith("raft.fleet.unroutable.total"))),
            "serving_at_end": obs.snapshot()["gauges"].get(
                "raft.fleet.replicas.serving", 0.0),
        }
        if chaos_events:
            report["chaos"] = {"schedule": args.chaos}
        if federator is not None:
            # one final sweep, so the section reflects end-of-run
            # counters and its cost is measured explicitly
            t_sweep = time.perf_counter()
            federator.scrape_once()
            final_scrape_s = time.perf_counter() - t_sweep
            fed_rep = federator.report()
            summed = 0.0
            for fam in federator.merged():
                if fam.name == "raft_serve_completed_total_total":
                    summed += sum(
                        s.value for s in fam.samples
                        if all(k_ != "instance" for k_, _ in s.labels))
            router_total = obs.snapshot()["counters"].get(
                "raft.serve.completed.total", 0.0)
            report["federation"] = {
                "instances": {name: row["state"] for name, row
                              in fed_rep["instances"].items()},
                "stale": federator.stale_instances(),
                "fleet_completed_summed": int(summed),
                "router_completed_total": int(router_total),
                "summed_over_router_ratio": round(
                    summed / max(1.0, router_total), 3),
                "instances_share_registry": True,
                "scrape_overhead_frac":
                    fed_rep["scrape_overhead"]["frac"],
                "final_scrape_s": round(final_scrape_s, 6),
            }
            federator.close()
            agg.close()
            for e in endpoints:
                e.close()
        prof = profile_report(router)
        if prof is not None:
            report["profile"] = prof
        if boxes:
            from raft_tpu_torch.obs import history as _history
            for box in boxes.values():
                box.close()     # final flush + seal: the run's dump
            _history.disable_history()
            bb = {"dir": os.path.abspath(args.blackbox),
                  "replicas": {n: b.dir for n, b in boxes.items()}}
            killed = [e for e in (chaos_events or ())
                      if e[1] == "kill_replica"]
            if killed:
                # the post-mortem: the killed replica's dump read back
                # through the offline doctor, the dump a crashed
                # process would have left
                from raft_tpu_torch.tools import doctor as _doctor
                name = f"r{int(killed[0][2] or 0)}"
                diag = _doctor.diagnose_dump(boxes[name].dir)
                downs = [t for t in diag["transitions"]
                         if t["replica"] == name and t["to"] == "down"]
                bb["killed_replica"] = {
                    "name": name,
                    "dump_readable": diag["records"] > 0,
                    "verdict": diag["verdict"],
                    "final_transition": downs[-1] if downs else None,
                    "final_window_deltas": len(
                        diag["final_window"]["counter_deltas"]),
                }
            report["blackbox"] = bb
        print(json.dumps(report), flush=True)
        router.close()
        return 0
    srv, q, mindex = _build_demo_server(
        args.n, args.dim, args.n_lists, args.k, ladder,
        args.deadline_ms, server=args.server,
        mutate_frac=args.mutate_frac, chaos=bool(chaos_events),
        quality_sample=quality_sample, tiered_frac=args.tiered,
        device=args.device)
    comp = None
    if mindex is not None:
        from raft_tpu_torch import mutate
        comp = mutate.Compactor(mindex)
    ambient_box = None
    if args.blackbox:
        # single-server run: one ambient box (the --fleet path above
        # keeps one box per replica instead)
        from raft_tpu_torch.obs import blackbox as _blackbox
        from raft_tpu_torch.obs import history as _history
        _history.enable_history(
            interval_s=min(1.0, max(0.1, args.duration / 20.0)))
        ambient_box = _blackbox.enable_blackbox(
            args.blackbox, exit_hooks=False)
    slo_tracker = None
    if args.demo:
        # declarative SLOs over the run: the p99 watermark,
        # availability and, when sampling is on, the recall floor, each
        # as multi-window burn rates in the final report
        from raft_tpu_torch.obs import slo as _slo
        objectives = [
            _slo.Objective("p99_watermark", "latency", target=0.99,
                           threshold_ms=srv.config.degrade_watermark_ms,
                           windows=(5.0, 15.0)),
            _slo.Objective("availability", "availability",
                           target=0.999, windows=(5.0, 15.0)),
        ]
        if srv.quality is not None:
            objectives.append(_slo.Objective(
                "recall_floor", "recall", target=0.5, tolerance=0.05,
                windows=(5.0, 15.0)))
        slo_tracker = _slo.SLOTracker(objectives, poll_s=0.5)
    try:
        if args.demo:
            from raft_tpu_torch import obs
            sustainable = measure_sustainable_qps(srv, q, nq=args.nq)
            rate = 2.0 * sustainable
            print(json.dumps({"phase": "calibrate",
                              "sustainable_qps": round(sustainable, 1),
                              "offered_qps": round(rate, 1)}),
                  flush=True)
            report = run_open_loop(
                srv, q, rate_qps=rate, duration_s=args.duration,
                nq=args.nq, deadline_ms=args.deadline_ms or None,
                seed=args.seed, mutator=mindex,
                mutate_frac=args.mutate_frac)
            report["phase"] = "overload"
            report["watermark_ms"] = srv.config.degrade_watermark_ms
            report["p99_under_watermark"] = (
                report["p99_ms"] <= srv.config.degrade_watermark_ms)
            if srv.quality is not None:
                # live recall: the shadow-exact estimate over the
                # sampled window, next to the p99 it was bought at
                srv.quality.drain(10.0)
                report["live_recall"] = srv.quality.stats()
            if slo_tracker is not None:
                report["slo"] = {
                    name: {"burn": o["burn"], "breach": o["breach"]}
                    for name, o in slo_tracker.tick().items()}
            if args.server == "dist":
                # what each degradation rung cost on the wire, beside
                # the p99 it bought
                report["merge_bytes_per_rung"] = merge_bytes_by_rung(
                    report["serve_metrics"])
            prof = profile_report()
            if prof is not None:
                # host- vs device-bound: the overload verdict's cause
                report["profile"] = prof
            print(json.dumps(report), flush=True)
            # drain: the ladder must step back up once load stops
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 5.0:
                lvl = obs.snapshot()["gauges"].get(
                    "raft.serve.degrade.level", 0.0)
                if lvl == 0:
                    break
                time.sleep(0.05)
            print(json.dumps({"phase": "drain",
                              "degrade_level": lvl,
                              "recovered": lvl == 0}), flush=True)
        else:
            stop = threading.Event()
            chaos_t = (run_chaos_schedule(chaos_events, stop)
                       if chaos_events else None)
            try:
                report = run_open_loop(
                    srv, q, rate_qps=args.rate,
                    duration_s=args.duration, nq=args.nq,
                    deadline_ms=args.deadline_ms or None,
                    seed=args.seed, mutator=mindex,
                    mutate_frac=args.mutate_frac)
            finally:
                stop.set()
                if chaos_t is not None:
                    chaos_t.join(timeout=10.0)
            if srv.quality is not None:
                srv.quality.drain(10.0)
                report["live_recall"] = srv.quality.stats()
            if chaos_events:
                from raft_tpu_torch import obs
                g = obs.snapshot()["gauges"]
                report["chaos"] = {
                    "schedule": args.chaos,
                    "failover_engaged_at_end": g.get(
                        "raft.serve.failover.engaged", 0.0),
                    "compactor_failing_at_end": g.get(
                        "raft.mutate.compactor.failing", 0.0),
                }
            if args.server == "dist":
                report["merge_bytes_per_rung"] = merge_bytes_by_rung(
                    report["serve_metrics"])
            prof = profile_report()
            if prof is not None:
                report["profile"] = prof
            if ambient_box is not None:
                report["blackbox"] = {"dir": ambient_box.dir}
            print(json.dumps(report), flush=True)
    finally:
        if slo_tracker is not None:
            slo_tracker.close()
        if comp is not None:
            comp.close()
        srv.close()
        if ambient_box is not None:
            # the run-end dump: final flush + seal, then detach
            from raft_tpu_torch.obs import blackbox as _blackbox
            from raft_tpu_torch.obs import history as _history
            _blackbox.disable_blackbox()
            _history.disable_history()
    return 0


if __name__ == "__main__":
    sys.exit(main())

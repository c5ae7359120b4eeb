"""fleetd: one replica of a multi-process fleet, as a daemon (counterpart
of the JAX package's ``tools/fleetd.py``; the same arguments, plus
``--device``).

Run it as ``python -m raft_tpu_torch.fleet.fleetd``. It serves one
``SearchServer`` over a ``MutableIndex`` built from a deterministic
dataset: every process derives the SAME base index from
``--n/--dim/--seed/--n-lists`` on ``--device`` (the port's fixed-order
sums make the build bit-identical across processes on the card), so a
follower's bootstrap can start from it before the primary's first fold.
Behind it, a :class:`~raft_tpu_torch.fleet.transport.ReplicaTransport`:
ONE port for the ``/rpc/*`` routes and the whole debug endpoint
(``/metrics``, ``/healthz``, ``/debug/*``).

``--device cuda`` (the default) runs on the card and exits non-zero on a
machine without one; it never serves on the CPU. The log names the card
(``torch.cuda.get_device_name()``). The kernels load from
``raft_tpu_torch/_build/``, built there once by the spawner.

Roles:

* ``--role primary`` — owns the mutation WAL (``--wal``): recovers over
  it when it exists (a restart over its own log) or starts it fresh;
  serves ``/rpc/wal/tail`` and ``/rpc/checkpoint`` and accepts
  ``/rpc/upsert`` and ``/rpc/delete``.
* ``--role follower --primary-url URL`` — bootstraps over the wire
  (checkpoint and tail, :func:`raft_tpu_torch.fleet.remote.
  bootstrap_from_url`) and keeps a
  :class:`~raft_tpu_torch.fleet.replication.Replicator` tailing the
  primary; writes are refused with 409.

``POST /rpc/promote`` completes a failover in place: the follower closes
its replicator, opens its OWN WAL at the inherited ``next_seq``
(``MutationWAL(start_seq=...)``) and folds once, which writes the
checkpoint and a meta-headed log. A caught-up peer retargeted here then
resumes tailing contiguously, a peer behind gets the typed 410 gap, and a
restart of this process over its own log (``--role primary``) gives the
same state, writes included.

The spawner's handshake: bind (``--port 0``, ephemeral, by default),
write the bound port to ``--port-file``, serve until SIGTERM/SIGINT (or
``POST /rpc/stop``), then drain, log the kernel launches of the
daemon's life (``ops.launch_counts()``, also in every ``/rpc/state``
answer) and exit 0.

``--blackbox <dir>`` gives the daemon a crash-durable black box
(:class:`raft_tpu_torch.obs.blackbox.BlackBox`, named after ``--name``):
it flushes on its cadence (``RAFT_TPU_BLACKBOX_INTERVAL``), on a
promotion and at a clean exit, so a SIGKILLed daemon leaves its last
cadence flush for the doctor (``python -m raft_tpu_torch.tools.doctor
<dir>``).
"""

import argparse
import json
import logging
import os
import signal
import sys
import threading

def build_args(argv=None):
    ap = argparse.ArgumentParser(
        description="raft_tpu_torch fleet replica daemon")
    ap.add_argument("--name", default="r0")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (written to --port-file)")
    ap.add_argument("--port-file", default=None)
    ap.add_argument("--role", choices=("primary", "follower"),
                    default="primary")
    ap.add_argument("--primary-url", default=None,
                    help="bootstrap/replication target (follower)")
    ap.add_argument("--wal", default="mutations.wal",
                    help="this replica's OWN log (primary now, or "
                         "after promotion)")
    ap.add_argument("--checkpoint", default="checkpoint.npz")
    ap.add_argument("--cache-dir", default=".",
                    help="bootstrap checkpoint download cache")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-lists", type=int, default=8)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--n-probes", type=int, default=8)
    ap.add_argument("--batch-sizes", default="1,8")
    ap.add_argument("--deadline-ms", type=float, default=5000.0)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=1.0)
    ap.add_argument("--sync-wal", action="store_true",
                    help="fsync every WAL append (durability over "
                         "smoke-test speed)")
    ap.add_argument("--blackbox", default=None,
                    help="crash-durable black-box directory: cadence "
                         "flushes (RAFT_TPU_BLACKBOX_INTERVAL), one on "
                         "promote and one at exit")
    ap.add_argument("--device", default="cuda",
                    help="the torch device to build and serve on "
                         "(default cuda; cpu only when asked)")
    ap.add_argument("--log-level", default="INFO")
    return ap.parse_args(argv)


class Daemon:
    """The transport's ``control`` object and the process's lifecycle.

    The control verbs run on transport handler threads; a ``ValueError``
    raised here maps to HTTP 409 (a refused transition), anything else
    to 503. Promotion and retarget are serialised by ``_lock`` (the GL003
    contract below).
    """

    # static race contract (tools/graftlint GL003): handler threads
    # (promote/retarget/stop/writes) and the main thread meet here
    GUARDED_BY = ("_role", "_replicator", "_promoting")

    def __init__(self, args, mindex, server, replicator, blackbox=None):
        self.args = args
        self.name = args.name
        self.m = mindex
        self.server = server
        self._lock = threading.Lock()
        self._role = args.role
        self._replicator = replicator
        self._promoting = False
        self._blackbox = blackbox
        self.transport = None          # installed by main()
        self.stop_event = threading.Event()

    # -- introspection -----------------------------------------------------
    def state(self):
        from raft_tpu_torch import ops
        with self._lock:
            role = self._role
            repl = self._replicator
        body = {"name": self.name, "role": role, "pid": os.getpid(),
                "state": "serving" if not self.stop_event.is_set()
                else "down",
                "epoch": self.m.epoch}
        wal = getattr(self.m, "_wal", None)
        if wal is not None:
            body["wal_next_seq"] = wal.next_seq
        if repl is not None:
            body["applied_seq"] = repl.applier.applied_seq
            body["replication_gap"] = repl.gap
        # the kernel launches so far: a caller diffs two reads around the
        # traffic it sent
        body["launches"] = ops.launch_counts()
        return body

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout_s=30.0):
        return {"drained": self.server.drain(float(timeout_s))}

    def stop(self):
        # answer first, die after: the handler thread must get its 200 out
        # before the main thread tears the transport down
        threading.Timer(0.2, self.stop_event.set).start()
        return {"stopping": True}

    # -- failover ----------------------------------------------------------
    def promote(self):
        """Follower → primary, in place. The inherited seq floor becomes
        this process's OWN log's start_seq; one fold writes the meta head
        and the checkpoint."""
        from raft_tpu_torch import obs
        from raft_tpu_torch.mutate.wal import MutationWAL
        with self._lock:
            if self._role == "primary":
                raise ValueError(f"{self.name} is already primary")
            if self._promoting:
                raise ValueError(f"{self.name}: promotion already "
                                 f"in flight")
            self._promoting = True
            repl = self._replicator
            self._replicator = None
        try:
            if repl is not None:
                applier = repl.applier
                repl.close()
            else:
                raise ValueError(f"{self.name}: no replication state "
                                 f"to promote from")
            next_seq = max(applier.applied_seq,
                           applier._skip_upto) + 1
            wal = MutationWAL(self.args.wal, sync=self.args.sync_wal,
                              start_seq=next_seq)
            self.m.attach_wal(wal,
                              checkpoint_path=self.args.checkpoint)
            # the ownership stamp: checkpoint and meta-headed log in one
            # swap; peers resume or get the gap off this log
            self.m.compact()
            if self.transport is not None:
                self.transport.wal_path = self.args.wal
            with self._lock:
                self._role = "primary"
        finally:
            with self._lock:
                self._promoting = False
        obs.counter("raft.fleet.proc.promotions.total").inc()
        if self._blackbox is not None:
            self._blackbox.flush("promote")
        return {"primary": self.name, "next_seq": wal.next_seq,
                "epoch": self.m.epoch}

    def retarget(self, primary_url):
        """Point this follower's replication at a NEW primary (after a
        promotion elsewhere), from the applied floor; if the new
        primary's log no longer holds it, the replicator parks on the
        typed gap and this replica must be respawned."""
        from raft_tpu_torch.fleet.replication import Replicator
        from raft_tpu_torch.fleet.transport import (RemoteWalReader,
                                                    TransportClient)
        with self._lock:
            if self._role == "primary":
                raise ValueError(f"{self.name} is primary — it has "
                                 f"no replication to retarget")
            repl = self._replicator
            self._replicator = None
        applier = repl.applier if repl is not None else None
        if repl is not None:
            repl.close()
        if applier is None:
            raise ValueError(f"{self.name}: no replication state to "
                             f"retarget")
        floor = max(applier.applied_seq, applier._skip_upto)
        reader = RemoteWalReader(TransportClient(str(primary_url)),
                                 from_seq=floor)
        new_repl = Replicator(self.m, wal_path=str(primary_url),
                              name=self.name, reader=reader,
                              applier=applier)
        with self._lock:
            self._replicator = new_repl
        return {"retargeted": True, "from_seq": floor,
                "primary_url": str(primary_url)}

    # -- writes (primary only) ---------------------------------------------
    def _require_primary(self, verb):
        with self._lock:
            if self._role != "primary":
                raise ValueError(
                    f"{self.name} is a follower — {verb} goes to "
                    f"the primary")

    def upsert(self, rows, ids=None):
        import numpy as np
        self._require_primary("upsert")
        out = self.m.upsert(np.asarray(rows, np.float32),
                            ids=None if ids is None
                            else np.asarray(ids, np.int64))
        return {"ids": np.asarray(out).tolist()}

    def delete(self, ids):
        import numpy as np
        self._require_primary("delete")
        n = self.m.delete(np.asarray(ids, np.int64))
        return {"deleted": int(n)}

    def close_replication(self):
        with self._lock:
            repl = self._replicator
            self._replicator = None
        if repl is not None:
            repl.close()


def build_index(args):
    """The shared base every process derives from (n, dim, seed,
    n_lists) on ``args.device``, wrapped as the role's MutableIndex →
    ``(mindex, rep_queries, replicator)``."""
    from raft_tpu_torch.mutate import MutableIndex
    from raft_tpu_torch.mutate.wal import MutationWAL
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.random import make_blobs

    x, _ = make_blobs(n_samples=args.n, n_features=args.dim,
                      centers=max(2, args.n_lists), cluster_std=2.0,
                      seed=args.seed, device=args.device)
    base = ivf_flat.build(x, ivf_flat.IndexParams(
        n_lists=args.n_lists, kmeans_n_iters=3), device=args.device)
    params = ivf_flat.SearchParams(n_probes=args.n_probes)
    rep_queries = x[:64].cpu().numpy()
    del x
    if base.device.type == "cuda":
        # hand the build's scratch back to the card: the daemons of a
        # fleet share it
        import torch
        torch.cuda.empty_cache()

    replicator = None
    if args.role == "primary":
        if os.path.exists(args.wal):
            # a restart over our own log: the promotion-survival path
            m = MutableIndex.recover(
                args.wal, args.k, base_index=base,
                checkpoint_path=args.checkpoint, params=params,
                sync=args.sync_wal, device=args.device)
        else:
            m = MutableIndex(base, k=args.k, params=params)
            m.attach_wal(MutationWAL(args.wal, sync=args.sync_wal),
                         checkpoint_path=args.checkpoint)
    else:
        from raft_tpu_torch.fleet.remote import bootstrap_from_url
        from raft_tpu_torch.fleet.replication import Replicator
        m, reader, applier = bootstrap_from_url(
            args.primary_url, args.k, args.cache_dir,
            base_index=base, params=params, name=args.name,
            device=args.device)
        replicator = Replicator(m, wal_path=args.primary_url,
                                name=args.name, reader=reader,
                                applier=applier)
    return m, rep_queries, replicator


def _device_name(device: str) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``;
    raises when a CUDA device is asked for and there is none."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device here")
    torch.cuda.set_device(dev.index or 0)
    return torch.cuda.get_device_name(dev.index or 0)


def main(argv=None):
    args = build_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format=f"%(asctime)s fleetd[{args.name}] %(levelname)s "
               f"%(name)s: %(message)s")
    log = logging.getLogger("fleetd")
    if args.role == "follower" and not args.primary_url:
        log.error("--role follower requires --primary-url")
        return 2
    try:
        card = _device_name(args.device)
    except RuntimeError as e:
        log.error("%s — refusing to serve on another device", e)
        return 3
    log.info("device %s: %s", args.device, card)

    from raft_tpu_torch import obs
    from raft_tpu_torch.fleet.transport import serve_replica
    from raft_tpu_torch.serve import SearchServer, ServeConfig

    blackbox = None
    if args.blackbox:
        # the box's own thread flushes and fsyncs on its cadence, off the
        # dispatcher; a relative directory is the daemon's working
        # directory's (the spawner's cwd is the replica's workdir)
        from raft_tpu_torch.obs.blackbox import BlackBox
        blackbox = BlackBox(args.blackbox, box=args.name).start()
        log.info("black box in %s", blackbox.dir)

    log.info("building index (role=%s)", args.role)
    m, rep_queries, replicator = build_index(args)

    cfg = ServeConfig(
        batch_sizes=tuple(int(b) for b
                          in args.batch_sizes.split(",")),
        max_queue=args.max_queue, max_wait_ms=args.max_wait_ms,
        default_deadline_ms=args.deadline_ms)
    server = SearchServer.from_index(m, rep_queries, args.k,
                                     config=cfg)

    daemon = Daemon(args, m, server, replicator, blackbox)
    transport = serve_replica(
        host=args.host, port=args.port, searcher=server,
        wal_path=(args.wal if args.role == "primary" else None),
        checkpoint_path=args.checkpoint, control=daemon)
    daemon.transport = transport
    obs.gauge("raft.fleet.replica.state", replica=args.name).set(1)

    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{transport.port}\n")
        os.replace(tmp, args.port_file)
    log.info("serving on %s (pid %d)", transport.url, os.getpid())

    def _on_signal(signum, frame):
        log.info("signal %d — shutting down", signum)
        daemon.stop_event.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    daemon.stop_event.wait()
    obs.gauge("raft.fleet.replica.state", replica=args.name).set(3)
    log.info("draining")
    try:
        server.drain(10.0)
    finally:
        daemon.close_replication()
        server.close()
        transport.close()
        if blackbox is not None:
            blackbox.close()
    from raft_tpu_torch import ops
    log.info("kernel launches: %s", json.dumps(ops.launch_counts()))
    log.info("exited clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())

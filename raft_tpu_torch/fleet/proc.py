"""ProcessFleet: N replica daemons as OS processes (counterpart of
``raft_tpu.fleet.proc``).

:class:`ProcessFleet` spawns N ``python -m raft_tpu_torch.fleet.fleetd``
daemons (one primary owning the mutation WAL, N-1 followers
bootstrapping over the wire), waits for each through ``/rpc/state`` and
hands back :class:`~raft_tpu_torch.fleet.remote.RemoteReplica` fronts
for a stock :class:`~raft_tpu_torch.fleet.router.FleetRouter`.

* **a device a process** — :func:`device_env` gives daemon ``index`` its
  cards through ``CUDA_VISIBLE_DEVICES`` (``index * devices_per_proc``
  on, modulo the machine's count: on a one-card machine every daemon
  shares card 0, each with its own CUDA context and caching allocator),
  or hides every card for ``platform="cpu"``; the daemon gets
  ``--device`` to match. A daemon told ``--device cuda`` on a machine
  without a card exits non-zero: it never serves on the CPU.
* **the port-file handshake** — each daemon binds an ephemeral port and
  writes it to its port file; the spawner polls the file, then
  ``/rpc/state`` until the daemon reports ``serving``. A daemon that
  dies during startup raises here.
* **death is physical** — :meth:`kill` sends ``SIGKILL`` and touches no
  replica state: the router finds the death through dispatch errors.
  :meth:`promote` completes a failover: the follower opens its OWN WAL
  at the inherited ``next_seq`` and the live peers are retargeted at it.

* **forensics** — ``blackbox=True`` gives each daemon a crash-durable
  black box at ``<workdir>/<name>/blackbox`` (``fleetd --blackbox``); a
  SIGKILLed daemon's last cadence flush stays there for the doctor.

The kernels load from ``raft_tpu_torch/_build/``: build them once in the
spawning process (``ops._build.build_all()``) before spawning, so the
daemons only load them.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.fleet.remote import RemoteReplica
from raft_tpu_torch.fleet.transport import TransportClient, wait_healthy

__all__ = ["ProcessFleet", "FleetProcess", "device_env"]

# the daemon, run as a module from the directory that holds the package
_FLEETD = "raft_tpu_torch.fleet.fleetd"
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

def _visible_cards() -> List[str]:
    """The card ids this process may hand out: its own
    ``CUDA_VISIBLE_DEVICES`` when set, else ``0 .. device_count - 1``."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None and vis.strip():
        return [c.strip() for c in vis.split(",") if c.strip()]
    import torch
    return [str(i) for i in range(torch.cuda.device_count())]


def device_env(index: int, platform: str = "cuda",
               devices_per_proc: int = 1) -> Dict[str, str]:
    """The device variables of daemon ``index``: for ``"cuda"`` the
    cards ``index * devices_per_proc`` on, modulo the cards this process
    sees (all daemons share card 0 on a one-card machine); for ``"cpu"``
    no card at all."""
    expects(platform in ("cuda", "cpu"),
            "device_env: platform must be 'cuda' or 'cpu', got %r",
            platform)
    if platform == "cpu":
        return {"CUDA_VISIBLE_DEVICES": ""}
    cards = _visible_cards()
    first = index * devices_per_proc
    picked = [cards[(first + j) % len(cards)] if cards else str(first + j)
              for j in range(devices_per_proc)]
    return {"CUDA_VISIBLE_DEVICES": ",".join(picked)}


class FleetProcess:
    """One spawned daemon: its Popen handle, address and role."""

    def __init__(self, name: str, popen: subprocess.Popen, url: str,
                 workdir: str, role: str):
        self.name = name
        self.popen = popen
        self.url = url
        self.workdir = workdir
        self.role = role                      # "primary" | "follower"
        self.client = TransportClient(url)

    @property
    def pid(self) -> int:
        return self.popen.pid

    def alive(self) -> bool:
        return self.popen.poll() is None

    def describe(self) -> dict:
        return {"name": self.name, "pid": self.pid, "url": self.url,
                "role": self.role, "alive": self.alive(),
                "workdir": self.workdir}


class ProcessFleet:
    """Spawn, health-check, route over, kill and fail over N replica
    daemons, on the card unless ``platform="cpu"``. Use as a context
    manager: :meth:`close` drains and ends every child it still owns."""

    # static race contract (tools/graftlint GL003): the operator thread,
    # chaos threads (kill/respawn) and close() meet on the process table
    GUARDED_BY = ("_procs", "_closed")

    def __init__(self, workdir: str, n_procs: int = 2,
                 n: int = 2000, dim: int = 16, seed: int = 0,
                 n_lists: int = 8, k: int = 4, n_probes: int = 8,
                 deadline_ms: float = 5000.0,
                 batch_sizes: str = "1,8",
                 platform: str = "cuda", devices_per_proc: int = 1,
                 startup_timeout_s: float = 180.0,
                 sync_wal: bool = False, blackbox: bool = False,
                 python: Optional[str] = None,
                 extra_args: Optional[List[str]] = None,
                 spawn: bool = True):
        expects(n_procs >= 1,
                "ProcessFleet: n_procs must be >= 1, got %d", n_procs)
        expects(platform in ("cuda", "cpu"),
                "ProcessFleet: platform must be 'cuda' or 'cpu', got %r",
                platform)
        self.workdir = os.path.abspath(workdir)
        self.n_procs = int(n_procs)
        self._dataset = dict(n=int(n), dim=int(dim), seed=int(seed),
                             n_lists=int(n_lists))
        self.k = int(k)
        self.n_probes = int(n_probes)
        self.deadline_ms = float(deadline_ms)
        self.batch_sizes = str(batch_sizes)
        self.platform = str(platform)
        self.devices_per_proc = int(devices_per_proc)
        self.startup_timeout_s = float(startup_timeout_s)
        self.sync_wal = bool(sync_wal)
        self.blackbox = bool(blackbox)
        self.python = python or sys.executable
        self.extra_args = list(extra_args or [])
        self._lock = threading.Lock()
        self._procs: Dict[str, FleetProcess] = {}
        self._closed = False
        os.makedirs(self.workdir, exist_ok=True)
        if spawn:
            try:
                self.spawn_all()
            except BaseException:
                self.close()
                raise

    # -- spawn -------------------------------------------------------------
    def _proc_paths(self, name: str) -> dict:
        d = os.path.join(self.workdir, name)
        os.makedirs(d, exist_ok=True)
        return {"dir": d,
                "wal": os.path.join(d, "mutations.wal"),
                "ckpt": os.path.join(d, "checkpoint.npz"),
                "port_file": os.path.join(d, "port"),
                "log": os.path.join(d, "daemon.log"),
                "blackbox": os.path.join(d, "blackbox")}

    def _spawn_one(self, index: int, name: str, role: str,
                   primary_url: Optional[str]) -> FleetProcess:
        p = self._proc_paths(name)
        try:
            os.remove(p["port_file"])
        except OSError:   # graftlint: disable=GL006
            # no stale port file: what the removal wants (justified)
            pass
        cmd = [self.python, "-m", _FLEETD,
               "--name", name, "--role", role,
               "--port-file", p["port_file"],
               "--wal", p["wal"], "--checkpoint", p["ckpt"],
               "--cache-dir", p["dir"],
               "--n", str(self._dataset["n"]),
               "--dim", str(self._dataset["dim"]),
               "--seed", str(self._dataset["seed"]),
               "--n-lists", str(self._dataset["n_lists"]),
               "--k", str(self.k), "--n-probes", str(self.n_probes),
               "--batch-sizes", self.batch_sizes,
               "--deadline-ms", str(self.deadline_ms),
               "--device", self.platform]
        if role == "follower":
            expects(primary_url is not None,
                    "ProcessFleet: follower %s needs a primary url",
                    name)
            cmd += ["--primary-url", primary_url]
        if self.sync_wal:
            cmd += ["--sync-wal"]
        if self.blackbox:
            cmd += ["--blackbox", p["blackbox"]]
        cmd += self.extra_args
        env = dict(os.environ)
        env.update(device_env(index, self.platform,
                              self.devices_per_proc))
        env["PYTHONPATH"] = os.pathsep.join(
            [_PKG_ROOT] + [s for s in env.get("PYTHONPATH", "").split(
                os.pathsep) if s])
        with open(p["log"], "ab") as logf:
            popen = subprocess.Popen(cmd, stdout=logf, stderr=logf,
                                     cwd=p["dir"], env=env)
        obs.counter("raft.fleet.proc.spawned.total").inc()
        try:
            url = self._handshake(name, popen, p["port_file"])
        except BaseException:
            if popen.poll() is None:
                popen.kill()
                popen.wait(timeout=30.0)
            raise
        return FleetProcess(name, popen, url, p["dir"], role)

    def _handshake(self, name: str, popen: subprocess.Popen,
                   port_file: str) -> str:
        """Port-file poll → base url → /rpc/state poll to serving."""
        deadline = time.monotonic() + self.startup_timeout_s
        port = None
        while time.monotonic() < deadline:
            if popen.poll() is not None:
                raise RuntimeError(
                    f"fleetd {name}: exited rc={popen.returncode} "
                    f"during startup (see its daemon.log)")
            try:
                with open(port_file) as f:
                    txt = f.read().strip()
                if txt:
                    port = int(txt)
                    break
            except (OSError, ValueError):   # graftlint: disable=GL006
                # not written yet, or half written: poll again (justified)
                pass
            time.sleep(0.1)
        if port is None:
            raise TimeoutError(
                f"fleetd {name}: no port file after "
                f"{self.startup_timeout_s:.0f}s")
        url = f"http://127.0.0.1:{port}"
        wait_healthy(TransportClient(url),
                     timeout_s=max(5.0,
                                   deadline - time.monotonic()))
        return url

    def spawn_all(self) -> "ProcessFleet":
        """Bring the fleet up: the primary first (it owns the WAL and
        serves bootstrap), then every follower against it."""
        with self._lock:
            expects(not self._closed, "ProcessFleet: closed")
            expects(not self._procs, "ProcessFleet: already spawned")
        primary = self._spawn_one(0, "r0", "primary", None)
        with self._lock:
            self._procs[primary.name] = primary
        for i in range(1, self.n_procs):
            fp = self._spawn_one(i, f"r{i}", "follower", primary.url)
            with self._lock:
                self._procs[fp.name] = fp
        self._export_alive()
        return self

    def _export_alive(self) -> None:
        with self._lock:
            alive = sum(1 for fp in self._procs.values()
                        if fp.alive())
        obs.gauge("raft.fleet.proc.alive").set(alive)

    # -- introspection -----------------------------------------------------
    def processes(self) -> List[FleetProcess]:
        with self._lock:
            return list(self._procs.values())

    def process(self, name: str) -> FleetProcess:
        with self._lock:
            fp = self._procs.get(name)
        expects(fp is not None, "ProcessFleet: no process %r", name)
        return fp

    def primary(self) -> FleetProcess:
        with self._lock:
            for fp in self._procs.values():
                if fp.role == "primary":
                    return fp
        raise RuntimeError("ProcessFleet: no primary (all killed?)")

    def urls(self) -> Dict[str, str]:
        """``{name: url}``; each daemon's one port serves /metrics too."""
        with self._lock:
            return {n: fp.url for n, fp in self._procs.items()}

    def replicas(self, **client_kw) -> List[RemoteReplica]:
        """Fresh :class:`RemoteReplica` fronts for every process, for a
        :class:`~raft_tpu_torch.fleet.router.FleetRouter`."""
        with self._lock:
            items = list(self._procs.items())
        return [RemoteReplica(name, fp.url, **client_kw)
                for name, fp in items]

    def describe(self) -> dict:
        return {"workdir": self.workdir, "platform": self.platform,
                "processes": [fp.describe()
                              for fp in self.processes()]}

    # -- chaos / failover --------------------------------------------------
    def kill(self, name: str) -> int:
        """``SIGKILL``: no drain, no bookkeeping; the router finds out
        the hard way. Returns the dead pid."""
        fp = self.process(name)
        pid = fp.pid
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:   # graftlint: disable=GL006
            # already dead: what the kill wants (justified)
            pass
        fp.popen.wait(timeout=30.0)
        obs.counter("raft.fleet.proc.killed.total").inc()
        get_logger("fleet").warning(
            "proc fleet: SIGKILL %s (pid %d)", name, pid)
        self._export_alive()
        return pid

    def promote(self, name: str, retarget_peers: bool = True) -> dict:
        """Complete a failover: promote follower ``name`` (its daemon
        opens its OWN WAL at the inherited next_seq; the RPC returns
        ``{primary, next_seq, epoch}``) and point every other live
        follower's replication at it. The old primary's slot becomes a
        follower's: :meth:`respawn` brings it back against the new
        primary."""
        fp = self.process(name)
        out = fp.client.promote(timeout=120.0)
        with self._lock:
            for other in self._procs.values():
                if other.role == "primary":
                    other.role = "follower"
            fp.role = "primary"
            peers = [o for o in self._procs.values()
                     if o.name != name and o.role == "follower"]
        obs.counter("raft.fleet.proc.promotions.total").inc()
        if retarget_peers:
            for peer in peers:
                if not peer.alive():
                    continue
                try:
                    peer.client.retarget(fp.url, timeout=30.0)
                except Exception:
                    get_logger("fleet").warning(
                        "proc fleet: retarget of %s at new primary "
                        "%s failed — it keeps its old target",
                        peer.name, name)
        return out

    def respawn(self, name: str, role: str = "follower") -> FleetProcess:
        """Bring a dead slot back: a fresh process in the same workdir (a
        promoted primary's slot restarts over its own WAL). It replaces
        the old entry."""
        old = self.process(name)
        expects(not old.alive(),
                "ProcessFleet: %s is still alive — kill it first",
                name)
        index = int(name.lstrip("r")) if name.lstrip("r").isdigit() \
            else 0
        primary_url = None
        if role == "follower":
            primary_url = self.primary().url
        fp = self._spawn_one(index, name, role, primary_url)
        with self._lock:
            self._procs[name] = fp
        self._export_alive()
        return fp

    # -- shutdown ----------------------------------------------------------
    def close(self, drain_timeout_s: float = 10.0) -> None:
        """Shut the fleet down: RPC stop (the daemon drains), SIGTERM,
        wait, SIGKILL what is left. Every child is reaped before this
        returns, so none keeps its card. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            procs = list(self._procs.values())
        for fp in procs:
            if not fp.alive():
                continue
            try:
                fp.client.stop(timeout=drain_timeout_s)
            except Exception:   # graftlint: disable=GL006
                # a dead or hung daemon gets the signals below
                # (justified swallow: close must reach SIGTERM)
                pass
        deadline = time.monotonic() + drain_timeout_s
        for fp in procs:
            if fp.alive():
                fp.popen.terminate()
        for fp in procs:
            left = max(0.5, deadline - time.monotonic())
            try:
                fp.popen.wait(timeout=left)
            except subprocess.TimeoutExpired:
                fp.popen.kill()
                fp.popen.wait(timeout=10.0)
        self._export_alive()

    def __enter__(self) -> "ProcessFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

"""Participant health tracking for failure-aware sync (counterpart of
``raft_tpu.comms.health``).

Every process runs a :class:`HealthMonitor` that heartbeats a shared KV
namespace: the ``torch.distributed`` TCP store of the bound process
world (the channel ``host_p2p`` uses), the native broker
(``native_p2p``), or the in-process board for ranks in one process.
``Comms.sync_stream(..., monitor=...)`` consults it while waiting and
reports the **suspect ranks** whose heartbeats went stale, so the
caller can re-form the mesh without them. The per-rank gauge
``raft.comms.health.suspect_rank{rank,session}`` carries the verdict to
``/healthz`` and to the distributed server's failover
(:func:`suspects_from_gauges`, the one parser of that plane).

Clock discipline: heartbeats are monotone counters, never wall-clock
stamps, and staleness is judged by the reader's clock (the time since
it last saw the counter advance), so clock skew cannot fake a failure.
A peer never seen gets a startup grace of ``stale_after_s``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch import obs
from raft_tpu_torch.comms.host_p2p import _coordination_client
from raft_tpu_torch.core.logger import get_logger

_log = get_logger("comms")

# sequence-key fallback: heartbeat keys at multiples of this survive
# retirement forever, so lagging readers always have a resync point
_CHECKPOINT = 256


class _InProcessBoard:
    """Heartbeat board for ranks in one process (test cliques). Keyed by
    (session, rank) — cliques sharing the default board must not read
    each other's heartbeats."""

    GUARDED_BY = ("_beats",)        # tools/graftlint GL003

    def __init__(self):
        self._beats: Dict[Tuple[str, int], int] = {}
        self._lock = threading.Lock()

    def publish(self, session: str, rank: int, seq: int) -> None:
        with self._lock:
            self._beats[(session, rank)] = seq

    def read(self, session: str, rank: int) -> Optional[int]:
        with self._lock:
            return self._beats.get((session, rank))


class HealthMonitor:
    """Heartbeat publisher + peer liveness reader for one comms clique.

    ``session`` scopes the key namespace like :class:`HostP2P`. The
    monitor owns a daemon thread publishing every ``interval_s``;
    :meth:`suspect_ranks` reports peers whose counter has not been seen
    to advance for ``stale_after_s`` (reader clock). Single-process
    cliques share an in-process board; multi-host cliques ride the
    coordination-service KV store or the native C++ broker
    (``client=NativeKVClient(...)``).

    Transports whose ``key_value_set`` cannot overwrite fall back to
    sequence-suffixed keys (``.../<rank>/<seq>``) read with a
    catch-up probe — no overwrite or key listing required.
    """

    def __init__(self, rank: int, size: int, session: str = "default",
                 interval_s: float = 1.0, stale_after_s: float = 10.0,
                 board: Optional[_InProcessBoard] = None, client=None):
        self.rank = rank
        self.size = size
        self.session = session
        self.interval_s = interval_s
        self.stale_after_s = stale_after_s
        if client is not None:
            self._client = client
            board = None
        else:
            self._client = None if board is not None else _coordination_client()
        self._board = board
        if self._client is None and self._board is None:
            self._board = _default_board
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self._overwrite_ok = True   # flips off on first TypeError
        self._started_at: Optional[float] = None
        # peer -> (last observed counter, reader-clock time of last advance)
        self._peer_state: Dict[int, Tuple[int, float]] = {}
        # next seq to probe per peer in sequence-key fallback mode
        self._peer_next_seq: Dict[int, int] = {}
        self.last_suspects: List[int] = []
        # ranks whose suspect_rank gauge is currently raised (so a
        # recovered peer's flag is cleared, not left stale)
        self._gauged_suspects: Dict[int, bool] = {}

    # -- publishing --------------------------------------------------------
    def _key(self, rank: int, seq: Optional[int] = None) -> str:
        base = f"raft_tpu/health/{self.session}/{rank}"
        return base if seq is None else f"{base}/{seq}"

    def beat(self) -> None:
        """Publish one heartbeat (an incremented counter) now."""
        self._seq += 1
        obs.counter("raft.comms.health.heartbeats",
                    session=self.session).inc()
        if self._client is not None:
            try:
                if self._overwrite_ok:
                    try:
                        self._client.key_value_set(
                            self._key(self.rank), str(self._seq),
                            allow_overwrite=True)
                        return
                    except TypeError:
                        # transport without overwrite: sequence-key mode
                        # from now on (peers probe suffixed keys)
                        self._overwrite_ok = False
                self._client.key_value_set(
                    self._key(self.rank, self._seq), str(self._seq))
                # bound the KV footprint: retire old keys, but keep every
                # multiple of _CHECKPOINT forever so a reader arbitrarily
                # far behind can always resync by probing checkpoint
                # multiples (best-effort; not every transport can delete)
                r = self._seq - 1024
                if r >= 1 and r % _CHECKPOINT != 0:
                    try:
                        self._client.key_value_delete(
                            self._key(self.rank, r))
                    except Exception:  # graftlint: disable=GL006
                        # justified swallow: key retirement is
                        # best-effort by design — transports without
                        # delete support raise on EVERY beat, and the
                        # _CHECKPOINT multiples bound the KV footprint
                        # regardless; counting here would page on a
                        # non-failure
                        pass
            except Exception:
                # a dropped beat is indistinguishable from latency to
                # the PEERS (their staleness clock judges), but the
                # publisher itself must not hide the failure: a
                # persistently erroring transport looks exactly like
                # our own death from outside
                obs.counter("raft.comms.health.errors",
                            op="beat").inc()
        else:
            self._board.publish(self.session, self.rank, self._seq)

    def start(self) -> "HealthMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()  # restartable after stop() (mesh re-formation)
        self._started_at = time.monotonic()
        self.beat()

        self._refresh_peers()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.beat()
                # observing peers every beat builds the advance history
                # suspect_ranks() judges staleness against
                self._refresh_peers()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"raft-health-{self.rank}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s)
            self._thread = None

    # -- peer liveness -----------------------------------------------------
    def _try_get(self, key: str) -> Optional[str]:
        try:
            return self._client.key_value_try_get(key)
        except AttributeError:
            try:  # fall back to a short blocking get
                return self._client.blocking_key_value_get(key, 50)
            except Exception:
                return None
        except Exception:
            return None

    def _peer_counter(self, rank: int) -> Optional[int]:
        """Latest observed heartbeat counter for ``rank``, or None."""
        if self._client is None:
            return self._board.read(self.session, rank)
        v = self._try_get(self._key(rank))
        if v is not None:
            try:
                return int(v)
            except ValueError:
                return None
        # sequence-key fallback: catch up from the last probed seq, and
        # when the sequential probe misses (keys below seq-1024 are
        # retired), resync via the permanent _CHECKPOINT multiples — a
        # reader arbitrarily far behind advances ≥ _CHECKPOINT per hit
        nxt = self._peer_next_seq.get(rank, 1)
        seen = nxt - 1 if nxt > 1 else None
        for _ in range(64):  # bound probes per refresh; resumes next call
            if self._try_get(self._key(rank, nxt)) is not None:
                seen = nxt
                nxt += 1
                continue
            cp = ((nxt // _CHECKPOINT) + 1) * _CHECKPOINT
            if self._try_get(self._key(rank, cp)) is None:
                break
            seen = cp
            nxt = cp + 1
        self._peer_next_seq[rank] = nxt
        return seen

    def _refresh_peers(self) -> None:
        """Record any counter advances with the reader-clock time they
        were observed."""
        now = time.monotonic()
        for r in range(self.size):
            if r == self.rank:
                continue
            counter = self._peer_counter(r)
            prev = self._peer_state.get(r)
            if counter is not None and (prev is None or counter > prev[0]):
                self._peer_state[r] = (counter, now)

    def suspect_ranks(self, stale_after_s: Optional[float] = None
                      ) -> List[int]:
        """Peers whose heartbeat counter has not been observed to advance
        within the staleness window (reader clock) — the failed
        participants a hung collective is waiting on. Never-seen peers
        are granted a startup grace of one staleness window from monitor
        start."""
        stale = stale_after_s if stale_after_s is not None \
            else self.stale_after_s
        self._refresh_peers()
        now = time.monotonic()
        started = self._started_at if self._started_at is not None else now
        out = []
        max_staleness = 0.0
        for r in range(self.size):
            if r == self.rank:
                continue
            prev = self._peer_state.get(r)
            # measure from the last advance we observed, or from monitor
            # start (startup grace) if the peer was never seen
            since = prev[1] if prev is not None else started
            max_staleness = max(max_staleness, now - since)
            if now - since > stale:
                out.append(r)
        self.last_suspects = out
        # gauges, not only log lines: a scraper sees suspect counts and
        # the worst heartbeat staleness without parsing logs
        obs.gauge("raft.comms.health.suspects",
                  session=self.session).set(len(out))
        obs.gauge("raft.comms.health.max_staleness_seconds",
                  session=self.session).set(max_staleness)
        # per-rank suspect flags: the distributed serving
        # tier's /healthz folds these into its `dist` section so an
        # operator sees WHICH shard is failing, not only a count.
        # Cardinality is bounded by the clique size; previously-suspect
        # ranks are explicitly cleared so a recovered peer stops
        # showing degraded
        for r, was in list(self._gauged_suspects.items()):
            if was and r not in out:
                obs.gauge("raft.comms.health.suspect_rank",
                          session=self.session, rank=r).set(0)
                self._gauged_suspects[r] = False
        for r in out:
            obs.gauge("raft.comms.health.suspect_rank",
                      session=self.session, rank=r).set(1)
            self._gauged_suspects[r] = True
        if out:
            obs.counter("raft.comms.health.suspect_events",
                        session=self.session).inc()
            _log.warn("health[%s] rank %d: stale peers %s",
                      self.session, self.rank, out)
        return out

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def suspects_from_gauges(gauges: Dict[str, float]) -> List[int]:
    """Parse the per-rank suspect flags out of a metrics-snapshot
    ``gauges`` dict → sorted ranks currently flagged. One parser shared
    by the ``/healthz`` dist section and the distributed serving tier's
    failover exclusion — the two consumers of the
    ``raft.comms.health.suspect_rank`` plane must never disagree on
    what it says."""
    raw = {lbl.split("rank=")[1].rstrip("}").split(",")[0]
           for lbl, v in gauges.items()
           if lbl.startswith("raft.comms.health.suspect_rank{")
           and "rank=" in lbl and v > 0}
    try:
        return sorted(int(r) for r in raw)
    except ValueError:
        return sorted(raw)


# ranks of a single-process clique share one board, mirroring host_p2p's
# default registry
_default_board = _InProcessBoard()

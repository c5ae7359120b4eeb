"""Offline post-mortem doctor for black-box dumps (counterpart of the JAX
package's ``tools/doctor.py``).

A ``kill_replica`` chaos kill, an out-of-memory death or a hung dispatch
leaves a black-box directory (:mod:`raft_tpu_torch.obs.blackbox`) and
nothing else. This tool reads that dump (either package's: the format
is shared), or, for a live box, its debug endpoints, and prints a
diagnosis:

* the replica **state transitions** reconstructed from the
  ``raft.fleet.replica.state`` gauge across history frames (what the
  process was doing when it died, and when);
* the **metric deltas in the final window** before death (counter
  movement in the last ``--window`` seconds of frames: what was
  actually happening, not the lifetime totals);
* the **slow-trace stage decomposition** (which span names ate the
  time in the recorded slow requests);
* a **verdict**: host-bound / device-bound / shed storm / compile
  storm / WAL gap / low-HBM / transfer-bound / healthy / inconclusive,
  with the evidence that produced it.

Verdict precedence (most specific cause first: a compile storm also
looks host-bound; naming the storm is the diagnosis)::

    compile storm   raft.plan.build.total moved >= COMPILE_STORM_BUILDS
                    in the final window (steady state compiles nothing)
    WAL gap         raft.mutate.wal.reader.gaps.total moved (a follower
                    fell off the replication stream)
    low-HBM         hbm.low_headroom tripped, or min headroom_frac
                    below LOW_HBM_FRAC (the card's memory)
    transfer-bound  exposed (un-overlapped) tiered cold-fetch seconds
                    dominate device seconds in the final window: the
                    host-to-device copy stopped hiding under the hot
                    tier's scan (raise the budget, or probe less)
    shed storm      shed+deadline drops > SHED_STORM_FRAC of offered
                    work in the final window
    device-bound    duty cycle >= DEVICE_BOUND_DUTY (the card is the
                    bottleneck: scale out, not up)
    host-bound      duty cycle < HOST_BOUND_DUTY while pressure exists
                    (queue depth, sheds, deadline misses): work arrives
                    but the card starves; the host side (batching,
                    transfers, the interpreter lock) is the bottleneck
    healthy         final healthz record said ok, nothing above fired
    inconclusive    not enough evidence (e.g. a dump with no profiler
                    attached and no pressure signals)

Use::

    python -m raft_tpu_torch.tools.doctor /path/to/blackbox/r1   # a dump
    python -m raft_tpu_torch.tools.doctor --url http://127.0.0.1:9100
    python -m raft_tpu_torch.tools.doctor dump/ --json   # machine-readable

The doctor runs on the host alone: it reads files and HTTP, never the
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

# reading a dump must NEVER ambient-attach a recorder that writes into
# (or over) the evidence: force the off state before raft_tpu_torch.obs
# can see a leaked RAFT_TPU_BLACKBOX from the dead process's env
os.environ["RAFT_TPU_BLACKBOX"] = "0"

from raft_tpu_torch.obs import blackbox as _blackbox    # noqa: E402
from raft_tpu_torch.obs.registry import snapshot_diff   # noqa: E402

# the gauge codes of raft_tpu_torch/fleet/replica.py (written out, not
# imported: the doctor must diagnose dumps from builds it does not run)
_STATE_NAMES = {0: "bootstrapping", 1: "serving", 2: "draining",
                3: "down"}

# verdict thresholds — module constants so tests pin the boundaries
COMPILE_STORM_BUILDS = 2.0     # plan builds in the final window
LOW_HBM_FRAC = 0.10            # min headroom_frac considered critical
SHED_STORM_FRAC = 0.05         # dropped / offered in the final window
DEVICE_BOUND_DUTY = 0.60       # duty cycle: device is the bottleneck
HOST_BOUND_DUTY = 0.35         # duty cycle: device starving
TRANSFER_BOUND_RATIO = 0.5     # exposed fetch_s / device_s threshold
TRANSFER_BOUND_MIN_S = 0.05    # exposed fetch floor (absolute)


def _fam(series: str) -> str:
    return series.split("{", 1)[0]


def _labels(series: str) -> Dict[str, str]:
    if "{" not in series:
        return {}
    body = series.split("{", 1)[1].rstrip("}")
    out = {}
    for part in body.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


def load_dump(path: str) -> List[dict]:
    """Every intact record of a dump directory (torn tails tolerated:
    :func:`raft_tpu_torch.obs.blackbox.read_dump`)."""
    return _blackbox.read_dump(path)


def _frames(records: List[dict]) -> List[dict]:
    """All history frames across every flush, deduped by seq (flushes
    overlap only when a frame batch straddles a rotation), in order."""
    seen = set()
    out = []
    for rec in records:
        if rec.get("kind") != "frames":
            continue
        for f in rec.get("data") or []:
            seq = f.get("seq")
            if seq in seen:
                continue
            seen.add(seq)
            out.append(f)
    out.sort(key=lambda f: f.get("seq", 0))
    return out


def _snapshots(records: List[dict]) -> List[dict]:
    return [r for r in records if r.get("kind") == "snapshot"]


def _last(records: List[dict], kind: str) -> Optional[dict]:
    for rec in reversed(records):
        if rec.get("kind") == kind:
            return rec
    return None


def transitions(records: List[dict]) -> List[dict]:
    """Replica state transitions reconstructed from the
    ``raft.fleet.replica.state`` gauge across frames (+ the snapshots,
    which catch a transition that happened between frame cadences —
    e.g. the kill-flush written after the sampler died)."""
    events: List[dict] = []
    cur: Dict[str, int] = {}

    def _feed(gauges: Dict[str, float], t_unix) -> None:
        for series, val in gauges.items():
            if _fam(series) != "raft.fleet.replica.state":
                continue
            rep = _labels(series).get("replica", "?")
            code = int(val)
            if cur.get(rep) != code:
                events.append({
                    "replica": rep, "t_unix": t_unix,
                    "from": _STATE_NAMES.get(cur.get(rep)),
                    "to": _STATE_NAMES.get(code, str(code))})
                cur[rep] = code

    # frames and snapshots interleave by write order in the dump —
    # walk records in that order so the kill-flush snapshot lands
    # after the last cadence frame, exactly as written
    for rec in records:
        if rec.get("kind") == "frames":
            for f in rec.get("data") or []:
                _feed(f.get("gauges", {}), f.get("t_unix"))
        elif rec.get("kind") == "snapshot":
            _feed((rec.get("data") or {}).get("gauges", {}),
                  rec.get("t_unix"))
    return events


def final_window_deltas(records: List[dict], window_s: float = 10.0
                        ) -> Tuple[Dict[str, float], Dict[str, float],
                                   float]:
    """(counter deltas, final gauge values, actual span seconds) over
    the last ``window_s`` of evidence. Prefers history frames (exact
    per-cadence deltas); falls back to diffing the last two registry
    snapshots when the dump carries no frames."""
    frames = _frames(records)
    if frames:
        t_end = frames[-1].get("t_unix") or 0.0
        cut = t_end - float(window_s)
        deltas: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        t_first = t_end
        for f in frames:
            gauges.update(f.get("gauges", {}))
            t = f.get("t_unix") or 0.0
            if t < cut:
                continue
            t_first = min(t_first, t)
            for k, d in (f.get("counters") or {}).items():
                deltas[k] = deltas.get(k, 0.0) + d
        # the death snapshot (kill/sigterm flush) may be newer than
        # the last sampled frame — fold its movement in too
        last_snap = _last(records, "snapshot")
        if last_snap is not None:
            snap_g = (last_snap.get("data") or {}).get("gauges", {})
            gauges.update(snap_g)
        return deltas, gauges, max(0.0, t_end - t_first)
    snaps = _snapshots(records)
    if len(snaps) >= 2:
        diff = snapshot_diff(snaps[-2]["data"], snaps[-1]["data"])
        span = ((snaps[-1].get("t_unix") or 0.0)
                - (snaps[-2].get("t_unix") or 0.0))
        return (dict(diff.get("counters", {})),
                dict(snaps[-1]["data"].get("gauges", {})),
                max(0.0, span))
    if snaps:
        return {}, dict(snaps[-1]["data"].get("gauges", {})), 0.0
    return {}, {}, 0.0


def slow_stage_decomposition(records: List[dict], top: int = 8
                             ) -> List[dict]:
    """Aggregate span-name → total/count/max ms over the recorded
    slow traces (deduped by trace_id across flushes) — which stage ate
    the time."""
    traces: Dict[str, dict] = {}
    for rec in records:
        if rec.get("kind") != "traces":
            continue
        for tr in (rec.get("data") or {}).get("slow") or []:
            tid = tr.get("trace_id") or str(id(tr))
            traces[tid] = tr
    stages: Dict[str, dict] = {}
    for tr in traces.values():
        for sp in tr.get("spans") or []:
            name = sp.get("name", "?")
            dur = float(sp.get("duration_ms", 0.0))
            row = stages.setdefault(
                name, {"name": name, "total_ms": 0.0, "count": 0,
                       "max_ms": 0.0})
            row["total_ms"] += dur
            row["count"] += 1
            row["max_ms"] = max(row["max_ms"], dur)
    rows = sorted(stages.values(), key=lambda r: -r["total_ms"])[:top]
    for r in rows:
        r["total_ms"] = round(r["total_ms"], 3)
        r["max_ms"] = round(r["max_ms"], 3)
    return rows


def _dsum(d: Dict[str, float], family: str) -> float:
    return sum(v for k, v in d.items() if _fam(k) == family)


def _gvals(gauges: Dict[str, float], family: str) -> List[float]:
    return [v for k, v in gauges.items() if _fam(k) == family]


def verdict(deltas: Dict[str, float], gauges: Dict[str, float]
            ) -> Tuple[str, List[str]]:
    """The diagnosis (module docstring has the precedence) →
    ``(verdict, evidence lines)``."""
    evidence: List[str] = []
    builds = _dsum(deltas, "raft.plan.build.total")
    if builds >= COMPILE_STORM_BUILDS:
        evidence.append(f"{builds:.0f} plan builds in the final "
                        f"window (steady state compiles nothing)")
        return "compile storm", evidence
    gaps = _dsum(deltas, "raft.mutate.wal.reader.gaps.total")
    if gaps > 0:
        evidence.append(f"{gaps:.0f} WAL reader gap(s): a follower "
                        f"fell off the replication stream")
        return "WAL gap", evidence
    low = _dsum(gauges, "raft.obs.profile.hbm.low_headroom")
    head = _gvals(gauges, "raft.obs.profile.hbm.headroom_frac")
    if low > 0 or (head and min(head) < LOW_HBM_FRAC):
        if low > 0:
            evidence.append(f"hbm.low_headroom tripped on "
                            f"{low:.0f} device(s)")
        if head:
            evidence.append(f"min HBM headroom_frac "
                            f"{min(head):.3f}")
        return "low-HBM", evidence
    fetch_s = _dsum(deltas, "raft.tiered.fetch.seconds")
    overlap_s = _dsum(deltas, "raft.tiered.overlap.seconds")
    device_s = _dsum(deltas, "raft.obs.profile.device.seconds")
    exposed = max(0.0, fetch_s - overlap_s)
    if (fetch_s > 0 and exposed >= TRANSFER_BOUND_MIN_S
            and exposed >= TRANSFER_BOUND_RATIO * device_s):
        fetch_mb = _dsum(deltas, "raft.tiered.fetch.bytes") / 1e6
        evidence.append(
            f"tiered cold fetch {fetch_s:.3f}s ({fetch_mb:.1f} MB) in "
            f"the final window, {exposed:.3f}s exposed "
            f"(un-overlapped) vs {device_s:.3f}s device compute")
        evidence.append(
            f"overlap fraction "
            f"{(overlap_s / fetch_s) if fetch_s else 0.0:.2f} — the "
            f"transfer window is not hiding under the hot-tier scan "
            f"(raise the HBM budget or drop an n_probes rung)")
        return "transfer-bound", evidence
    shed = _dsum(deltas, "raft.serve.shed.total")
    deadline = _dsum(deltas, "raft.serve.deadline.total")
    completed = _dsum(deltas, "raft.serve.completed.total")
    offered = completed + shed + deadline
    dropped = shed + deadline
    if offered > 0 and dropped / offered > SHED_STORM_FRAC:
        evidence.append(
            f"{dropped:.0f}/{offered:.0f} requests dropped in the "
            f"final window ({100.0 * dropped / offered:.1f}% — shed "
            f"{shed:.0f}, deadline {deadline:.0f})")
        return "shed storm", evidence
    duty = _gvals(gauges, "raft.obs.profile.duty_cycle")
    mean_duty = sum(duty) / len(duty) if duty else None
    depth = _dsum(gauges, "raft.serve.queue.depth")
    pressure = depth > 0 or dropped > 0
    if mean_duty is not None:
        evidence.append(f"device duty cycle {mean_duty:.2f}")
        if mean_duty >= DEVICE_BOUND_DUTY:
            evidence.append("the accelerator is the bottleneck "
                            "(scale out, not up)")
            return "device-bound", evidence
        if mean_duty < HOST_BOUND_DUTY and pressure:
            evidence.append(
                f"work waiting (queue depth {depth:.0f}, dropped "
                f"{dropped:.0f}) while the device idles — the host "
                f"side is the bottleneck")
            return "host-bound", evidence
    if offered > 0 and dropped == 0 and (
            mean_duty is None or mean_duty < DEVICE_BOUND_DUTY):
        evidence.append(f"{completed:.0f} requests completed, "
                        f"nothing dropped")
        return "healthy", evidence
    evidence.append("no pressure signals and no profiler evidence "
                    "in the final window")
    return "inconclusive", evidence


def diagnose(records: List[dict], window_s: float = 10.0) -> dict:
    """Full structured diagnosis of one dump's records."""
    deltas, gauges, span = final_window_deltas(records, window_s)
    v, evidence = verdict(deltas, gauges)
    meta = _last(records, "meta")
    healthz = _last(records, "healthz")
    moved = {k: round(d, 3) for k, d in sorted(
        deltas.items(), key=lambda kv: -abs(kv[1])) if d}
    out = {
        "verdict": v,
        "evidence": evidence,
        "transitions": transitions(records),
        "final_window": {
            "window_s": window_s,
            "observed_s": round(span, 3),
            "counter_deltas": dict(list(moved.items())[:24]),
        },
        "slow_stages": slow_stage_decomposition(records),
        "records": len(records),
    }
    if meta is not None:
        out["meta"] = meta.get("data")
        out["last_flush_reason"] = (meta.get("data") or {}).get(
            "reason")
        out["t_last_flush_unix"] = meta.get("t_unix")
    if healthz is not None:
        hz = healthz.get("data") or {}
        out["final_healthz"] = {"status": hz.get("status")}
        if "history" in hz:
            out["final_healthz"]["anomalies"] = hz["history"].get(
                "anomalies")
    return out


def diagnose_dump(path: str, window_s: float = 10.0) -> dict:
    d = diagnose(load_dump(path), window_s=window_s)
    d["source"] = {"kind": "dump", "path": os.path.abspath(path)}
    return d


# -- live mode -------------------------------------------------------------

def _get_json(url: str, timeout_s: float = 5.0):
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return json.loads(r.read().decode("utf-8"))


def diagnose_live(base_url: str, window_s: float = 10.0) -> dict:
    """Minimal live diagnosis from a running box's endpoints: the
    /debug/history window supplies the deltas the dump's frames
    would."""
    base = base_url.rstrip("/")
    records: List[dict] = []
    import time as _time
    # wall stamp: correlating live endpoint reads with each other is
    # exactly the cross-process use GL005 carves out
    now = _time.time()  # graftlint: disable=GL005
    try:
        hz = _get_json(f"{base}/healthz")
    except urllib.error.HTTPError as e:
        hz = json.loads(e.read().decode("utf-8"))
    records.append({"kind": "healthz", "t_unix": now, "data": hz})
    body = _get_json(f"{base}/debug/requests?slow=1&n=8")
    records.append({"kind": "traces", "t_unix": now,
                    "data": {"slow": body.get("traces", [])}})
    try:
        hist = _get_json(f"{base}/debug/history?window={window_s}"
                         f"&points=1&name=raft")
        frames = []
        for series, row in (hist.get("series") or {}).items():
            kind = row.get("kind")
            for i, (t, v) in enumerate(row.get("values") or []):
                while i >= len(frames):
                    frames.append({"seq": len(frames) + 1,
                                   "t_unix": t, "counters": {},
                                   "gauges": {}})
                if kind == "gauge":
                    frames[i]["gauges"][series] = v
                else:
                    prev = (row["values"][i - 1][1] if i else None)
                    if prev is not None and v != prev:
                        frames[i]["counters"][series] = v - prev
        if frames:
            records.append({"kind": "frames", "t_unix": now,
                            "data": frames})
    except urllib.error.HTTPError:
        pass    # no history attached on that box: snapshots only
    d = diagnose(records, window_s=window_s)
    d["source"] = {"kind": "live", "url": base}
    return d


# -- CLI -------------------------------------------------------------------

def format_diagnosis(d: dict) -> str:
    lines = []
    src = d.get("source", {})
    lines.append("== raft-tpu doctor ==")
    lines.append(f"source: {src.get('path') or src.get('url') or '?'}"
                 f" ({d.get('records', 0)} records)")
    meta = d.get("meta") or {}
    if meta:
        lines.append(f"box: {meta.get('box')}  pid: {meta.get('pid')}"
                     f"  last flush: {d.get('last_flush_reason')}")
    hz = d.get("final_healthz")
    if hz:
        extra = (f"  anomalies: {', '.join(hz['anomalies'])}"
                 if hz.get("anomalies") else "")
        lines.append(f"final healthz: {hz.get('status')}{extra}")
    lines.append("")
    lines.append(f"VERDICT: {d['verdict']}")
    for e in d["evidence"]:
        lines.append(f"  - {e}")
    trs = d.get("transitions") or []
    if trs:
        lines.append("")
        lines.append("state transitions:")
        for t in trs:
            ts = t.get("t_unix")
            stamp = f"{ts:.3f}" if isinstance(ts, (int, float)) else "?"
            lines.append(f"  [{stamp}] {t['replica']}: "
                         f"{t.get('from') or '(first seen)'} -> "
                         f"{t['to']}")
    fw = d.get("final_window") or {}
    moved = fw.get("counter_deltas") or {}
    if moved:
        lines.append("")
        lines.append(f"final-window counter deltas "
                     f"({fw.get('observed_s')}s observed of "
                     f"{fw.get('window_s')}s window):")
        for k, v in moved.items():
            lines.append(f"  {k:<56s} {v:+.1f}")
    stages = d.get("slow_stages") or []
    if stages:
        lines.append("")
        lines.append("slow-trace stage decomposition:")
        for s in stages:
            lines.append(f"  {s['name']:<44s} total {s['total_ms']:9.1f}"
                         f" ms  n={s['count']:<4d} max {s['max_ms']:8.1f}"
                         f" ms")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="post-mortem doctor for raft-tpu black-box dumps "
                    "(either package's)")
    ap.add_argument("dump", nargs="?", help="black-box dump directory")
    ap.add_argument("--url", help="diagnose a LIVE box via its debug "
                                  "endpoint instead of a dump")
    ap.add_argument("--window", type=float, default=10.0,
                    help="final-window seconds (default 10)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable diagnosis")
    args = ap.parse_args(argv)
    if not args.dump and not args.url:
        ap.error("need a dump directory or --url")
    if args.dump and not os.path.isdir(args.dump):
        print(f"doctor: {args.dump!r} is not a directory",
              file=sys.stderr)
        return 2
    d = (diagnose_live(args.url, window_s=args.window) if args.url
         else diagnose_dump(args.dump, window_s=args.window))
    if args.json:
        print(json.dumps(d, indent=1, default=str))
    else:
        print(format_diagnosis(d))
    return 0


if __name__ == "__main__":
    sys.exit(main())

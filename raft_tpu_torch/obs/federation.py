"""Metric federation: one fleet rollup over N replica registries
(counterpart of ``raft_tpu.obs.federation``).

Every observability surface below this module is per-process: the
registry, ``/metrics``, ``/healthz``, ``/debug/*`` each describe ONE
process. Once the fleet splits across processes
(:class:`~raft_tpu_torch.fleet.ProcessFleet`), its counters live in N
disjoint registries and no single page shows the fleet. This module is
that page's engine:

* :func:`parse_prometheus_text` / :func:`render_prometheus_text` —
  the exposition format round trip. The parser is the first real
  consumer of our own exporter
  (:meth:`~raft_tpu_torch.obs.registry.MetricsRegistry
  .to_prometheus_text`); ``render(parse(text)) == text`` BYTE-STABLY
  for any exporter output (pinned in tier-1), so federation can never
  silently corrupt a sample on the way through.
* :class:`MetricsFederator` — scrapes N instances (HTTP ``/metrics``
  endpoints and/or in-process registries) on a ``time.monotonic``
  cadence and merges them under an added ``instance`` label with
  per-kind semantics:

  ========== ============================================ ===========
  kind       per-instance series                          fleet rollup
  ========== ============================================ ===========
  counter    kept, ``instance`` label added               SUM (no
                                                          instance
                                                          label)
  gauge      kept, ``instance`` label added               none in
                                                          text;
                                                          ``report()``
                                                          carries
                                                          sum/min/max
  histogram  kept, ``instance`` label added               buckets,
                                                          sum, count
                                                          ADD
  ========== ============================================ ===========

  Gauges get no text rollup on purpose: summing queue depths is
  meaningful, summing duty cycles is not, and the federator cannot
  know which — the typed rollups live in :meth:`report` where the
  reader picks.

* **Staleness** — a failed scrape is typed and counted
  (``raft.obs.fed.scrape.errors{instance}``); the last good sample
  set ages out after ``stale_after_s`` (default 3× the scrape
  interval). A STALE instance is ABSENT from the merged export — a
  dead replica must read as missing, never as frozen-healthy.
* :meth:`MetricsFederator.healthz` — the fleet verdict:
  worst-of across per-instance ``/healthz`` verdicts (stale and
  unreachable both degrade), plus per-instance replication lag and
  the attached router's suspect set.
* :meth:`MetricsFederator.report` — the ``/debug/fleet`` federation
  section: per-instance scrape state side by side with the
  well-known per-replica gauges (duty cycle, HBM headroom, SLO
  burn), and the aggregator's own scrape overhead.

The scraper thread and report/merge readers share state under one
lock; network and registry I/O never happens while it is held
(the GL003/GL007 discipline: ``GUARDED_BY`` below).
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple, Union

from raft_tpu_torch import obs
from raft_tpu_torch.obs.registry import _fmt, _prom_labels
from raft_tpu_torch.testing import faults

__all__ = [
    "Sample",
    "Family",
    "parse_prometheus_text",
    "render_prometheus_text",
    "merge_families",
    "MetricsFederator",
]

# seconds buckets for the scrape-duration histogram: scrapes are
# local-network small-payload GETs — sub-ms to a few hundred ms
_SCRAPE_BUCKETS = (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 1.0, 5.0)

LabelTuple = Tuple[Tuple[str, str], ...]


class Sample:
    """One exposition sample line: full sample name (including any
    ``_bucket``/``_sum``/``_count`` suffix), labels in parsed order
    (values unescaped), float value."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelTuple, value: float):
        self.name = name
        self.labels = labels
        self.value = value

    def __repr__(self) -> str:
        return f"Sample({self.name!r}, {self.labels!r}, {self.value!r})"


class Family:
    """One metric family as exposed: prom-charset name exactly as the
    ``# TYPE`` line spells it (counters keep ``_total``), kind, HELP
    text, samples in exposition order."""

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str, help: str = ""):
        self.name = name
        self.kind = kind
        self.help = help
        self.samples: List[Sample] = []

    def __repr__(self) -> str:
        return (f"Family({self.name!r}, {self.kind!r}, "
                f"{len(self.samples)} samples)")


_LABEL_RE = re.compile(r'\s*([a-zA-Z_][a-zA-Z0-9_]*)='
                       r'"((?:[^"\\]|\\.)*)"\s*,?')
# one regex pass per escape set — sequential str.replace would corrupt
# r"\\n" (escaped backslash + n) into a newline
_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPE_MAP = {"n": "\n", '"': '"', "\\": "\\"}
_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")


def _unescape(v: str) -> str:
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPE_MAP.get(m.group(1), m.group(0)), v)


def _parse_sample(line: str) -> Optional[Sample]:
    m = _NAME_RE.match(line)
    if m is None:
        return None
    name = m.group(0)
    pos = m.end()
    labels: List[Tuple[str, str]] = []
    if pos < len(line) and line[pos] == "{":
        pos += 1
        while pos < len(line) and line[pos] != "}":
            lm = _LABEL_RE.match(line, pos)
            if lm is None:
                return None
            labels.append((lm.group(1), _unescape(lm.group(2))))
            pos = lm.end()
        if pos >= len(line):
            return None
        pos += 1  # past '}'
    try:
        value = float(line[pos:].strip())
    except ValueError:
        return None
    return Sample(name, tuple(labels), value)


def _base_name(fam: Family, sample_name: str) -> bool:
    """Does ``sample_name`` belong to ``fam``? Histograms expose under
    three suffixes of the family name."""
    if sample_name == fam.name:
        return True
    if fam.kind == "histogram":
        return sample_name in (fam.name + "_bucket",
                               fam.name + "_sum",
                               fam.name + "_count")
    return False


def parse_prometheus_text(text: str) -> List[Family]:
    """Parse exposition text into :class:`Family` objects, order
    preserved. Tolerant of other exporters' output (unknown escapes
    pass through, untyped samples become gauge families), but exact
    on our own: :func:`render_prometheus_text` of the result
    reproduces the input byte for byte."""
    fams: List[Family] = []
    cur: Optional[Family] = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            if cur is None or cur.name != name or cur.samples:
                cur = Family(name, "untyped")
                fams.append(cur)
            cur.help = help_text
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, kind = rest.partition(" ")
            kind = kind.strip() or "untyped"
            if cur is not None and cur.name == name and not cur.samples:
                cur.kind = kind
            else:
                cur = Family(name, kind)
                fams.append(cur)
            continue
        if line.startswith("#"):
            continue
        sample = _parse_sample(line)
        if sample is None:
            continue
        if cur is None or not _base_name(cur, sample.name):
            cur = Family(sample.name, "untyped")
            fams.append(cur)
        cur.samples.append(sample)
    return fams


def render_prometheus_text(families: Sequence[Family]) -> str:
    """Render families back to exposition text, preserving order.
    Inverse of :func:`parse_prometheus_text` over the image of our
    exporter (``_fmt`` is a true inverse of ``float`` there, label
    escaping round-trips)."""
    lines: List[str] = []
    for fam in families:
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        if fam.kind != "untyped":
            lines.append(f"# TYPE {fam.name} {fam.kind}")
        for s in fam.samples:
            lines.append(
                f"{s.name}{_prom_labels(s.labels)} {_fmt(s.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def _with_instance(labels: LabelTuple, instance: str) -> LabelTuple:
    """Insert the ``instance`` label in sorted key position (matching
    the exporter's sorted-series-key convention). A scraped sample
    that already carries ``instance`` — e.g. a downstream federator's
    self-metrics, or the shared-registry single-process fleet — keeps
    it as ``exported_instance`` (the Prometheus federation
    convention) so the output never holds a duplicate label key."""
    kept = tuple(("exported_instance", v) if k == "instance" else
                 (k, v) for k, v in labels)
    return tuple(sorted(kept + (("instance", instance),)))


def merge_families(per_instance: Dict[str, List[Family]]
                   ) -> List[Family]:
    """Merge each instance's families into the fleet view: every
    sample reappears with an ``instance`` label; counter and
    histogram families additionally get rollup samples WITHOUT the
    instance label (values summed across instances — cumulative
    bucket counts sum bucket-wise, which is exact when instances
    share bucket bounds, i.e. run the same binary). Gauges get no
    text rollup (see module docstring). Families are merged by name;
    kind/help come from the first instance exposing them."""
    merged: Dict[str, Family] = {}
    rollups: Dict[str, Dict[Tuple[str, LabelTuple], float]] = {}
    for inst in sorted(per_instance):
        for fam in per_instance[inst]:
            out = merged.get(fam.name)
            if out is None:
                out = Family(fam.name, fam.kind, fam.help)
                merged[fam.name] = out
                rollups[fam.name] = {}
            for s in fam.samples:
                out.samples.append(Sample(
                    s.name, _with_instance(s.labels, inst), s.value))
                if out.kind in ("counter", "histogram"):
                    # rollup keys get the same instance →
                    # exported_instance rename as the per-instance
                    # samples, so a scraped target's own `instance`
                    # label never reappears as OUR instance dimension
                    key = (s.name, tuple(sorted(
                        ("exported_instance", v) if k == "instance"
                        else (k, v) for k, v in s.labels)))
                    roll = rollups[fam.name]
                    roll[key] = roll.get(key, 0.0) + s.value
    for name, fam in merged.items():
        for (sname, labels), value in sorted(rollups[name].items()):
            fam.samples.append(Sample(sname, labels, value))
    return [merged[name] for name in sorted(merged)]


class _Instance:
    """Scrape-side state of one instance (guarded by the federator
    lock): last good parse + when, cumulative stats."""

    __slots__ = ("families", "t_good", "scrapes", "errors",
                 "last_error", "last_scrape_s")

    def __init__(self):
        self.families: Optional[List[Family]] = None
        self.t_good: Optional[float] = None     # monotonic
        self.scrapes = 0
        self.errors = 0
        self.last_error: Optional[str] = None
        self.last_scrape_s = 0.0


# a source is either a base URL ("http://host:port") or an in-process
# registry-like object (to_prometheus_text + snapshot)
Source = Union[str, object]


class MetricsFederator:
    """Scrape N instances, merge, re-export — see module docstring.

    ``instances`` maps instance name → source: a base URL string
    (scraped over ``GET <url>/metrics``, health over ``/healthz``) or
    an in-process registry-like object (``to_prometheus_text()`` +
    ``snapshot()``). ``fleet`` optionally attaches the local
    :class:`~raft_tpu_torch.fleet.FleetRouter` so :meth:`healthz` can fold
    in its suspect set.

    Thread model: ONE scraper thread (:meth:`start`) sweeps on a
    ``time.monotonic`` cadence; any thread may read
    :meth:`merged_text`/:meth:`healthz`/:meth:`report` concurrently.
    Network and peer-registry I/O always happens OUTSIDE the lock —
    a slow replica can delay freshness, never block a reader."""

    GUARDED_BY = ("_sources", "_instances", "_scrape_s_total",
                  "_blackboxes")

    def __init__(self, instances: Optional[Dict[str, Source]] = None,
                 interval_s: float = 5.0,
                 stale_after_s: Optional[float] = None,
                 timeout_s: float = 2.0,
                 fleet: Optional[object] = None):
        self.interval_s = float(interval_s)
        self.stale_after_s = (float(stale_after_s)
                              if stale_after_s is not None
                              else 3.0 * self.interval_s)
        self.timeout_s = float(timeout_s)
        self.fleet = fleet
        self._lock = threading.Lock()
        self._sources: Dict[str, Source] = dict(instances or {})
        self._instances: Dict[str, _Instance] = {}
        # per-instance black-box dump paths: the aggregator remembers
        # where each replica's black box spills, so a dead instance's
        # report row still points at its forensics
        self._blackboxes: Dict[str, str] = {}
        self._scrape_s_total = 0.0
        self._t_started = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- membership --------------------------------------------------------
    def add_instance(self, name: str, source: Source) -> None:
        with self._lock:
            self._sources[name] = source

    def set_blackbox_path(self, name: str, path: Optional[str]) -> None:
        """Record (or clear, ``path=None``) where instance ``name``'s
        black box dumps — surfaced per-row in :meth:`report` so the
        doctor can be pointed at a dead replica straight from
        ``/debug/fleet``. Deliberately NOT dropped with the source in
        :meth:`remove_instance`'s instances map: the path outlives the
        process it names."""
        with self._lock:
            if path is None:
                self._blackboxes.pop(name, None)
            else:
                self._blackboxes[name] = str(path)

    def remove_instance(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)
            self._instances.pop(name, None)
            self._blackboxes.pop(name, None)

    def instance_names(self) -> List[str]:
        with self._lock:
            return sorted(self._sources)

    def url_instances(self) -> Dict[str, str]:
        """The URL-backed instances (name → base URL) — the peers a
        trace stitch can fetch fragments from (in-process registry
        instances share the local recorder already)."""
        with self._lock:
            return {n: s for n, s in self._sources.items()
                    if isinstance(s, str)}

    # -- scraping ----------------------------------------------------------
    def _fetch(self, name: str, source: Source) -> str:
        """One instance's exposition text (I/O — never under the
        lock). The fault site ``fed.scrape`` lets chaos tests fail or
        delay exactly this boundary."""
        faults.inject("fed.scrape", instance=name)
        if isinstance(source, str):
            url = source.rstrip("/") + "/metrics"
            with urllib.request.urlopen(
                    url, timeout=self.timeout_s) as resp:
                return resp.read().decode("utf-8")
        return source.to_prometheus_text()

    def scrape_once(self) -> dict:
        """One full sweep over every instance → ``{"scraped": n,
        "errors": n}``. Serial on purpose: N is replica-count small,
        and a serial sweep keeps the fault/timeout story trivially
        bounded at ``N * timeout_s``."""
        from raft_tpu_torch.obs import spans
        with self._lock:
            sources = dict(self._sources)
        errors = 0
        with spans.span("raft.obs.fed.scrape",
                        instances=len(sources)) as sp:
            for name in sorted(sources):
                t0 = time.monotonic()
                err: Optional[str] = None
                fams: Optional[List[Family]] = None
                try:
                    fams = parse_prometheus_text(
                        self._fetch(name, sources[name]))
                except Exception as e:
                    err = f"{type(e).__name__}: {e}"
                dur = time.monotonic() - t0
                obs.counter("raft.obs.fed.scrapes.total",
                            instance=name).inc()
                obs.histogram("raft.obs.fed.scrape.seconds",
                              buckets=_SCRAPE_BUCKETS).observe(dur)
                if err is not None:
                    errors += 1
                    obs.counter("raft.obs.fed.scrape.errors",
                                instance=name).inc()
                with self._lock:
                    inst = self._instances.setdefault(name, _Instance())
                    inst.scrapes += 1
                    inst.last_scrape_s = dur
                    self._scrape_s_total += dur
                    if err is None:
                        inst.families = fams
                        inst.t_good = t0
                        inst.last_error = None
                    else:
                        inst.errors += 1
                        inst.last_error = err
            sp.set_attrs(errors=errors)
        live = self.live_instances()
        obs.gauge("raft.obs.fed.instances").set(len(sources))
        obs.gauge("raft.obs.fed.stale").set(len(sources) - len(live))
        return {"scraped": len(sources), "errors": errors}

    def _stale_locked(self, name: str, now: float) -> bool:
        inst = self._instances.get(name)
        return (inst is None or inst.t_good is None
                or now - inst.t_good > self.stale_after_s)

    def live_instances(self) -> List[str]:
        """Instances with a good scrape inside the staleness window."""
        now = time.monotonic()
        with self._lock:
            return sorted(n for n in self._sources
                          if not self._stale_locked(n, now))

    def stale_instances(self) -> List[str]:
        now = time.monotonic()
        with self._lock:
            return sorted(n for n in self._sources
                          if self._stale_locked(n, now))

    # -- export ------------------------------------------------------------
    def merged(self) -> List[Family]:
        """The fleet-merged families over LIVE instances only (stale
        instances are absent — never frozen-healthy)."""
        now = time.monotonic()
        with self._lock:
            per = {name: list(inst.families)
                   for name, inst in self._instances.items()
                   if name in self._sources
                   and inst.families is not None
                   and not self._stale_locked(name, now)}
        return merge_families(per)

    def merged_text(self) -> str:
        """The aggregator ``/metrics`` body."""
        return render_prometheus_text(self.merged())

    def _extract(self, fams: List[Family], name: str) -> Dict[str, float]:
        """All samples of prom family ``name`` as series → value."""
        out: Dict[str, float] = {}
        for fam in fams:
            for s in fam.samples:
                if s.name == name:
                    out[f"{s.name}{_prom_labels(s.labels)}"] = s.value
        return out

    def healthz(self) -> dict:
        """The fleet health verdict: worst-of across per-instance
        verdicts. Stale and unreachable instances degrade — absence
        of evidence of health is evidence of degradation here."""
        now = time.monotonic()
        with self._lock:
            sources = dict(self._sources)
            stale = {n: self._stale_locked(n, now) for n in sources}
            lag: Dict[str, Dict[str, float]] = {}
            for n, inst in self._instances.items():
                if n in sources and inst.families is not None:
                    lag[n] = self._extract(
                        inst.families, "raft_fleet_replication_lag_records")
        per: Dict[str, dict] = {}
        for name in sorted(sources):
            if stale[name]:
                per[name] = {"status": "stale"}
                continue
            per[name] = self._instance_health(name, sources[name])
            if lag.get(name):
                per[name]["replication_lag_records"] = lag[name]
        degraded = (not per) or any(
            v.get("status") != "ok" for v in per.values())
        body = {
            "status": "degraded" if degraded else "ok",
            "instances": per,
            "stale": sorted(n for n in sources if stale[n]),
        }
        if self.fleet is not None:
            body["suspects"] = list(self.fleet.suspects())
        return body

    def _instance_health(self, name: str, source: Source) -> dict:
        """One instance's /healthz verdict (I/O — never under the
        lock)."""
        try:
            if isinstance(source, str):
                url = source.rstrip("/") + "/healthz"
                req = urllib.request.Request(url)
                try:
                    with urllib.request.urlopen(
                            req, timeout=self.timeout_s) as resp:
                        return json.loads(resp.read().decode("utf-8"))
                except urllib.error.HTTPError as he:
                    # /healthz answers 503 WITH a body when degraded
                    return json.loads(he.read().decode("utf-8"))
            from raft_tpu_torch.obs import endpoint as _endpoint
            return _endpoint._health_body(source.snapshot())
        except Exception as e:
            return {"status": "unreachable",
                    "error": f"{type(e).__name__}: {e}"}

    def report(self) -> dict:
        """The ``/debug/fleet`` federation section: per-instance
        scrape state + the well-known per-replica gauges side by
        side, gauge rollups (sum/min/max per series), and the
        aggregator's own overhead."""
        now = time.monotonic()
        with self._lock:
            sources = dict(self._sources)
            blackboxes = dict(self._blackboxes)
            rows: Dict[str, dict] = {}
            gauge_values: Dict[str, Dict[str, float]] = {}
            for name in sorted(sources):
                inst = self._instances.get(name)
                if inst is None:
                    row = {"state": "absent", "scrapes": 0,
                           "errors": 0}
                    if name in blackboxes:
                        row["blackbox"] = blackboxes[name]
                    rows[name] = row
                    continue
                state = ("stale" if self._stale_locked(name, now)
                         else "live")
                row = {
                    "state": state,
                    "scrapes": inst.scrapes,
                    "errors": inst.errors,
                    "last_scrape_s": round(inst.last_scrape_s, 6),
                    "age_s": (round(now - inst.t_good, 3)
                              if inst.t_good is not None else None),
                }
                if inst.last_error:
                    row["last_error"] = inst.last_error
                if name in blackboxes:
                    # the post-mortem pointer: a STALE row plus this
                    # path is the doctor's entry point
                    row["blackbox"] = blackboxes[name]
                if inst.families is not None:
                    for label, prom in (
                            ("duty_cycle",
                             "raft_obs_profile_duty_cycle"),
                            ("hbm_headroom_frac",
                             "raft_obs_profile_hbm_headroom_frac"),
                            ("slo_burn_rate", "raft_slo_burn_rate"),
                            ("replication_lag_records",
                             "raft_fleet_replication_lag_records"),
                            ("tiered_hit_rate", "raft_tiered_hit_rate"),
                            ("tiered_overlap_frac",
                             "raft_tiered_overlap_frac")):
                        vals = self._extract(inst.families, prom)
                        if vals:
                            row[label] = vals
                    if state == "live":
                        for fam in inst.families:
                            if fam.kind != "gauge":
                                continue
                            for s in fam.samples:
                                series = (f"{s.name}"
                                          f"{_prom_labels(s.labels)}")
                                gauge_values.setdefault(
                                    series, {})[name] = s.value
                rows[name] = row
            scrape_s = self._scrape_s_total
        uptime = max(1e-9, now - self._t_started)
        rollups = {
            series: {"sum": sum(vs.values()),
                     "min": min(vs.values()),
                     "max": max(vs.values())}
            for series, vs in sorted(gauge_values.items())
            if len(vs) > 1}
        return {
            "interval_s": self.interval_s,
            "stale_after_s": self.stale_after_s,
            "instances": rows,
            "gauge_rollups": rollups,
            "scrape_overhead": {
                "total_s": round(scrape_s, 6),
                "uptime_s": round(uptime, 3),
                "frac": round(scrape_s / uptime, 6),
            },
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MetricsFederator":
        """Start the scraper thread (idempotent). One immediate sweep,
        then one per ``interval_s`` on the monotonic clock."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="raft-obs-federator")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:
                # the sweep itself must never kill the thread; per-
                # instance failures are already typed and counted
                pass
            self._stop.wait(self.interval_s)

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(2.0, self.timeout_s + 1.0))
            self._thread = None

    def __enter__(self) -> "MetricsFederator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

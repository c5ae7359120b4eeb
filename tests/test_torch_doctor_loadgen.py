"""The port's doctor and load generator (``raft_tpu_torch.tools.doctor``,
``raft_tpu_torch.tools.loadgen``) against the JAX package's
``tools/doctor.py`` and ``tools/loadgen.py``, on the CPU.

* Every record set of the JAX package's doctor tests (its verdict,
  transition, window-fallback and transfer-bound cases) through both
  doctors: equal diagnoses, equal rendered text, the verdict each case
  names.
* ``parse_chaos_spec``, ``percentile``, ``fleet_route_share`` and
  ``merge_bytes_by_rung`` equal on the JAX tests' inputs.
* The JAX package's kill-replica post-mortem run through the port's
  loadgen (``--fleet 2 ... --device cpu``): the killed replica's dump,
  read apart from the run by both doctors, gives one diagnosis with a
  DOWN transition, final-window deltas, an accepted verdict and the
  kill flush.
* ``--fleet-procs 2 --federate --blackbox`` over CPU daemons, one
  SIGKILLed: no failed request, two federated instances with their own
  registries, the dead daemon's own dump read by both doctors alike.
* ``raft_tpu_torch`` imports no JAX, nothing of ``raft_tpu`` and nothing
  of the root ``tools`` package (a grep of its sources and a fresh
  interpreter).
"""

import io
import json
import os
import pathlib
import re
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from raft_tpu.obs import blackbox as jbb
from raft_tpu_torch.obs import blackbox as tbb
from raft_tpu_torch.obs import history as thist
from raft_tpu_torch.obs import profiler as tprof
from raft_tpu_torch.testing import faults as tfaults
from raft_tpu_torch.tools import doctor as tdoc
from raft_tpu_torch.tools import loadgen as tload
from tools import doctor as jdoc
from tools import loadgen as jload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACCEPTED = ("host-bound", "device-bound", "shed storm", "healthy",
            "compile storm")


def _frame(seq, t, counters=None, gauges=None):
    return {"seq": seq, "t_unix": t, "t_mono": t,
            "counters": counters or {}, "gauges": gauges or {}}


def _records(frames, gauges_final=None):
    recs = [{"kind": "meta", "t_unix": 0.0,
             "data": {"box": "r1", "pid": 1, "reason": "kill"}},
            {"kind": "frames", "t_unix": 99.0, "data": frames}]
    if gauges_final is not None:
        recs.append({"kind": "snapshot", "t_unix": 100.0,
                     "data": {"counters": {}, "gauges": gauges_final,
                              "histograms": {}}})
    return recs


def _series(n, **counters):
    return [_frame(i, float(i), dict(counters)) for i in range(1, n + 1)]


_STATE = "raft.fleet.replica.state{replica=r1}"
_TIERED = {
    "exposed": lambda i: {
        "raft.serve.completed.total": 10 * i,
        "raft.tiered.fetch.seconds": 0.5 * i,
        "raft.tiered.fetch.bytes": 1e8 * i,
        "raft.tiered.overlap.seconds": 0.05 * i,
        "raft.obs.profile.device.seconds": 0.1 * i},
    "hidden": lambda i: {
        "raft.serve.completed.total": 10 * i,
        "raft.tiered.fetch.seconds": 0.5 * i,
        "raft.tiered.overlap.seconds": 0.5 * i,
        "raft.obs.profile.device.seconds": 0.5 * i},
}

# case -> (records, the verdict the JAX package's test expects)
CASES = {
    "device_bound": (_records(
        _series(5, **{"raft.serve.completed.total": 50}),
        {"raft.obs.profile.duty_cycle": 0.95}), "device-bound"),
    "host_bound": (_records(
        _series(5, **{"raft.serve.completed.total": 100,
                      "raft.serve.shed.total": 1}),
        {"raft.obs.profile.duty_cycle": 0.10,
         "raft.serve.queue.depth": 40.0}), "host-bound"),
    "shed_storm": (_records(
        _series(5, **{"raft.serve.completed.total": 10,
                      "raft.serve.shed.total": 30}), {}), "shed storm"),
    "compile_storm_beats_duty": (_records(
        _series(5, **{"raft.plan.build.total": 3,
                      "raft.serve.completed.total": 5}),
        {"raft.obs.profile.duty_cycle": 0.95}), "compile storm"),
    "wal_gap": (_records(
        [_frame(1, 1.0, {"raft.mutate.wal.reader.gaps.total": 1})], {}),
        "WAL gap"),
    "low_hbm": (_records(
        [_frame(1, 1.0, {"raft.serve.completed.total": 5})],
        {"raft.obs.profile.hbm.headroom_frac{device=0}": 0.04}),
        "low-HBM"),
    "healthy": (_records(
        _series(5, **{"raft.serve.completed.total": 100}), {}), "healthy"),
    "transitions_and_final_window": (_records([
        _frame(1, 1.0, {}, {_STATE: 1.0}),
        _frame(2, 2.0, {"raft.serve.completed.total": 42}, {}),
        _frame(3, 3.0, {}, {_STATE: 3.0})], {}), "healthy"),
    "window_fallback_snapshot_diff": ([
        {"kind": "snapshot", "t_unix": 1.0,
         "data": {"counters": {"raft.serve.completed.total": 10},
                  "gauges": {}, "histograms": {}}},
        {"kind": "snapshot", "t_unix": 5.0,
         "data": {"counters": {"raft.serve.completed.total": 60},
                  "gauges": {}, "histograms": {}}}], "healthy"),
    "transfer_exposed_fetch_dominates": (_records(
        [_frame(i, float(i), _TIERED["exposed"](i)) for i in range(1, 6)],
        {"raft.obs.profile.duty_cycle": 0.2}), "transfer-bound"),
    "transfer_hidden_fetch_stays_quiet": (_records(
        [_frame(i, float(i), _TIERED["hidden"](i)) for i in range(1, 6)],
        {"raft.obs.profile.duty_cycle": 0.95}), "device-bound"),
    "empty": ([], "inconclusive"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_doctor_diagnoses_equal(case):
    recs, want = CASES[case]
    got = tdoc.diagnose(recs)
    assert got == jdoc.diagnose(recs)
    assert got["verdict"] == want
    assert tdoc.format_diagnosis(got) == jdoc.format_diagnosis(got)
    assert tdoc.final_window_deltas(recs, 2.0) == \
        jdoc.final_window_deltas(recs, 2.0)
    if case == "transitions_and_final_window":
        assert [t["to"] for t in got["transitions"]] == ["serving", "down"]
        assert got["transitions"][-1]["t_unix"] == 3.0
        assert got["final_window"]["counter_deltas"][
            "raft.serve.completed.total"] == 42
    if case == "window_fallback_snapshot_diff":
        deltas, _, span = tdoc.final_window_deltas(recs)
        assert deltas == {"raft.serve.completed.total": 50}
        assert span == 4.0


SPECS = ["kill_replica:1@t+2s+3s,stall_shard:0@t+1s",
         "kill_replica:2@t+2s+3s",
         "stall_shard:3@t+10s,kill_compactor@t+20s",
         "fail_transfer:2@t+1s+0.5s, delay_execute:50@t+0.25s,",
         "eat_replica:1@t+2s", "kill_replica:1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_chaos_spec_equal(spec):
    def parse(mod):
        try:
            return mod.parse_chaos_spec(spec, 5.0)
        except ValueError as e:
            return ("ValueError", str(e))
    assert parse(tload) == parse(jload)
    if spec.startswith("kill_replica:1@"):
        assert parse(tload) == [(1.0, "stall_shard", "0", 5.0),
                                (2.0, "kill_replica", "1", 3.0)]


def test_report_helpers_equal():
    for xs in ([1.0, 2.0, 3.0], [], [5.0, 1.0, 4.0, 2.0, 3.0]):
        for q in (0, 50, 99, 100):
            a, b = tload.percentile(xs, q), jload.percentile(xs, q)
            assert a == b or (a != a and b != b)
    routes = {"raft.fleet.route.total{replica=r0}": 30.0,
              "raft.fleet.route.total{replica=r1}": 10.0,
              "raft.serve.completed.total": 7.0}
    assert tload.fleet_route_share(routes) == \
        jload.fleet_route_share(routes) == {"r0": 0.75, "r1": 0.25}
    rungs = {"raft.serve.dist.merge.bytes_post{level=0}": 100.0,
             "raft.serve.dist.merge.bytes_post{level=1}": 40.0}
    assert tload.merge_bytes_by_rung(rungs) == \
        jload.merge_bytes_by_rung(rungs)


def _main(argv):
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            rc = tload.main(argv)
    finally:
        tprof.disable_profiling()
        thist.disable_history()
        tfaults.reset()
    return rc, json.loads(buf.getvalue().splitlines()[-1])


def test_kill_replica_post_mortem(tmp_path):
    """A ``kill()``-ed replica under the port's loadgen leaves a dump that
    both doctors, run apart from the live run, diagnose alike: the DOWN
    transition, final-window deltas, a host- or device-side verdict."""
    d = str(tmp_path / "bb")
    rc, report = _main(["--fleet", "2", "--n", "3000", "--n-lists", "8",
                        "--dim", "16", "--rate", "120", "--duration", "1.5",
                        "--chaos", "kill_replica:1@t+0.5s+30s",
                        "--profile-sample", "0.5", "--blackbox", d,
                        "--device", "cpu"])
    assert rc == 0 and report["errors"] == 0
    bb = report["blackbox"]
    assert bb["killed_replica"]["dump_readable"] is True
    assert bb["killed_replica"]["final_transition"]["to"] == "down"
    dump = os.path.join(d, "r1")
    diag = tdoc.diagnose_dump(dump)
    assert diag == jdoc.diagnose_dump(dump)
    downs = [t for t in diag["transitions"]
             if t["replica"] == "r1" and t["to"] == "down"]
    assert downs, diag
    assert diag["final_window"]["counter_deltas"]
    assert diag["verdict"] in ACCEPTED
    recs = jbb.read_dump(dump)
    assert recs == tbb.read_dump(dump)
    assert "kill" in {r["data"]["reason"] for r in recs
                      if r["kind"] == "meta"}
    assert report["fleet"]["replicas"] == 2
    assert set(bb["replicas"]) == {"r0", "r1"}


def test_fleet_procs_federate_blackbox(tmp_path, monkeypatch):
    """Two CPU daemons behind the router, r1 SIGKILLed and respawned:
    no failed request, two federated instances on their own registries,
    the respawned r1 scraped at its new url (F17: live, not stale), r1's
    own dump readable by both doctors."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("RAFT_TPU_BLACKBOX_INTERVAL", "0.5")
    rc, report = _main(["--fleet-procs", "2", "--n", "2000", "--n-lists",
                        "8", "--dim", "16", "--k", "4", "--probes-ladder",
                        "8", "--rate", "40", "--duration", "2.5",
                        "--federate", "--blackbox", "on", "--chaos",
                        "kill_replica:1@t+1s+30s", "--device", "cpu"])
    assert rc == 0 and report["errors"] == 0, report
    fed = report["federation"]
    assert sorted(fed["instances"]) == ["r0", "r1"]
    assert fed["instances_share_registry"] is False
    assert fed["stale"] == []       # r1 is scraped at its new url
    assert report["fleet"]["killed"] == 1
    killed = report["blackbox"]["killed_replica"]
    assert killed["name"] == "r1" and killed["dump_readable"] is True
    diag = tdoc.diagnose_dump(killed["dump_dir"])
    assert diag == jdoc.diagnose_dump(killed["dump_dir"])
    assert killed["verdict"] == diag["verdict"]
    assert [p["name"] for p in report["fleet"]["processes"]] == ["r0", "r1"]


def test_doctor_cli(tmp_path, capsys):
    box = tbb.BlackBox(str(tmp_path / "bb"), box="cli")
    box.close()
    assert tdoc.main([str(tmp_path / "bb"), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["records"] > 0 and out["meta"]["box"] == "cli"
    assert tdoc.main([str(tmp_path / "bb")]) == 0
    assert "VERDICT" in capsys.readouterr().out
    assert tdoc.main([str(tmp_path / "missing")]) == 2


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|raft_tpu|tools)\b",
                     re.M)


def test_port_imports_no_jax_nor_the_reference():
    port = pathlib.Path(REPO) / "raft_tpu_torch"
    bad = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
           for p in sorted(port.rglob("*.py"))
           for m in _IMPORT.finditer(p.read_text())]
    assert not bad, bad
    code = ("import sys\n"
            "import raft_tpu_torch.obs.federation, "
            "raft_tpu_torch.obs.blackbox, raft_tpu_torch.tools.doctor, "
            "raft_tpu_torch.tools.loadgen, raft_tpu_torch.fleet.fleetd\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'raft_tpu', 'tools'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_loadgen_refuses_cuda_without_a_card(tmp_path):
    """``--device cuda`` (the default) where no card is visible: a usage
    error before anything is built; no fallback to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.tools.loadgen", "--n",
         "1000", "--duration", "0.1"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr

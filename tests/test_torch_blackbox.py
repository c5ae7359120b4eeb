"""The port's crash-durable black box (``raft_tpu_torch.obs.blackbox``),
its ambient attach and the fleet's black-box hooks against the JAX
package's ``raft_tpu.obs.blackbox``, on the CPU.

* The on-disk format is shared: a dump the port writes is read by the JAX
  package's ``read_dump`` and a dump the JAX package writes by the
  port's, each reader giving the other's records exactly.
* A torn tail made through ``obs.blackbox.append`` (the header on disk,
  the payload not) stops both readers at the same record; a new box of
  either package over the directory truncates it, seals the intact
  prefix and counts ``raft.obs.blackbox.torn.total`` once.
* Rotation and pruning, the degrade-edge flush, the wire format's bad
  magic and absurd length, the detached module state.
* ``RAFT_TPU_BLACKBOX`` in subprocesses: off imports neither the black
  box nor the history; set, it attaches both and flushes at exit and on
  SIGTERM.
* ``Replica.kill()`` flushes a DOWN (3.0) state gauge into an attached
  box, and ``set_blackbox(<directory>)`` builds one.
"""

import json
import os
import struct
import subprocess
import sys
import time
import types
import zlib

import pytest

from raft_tpu.obs import blackbox as jbb
from raft_tpu.obs import history as jhist
from raft_tpu.obs import registry as jreg
from raft_tpu.testing import faults as jfaults
from raft_tpu_torch import fleet as tfleet
from raft_tpu_torch.obs import blackbox as tbb
from raft_tpu_torch.obs import history as thist
from raft_tpu_torch.obs import registry as treg
from raft_tpu_torch.testing import faults as tfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": types.SimpleNamespace(bb=jbb, hist=jhist, reg=jreg,
                                 faults=jfaults),
    "torch": types.SimpleNamespace(bb=tbb, hist=thist, reg=treg,
                                   faults=tfaults),
}
BOTH = sorted(PKGS)
OTHER = {"jax": "torch", "torch": "jax"}


@pytest.fixture(autouse=True)
def _clean_modules():
    yield
    for p in BOTH:
        PKGS[p].bb.disable_blackbox(flush=False)
        PKGS[p].hist.disable_history()
        PKGS[p].faults.reset()


def _box(p, path, **kw):
    """A box of package ``p`` over a private registry with a history fed
    two frames."""
    pk = PKGS[p]
    reg = pk.reg.MetricsRegistry(enabled=True)
    hist = pk.hist.MetricsHistory(registry=reg, interval_s=1.0, capacity=64)
    reg.counter("raft.t.ops.total").inc(5)
    reg.gauge("raft.fleet.replica.state", replica="rX").set(1)
    hist.tick(t=0.0)
    reg.counter("raft.t.ops.total").inc(2)
    hist.tick(t=1.0)
    return pk.bb.BlackBox(str(path), registry=reg, history=hist, **kw), reg


def _reasons(recs):
    return [r["data"]["reason"] for r in recs if r["kind"] == "meta"]


@pytest.mark.parametrize("writer", BOTH)
def test_dump_read_across_packages(writer, tmp_path):
    bb, _ = _box(writer, tmp_path / "bb", box="unit")
    bb.flush("manual")
    bb.close()
    recs = {p: PKGS[p].bb.read_dump(bb.dir) for p in BOTH}
    assert recs["torch"] == recs["jax"]
    got = recs[OTHER[writer]]
    assert {"meta", "snapshot", "healthz", "frames", "traces"} <= {
        r["kind"] for r in got}
    assert {r["box"] for r in got} == {"unit"}
    assert _reasons(got) == ["start", "manual", "close"]
    snap = [r for r in got if r["kind"] == "snapshot"][-1]
    assert snap["data"]["counters"]["raft.t.ops.total"] == 7
    seqs = [f["seq"] for r in got if r["kind"] == "frames"
            for f in r["data"]]
    assert seqs == [1, 2]
    names = sorted(os.listdir(bb.dir))
    assert names == ["bb-000000.seg"]
    with open(os.path.join(bb.dir, names[0]), "rb") as f:
        head = f.read(16)
    assert head[:8] == b"RTPUBBX1"
    length, crc = struct.unpack("<II", head[8:])
    with open(os.path.join(bb.dir, names[0]), "rb") as f:
        payload = f.read()[16:16 + length]
    assert zlib.crc32(payload) == crc
    assert json.loads(payload)["kind"] == "meta"
    assert b", " not in payload and b": " not in payload   # compact JSON


@pytest.mark.parametrize("writer", BOTH)
def test_torn_tail_recovered_across(writer, tmp_path):
    """A tear made by ``writer``'s own fault site, recovered by the other
    package's box."""
    pk, other = PKGS[writer], PKGS[OTHER[writer]]
    bb, reg = _box(writer, tmp_path / "bb")
    bb.flush("good")
    good = other.bb.read_dump(bb.dir)
    with pk.faults.inject_fault("obs.blackbox.append", action="error",
                                match={"kind": "snapshot"}):
        with pytest.raises(pk.faults.FaultError):
            bb.flush("doomed")
    # readable already: both readers stop at the tear, after the
    # doomed flush's meta record
    torn = {p: PKGS[p].bb.read_dump(bb.dir) for p in BOTH}
    assert torn["torch"] == torn["jax"]
    assert torn["torch"][:len(good)] == good
    assert _reasons(torn["torch"]) == ["start", "good", "doomed"]
    assert [r["kind"] for r in torn["torch"]][-1] == "meta"
    # the process dies: its file is closed unsealed, nothing else runs;
    # the next box reopens the directory
    bb._f.close()
    bb._f, bb._open_path, bb._closed = None, None, True
    before = other.reg.snapshot()["counters"].get(
        "raft.obs.blackbox.torn.total", 0.0)
    bb2 = other.bb.BlackBox(str(tmp_path / "bb"),
                            registry=other.reg.MetricsRegistry())
    after = other.reg.snapshot()["counters"].get(
        "raft.obs.blackbox.torn.total", 0.0)
    assert after - before == 1
    bb2.flush("after")
    bb2.close()
    recs = {p: PKGS[p].bb.read_dump(bb2.dir) for p in BOTH}
    assert recs["torch"] == recs["jax"]
    assert _reasons(recs["torch"]) == ["start", "good", "doomed", "start",
                                       "after", "close"]
    for path in tbb._segment_files(bb2.dir):
        assert path.endswith(".seg")
        it = tbb._iter_segment(path)
        while True:
            try:
                next(it)
            except StopIteration as stop:
                assert not stop.value, f"torn bytes left in {path}"
                break


def test_rotation_and_prune(tmp_path):
    reg = treg.MetricsRegistry(enabled=True)
    for i in range(300):
        reg.counter("raft.t.rot.total", series=f"s{i:03d}").inc()
    bb = tbb.BlackBox(str(tmp_path / "bb"), registry=reg,
                      max_segment_bytes=4096, max_segments=3)
    for i in range(12):
        bb.flush(f"f{i}")
    files = tbb._segment_files(bb.dir)
    assert len(files) <= 3
    reasons = _reasons(jbb.read_dump(bb.dir))
    assert "f11" in reasons and "f0" not in reasons
    assert bb.report()["max_segments"] == 3
    bb.close()
    assert all(f.endswith(".seg") for f in tbb._segment_files(bb.dir))


def test_degrade_edge_triggers_flush(tmp_path):
    reg = treg.MetricsRegistry(enabled=True)
    bb = tbb.BlackBox(str(tmp_path / "bb"), registry=reg,
                      interval_s=3600.0)
    g = reg.gauge("raft.serve.overloaded")
    try:
        bb.start()
        g.set(1.0)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and \
                "degrade" not in _reasons(tbb.read_dump(bb.dir)):
            time.sleep(0.05)
        assert "degrade" in _reasons(tbb.read_dump(bb.dir))
    finally:
        g.set(0.0)
        bb.close()


def test_wire_format_edges(tmp_path):
    p = str(tmp_path / "bb-000000.seg")
    with open(p, "wb") as f:
        f.write(b"NOTMAGIC" + b"\x00" * 16)
    assert tbb.read_segment(p) == [] == jbb.read_segment(p)
    payload = json.dumps({"kind": "meta", "t_unix": 0, "reason": "x",
                          "box": "b", "data": {}}).encode()
    with open(p, "wb") as f:
        f.write(tbb._MAGIC)
        f.write(struct.pack("<II", len(payload), zlib.crc32(payload)))
        f.write(payload)
        f.write(struct.pack("<II", 1 << 30, 0))   # an absurd length
    assert len(tbb.read_segment(p)) == 1
    assert tbb.read_segment(p) == jbb.read_segment(p)
    assert tbb.read_dump(str(tmp_path / "missing")) == []


def test_module_state_when_detached(tmp_path):
    assert tbb.flush("x") == 0
    assert tbb.state() is None and tbb.enabled() is False
    box = tbb.enable_blackbox(str(tmp_path / "amb"), start=False,
                              exit_hooks=False)
    assert tbb.state() is box and tbb.enabled()
    assert tbb.flush("manual") > 0
    tbb.disable_blackbox()
    assert tbb.state() is None
    assert _reasons(tbb.read_dump(box.dir)) == ["start", "manual", "close"]


def _run(code, env_extra, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "RAFT_TPU_BLACKBOX"}
    env.update(PYTHONPATH=REPO, **env_extra)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("off", ["0", "off", "unset"])
def test_env_off_imports_nothing(off, tmp_path):
    code = ("import sys\n"
            "import raft_tpu_torch.obs\n"
            "assert 'raft_tpu_torch.obs.blackbox' not in sys.modules\n"
            "assert 'raft_tpu_torch.obs.history' not in sys.modules\n"
            "from raft_tpu_torch.obs import blackbox, history\n"
            "assert blackbox.state() is None\n"
            "assert history.history() is None\n"
            "print('CLEAN')\n")
    env = {} if off == "unset" else {"RAFT_TPU_BLACKBOX": off}
    out = _run(code, env, tmp_path)
    assert out.returncode == 0 and "CLEAN" in out.stdout, out.stderr


def test_env_set_attaches_and_flushes_at_exit(tmp_path):
    d = str(tmp_path / "amb")
    code = ("from raft_tpu_torch.obs import blackbox, history\n"
            "assert blackbox.state() is not None\n"
            "assert history.history() is not None\n"
            "import raft_tpu_torch.obs as o\n"
            "o.REGISTRY.counter('raft.t.sub.total').inc(3)\n")
    out = _run(code, {"RAFT_TPU_BLACKBOX": d}, tmp_path)
    assert out.returncode == 0, out.stderr
    recs = jbb.read_dump(d)
    assert recs == tbb.read_dump(d)
    assert _reasons(recs)[0] == "start" and "atexit" in _reasons(recs)
    snap = [r for r in recs if r["kind"] == "snapshot"][-1]
    assert snap["data"]["counters"]["raft.t.sub.total"] == 3


def test_sigterm_flushes(tmp_path):
    d = str(tmp_path / "term")
    code = ("import os, signal, time\n"
            "import raft_tpu_torch.obs\n"
            "os.kill(os.getpid(), signal.SIGTERM)\n"
            "time.sleep(10)\n")
    out = _run(code, {"RAFT_TPU_BLACKBOX": d}, tmp_path)
    assert out.returncode != 0
    assert "sigterm" in _reasons(tbb.read_dump(d))


def test_replica_kill_flushes_down_state(tmp_path):
    rep = tfleet.Replica("rX", server=None,
                         state=tfleet.ReplicaState.SERVING)
    bb = tbb.BlackBox(str(tmp_path / "rX"), box="rX")
    rep.set_blackbox(bb)
    assert rep.describe()["blackbox"] == bb.dir
    rep.kill()
    recs = jbb.read_dump(bb.dir)
    assert "kill" in _reasons(recs)
    snap = [r for r in recs if r["kind"] == "snapshot"][-1]
    assert snap["data"]["gauges"][
        "raft.fleet.replica.state{replica=rX}"] == 3.0
    bb.close(flush=False)
    # a directory in place of a box: a box is built for it
    rep2 = tfleet.Replica("rY", server=None,
                          state=tfleet.ReplicaState.SERVING)
    rep2.set_blackbox(str(tmp_path / "rY"))
    assert rep2.describe()["blackbox"] == str(tmp_path / "rY")
    rep2.stop()
    assert _reasons(tbb.read_dump(str(tmp_path / "rY"))) == ["start",
                                                             "stop"]

"""The port's mutation WAL (``raft_tpu_torch.mutate.wal``) and the WAL half
of its ``MutableIndex`` against the JAX package's, on the CPU.

Mirrors ``tests/test_faults.py::TestWal``/``TestWalRecovery`` and
``tests/test_fleet.py::TestWalSequencing`` through both packages, then
holds them to each other:

* the byte format: with both modules' ``time`` patched to one fake
  clock, the same operations write byte-identical logs, and each
  package's ``replay``, ``WalReader.tail`` and ``decode_stream`` read the
  other's log;
* torn tails are truncated alike, and a reader behind a ``rewrite`` gets
  the same ``WalGapError`` in both;
* ``recover`` gives the JAX package's ids (the JAX package's IVF-Flat
  index, 1200 x 16 in 8 lists, handed to the port through
  ``index_from_numpy``), with and without a checkpoint, and the port
  recovers from the JAX package's log and checkpoint;
* a writer process on the CPU killed with ``SIGKILL`` after printing its
  acknowledged count loses no acknowledged mutation.

Tolerances: ids identical; distances of one package against itself
within rtol 1e-6, across the packages within 2e-6 of ``|q|^2 + max
|x|^2`` (the expanded-L2 form's fp32 rounding, ~1e-4 at these norms).
Counters are read from ``snapshot()``, never registered here under a
literal name.
"""

import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from raft_tpu import mutate as jmutate
from raft_tpu import obs as jobs
from raft_tpu.mutate import wal as jwal
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import serialize as jser
from raft_tpu_torch import mutate as tmutate
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.mutate import wal as twal
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import serialize as tser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4
CAPS = (64, 256)
FLAT_FIELDS = ("centers", "lists_data", "lists_indices", "lists_norms",
               "list_sizes")
PKGS = {
    "jax": types.SimpleNamespace(wal=jwal, mutate=jmutate, obs=jobs,
                                 ser=jser),
    "torch": types.SimpleNamespace(wal=twal, mutate=tmutate, obs=tobs,
                                   ser=tser),
}
BOTH = sorted(PKGS)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _csum(snap, name):
    return sum(v for k, v in snap["counters"].items()
               if k == name or k.startswith(name + "{"))


def _cdiff(ns, before, name):
    return _csum(ns.obs.snapshot(), name) - _csum(before, name)


class _Clock:
    """A fake ``time`` module: ``time()`` steps by 0.25 s from a fixed
    start, the same sequence for each package."""

    def __init__(self):
        self.t = 1.7e9

    def time(self):
        self.t += 0.25
        return self.t


@pytest.fixture
def one_clock(monkeypatch):
    monkeypatch.setattr(jwal, "time", _Clock())
    monkeypatch.setattr(twal, "time", _Clock())


@pytest.fixture(scope="module")
def small_flat():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 4.0
    x = (centers[rng.integers(0, 8, 1200)]
         + rng.normal(size=(1200, 16)).astype(np.float32))
    return x, jflat.build(x, jflat.IndexParams(n_lists=8, kmeans_n_iters=3))


def _port(jidx):
    return tflat.index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in FLAT_FIELDS},
        int(jidx.metric), jidx.size, float(jidx.scale), device="cpu")


def _index(pkg, jidx):
    return jidx if pkg == "jax" else _port(jidx)


def _mindex(pkg, idx):
    ns = PKGS[pkg]
    return ns.mutate.MutableIndex(
        idx, k=K, config=ns.mutate.MutateConfig(delta_capacities=CAPS))


def _ids(m, q):
    d, i = m.search(q, block=True)
    return np.asarray(d), np.asarray(i)


def _close_across(d_a, d_b, q, x):
    """Distances of the two packages within 2e-6 of ``|q|^2 + max
    |x|^2``."""
    scale = (q * q).sum(1)[:, None] + float((x * x).sum(1).max())
    assert (np.abs(np.asarray(d_a) - np.asarray(d_b)) <= 2e-6 * scale).all()


def _ops(w):
    """The same operations into a WAL ``w`` of either package."""
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    w.append_upsert([5, 6, 9], rows)
    w.append_delete([3])
    w.append_meta({"epoch": 2, "id_base": 10, "next_id": 12})
    w.append_upsert(np.array([11], np.int64), rows[1:2] * -0.5)
    w.append_delete(np.array([5, 6], np.int32))


# ---------------------------------------------------------------------------
# the log itself, each package (test_faults.py::TestWal)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH)
class TestWal:
    def test_round_trip_and_order(self, tmp_path, pkg):
        ns = PKGS[pkg]
        p = str(tmp_path / "m.wal")
        w = ns.wal.MutationWAL(p, sync=True)
        rows = np.arange(8, dtype=np.float32).reshape(2, 4)
        before = ns.obs.snapshot()
        w.append_upsert([5, 6], rows)
        w.append_delete([3])
        w.close()
        assert _cdiff(ns, before, "raft.mutate.wal.fsyncs.total") == 2
        assert _cdiff(ns, before, "raft.mutate.wal.appends.total") == 2
        recs = ns.wal.MutationWAL(p, sync=False).replay()
        assert [r.op for r in recs] == [1, 2]
        np.testing.assert_array_equal(recs[0].ids, [5, 6])
        np.testing.assert_array_equal(recs[0].rows, rows)
        np.testing.assert_array_equal(recs[1].ids, [3])

    def test_torn_tail_detected_and_repaired(self, tmp_path, pkg):
        ns = PKGS[pkg]
        p = str(tmp_path / "m.wal")
        w = ns.wal.MutationWAL(p, sync=False)
        w.append_delete([1])
        w.close()
        with open(p, "ab") as f:    # crash mid-append: torn record
            f.write(b"\x40\x00\x00\x00\xde\xad\xbe\xefjunk")
        before = ns.obs.snapshot()
        w2 = ns.wal.MutationWAL(p, sync=False)
        assert w2.torn_bytes > 0
        assert _cdiff(ns, before, "raft.mutate.wal.torn.total") >= 1
        assert [r.op for r in w2.replay()] == [2]
        # the reopen truncated the torn bytes: appends continue cleanly
        w2.append_delete([2])
        w2.close()
        assert [r.op for r in ns.wal.MutationWAL(p, sync=False).replay()] \
            == [2, 2]

    def test_corrupt_payload_stops_replay(self, tmp_path, pkg):
        ns = PKGS[pkg]
        p = str(tmp_path / "m.wal")
        w = ns.wal.MutationWAL(p, sync=False)
        w.append_delete([1])
        w.append_delete([2])
        w.close()
        data = bytearray(open(p, "rb").read())
        data[-1] ^= 0xFF            # flip a byte in the LAST record
        open(p, "wb").write(bytes(data))
        recs = ns.wal.MutationWAL(p, sync=False).replay()
        assert [r.ids.tolist() for r in recs] == [[1]]


# ---------------------------------------------------------------------------
# sequencing and the reader (test_fleet.py::TestWalSequencing)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH)
class TestWalSequencing:
    def test_seqs_monotone_contiguous_and_restored(self, tmp_path, pkg):
        ns = PKGS[pkg]
        p = str(tmp_path / "m.wal")
        w = ns.wal.MutationWAL(p, sync=False)
        w.append_upsert([1, 2], np.zeros((2, 4), np.float32))
        w.append_delete([1])
        w.append_delete([2])
        recs = w.replay()
        assert [r.seq for r in recs] == [1, 2, 3]
        assert all(r.ts > 0 for r in recs)
        w.close()
        w2 = ns.wal.MutationWAL(p, sync=False)
        assert w2.next_seq == 4
        w2.append_delete([3])
        assert [r.seq for r in w2.replay()] == [1, 2, 3, 4]

    def test_reader_tail_positions_and_increments(self, tmp_path, pkg):
        ns = PKGS[pkg]
        p = str(tmp_path / "m.wal")
        w = ns.wal.MutationWAL(p, sync=False)
        for i in range(5):
            w.append_delete([i])
        r = ns.wal.WalReader(p)
        assert [x.seq for x in r.tail()] == [1, 2, 3, 4, 5]
        assert r.tail() == [] and r.position == 5
        w.append_delete([9])
        assert [x.seq for x in r.tail()] == [6]
        r2 = ns.wal.WalReader(p, from_seq=3)
        assert [x.seq for x in r2.tail(max_records=2)] == [4, 5]
        assert [x.seq for x in r2.tail()] == [6]

    def test_reader_resumes_across_rewrite(self, tmp_path, pkg):
        ns = PKGS[pkg]
        p = str(tmp_path / "m.wal")
        w = ns.wal.MutationWAL(p, sync=False)
        rows = np.arange(8, dtype=np.float32).reshape(2, 4)
        w.append_upsert([5, 6], rows)
        w.append_delete([5])
        r = ns.wal.WalReader(p)
        assert len(r.tail()) == 2
        before = ns.obs.snapshot()
        w.rewrite(meta={"epoch": 1, "id_base": 10, "next_id": 20},
                  tomb_ids=[5], upsert_ids=[6], upsert_rows=rows[:1])
        assert _cdiff(ns, before, "raft.mutate.wal.truncations.total") == 1
        recs = r.tail()
        assert [(x.seq, x.op) for x in recs] == [(3, 3), (4, 2), (5, 1)]
        assert recs[0].meta["snapshot_upto_seq"] == 5
        w.append_delete([7])
        assert [x.seq for x in r.tail()] == [6]

    def test_behind_reader_gaps_fresh_reader_does_not(self, tmp_path, pkg):
        ns = PKGS[pkg]
        p = str(tmp_path / "m.wal")
        w = ns.wal.MutationWAL(p, sync=False)
        for i in range(4):
            w.append_delete([i])
        w.rewrite(meta={"epoch": 1, "id_base": 4, "next_id": 4})
        before = ns.obs.snapshot()
        with pytest.raises(ns.wal.WalGapError) as gap:
            ns.wal.WalReader(p, from_seq=2).tail()
        assert (gap.value.last_seq, gap.value.first_seq) == (2, 5)
        assert _cdiff(ns, before, "raft.mutate.wal.reader.gaps.total") == 1
        assert [x.op for x in ns.wal.WalReader(p).tail()] == [3]


# ---------------------------------------------------------------------------
# the byte format across the packages
# ---------------------------------------------------------------------------


class TestByteFormat:
    def test_same_operations_write_identical_bytes(self, tmp_path,
                                                   one_clock):
        paths = {}
        for pkg in BOTH:
            paths[pkg] = str(tmp_path / f"{pkg}.wal")
            w = PKGS[pkg].wal.MutationWAL(paths[pkg], sync=False)
            _ops(w)
            w.rewrite(meta={"epoch": 3, "id_base": 12, "next_id": 14},
                      tomb_ids=[3, 6], upsert_ids=[11],
                      upsert_rows=np.ones((1, 4), np.float32))
            w.append_delete([11])
            w.close()
        data = {p: open(paths[p], "rb").read() for p in BOTH}
        assert data["jax"][:8] == b"RTPUWAL2"
        assert data["torch"] == data["jax"]

    def test_tensors_encode_as_numpy(self, tmp_path, one_clock):
        """Ids and rows handed in as torch tensors write the bytes of
        the same numpy arrays."""
        a, b = str(tmp_path / "a.wal"), str(tmp_path / "b.wal")
        rows = np.random.default_rng(1).normal(size=(3, 5)).astype(
            np.float32)
        wa = twal.MutationWAL(a, sync=False)
        wa.append_upsert(np.array([4, 8, 1]), rows)
        wa.append_delete([8])
        wb = twal.MutationWAL(b, sync=False)
        twal.time.t = 1.7e9     # the same clock for the second log
        wb.append_upsert(torch.tensor([4, 8, 1], dtype=torch.int32),
                         torch.from_numpy(rows))
        wb.append_delete(torch.tensor([8]))
        assert open(a, "rb").read() == open(b, "rb").read()

    @pytest.mark.parametrize("writer", BOTH)
    def test_each_package_replays_the_others_log(self, tmp_path, writer):
        reader = "torch" if writer == "jax" else "jax"
        p = str(tmp_path / "m.wal")
        w = PKGS[writer].wal.MutationWAL(p, sync=False)
        _ops(w)
        w.close()
        mine = PKGS[writer].wal.MutationWAL(p, sync=False).replay()
        theirs = PKGS[reader].wal.MutationWAL(p, sync=False).replay()
        tail = PKGS[reader].wal.WalReader(p).tail()
        for got in (theirs, tail):
            assert [(r.seq, r.op, r.ts) for r in got] == \
                [(r.seq, r.op, r.ts) for r in mine]
            for a, b in zip(got, mine):
                for f in ("ids", "rows"):
                    if getattr(b, f) is None:
                        assert getattr(a, f) is None
                    else:
                        np.testing.assert_array_equal(getattr(a, f),
                                                      getattr(b, f))
                assert a.meta == b.meta
        # the reader's appends continue the writer's sequence space
        w2 = PKGS[reader].wal.MutationWAL(p, sync=False)
        assert w2.next_seq == 6
        w2.append_delete([1])
        assert [r.seq for r in PKGS[writer].wal.MutationWAL(
            p, sync=False).replay()] == [1, 2, 3, 4, 5, 6]

    @pytest.mark.parametrize("writer", BOTH)
    def test_wire_slices_decode_across(self, tmp_path, writer):
        reader = "torch" if writer == "jax" else "jax"
        p = str(tmp_path / "m.wal")
        w = PKGS[writer].wal.MutationWAL(p, sync=False)
        _ops(w)
        bufs = {pkg: PKGS[pkg].wal.read_raw(p, from_seq=2)
                for pkg in BOTH}
        assert bufs["jax"] == bufs["torch"]
        buf, n, last = bufs[writer]
        assert (n, last) == (3, 5)
        recs = PKGS[reader].wal.decode_stream(buf)
        assert [r.seq for r in recs] == [3, 4, 5]
        assert recs[0].meta == {"epoch": 2, "id_base": 10, "next_id": 12}


class TestTornAndGap:
    def test_torn_tail_truncated_alike(self, tmp_path):
        src = str(tmp_path / "src.wal")
        w = jwal.MutationWAL(src, sync=False)
        _ops(w)
        w.close()
        torn = open(src, "rb").read()[:-7]      # cut into the last record
        sizes = {}
        for pkg in BOTH:
            p = str(tmp_path / f"{pkg}.wal")
            open(p, "wb").write(torn)
            w = PKGS[pkg].wal.MutationWAL(p, sync=False)
            sizes[pkg] = (w.torn_bytes, w.next_seq, os.path.getsize(p))
            w.append_delete([42])
            w.close()
        assert sizes["torch"] == sizes["jax"]
        assert open(str(tmp_path / "torch.wal"), "rb").read() != torn
        recs = {pkg: [(r.seq, r.op) for r in PKGS[pkg].wal.MutationWAL(
            str(tmp_path / f"{pkg}.wal"), sync=False).replay()]
            for pkg in BOTH}
        assert recs["torch"] == recs["jax"] == \
            [(1, 1), (2, 2), (3, 3), (4, 1), (5, 2)]

    def test_gap_after_rewrite_alike(self, tmp_path):
        gaps = {}
        for pkg in BOTH:
            ns = PKGS[pkg]
            p = str(tmp_path / f"{pkg}.wal")
            w = ns.wal.MutationWAL(p, sync=False)
            _ops(w)
            r = ns.wal.WalReader(p)
            r.tail(max_records=2)
            w.rewrite(meta={"epoch": 1, "id_base": 12, "next_id": 12},
                      tomb_ids=[3])
            with pytest.raises(ns.wal.WalGapError) as e:
                r.tail()
            with pytest.raises(ns.wal.WalGapError):
                ns.wal.read_raw(p, from_seq=2)
            gaps[pkg] = (e.value.last_seq, e.value.first_seq, str(e.value))
        assert gaps["torch"] == gaps["jax"]
        assert gaps["jax"][:2] == (2, 6)


# ---------------------------------------------------------------------------
# recovery (test_faults.py::TestWalRecovery) against the JAX package
# ---------------------------------------------------------------------------


def _mutate_some(m, x, seed=0):
    rng = np.random.default_rng(seed)
    ids = m.upsert(x[:10] + 0.01)
    m.delete(np.asarray(ids[:3]))
    m.delete([2, 5])
    m.upsert(x[10:12] + 0.02, ids=np.asarray(ids[3:5]))   # replace
    m.upsert(rng.standard_normal((4, 16)).astype(np.float32))
    return ids


_STATS = ("delta_used", "delta_live", "tombstones", "next_id", "id_base",
          "epoch")


class TestRecover:
    def test_acked_mutations_replay_like_jax(self, small_flat, tmp_path):
        x, jidx = small_flat
        q = x[:16]
        got = {}
        for pkg in BOTH:
            ns = PKGS[pkg]
            idx = _index(pkg, jidx)
            wal_p = str(tmp_path / f"{pkg}.wal")
            m = _mindex(pkg, idx)
            m.attach_wal(ns.wal.MutationWAL(wal_p))
            _mutate_some(m, x)
            live = _ids(m, q)
            # crash: the process dies with the object — nothing closed
            m2 = ns.mutate.MutableIndex.recover(
                wal_p, k=K, base_index=idx,
                config=ns.mutate.MutateConfig(delta_capacities=CAPS))
            for key in _STATS:
                assert m.stats()[key] == m2.stats()[key], (pkg, key)
            back = _ids(m2, q)
            np.testing.assert_array_equal(back[1], live[1])
            np.testing.assert_allclose(back[0], live[0], rtol=1e-6)
            got[pkg] = (back, {k: m2.stats()[k] for k in _STATS})
        np.testing.assert_array_equal(got["torch"][0][1], got["jax"][0][1])
        _close_across(got["torch"][0][0], got["jax"][0][0], q, x)
        assert got["torch"][1] == got["jax"][1]

    def test_checkpointed_compaction_like_jax(self, small_flat, tmp_path):
        x, jidx = small_flat
        q = x[:16]
        got = {}
        for pkg in BOTH:
            ns = PKGS[pkg]
            wal_p = str(tmp_path / f"{pkg}.wal")
            ckpt_p = str(tmp_path / f"{pkg}.ckpt")
            m = _mindex(pkg, _index(pkg, jidx))
            m.attach_wal(ns.wal.MutationWAL(wal_p), checkpoint_path=ckpt_p)
            _mutate_some(m, x)
            before = ns.obs.snapshot()
            assert m.compact()
            assert os.path.exists(ckpt_p)
            assert _cdiff(ns, before,
                          "raft.mutate.wal.truncations.total") == 1
            recs = ns.wal.MutationWAL(wal_p, sync=False).replay()
            assert [r.op for r in recs] == [3]      # the meta record alone
            assert recs[0].seq == 6                 # the space continues
            ids = m.upsert(x[20:24] + 0.03)
            m.delete([int(ids[0]), 9])
            live = _ids(m, q)
            kw = {"device": "cpu"} if pkg == "torch" else {}
            m2 = ns.mutate.MutableIndex.recover(
                wal_p, k=K, checkpoint_path=ckpt_p,
                config=ns.mutate.MutateConfig(delta_capacities=CAPS), **kw)
            for key in _STATS:
                assert m.stats()[key] == m2.stats()[key], (pkg, key)
            np.testing.assert_array_equal(_ids(m2, q)[1], live[1])
            got[pkg] = live[1]
        # after a fold each package labels the delta rows with its own
        # kernel 1: ids agree on (nearly) every entry
        assert np.mean(got["torch"] == got["jax"]) >= 0.999

    def test_port_recovers_the_jax_packages_files(self, small_flat,
                                                  tmp_path):
        """The JAX package writes the log and the checkpoint; the port
        recovers from them to the JAX package's live ids."""
        x, jidx = small_flat
        q = x[:16]
        wal_p, ckpt_p = str(tmp_path / "m.wal"), str(tmp_path / "m.ckpt")
        m = _mindex("jax", jidx)
        m.attach_wal(jwal.MutationWAL(wal_p), checkpoint_path=ckpt_p)
        _mutate_some(m, x)
        m.compact()
        m.upsert(x[30:33] + 0.05)
        m.delete([11, 12])
        live = _ids(m, q)
        back = tmutate.MutableIndex.recover(
            wal_p, k=K, checkpoint_path=ckpt_p, device="cpu",
            config=tmutate.MutateConfig(delta_capacities=CAPS))
        assert back.index.device.type == "cpu"
        for key in _STATS:
            assert back.stats()[key] == m.stats()[key], key
        d, i = _ids(back, q)
        np.testing.assert_array_equal(i, live[1])
        _close_across(d, live[0], q, x)
        # and the port's appends continue the JAX package's log
        back.delete([13])
        recs = jwal.MutationWAL(wal_p, sync=False).replay()
        assert recs[-1].op == 2 and recs[-1].ids.tolist() == [13]

    def test_replay_overflow_compacts_inline(self, small_flat, tmp_path):
        x, jidx = small_flat
        idx = _port(jidx)
        wal_p = str(tmp_path / "m.wal")
        m = tmutate.MutableIndex(idx, k=K, config=tmutate.MutateConfig(
            delta_capacities=(64, 256)))
        m.attach_wal(twal.MutationWAL(wal_p, sync=False))
        rng = np.random.default_rng(3)
        acked = m.upsert(rng.standard_normal((100, 16)).astype(np.float32))
        # recovery under a SMALLER delta budget compacts inline
        m2 = tmutate.MutableIndex.recover(
            wal_p, k=K, base_index=idx, sync=False,
            config=tmutate.MutateConfig(delta_capacities=(8, 32)))
        assert m2.size == m.size and m2.epoch >= 1
        assert int(m2.search(rng.standard_normal((1, 16)).astype(
            np.float32), block=True)[1].min()) >= 0
        assert acked.shape[0] == 100

    def test_reader_apply_matches_recover(self, small_flat, tmp_path):
        """Ordered at-least-once apply through the reader reproduces what
        crash recovery reproduces — the reader is the replication
        protocol."""
        x, jidx = small_flat
        idx = _port(jidx)
        p = str(tmp_path / "m.wal")
        m = _mindex("torch", idx)
        m.attach_wal(twal.MutationWAL(p, sync=False))
        ids = m.upsert(x[:10] + 0.01)
        m.delete(ids[:3])
        m.upsert(x[10:12] + 0.02, ids=ids[3:5])
        follower = _mindex("torch", idx)
        for rec in twal.WalReader(p).tail():
            if rec.op == twal.OP_UPSERT:
                follower.upsert(rec.rows, ids=rec.ids)
            elif rec.op == twal.OP_DELETE:
                follower.delete(rec.ids)
        recovered = tmutate.MutableIndex.recover(
            p, k=K, base_index=idx, sync=False,
            config=tmutate.MutateConfig(delta_capacities=CAPS))
        assert follower.stats() == recovered.stats()
        np.testing.assert_array_equal(_ids(follower, x[:16])[1],
                                      _ids(recovered, x[:16])[1])


# ---------------------------------------------------------------------------
# a crash between the checkpoint's promotion and the log's rewrite
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def crash_flat():
    """3000 x 16 in 16 lists, the port's own CPU build."""
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(16, 16)).astype(np.float32) * 4.0
    x = (centers[rng.integers(0, 16, 3000)]
         + rng.normal(size=(3000, 16)).astype(np.float32))
    idx = tflat.build(x, tflat.IndexParams(n_lists=16, kmeans_n_iters=4),
                      device="cpu")
    return x, idx


_CRASH_CFG = dict(delta_capacities=(256, 1024))


def _fold(m, crash, monkeypatch):
    """``m.compact()``; with ``crash`` the log's rewrite raises, as a
    process that dies right after the checkpoint's promotion."""
    if not crash:
        assert m.compact()
        return
    with monkeypatch.context() as mp:
        def died(*_a, **_k):
            raise SystemExit("killed after the checkpoint's promotion")
        mp.setattr(twal.MutationWAL, "rewrite", died)
        with pytest.raises(SystemExit):
            m.compact()


def _crash_run(idx, x, tmp, folds, crash, monkeypatch):
    """Delete ids 0-199 and upsert ids 3000-3099, fold; with ``folds`` 2
    delete 300-349 and upsert 3100-3149, fold again. Only the last fold
    may crash. Returns the index recovered from the files and the
    upserted rows."""
    wal_p, ckpt_p = str(tmp / "m.wal"), str(tmp / "m.ckpt")
    cfg = tmutate.MutateConfig(**_CRASH_CFG)
    m = tmutate.MutableIndex(idx, k=8, config=cfg)
    m.attach_wal(twal.MutationWAL(wal_p, sync=False),
                 checkpoint_path=ckpt_p)
    rng = np.random.default_rng(5)
    rounds = [(np.arange(0, 200), np.arange(3000, 3100)),
              (np.arange(300, 350), np.arange(3100, 3150))][:folds]
    rows = []
    for r, (dead, new_ids) in enumerate(rounds):
        m.delete(dead)
        v = (x[rng.integers(0, x.shape[0], new_ids.shape[0])]
             + rng.normal(size=(new_ids.shape[0], 16)).astype(np.float32))
        m.upsert(v, ids=new_ids)
        rows.append(v)
        _fold(m, crash and r == folds - 1, monkeypatch)
    del m           # the process dies with the object
    back = tmutate.MutableIndex.recover(
        wal_p, k=8, checkpoint_path=ckpt_p, device="cpu", sync=False,
        config=cfg)
    return back, np.concatenate(rows)


@pytest.mark.parametrize("folds", [1, 2])
def test_recover_after_a_crash_between_promotion_and_rewrite(
        crash_flat, tmp_path, monkeypatch, folds):
    """The crash leaves the new checkpoint beside the old log (whose head
    meta, after the second fold, is the first fold's): recovery returns
    every id once, and the ids a crash-free recovery returns."""
    x, idx = crash_flat
    got = {}
    for crash in (False, True):
        tmp = tmp_path / ("crash" if crash else "clean")
        tmp.mkdir()
        m, rows = _crash_run(idx, x, tmp, folds, crash, monkeypatch)
        q = np.concatenate([rows, x[:64], x[200:264]])
        d, i = _ids(m, q)
        for row in i:
            live = row[row >= 0]
            assert len(set(live.tolist())) == live.shape[0], row
        assert m.stats()["epoch"] == folds
        got[crash] = (d, i, {k: m.stats()[k] for k in _STATS})
    np.testing.assert_array_equal(got[True][1], got[False][1])
    np.testing.assert_allclose(got[True][0], got[False][0], rtol=1e-6)
    assert got[True][2] == got[False][2]


def test_concurrent_writers_log_in_apply_order(small_flat, tmp_path):
    """8 threads upsert and delete through one WAL'd index at once (a
    short switch interval): the log holds the mutations in the order the
    lock applied them, so recovery reproduces the live state exactly."""
    import threading
    x, jidx = small_flat
    idx = _port(jidx)
    wal_p = str(tmp_path / "m.wal")
    m = tmutate.MutableIndex(idx, k=K, config=tmutate.MutateConfig(
        delta_capacities=(1024,)))
    m.attach_wal(twal.MutationWAL(wal_p, sync=False))
    errors = []

    def writer(t):
        rng = np.random.default_rng(100 + t)
        try:
            for j in range(12):
                ids = m.upsert(rng.normal(size=(3, 16)).astype(np.float32),
                               ids=[2000 + (t * 7 + j) % 40 + i * 50
                                    for i in range(3)])
                m.delete([int(ids[0]), int(rng.integers(0, 1200))])
        except Exception as e:  # reported after the join
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ths = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in ths)
    back = tmutate.MutableIndex.recover(
        wal_p, k=K, base_index=idx, sync=False,
        config=tmutate.MutateConfig(delta_capacities=(1024,)))
    assert back.stats() == m.stats()
    q = np.concatenate([x[:16], np.random.default_rng(5).normal(
        size=(16, 16)).astype(np.float32)])
    np.testing.assert_array_equal(_ids(back, q)[1], _ids(m, q)[1])


# ---------------------------------------------------------------------------
# process death
# ---------------------------------------------------------------------------

_WRITER = r"""
import sys
import numpy as np
from raft_tpu_torch import mutate
from raft_tpu_torch.mutate.wal import MutationWAL
from raft_tpu_torch.neighbors import serialize
index_p, wal_p = sys.argv[1], sys.argv[2]
m = mutate.MutableIndex(serialize.load(index_p, device="cpu"), k=4,
                        config=mutate.MutateConfig(delta_capacities=(64, 256)))
m.attach_wal(MutationWAL(wal_p, sync=True))
rng = np.random.default_rng(11)
acked = 0
while True:
    rows = rng.normal(size=(4, 16)).astype(np.float32) + 25.0
    ids = m.upsert(rows)
    acked += len(ids)
    if acked % 12 == 0:
        m.delete([int(ids[0])])
        print("D", int(ids[0]), flush=True)
    print("A", acked, " ".join(str(int(i)) for i in ids), flush=True)
"""


def test_sigkilled_writer_loses_no_acked_mutation(small_flat, tmp_path):
    """A writer process on the CPU upserts (and now and then deletes)
    through a WAL with fsync; it is killed with ``SIGKILL`` after it has
    printed 40 acknowledged upserts. Recovery from the log holds every
    acknowledged row (at rank 0 for its own vector) and no acknowledged
    delete."""
    x, jidx = small_flat
    idx = _port(jidx)
    index_p, wal_p = str(tmp_path / "idx.npz"), str(tmp_path / "m.wal")
    tser.save(idx, index_p)
    script = tmp_path / "writer.py"
    script.write_text(_WRITER)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, str(script), index_p, wal_p],
                            stdout=subprocess.PIPE, text=True, env=env)
    acked, deleted = [], []
    try:
        for line in proc.stdout:
            tag, *rest = line.split()
            if tag == "D":
                deleted.append(int(rest[0]))
            else:
                acked.extend(int(i) for i in rest[1:])
                if len(acked) >= 40:
                    break
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL
    assert len(acked) >= 40
    m = tmutate.MutableIndex.recover(
        wal_p, k=K, base_index=idx, sync=False,
        config=tmutate.MutateConfig(delta_capacities=(64, 256)))
    # the writer's rows, regenerated from its seed
    rng = np.random.default_rng(11)
    rows = np.concatenate([rng.normal(size=(4, 16)).astype(np.float32)
                           + 25.0 for _ in range(len(acked) // 4)])
    live = [j for j, i in enumerate(acked) if i not in deleted]
    got = _ids(m, rows[live])[1]
    np.testing.assert_array_equal(got[:, 0], np.asarray(acked)[live])
    assert not np.isin(_ids(m, rows)[1], deleted).any()
    assert m.stats()["next_id"] >= max(acked) + 1

"""The port's long-tail util and core modules against the JAX package's
(``tests/test_util.py``, ``tests/test_core.py``), on the CPU: the
power-of-two helpers, the sieve, scatter / scatter_if, the vector cache,
trace ranges, cancellable sync points, memory stats and the kernel build
directory. Integer and selection results must be identical; the cache's
whole state is compared after every step of one key stream.
"""

import importlib
import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from raft_tpu.util import cache as jcache
from raft_tpu.util import pow2_utils as jpow2
from raft_tpu.util import seive as jseive
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core import compile_cache, memory, trace
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.ops import _build
from raft_tpu_torch.util import cache as tcache
from raft_tpu_torch.util import pow2_utils as tpow2
from raft_tpu_torch.util import seive as tseive

# the modules, not the functions the packages export under their names
jintr = importlib.import_module("raft_tpu.core.interruptible")
tintr = importlib.import_module("raft_tpu_torch.core.interruptible")
jscatter = importlib.import_module("raft_tpu.util.scatter")
tscatter = importlib.import_module("raft_tpu_torch.util.scatter")
jtrace = importlib.import_module("raft_tpu.core.trace")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# pow2, seive
# ---------------------------------------------------------------------------


def test_pow2_helpers_match():
    for v in range(-3, 300):
        assert tpow2.is_pow2(v) == jpow2.is_pow2(v)
        for m in (1, 2, 8, 64, 128):
            assert tpow2.round_up_pow2(v, m) == jpow2.round_up_pow2(v, m)
            assert tpow2.round_down_pow2(v, m) == \
                jpow2.round_down_pow2(v, m)
    for m in (1, 4, 128, 1 << 20):
        tp, jp = tpow2.Pow2(m), jpow2.Pow2(m)
        assert (tp.mask, tp.log2) == (jp.mask, jp.log2)
        for v in (0, 1, 5, 127, 128, 129, 1000, 123456789):
            assert (tp.round_up(v), tp.round_down(v), tp.mod(v), tp.div(v),
                    tp.is_multiple(v)) == \
                (jp.round_up(v), jp.round_down(v), jp.mod(v), jp.div(v),
                 jp.is_multiple(v))
    for mod in (tpow2, jpow2):
        with pytest.raises(ValueError):
            mod.Pow2(12)
        with pytest.raises(ValueError):
            mod.round_up_pow2(5, 6)


def test_seive_matches():
    ts, js = tseive.Seive(1000), jseive.Seive(1000)
    assert [p for p in range(1001) if ts.is_prime(p)] == \
        [p for p in range(1001) if js.is_prime(p)]
    assert ts.is_prime(997) and not ts.is_prime(91)
    for s in (ts, js):
        with pytest.raises(ValueError):
            s.is_prime(1001)


# ---------------------------------------------------------------------------
# scatter, scatter_if
# ---------------------------------------------------------------------------

SCATTER_CASES = {
    "distinct": ([3, 0, 4, 1, 2], 0),
    "out_len": ([7, 0, 2, 9, 5], 10),
    "negative": ([-1, 2, -5, 0, -2], 0),
    "out_of_range": ([5, 1, -6, 99, 2], 0),
    "duplicates": ([0, 0, 2, 0, 2], 0),
    "dup_negative": ([-1, 4, 1, -4, 3], 6),
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
@pytest.mark.parametrize("cols", [0, 3])
def test_scatter_matches(case, cols):
    """Negative indices count from the end, out-of-range ones drop, the
    last of duplicate writers wins: the JAX package's ``mode="drop"``."""
    idx, out_len = SCATTER_CASES[case]
    rng = np.random.default_rng(len(idx) + cols)
    shape = (len(idx),) + ((cols,) if cols else ())
    v = rng.normal(size=shape).astype(np.float32)
    got = tscatter.scatter(torch.from_numpy(v),
                           torch.tensor(idx, dtype=torch.int64), out_len,
                           fill=-7)
    want = jscatter.scatter(v, np.asarray(idx), out_len, fill=-7)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_if_matches(case):
    idx, out_len = SCATTER_CASES[case]
    rng = np.random.default_rng(7)
    v = rng.integers(-50, 50, size=(len(idx), 2)).astype(np.int32)
    pred = np.asarray([1, 0, 3, 0, 1], np.int32)
    got = tscatter.scatter_if(torch.from_numpy(v), torch.tensor(idx),
                              torch.from_numpy(pred), out_len)
    want = jscatter.scatter_if(v, np.asarray(idx), pred, out_len)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# VecCache
# ---------------------------------------------------------------------------


def _state(c):
    return tuple(_np(a) for a in (c.keys, c.time, c.vecs, c.clock))


def _same_state(tc, jc):
    for a, b in zip(_state(tc), _state(jc)):
        np.testing.assert_array_equal(a, b)


def test_vec_cache_roundtrip_and_lru():
    """The JAX package's two cache tests through both caches."""
    rng = np.random.default_rng(0)
    tc = tcache.VecCache.create(8, 4, 2, device="cpu")
    jc = jcache.VecCache.create(n_vec=8, n_sets=4, associativity=2)
    keys = np.asarray([4, 9, 14], np.int32)            # sets 0, 1, 2
    vecs = rng.random((3, 8)).astype(np.float32)
    tc, jc = tc.store(torch.from_numpy(keys), torch.from_numpy(vecs)), \
        jc.store(keys, vecs)
    to, tf, tc = tc.lookup(torch.from_numpy(keys))
    jo, jf, jc = jc.lookup(keys)
    assert bool(tf.all()) and bool(jf.all())
    np.testing.assert_array_equal(_np(to), vecs)
    _same_state(tc, jc)
    # associativity 2 in one set: the LRU way goes
    tc = tcache.VecCache.create(4, 1, 2, device="cpu")
    jc = jcache.VecCache.create(n_vec=4, n_sets=1, associativity=2)
    v = rng.random((1, 4)).astype(np.float32)
    for key, vv in ((1, v), (2, v + 1)):
        k = np.asarray([key], np.int32)
        tc, jc = tc.store(torch.from_numpy(k), torch.from_numpy(vv)), \
            jc.store(k, vv)
    one = np.asarray([1], np.int32)
    tc, jc = tc.lookup(torch.from_numpy(one))[2], jc.lookup(one)[2]
    k3 = np.asarray([3], np.int32)
    tc, jc = tc.store(torch.from_numpy(k3), torch.from_numpy(v + 2)), \
        jc.store(k3, v + 2)
    both = np.asarray([1, 2], np.int32)
    assert _np(tc.lookup(torch.from_numpy(both))[1]).tolist() == \
        _np(jc.lookup(both)[1]).tolist() == [True, False]
    _same_state(tc, jc)


def test_vec_cache_same_hits_and_evictions_on_one_stream():
    """A seeded stream of store and lookup batches, keys colliding in
    sets and within batches: the same hits, vectors and state after every
    step."""
    rng = np.random.default_rng(11)
    tc = tcache.VecCache.create(5, 4, 3, device="cpu")
    jc = jcache.VecCache.create(n_vec=5, n_sets=4, associativity=3)
    hits = 0
    for step in range(40):
        keys = rng.choice(48, size=rng.integers(1, 6),
                          replace=False).astype(np.int32)
        if step % 2 == 0:
            vecs = rng.normal(size=(len(keys), 5)).astype(np.float32)
            tc = tc.store(torch.from_numpy(keys), torch.from_numpy(vecs))
            jc = jc.store(keys, vecs)
        else:
            to, tf, tc = tc.lookup(torch.from_numpy(keys))
            jo, jf, jc = jc.lookup(keys)
            np.testing.assert_array_equal(_np(tf), _np(jf))
            np.testing.assert_array_equal(_np(to), _np(jo))
            hits += int(_np(tf).sum())
        _same_state(tc, jc)
    assert hits > 0


# ---------------------------------------------------------------------------
# trace ranges: the toggle-balance contract
# ---------------------------------------------------------------------------


def _fake_annotations(monkeypatch):
    """Both packages' annotations replaced by one recording fake."""
    events = {"jax": [], "torch": []}

    def fake(tag):
        class Ann:
            def __init__(self, name):
                self.name = name

            def __enter__(self):
                events[tag].append(("enter", self.name))
                return self

            def __exit__(self, *exc):
                events[tag].append(("exit", self.name))
        return Ann

    monkeypatch.setattr(jax.profiler, "TraceAnnotation", fake("jax"))
    monkeypatch.setattr(trace, "record_function", fake("torch"))
    return events


TRACE_SCRIPTS = {
    # enabled at push, disabled at pop: the annotation is still exited
    "on_then_off": [("push", "outer %d", 1), ("off",), ("pop",)],
    # disabled at push: the placeholder pops silently, later ranges pair
    "off_then_on": [("off",), ("push", "ghost"), ("on",), ("pop",),
                    ("push", "real"), ("pop",)],
    "interleaved": [("push", "a"), ("off",), ("push", "b"), ("on",),
                    ("pop",), ("pop",)],
    "pop_empty": [("pop",), ("push", "x"), ("pop",), ("pop",)],
    "context": [("range", "r %s", "z"), ("off",), ("range", "hidden")],
}


@pytest.mark.parametrize("script", sorted(TRACE_SCRIPTS))
def test_trace_toggle_balance_matches(monkeypatch, script):
    events = _fake_annotations(monkeypatch)
    try:
        for tag, mod in (("jax", jtrace), ("torch", trace)):
            for op, *args in TRACE_SCRIPTS[script]:
                if op == "push":
                    mod.push_range(*args)
                elif op == "pop":
                    mod.pop_range()
                elif op == "range":
                    with mod.range(*args):
                        pass
                else:
                    mod.enable_tracing(op == "on")
            mod.enable_tracing(True)
            assert mod._stack() == []
    finally:
        jtrace.enable_tracing(True)
        trace.enable_tracing(True)
    assert events["torch"] == events["jax"]
    assert len(events["torch"]) % 2 == 0


def test_trace_range_lands_in_the_torch_profiler():
    with torch.profiler.profile() as prof:
        with trace.range("raft_range %d", 7):
            torch.ones(4).add_(1)
        trace.push_range("raft_pushed")
        torch.ones(4).mul_(2)
        trace.pop_range()
    keys = {e.key for e in prof.key_averages()}
    assert {"raft_range 7", "raft_pushed"} <= keys


# ---------------------------------------------------------------------------
# interruptible
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [jintr, tintr], ids=["jax", "torch"])
def test_interruptible_yield_roundtrip(mod):
    assert mod.yield_no_throw() is False
    mod.cancel(threading.get_ident())
    assert mod.yield_no_throw() is True
    assert mod.yield_no_throw() is False
    mod.cancel(threading.get_ident())
    with pytest.raises(mod.InterruptedException):
        mod.yield_()
    mod.yield_()


@pytest.mark.parametrize("mod", [jintr, tintr], ids=["jax", "torch"])
def test_interruptible_cancel_from_another_thread(mod):
    """A thread in a cancellable scope sees the cancellation at its next
    yield, and the scope drops a cancellation it did not consume."""
    result = {}

    def waiter():
        try:
            with mod.interruptible():
                while True:
                    mod.yield_()
                    time.sleep(0.001)
        except mod.InterruptedException:
            result["interrupted"] = True

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    mod.cancel(t.ident)
    t.join(timeout=5)
    assert result.get("interrupted")
    mod.cancel(threading.get_ident())
    with mod.interruptible():
        pass
    assert mod.yield_no_throw() is False


def test_synchronize_cpu_tensors_are_ready():
    x = torch.ones(8) * 2
    t0 = time.perf_counter()
    tintr.synchronize(x, [x, {"y": x + 1}], poll_interval=0.5)
    tintr.synchronize()
    assert time.perf_counter() - t0 < 0.5


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------


def test_memory_stats_on_the_cpu():
    """A CPU device has no allocator stats: both calls answer ``{}``;
    ``donate`` hands ``fn`` back, which computes what the JAX package's
    donated program computes."""
    assert memory.memory_stats("cpu") == {}
    assert memory.hbm_stats(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        with pytest.raises(LogicError):
            memory.memory_stats()

    def f(x):
        return x + 1.0
    assert memory.donate(f, 0) is f
    from raft_tpu.core import memory as jmemory
    assert float(jmemory.donate(f, 0)(np.ones(4, np.float32))[0]) == \
        float(f(torch.ones(4))[0]) == 2.0
    # the JAX package's CPU answer has the same keys, beside its source
    assert set(jmemory.hbm_stats()) >= {"bytes_in_use", "peak_bytes_in_use",
                                        "bytes_limit"}


# ---------------------------------------------------------------------------
# compile_cache
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_cache(monkeypatch):
    """compile_cache and the build directory as at import, restored
    afterwards."""
    monkeypatch.setattr(compile_cache, "_enabled", False)
    monkeypatch.setattr(compile_cache, "_active_path", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.delenv("RAFT_TPU_COMPILE_CACHE", raising=False)
    return monkeypatch


def _enables():
    snap = tobs.snapshot()["counters"]
    return {k: v for k, v in snap.items()
            if k.startswith("raft.compile_cache.enable")}


def test_compile_cache_enable_is_idempotent(fresh_cache, tmp_path):
    before = _enables()
    first, second = tmp_path / "a", tmp_path / "b"
    assert compile_cache.enable(str(first)) is True
    assert _build.BUILD_DIR == first and first.is_dir()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert compile_cache.enable(str(first)) is True
        assert not caught
        assert compile_cache.enable(str(second)) is True
        assert any("ignoring new path" in str(w.message) for w in caught)
    assert _build.BUILD_DIR == first and not second.exists()
    after = _enables()
    ok = "raft.compile_cache.enable{result=ok}"
    assert after[ok] - before.get(ok, 0) == 1
    assert tobs.snapshot()["gauges"]["raft.compile_cache.active"] == 1


def test_compile_cache_env(fresh_cache, tmp_path):
    default = _build.BUILD_DIR
    fresh_cache.setenv("RAFT_TPU_COMPILE_CACHE", "0")
    before = _enables()
    assert compile_cache.enable(str(tmp_path / "x")) is False
    assert _build.BUILD_DIR == default
    off = "raft.compile_cache.enable{result=disabled}"
    assert _enables()[off] - before.get(off, 0) == 1
    fresh_cache.setenv("RAFT_TPU_COMPILE_CACHE", str(tmp_path / "env"))
    assert compile_cache.enable() is True
    assert _build.BUILD_DIR == tmp_path / "env"


def test_compile_cache_fixed_once_a_library_is_loaded(fresh_cache,
                                                      tmp_path):
    default = _build.BUILD_DIR
    fresh_cache.setattr(_build, "_libs", {"select_k": object()})
    assert _build.loaded() == ("select_k",)
    with pytest.warns(UserWarning, match="already loaded"):
        assert compile_cache.enable(str(tmp_path / "late")) is True
    assert _build.BUILD_DIR == default
    assert not (tmp_path / "late").exists()

"""The port's host-side entry points on tensors that ``np.asarray`` refuses:
bfloat16 tensors, and tensors that live on the card.

The mutation log, the host-resident index builds, the mutable index's
``upsert(ids=)`` and ``delete``, the serving front door and the quality
scorer each copy a tensor to the host in their own dtype
(``raft_tpu_torch.util.host.host_array``):

* a bfloat16 tensor widens to float32 exactly as the JAX package's
  ``np.asarray`` of a bfloat16 array does: the same WAL bytes (both
  modules' ``time`` patched to one fake clock), and the same lists from
  the host builds (row for row against the port's build of the widened
  float32 rows; list membership on >= 0.999 of the rows against the JAX
  package's builds of the same bfloat16 array, which draw their
  trainer's rows from one numpy stream above 65536 rows);
* a tensor on the card refuses ``numpy()``. The CPU has no card, and a
  tensor on the ``meta`` device holds no data to copy, so :class:`OnCard`
  plays the card's part: a tensor whose ``numpy()`` raises the error a
  CUDA tensor's raises, until ``.to("cpu")`` copies it. Each call must
  give what the same call on numpy arrays gives. The same calls on real
  card tensors sit in ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.mutate import wal as jwal
from raft_tpu.neighbors import host_memory as jhm
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu_torch import mutate as tmutate
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.mutate import wal as twal
from raft_tpu_torch.neighbors import host_memory as thm
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.obs import quality as tquality
from raft_tpu_torch.serve import SearchServer
from raft_tpu_torch.util.host import host_array


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


class OnCard(torch.Tensor):
    """A CPU tensor that refuses ``numpy()`` (and so ``np.asarray``) as a
    tensor on the card does; ``.to("cpu")`` and ``.cpu()`` return a plain
    tensor."""

    def numpy(self, *args, **kwargs):
        raise TypeError("can't convert cuda:0 device type tensor to numpy. "
                        "Use Tensor.cpu() to copy the tensor to host "
                        "memory first.")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        out = super().__torch_function__(func, types, args, kwargs or {})
        if func in (torch.Tensor.to, torch.Tensor.cpu) and \
                isinstance(out, cls):
            out = out.as_subclass(torch.Tensor)
        return out


def on_card(a):
    return torch.as_tensor(a).as_subclass(OnCard)


class _Clock:
    def __init__(self):
        self.t = 1.7e9

    def time(self):
        self.t += 0.25
        return self.t


def test_stand_in_refuses_numpy_like_a_card_tensor():
    t = on_card(np.arange(4))
    with pytest.raises(TypeError, match="cuda"):
        np.asarray(t, np.int64)
    np.testing.assert_array_equal(host_array(t, np.int64), np.arange(4))


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.int32])
def test_host_array_keeps_the_target_dtype(dtype):
    src = np.arange(12).reshape(3, 4)
    for a in (src, src.tolist(), torch.from_numpy(src),
              on_card(src), torch.from_numpy(src).to(torch.bfloat16)):
        got = host_array(a, dtype)
        assert isinstance(got, np.ndarray) and got.dtype == dtype
        np.testing.assert_array_equal(got, src.astype(dtype))


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------


def test_bf16_rows_write_the_jax_packages_wal_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(jwal, "time", _Clock())
    monkeypatch.setattr(twal, "time", _Clock())
    rows = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    ids = np.array([4, 8, 1])
    pj, pt = str(tmp_path / "j.wal"), str(tmp_path / "t.wal")
    wj = jwal.MutationWAL(pj, sync=False)
    wj.append_upsert(ids, jnp.asarray(rows, jnp.bfloat16))
    wj.rewrite(meta={"epoch": 1, "id_base": 9, "next_id": 9},
               tomb_ids=[8], upsert_ids=ids[:1],
               upsert_rows=jnp.asarray(rows[:1], jnp.bfloat16))
    wt = twal.MutationWAL(pt, sync=False)
    trows = torch.from_numpy(rows).to(torch.bfloat16)
    wt.append_upsert(torch.from_numpy(ids), trows)
    wt.rewrite(meta={"epoch": 1, "id_base": 9, "next_id": 9},
               tomb_ids=torch.tensor([8]), upsert_ids=ids[:1],
               upsert_rows=trows[:1])
    assert open(pt, "rb").read() == open(pj, "rb").read()
    rec = twal.MutationWAL(pt, sync=False).replay()[-1]
    np.testing.assert_array_equal(
        rec.rows, np.asarray(jnp.asarray(rows[:1], jnp.bfloat16), np.float32))


def _blobs(n, d, centers, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, d)).astype(np.float32) * 10.0
    return (c[rng.integers(0, centers, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def _labels(h, n_lists, n):
    lab = np.full(n, -1, np.int64)
    ids = np.asarray(h.lists_indices)
    lst = np.broadcast_to(np.arange(n_lists)[:, None], ids.shape)
    lab[ids[ids >= 0]] = lst[ids >= 0]
    return lab


@pytest.mark.parametrize("entry", ["build", "build_streaming"])
def test_bf16_host_builds_like_jax(entry):
    x = _blobs(70_000, 4, 8, 2)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    widened = xt.float().numpy()
    kw = dict(train_rows=1 << 17)
    jp = jflat.IndexParams(n_lists=8, kmeans_n_iters=2)
    tp = tflat.IndexParams(n_lists=8, kmeans_n_iters=2)
    if entry == "build":
        jh = jhm.build(xj, jp, chunk_rows=20_000, **kw)
        th = thm.build(xt, tp, chunk_rows=20_000, device="cpu", **kw)
        ref = thm.build(widened, tp, chunk_rows=20_000, device="cpu", **kw)
    else:
        def chunks(a):
            return [a[s:s + 30_000] for s in range(0, a.shape[0], 30_000)]
        jh = jhm.build_streaming(chunks(xj), jp, **kw)
        th = thm.build_streaming(chunks(xt), tp, device="cpu", **kw)
        ref = thm.build_streaming(chunks(widened), tp, device="cpu", **kw)
    for f in ("lists_indices", "lists_data", "lists_norms"):
        np.testing.assert_array_equal(getattr(th, f), getattr(ref, f))
    assert th.size == jh.size == x.shape[0]
    assert np.mean(_labels(th, 8, len(x)) == _labels(jh, 8, len(x))) >= 0.999


# ---------------------------------------------------------------------------
# tensors on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flat():
    x = _blobs(2000, 16, 16, 4)
    idx = tflat.build(x, tflat.IndexParams(n_lists=16, kmeans_n_iters=4),
                      device="cpu")
    return x, idx


def test_mutable_ids_on_the_card(flat, tmp_path):
    """``delete`` and ``upsert(ids=)`` by card tensors, among them the ids
    a search returned, give the state and the log the same calls on
    numpy give."""
    x, idx = flat
    q = x[:32]
    rows = x[100:140] + 0.5
    out = {}
    for where in ("numpy", "card"):
        put = on_card if where == "card" else np.asarray
        m = tmutate.MutableIndex(idx, k=8, config=tmutate.MutateConfig(
            delta_capacities=(64, 256)))
        m.attach_wal(twal.MutationWAL(str(tmp_path / f"{where}.wal"),
                                      sync=False))
        _, found = m.search(q[:4], block=True)
        m.delete(put(np.asarray(found)[:, 0]))
        m.delete(put(np.arange(50, 60)))
        m.upsert(rows, ids=put(np.arange(3000, 3040)))
        m.upsert(rows[:5] * 0.5, ids=put(np.arange(3000, 3005, dtype=np.int32)))
        d, i = m.search(q, block=True)
        recs = twal.MutationWAL(str(tmp_path / f"{where}.wal"),
                                sync=False).replay()
        out[where] = (np.asarray(d), np.asarray(i), m.stats(),
                      [(r.op, r.ids.tolist()) for r in recs])
    np.testing.assert_array_equal(out["card"][1], out["numpy"][1])
    np.testing.assert_array_equal(out["card"][0], out["numpy"][0])
    assert out["card"][2] == out["numpy"][2]
    assert out["card"][3] == out["numpy"][3]


def test_server_submit_of_card_queries(flat):
    x, idx = flat
    q = x[:8] + 0.1
    sp = tflat.SearchParams(n_probes=8)
    srv = SearchServer.from_index(idx, q, 4, params=sp)
    try:
        d, i = srv.submit(on_card(q)).result(timeout=60)
        d0, i0 = srv.search(q)
    finally:
        srv.close()
    np.testing.assert_array_equal(i, i0)
    np.testing.assert_array_equal(d, d0)


def test_exact_scorer_on_a_card_corpus(flat):
    x, _ = flat
    ids = np.arange(x.shape[0], dtype=np.int64) * 3
    want = tquality.ExactScorer(x, ids=ids, metric=DistanceType.L2Expanded,
                                chunk=512, device="cpu")
    got = tquality.ExactScorer(on_card(x), ids=on_card(ids),
                               metric=DistanceType.L2Expanded, chunk=512,
                               device="cpu")
    q = x[:16] + 0.01
    np.testing.assert_array_equal(got.topk(on_card(q), 8), want.topk(q, 8))

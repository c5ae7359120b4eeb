"""IVF-Flat, IVF-PQ, IVF-BQ, ball-cover and mutable-index save/load, and
the type-dispatching ``save``/``load`` (counterpart of
``raft_tpu.neighbors.serialize``).

Same file format as the JAX package, so an index moves between the two
packages: a numpy ``.npz`` whose ``__meta__`` entry is a JSON object
``{format, version, bf16_fields, ...}`` (IVF-Flat: ``metric, size,
scale``; IVF-PQ: ``metric, size, pq_bits, codebook_kind, has_raw``;
IVF-BQ: ``metric, size, has_raw``; ball cover: ``metric, size``; the metric as its ``DistanceType``
integer) beside one array per index field. IVF-BQ bits are stored as
uint32, as the JAX package holds them. numpy has no bfloat16, so a
bfloat16 field (IVF-Flat's bf16 list rows) is stored as its uint16 bit
patterns and named in ``bf16_fields``, as the JAX package stores it, and
loaded as a ``torch.bfloat16`` tensor; int8 rows are stored as int8, their
``scale`` in the meta. A mutable index (format ``mutable``: meta ``k,
epoch, id_base, next_id``) embeds its inner index's file as bytes
(``inner``) beside its pending delta rows (``delta_data``, ``delta_ids``)
and tombstone ids (``tomb_ids``): the ids, not the bitmap. A host-memory
IVF-Flat index (format ``host_ivf_flat``: meta ``metric, size, scale``)
stores its centres and its host lists (``lists_data``, ``lists_indices``,
``lists_norms``); loading keeps the lists in host numpy and puts only the
centres on the device.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import numpy as np
import torch

from raft_tpu_torch.core.error import expects

_VERSION = 1
_FIELDS = ("centers", "lists_data", "lists_indices", "lists_norms",
           "list_sizes")
_PQ_FIELDS = ("centers", "centers_rot", "rotation_matrix", "pq_centers",
              "codes", "lists_indices", "list_sizes")
_BALL_FIELDS = ("landmarks", "lists_data", "lists_indices", "radii")
_BQ_FIELDS = ("centers", "centers_rot", "rotation_matrix", "bits", "norms2",
              "scales", "lists_indices", "list_sizes")


def _pack(path: str, fmt: str, meta: dict, arrays: dict) -> None:
    """Write ``arrays`` (numpy arrays or torch tensors) and ``meta``;
    bfloat16 tensors as uint16 bit patterns named in ``bf16_fields``."""
    out, bf16_fields = {}, []
    for name, a in arrays.items():
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
            if a.dtype == torch.bfloat16:
                a = a.view(torch.int16).numpy().view(np.uint16)
                bf16_fields.append(name)
            else:
                a = a.numpy()
        out[name] = a
    meta = dict(meta, format=fmt, version=_VERSION, bf16_fields=bf16_fields)
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                          dtype=np.uint8), **out)
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        os.replace(path + ".npz", path)


def _npz(src):
    """``np.load`` of a path, or of an open binary file from its start
    (``load`` reads one file twice: its tag, then its arrays)."""
    if hasattr(src, "seek"):
        src.seek(0)
    return np.load(src)


def _unpack(path, fmt: str, fields):
    with _npz(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        expects(meta.get("format") == fmt,
                "serialize: %s holds %r, expected %r", path,
                meta.get("format"), fmt)
        expects(meta.get("version") == _VERSION,
                "serialize: unsupported version %s", meta.get("version"))
        arrays = {f: z[f] for f in fields if f in z.files}
    for f in meta.get("bf16_fields") or ():
        if f in arrays:  # uint16 bit patterns -> torch.bfloat16
            arrays[f] = torch.from_numpy(
                np.ascontiguousarray(arrays[f]).view(np.int16)).view(
                    torch.bfloat16)
    return meta, arrays


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_ivf_flat(index, path: str) -> None:
    """Write an IVF-Flat :class:`~raft_tpu_torch.neighbors.ivf_flat.Index`
    to ``path`` (exactly that path, even without ``.npz``), in its list
    storage."""
    _pack(path, "ivf_flat",
          {"metric": int(index.metric), "size": int(index.size),
           "scale": float(index.scale)},
          {f: getattr(index, f) for f in _FIELDS})


def load_ivf_flat(path: str, device="cuda"):
    """Read an IVF-Flat index written by either package onto ``device``
    (default ``cuda``), in the list storage it was saved in."""
    from raft_tpu_torch.neighbors.ivf_flat import index_from_numpy
    meta, arrays = _unpack(path, "ivf_flat", _FIELDS)
    return index_from_numpy(arrays, meta["metric"], meta["size"],
                            float(meta.get("scale", 1.0)), device=device)


def save_ivf_pq(index, path: str, include_raw: bool = True) -> None:
    """Write an IVF-PQ :class:`~raft_tpu_torch.neighbors.ivf_pq.Index` to
    ``path``. ``include_raw=False`` leaves out the host rescore corpus.
    Code norms are not stored: loading derives them."""
    arrays = {f: _host(getattr(index, f)) for f in _PQ_FIELDS}
    has_raw = include_raw and index.raw is not None
    if has_raw:
        arrays["raw"] = np.asarray(index.raw)
    _pack(path, "ivf_pq",
          {"metric": int(index.metric), "size": int(index.size),
           "pq_bits": int(index.pq_bits),
           "codebook_kind": int(index.codebook_kind), "has_raw": has_raw},
          arrays)


def load_ivf_pq(path: str, device="cuda"):
    """Read an IVF-PQ index written by either package onto ``device``
    (default ``cuda``); the raw corpus, when stored, stays on the host."""
    from raft_tpu_torch.neighbors.ivf_pq import index_from_numpy
    meta, arrays = _unpack(path, "ivf_pq", _PQ_FIELDS + ("raw",))
    return index_from_numpy(arrays, meta["metric"], meta["size"],
                            meta["pq_bits"], meta.get("codebook_kind", 0),
                            raw=arrays.get("raw") if meta.get("has_raw")
                            else None, device=device)


def save_ivf_bq(index, path: str, include_raw: bool = True) -> None:
    """Write an IVF-BQ :class:`~raft_tpu_torch.neighbors.ivf_bq.Index` to
    ``path``, the bits as uint32. ``include_raw=False`` leaves out the
    host rescore corpus."""
    arrays = {f: _host(getattr(index, f)) for f in _BQ_FIELDS}
    arrays["bits"] = arrays["bits"].view(np.uint32)
    has_raw = include_raw and index.raw is not None
    if has_raw:
        arrays["raw"] = np.asarray(index.raw)
    _pack(path, "ivf_bq",
          {"metric": int(index.metric), "size": int(index.size),
           "has_raw": has_raw}, arrays)


def load_ivf_bq(path: str, device="cuda"):
    """Read an IVF-BQ index written by either package onto ``device``
    (default ``cuda``); the raw corpus, when stored, stays on the host."""
    from raft_tpu_torch.neighbors.ivf_bq import index_from_numpy
    meta, arrays = _unpack(path, "ivf_bq", _BQ_FIELDS + ("raw",))
    return index_from_numpy(arrays, meta["metric"], meta["size"],
                            raw=arrays.get("raw") if meta.get("has_raw")
                            else None, device=device)


def save_ball_cover(index, path: str) -> None:
    """Write a :class:`~raft_tpu_torch.neighbors.ball_cover.BallCoverIndex`
    to ``path``."""
    _pack(path, "ball_cover",
          {"metric": int(index.metric), "size": int(index.size)},
          {f: getattr(index, f) for f in _BALL_FIELDS})


def load_ball_cover(path: str, device="cuda"):
    """Read a ball-cover index written by either package onto ``device``
    (default ``cuda``)."""
    from raft_tpu_torch.neighbors.ball_cover import index_from_numpy
    meta, arrays = _unpack(path, "ball_cover", _BALL_FIELDS)
    return index_from_numpy(arrays, meta["metric"], meta["size"],
                            device=device)


@contextlib.contextmanager
def _scratch_npz(path: str):
    """A temporary ``.npz`` path beside ``path``, removed afterwards."""
    path = getattr(path, "name", path)    # an open file: its path
    fd, tmp = tempfile.mkstemp(
        suffix=".npz", dir=os.path.dirname(os.path.abspath(path)) or ".")
    os.close(fd)
    try:
        yield tmp
    finally:
        os.remove(tmp)


def save_mutable(mindex, path: str) -> None:
    """Write a :class:`raft_tpu_torch.mutate.MutableIndex`: the inner
    index (through its family's writer, embedded as bytes) PLUS the
    mutable state (pending delta rows, tombstone ids, the epoch and
    id-space counters), so a mutated index reloads without losing a
    pending mutation. The snapshot is taken under the index's lock."""
    st = mindex.export_state()
    with _scratch_npz(path) as tmp:
        save(st["index"], tmp)
        inner = np.fromfile(tmp, dtype=np.uint8)
    _pack(path, "mutable",
          {"k": int(st["k"]), "epoch": int(st["epoch"]),
           "id_base": int(st["id_base"]), "next_id": int(st["next_id"])},
          {"inner": inner, "delta_data": st["delta_data"],
           "delta_ids": st["delta_ids"], "tomb_ids": st["tomb_ids"]})


def load_mutable(path: str, params=None, config=None, device="cuda"):
    """Read a mutable index written by either package →
    :class:`raft_tpu_torch.mutate.MutableIndex` on ``device`` (default
    ``cuda``) with its delta segment, tombstones and epoch counters
    restored (its programs are prepared by ``warmup()`` or the serving
    ladder, as for a fresh wrap)."""
    from raft_tpu_torch.mutate import MutableIndex
    meta, a = _unpack(path, "mutable",
                      ("inner", "delta_data", "delta_ids", "tomb_ids"))
    with _scratch_npz(path) as tmp:
        a["inner"].tofile(tmp)
        inner = load(tmp, device=device)
    state = {"k": meta["k"], "epoch": meta["epoch"],
             "id_base": meta["id_base"], "next_id": meta["next_id"],
             "delta_data": a["delta_data"], "delta_ids": a["delta_ids"],
             "tomb_ids": a["tomb_ids"]}
    return MutableIndex.restore(inner, state, params=params,
                                config=config)


_HOST_FIELDS = ("centers", "lists_data", "lists_indices", "lists_norms")


def save_host_ivf_flat(index, path: str) -> None:
    """Write a host-resident
    :class:`~raft_tpu_torch.neighbors.host_memory.HostIvfFlat`; the list
    arrays stream from host numpy (bfloat16 rows, held as uint16 bit
    patterns, are written as the JAX package writes bfloat16)."""
    from raft_tpu_torch.neighbors.host_memory import _host_tensor
    data = index.lists_data
    _pack(path, "host_ivf_flat",
          {"metric": int(index.metric), "size": int(index.size),
           "scale": float(index.scale)},
          {"centers": index.centers,
           "lists_data": (_host_tensor(data) if data.dtype == np.uint16
                          else data),
           "lists_indices": index.lists_indices,
           "lists_norms": index.lists_norms})


def load_host_ivf_flat(path: str, device="cuda"):
    """Read a host-resident index written by either package: the lists
    stay in host numpy; only the coarse centres go to ``device``
    (default ``cuda``)."""
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.neighbors.host_memory import (HostIvfFlat,
                                                      _host_array)
    from raft_tpu_torch.neighbors.ivf_flat import _host_array as _writable
    meta, a = _unpack(path, "host_ivf_flat", _HOST_FIELDS)
    dev = torch.device(device)

    def host(name, dtype=None):
        v = a[name]
        return (_host_array(v) if isinstance(v, torch.Tensor)
                else _writable(v, dtype))

    return HostIvfFlat(
        centers=torch.from_numpy(_writable(a["centers"], np.float32)).to(dev),
        lists_data=host("lists_data"),
        lists_norms=host("lists_norms", np.float32),
        lists_indices=host("lists_indices", np.int32),
        metric=DistanceType(int(meta["metric"])), size=int(meta["size"]),
        scale=float(meta.get("scale", 1.0)))


def save(index, path: str) -> None:
    """Type-dispatching save for the port's index types."""
    from raft_tpu_torch.mutate import MutableIndex
    from raft_tpu_torch.neighbors import ball_cover, ivf_bq, ivf_flat, ivf_pq
    from raft_tpu_torch.neighbors.host_memory import HostIvfFlat
    if isinstance(index, MutableIndex):
        save_mutable(index, path)
    elif isinstance(index, ivf_flat.Index):
        save_ivf_flat(index, path)
    elif isinstance(index, ivf_pq.Index):
        save_ivf_pq(index, path)
    elif isinstance(index, ivf_bq.Index):
        save_ivf_bq(index, path)
    elif isinstance(index, HostIvfFlat):
        save_host_ivf_flat(index, path)
    elif isinstance(index, ball_cover.BallCoverIndex):
        save_ball_cover(index, path)
    else:
        raise TypeError(f"serialize.save: unsupported index {type(index)}")


def load(path, device="cuda"):
    """Type-dispatching load: reads the format tag and returns the
    matching index type on ``device`` (default ``cuda``). ``path`` may
    also be a binary file open for reading."""
    with _npz(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    fmt = meta.get("format")
    readers = {"ivf_flat": load_ivf_flat, "ivf_pq": load_ivf_pq,
               "ivf_bq": load_ivf_bq, "host_ivf_flat": load_host_ivf_flat,
               "ball_cover": load_ball_cover, "mutable": load_mutable}
    if fmt in readers:
        return readers[fmt](path, device=device)
    raise ValueError(f"serialize.load: unknown format {fmt!r} in {path}")

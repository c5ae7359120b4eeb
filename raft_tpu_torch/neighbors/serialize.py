"""IVF-Flat save/load (counterpart of ``raft_tpu.neighbors.serialize``).

Same file format as the JAX package, so an index moves between the two
packages: a numpy ``.npz`` whose ``__meta__`` entry is a JSON object
``{format, version, bf16_fields, metric, size, scale}`` (the metric as
its ``DistanceType`` integer) beside one array per index field.
"""

from __future__ import annotations

import json
import os

import numpy as np

from raft_tpu_torch.core.error import expects

_VERSION = 1
_FIELDS = ("centers", "lists_data", "lists_indices", "lists_norms",
           "list_sizes")


def save_ivf_flat(index, path: str) -> None:
    """Write an IVF-Flat :class:`~raft_tpu_torch.neighbors.ivf_flat.Index`
    to ``path`` (exactly that path, even without ``.npz``)."""
    meta = {"metric": int(index.metric), "size": int(index.size),
            "scale": float(index.scale), "format": "ivf_flat",
            "version": _VERSION, "bf16_fields": []}
    arrays = {f: getattr(index, f).detach().cpu().numpy() for f in _FIELDS}
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                          dtype=np.uint8), **arrays)
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        os.replace(path + ".npz", path)


def load_ivf_flat(path: str, device="cuda"):
    """Read an IVF-Flat index written by either package onto ``device``
    (default ``cuda``). bf16/int8 storage is not ported yet."""
    from raft_tpu_torch.neighbors.ivf_flat import index_from_numpy
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        expects(meta.get("format") == "ivf_flat",
                "serialize: %s holds %r, expected 'ivf_flat'", path,
                meta.get("format"))
        expects(meta.get("version") == _VERSION,
                "serialize: unsupported version %s", meta.get("version"))
        if meta.get("bf16_fields"):
            raise NotImplementedError(
                "load_ivf_flat: bfloat16 list storage is not ported yet")
        arrays = {f: z[f] for f in _FIELDS}
    return index_from_numpy(arrays, meta["metric"], meta["size"],
                            float(meta.get("scale", 1.0)), device=device)

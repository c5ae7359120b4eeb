"""CSR sparse container (counterpart of ``raft_tpu.sparse.csr``):
``indptr`` (n_rows + 1), ``indices`` and ``data`` tensors on one device,
indices int32, beside the dense shape. Every CSR computation in the
port's sparse stack expands ``indptr`` to a per-nonzero row id
(:meth:`CSR.row_ids`) or reduces over the row lengths."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.sparse.coo import _tensor


class CSR:
    """Compressed-sparse-row matrix: (indptr, indices, data) + dense shape."""

    def __init__(self, indptr, indices, data, shape: Tuple[int, int]):
        self.indptr = _tensor(indptr)
        self.indices = _tensor(indices)
        self.data = _tensor(data)
        expects(self.indptr.shape[0] == int(shape[0]) + 1,
                "CSR indptr must have n_rows+1 entries")
        expects(self.indices.shape == self.data.shape,
                "CSR indices/data must have identical shape")
        expects(self.indptr.device == self.indices.device
                == self.data.device, "CSR arrays must share a device")
        self.shape = (int(shape[0]), int(shape[1]))

    @classmethod
    def from_numpy(cls, indptr, indices, data, shape: Tuple[int, int],
                   device="cuda") -> "CSR":
        """A CSR on ``device`` from host arrays (the JAX container's
        ``indptr``, ``indices``, ``data``): ``indptr`` and ``indices`` as
        int32, values as given."""
        dev = torch.device(device)

        def put(a, dtype=None):
            return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

        return cls(put(indptr, np.int32), put(indices, np.int32), put(data),
                   shape)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def row_ids(self) -> torch.Tensor:
        """Per-nonzero row ids (int32), nondecreasing."""
        return torch.repeat_interleave(
            torch.arange(self.shape[0], dtype=torch.int32,
                         device=self.device),
            self.row_lengths().long(), output_size=self.nnz)

    def row_lengths(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.device)
        return out.index_put_((self.row_ids().long(), self.indices.long()),
                              self.data, accumulate=True)

    def __repr__(self):
        return f"CSR(shape={self.shape}, nnz={self.nnz}, dtype={self.dtype})"

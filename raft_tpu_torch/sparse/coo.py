"""COO sparse container (counterpart of ``raft_tpu.sparse.coo``): three
tensors on one device, ``rows``/``cols`` int32 and ``vals``, beside the
dense shape. Ops that change nnz return a new container, as the JAX
package's do."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(a)


class COO:
    """Coordinate-format sparse matrix: (rows, cols, vals) + dense shape."""

    def __init__(self, rows, cols, vals, shape: Tuple[int, int]):
        self.rows = _tensor(rows)
        self.cols = _tensor(cols)
        self.vals = _tensor(vals)
        expects(self.rows.shape == self.cols.shape == self.vals.shape,
                "COO rows/cols/vals must have identical shape")
        expects(self.rows.device == self.cols.device == self.vals.device,
                "COO rows/cols/vals must share a device")
        self.shape = (int(shape[0]), int(shape[1]))

    @classmethod
    def from_numpy(cls, rows, cols, vals, shape: Tuple[int, int],
                   device="cuda") -> "COO":
        """A COO on ``device`` from host arrays (the JAX container's
        ``rows``, ``cols``, ``vals``): indices as int32, values as
        given."""
        dev = torch.device(device)

        def put(a, dtype=None):
            return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

        return cls(put(rows, np.int32), put(cols, np.int32), put(vals),
                   shape)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.device)
        return out.index_put_((self.rows.long(), self.cols.long()),
                              self.vals, accumulate=True)

    def __repr__(self):
        return f"COO(shape={self.shape}, nnz={self.nnz}, dtype={self.dtype})"

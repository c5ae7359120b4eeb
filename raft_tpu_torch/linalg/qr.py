"""QR decomposition (counterpart of ``raft_tpu.linalg.qr``): the reduced
factors by ``torch.linalg.qr`` (cuSOLVER geqrf/orgqr on the card)."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device


def qr_get_q(a, res=None) -> torch.Tensor:
    return qr_get_qr(a, res)[0]


def qr_get_qr(a, res=None) -> Tuple[torch.Tensor, torch.Tensor]:
    q, r = torch.linalg.qr(as_array(a, input_device(res, a)))
    return q, r

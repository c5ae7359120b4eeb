"""R-MAT rectangular graph generator (counterpart of
``raft_tpu.random.rmat``): each edge picks one quadrant per bit level of
(r_scale, c_scale) with probabilities theta = [a, b, c, d] (flat, or one
row a level). The quadrant convention is the reference's: a = (0, 0),
b = (0, 1), c = (1, 0), d = (1, 1) as (row bit, column bit); at levels
past r_scale (c_scale) the row (column) bit is 0. One uniform per edge
and level, drawn at once; the levels are folded into ids one at a time.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.random.rng import KeyLike, _key


def rmat_rectangular_gen(
    rng: KeyLike,
    theta,
    r_scale: int,
    c_scale: int,
    n_edges: int,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_edges`` edges of a 2^r_scale x 2^c_scale R-MAT graph → (src
    int32, dst int32) on the generator's device. Rows of ``theta`` need
    not be normalized."""
    g = _key(rng, device)
    dev = g.device
    theta = as_array(theta, dev).float().reshape(-1, 4)
    max_scale = max(r_scale, c_scale)
    if theta.shape[0] == 1:
        theta = theta.expand(max_scale, 4)
    expects(theta.shape[0] >= max_scale,
            "rmat: need theta for %d levels, got %d", max_scale,
            theta.shape[0])
    theta = theta / theta.sum(dim=1, keepdim=True)
    u = torch.rand((n_edges, max_scale), generator=g, device=dev)
    src = torch.zeros(n_edges, dtype=torch.int32, device=dev)
    dst = torch.zeros(n_edges, dtype=torch.int32, device=dev)
    for lvl in range(max_scale):
        ta, tb, tc = (theta[lvl, i] for i in range(3))
        ul = u[:, lvl]
        # quadrant index q in {0: a, 1: b, 2: c, 3: d}
        q = ((ul >= ta).int() + (ul >= ta + tb).int()
             + (ul >= ta + tb + tc).int())
        if lvl < r_scale:
            src = src * 2 + (q >> 1)
        if lvl < c_scale:
            dst = dst * 2 + (q & 1)
    return src, dst


def rmat(rng: KeyLike, theta, r_scale: int, c_scale: int, n_edges: int,
         device=None):
    """pylibraft-style alias: an (n_edges, 2) int32 tensor of (src, dst)
    pairs."""
    src, dst = rmat_rectangular_gen(rng, theta, r_scale, c_scale, n_edges,
                                    device)
    return torch.stack([src, dst], dim=1)

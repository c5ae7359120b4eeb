"""Isotropic Gaussian blob generator (counterpart of
``raft_tpu.random.make_blobs``): n_clusters centres (given, or uniform
in a box), a per-cluster or shared std, optional shuffle → (data,
labels). One generator draws, in turn, the centres, the labels, the
noise and the shuffle."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.random.rng import KeyLike, _key


def make_blobs(
    n_samples: int = 100,
    n_features: int = 2,
    centers: Optional[object] = None,
    cluster_std: float = 1.0,
    shuffle: bool = True,
    center_box_min: float = -10.0,
    center_box_max: float = 10.0,
    seed: KeyLike = 0,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian blobs → (X (n_samples, n_features), labels int32) on
    ``device`` (default: the generator's, ``cuda`` for an int seed).
    ``centers``: an int (number of clusters, default 5, the CUDA
    default) or the centres themselves."""
    g = _key(seed, device)
    dev = g.device
    if centers is None:
        centers = 5
    if isinstance(centers, int):
        centers_arr = center_box_min + (center_box_max - center_box_min) * \
            torch.rand((centers, n_features), generator=g, device=dev,
                       dtype=dtype)
    else:
        centers_arr = as_array(centers, dev).to(dtype)
    n_clusters = centers_arr.shape[0]
    labels = torch.randint(0, n_clusters, (n_samples,), generator=g,
                           device=dev, dtype=torch.int32)
    std = as_array(cluster_std, dev).to(dtype)
    noise = torch.randn((n_samples, n_features), generator=g, device=dev,
                        dtype=dtype)
    per_point = std[labels.long()][:, None] if std.dim() == 1 else std
    x = centers_arr[labels.long()] + noise * per_point
    if shuffle:
        perm = torch.randperm(n_samples, generator=g, device=dev)
        x, labels = x[perm], labels[perm]
    return x, labels

"""Per-metric cores of the elementwise distance family (counterpart of
``raft_tpu.distance._elementwise_cores``).

The single definition of each metric's per-coordinate term
(:func:`combine`) and post-reduction op (:func:`finalize`) for the plain
PyTorch versions; ``csrc/elementwise_dist.cu`` spells the same cores in
CUDA. Tags: l1 | l2unexp | linf | canberra | minkowski | hamming |
jensen_shannon | kl | braycurtis. ``braycurtis`` is the one
pair-accumulator metric: combine returns (numerator, denominator) terms
and finalize divides.
"""

from __future__ import annotations

import math

import torch

TAGS = ("l1", "l2unexp", "linf", "canberra", "minkowski", "hamming",
        "jensen_shannon", "kl", "braycurtis")
# metrics whose feature reduction is max instead of sum
MAX_REDUCE = ("linf",)
# metrics needing two running sums (combine returns a tuple)
PAIR_ACCUM = ("braycurtis",)


def combine(metric: str, a: torch.Tensor, b: torch.Tensor, p: float):
    """Per-coordinate term(s); reduced over the feature axis by sum (or
    max for MAX_REDUCE metrics)."""
    if metric in ("l1", "linf"):
        return (a - b).abs()
    if metric == "l2unexp":
        d = a - b
        return d * d
    if metric == "canberra":
        num = (a - b).abs()
        den = a.abs() + b.abs()
        return torch.where(den == 0.0, 0.0,
                           num / torch.where(den == 0.0, 1.0, den))
    if metric == "minkowski":
        return (a - b).abs() ** p
    if metric == "hamming":
        return (a != b).to(torch.float32)
    if metric == "jensen_shannon":
        m = 0.5 * (a + b)
        safe_m = torch.where(m > 0.0, m, 1.0)
        ta = torch.where(a > 0.0,
                         a * torch.log(torch.where(a > 0.0, a, 1.0) / safe_m),
                         0.0)
        tb = torch.where(b > 0.0,
                         b * torch.log(torch.where(b > 0.0, b, 1.0) / safe_m),
                         0.0)
        return ta + tb
    if metric == "kl":
        num = torch.where(a > 0.0, a, 1.0)
        den = torch.where(b > 0.0, b, 1.0)
        return torch.where(a > 0.0, a * torch.log(num / den), 0.0)
    if metric == "braycurtis":
        return (a - b).abs(), (a + b).abs()
    raise ValueError(f"elementwise core: unknown metric {metric!r}")


def finalize(metric: str, d, p: float, dim: int, sqrt: bool):
    """Post-reduction op. For PAIR_ACCUM metrics ``d`` is the tuple of
    reduced accumulators."""
    if metric == "braycurtis":
        num, den = d
        return num / torch.where(den == 0.0, 1.0, den)
    if metric == "l2unexp" and sqrt:
        return torch.sqrt(torch.clamp(d, min=0.0))
    if metric == "minkowski":
        # p = 0: every term is 1, d is the dim, and the root dim^(1/0)
        # its limit: +inf, or 1 at dim 1
        return d ** (math.inf if p == 0 else 1.0 / p)
    if metric == "hamming":
        # a tensor divisor: PyTorch turns division by a Python scalar on
        # CUDA into a product with its reciprocal, one ulp off the
        # kernel's (and the JAX package's) true division
        return d / torch.full_like(d, float(dim))
    if metric == "jensen_shannon":
        return torch.sqrt(torch.clamp(0.5 * d, min=0.0))
    return d

"""Device RNG state and distributions (counterpart of
``raft_tpu.random.rng``).

``RngState`` keeps a seed and a subsequence counter, as the JAX
package's does; each :meth:`RngState.next_key` derives a fresh
``torch.Generator`` (Philox on CUDA) seeded from (seed, generator type,
subsequence) through numpy's ``SeedSequence``, so every stream is
reproducible from the seed and independent of the others. The bits are
torch's, not ``jax.random``'s: the two packages draw other numbers from
one seed, and their results agree in distribution only.

Every distribution takes a ``KeyLike``: an ``RngState``, a
``torch.Generator`` or an int seed. The draws land on the generator's
device. An int seed or an ``RngState`` makes its generator on
``device``, else on the state's device, else on the default one
(``cuda``); a ``torch.Generator`` brings its own.
"""

from __future__ import annotations

import enum
import math
from typing import Union

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.resources import default_resources


class GeneratorType(enum.IntEnum):
    """The reference's generator types; both map to ``torch.Generator``
    (Philox on CUDA), seeded from distinct streams."""

    GenPhilox = 0
    GenPC = 1


def _derive(seed: int, kind: int, subsequence: int) -> int:
    """A 63-bit generator seed for (seed, kind, subsequence)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(kind),
                                 int(subsequence)])
    return int(ss.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


def _generator(seed: int, device) -> torch.Generator:
    dev = torch.device(device) if device is not None \
        else default_resources().device
    return torch.Generator(device=dev).manual_seed(seed)


class RngState:
    """Seed + subsequence state. Each :meth:`next_key` derives a fresh
    independent generator and advances the subsequence — the analogue of
    the reference's per-call ``advance(subsequence)``."""

    def __init__(self, seed: int = 0,
                 type: GeneratorType = GeneratorType.GenPhilox,
                 device=None):
        self.seed = int(seed)
        self.type = GeneratorType(type)
        self.device = device
        self.subsequence = 0

    def advance(self, n: int = 1) -> None:
        self.subsequence += int(n)

    def next_key(self, device=None) -> torch.Generator:
        key = self.key_at(self.subsequence, device)
        self.advance()
        return key

    def key_at(self, subsequence: int, device=None) -> torch.Generator:
        return _generator(_derive(self.seed, self.type, subsequence),
                          device if device is not None else self.device)


KeyLike = Union[RngState, torch.Generator, int]


def _key(rng: KeyLike, device=None) -> torch.Generator:
    """A generator for one draw (module doc: devices)."""
    if isinstance(rng, torch.Generator):
        expects(device is None
                or torch.device(device).type == rng.device.type,
                "random: generator on %s, device %s asked for", rng.device,
                device)
        return rng
    if isinstance(rng, RngState):
        return rng.next_key(device)
    return _generator(_derive(int(rng), GeneratorType.GenPhilox, 0), device)


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _rand(g: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.rand(_shape(shape), generator=g, device=g.device,
                      dtype=dtype)


def _randn(g: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(_shape(shape), generator=g, device=g.device,
                       dtype=dtype)


def _open_unit(g: torch.Generator, shape, dtype) -> torch.Tensor:
    """Uniform on (tiny, 1): the open interval the transforms need."""
    return torch.clamp(_rand(g, shape, dtype), min=torch.finfo(dtype).tiny)


# -- distributions (rng.cuh order) ------------------------------------------

def uniform(rng: KeyLike, shape, start=0.0, end=1.0, dtype=torch.float32,
            device=None):
    u = _rand(_key(rng, device), shape, dtype)
    # rounding can carry start + (end - start) * u onto end: keep [start, end)
    below_end = torch.nextafter(torch.tensor(float(end), dtype=dtype),
                                torch.tensor(-math.inf, dtype=dtype))
    return torch.clamp(start + (end - start) * u, min=start,
                       max=float(below_end))


def uniformInt(rng: KeyLike, shape, start: int, end: int,
               dtype=torch.int32, device=None):
    g = _key(rng, device)
    return torch.randint(int(start), int(end), _shape(shape), generator=g,
                         device=g.device, dtype=dtype)


def normal(rng: KeyLike, shape, mu=0.0, sigma=1.0, dtype=torch.float32,
           device=None):
    return mu + sigma * _randn(_key(rng, device), shape, dtype)


def normalInt(rng: KeyLike, shape, mu: int, sigma: int, dtype=torch.int32,
              device=None):
    z = _randn(_key(rng, device), shape)
    return torch.round(mu + sigma * z).to(dtype)


def normalTable(rng: KeyLike, n_rows: int, mu_vec, sigma_vec,
                dtype=torch.float32, device=None):
    """Per-column mu/sigma gaussian table (rng.cuh normalTable)."""
    g = _key(rng, device)
    mu_vec = as_array(mu_vec, g.device).to(dtype)
    sigma_vec = as_array(sigma_vec, g.device).to(dtype)
    z = _randn(g, (n_rows, mu_vec.shape[0]), dtype)
    return mu_vec[None, :] + sigma_vec[None, :] * z


def fill(rng: KeyLike, shape, val, dtype=torch.float32, device=None):
    g = _key(rng, device)
    return torch.full(_shape(shape), val, dtype=dtype, device=g.device)


def bernoulli(rng: KeyLike, shape, prob: float, dtype=torch.bool,
              device=None):
    return (_rand(_key(rng, device), shape) < prob).to(dtype)


def scaled_bernoulli(rng: KeyLike, shape, prob: float, scale: float,
                     dtype=torch.float32, device=None):
    """-scale where u < prob, else scale (reference scaled_bernoulli)."""
    u = _rand(_key(rng, device), shape, dtype)
    return torch.where(u < prob, -scale, scale).to(dtype)


def gumbel(rng: KeyLike, shape, mu=0.0, beta=1.0, dtype=torch.float32,
           device=None):
    u = _open_unit(_key(rng, device), shape, dtype)
    return mu + beta * -torch.log(-torch.log(u))


def lognormal(rng: KeyLike, shape, mu=0.0, sigma=1.0, dtype=torch.float32,
              device=None):
    return torch.exp(normal(rng, shape, mu, sigma, dtype, device))


def logistic(rng: KeyLike, shape, mu=0.0, scale=1.0, dtype=torch.float32,
             device=None):
    u = _open_unit(_key(rng, device), shape, dtype)
    return mu + scale * (torch.log(u) - torch.log1p(-u))


def exponential(rng: KeyLike, shape, lambda_=1.0, dtype=torch.float32,
                device=None):
    u = _rand(_key(rng, device), shape, dtype)
    return -torch.log1p(-u) / lambda_


def rayleigh(rng: KeyLike, shape, sigma=1.0, dtype=torch.float32,
             device=None):
    u = 1e-7 + (1.0 - 1e-7) * _rand(_key(rng, device), shape, dtype)
    return sigma * torch.sqrt(-2.0 * torch.log(u))


def laplace(rng: KeyLike, shape, mu=0.0, scale=1.0, dtype=torch.float32,
            device=None):
    g = _key(rng, device)
    u = torch.clamp(2.0 * _rand(g, shape, dtype) - 1.0,
                    min=-1.0 + torch.finfo(dtype).eps)
    return mu + scale * (-torch.sign(u) * torch.log1p(-torch.abs(u)))


def discrete(rng: KeyLike, shape, weights, device=None):
    """Sample indices with probability proportional to ``weights``
    (rng.cuh discrete) → int32 of ``shape``."""
    g = _key(rng, device)
    w = as_array(weights, g.device).float()
    n = math.prod(_shape(shape))
    idx = torch.multinomial(torch.clamp(w, min=0.0), n, replacement=True,
                            generator=g)
    return idx.to(torch.int32).reshape(_shape(shape))


def sample_without_replacement(rng: KeyLike, n: int, n_samples: int,
                               weights=None, device=None) -> torch.Tensor:
    """Weighted sampling without replacement by the Gumbel top-k trick
    (the reference's one-pass ``sampleWithoutReplacement``) → int32."""
    expects(n_samples <= n, "sampleWithoutReplacement: n_samples > n")
    g = _key(rng, device)
    if weights is None:
        scores = _rand(g, (n,))
    else:
        w = as_array(weights, g.device).float()
        u = _open_unit(g, (n,), torch.float32)
        scores = torch.log(torch.clamp(w, min=1e-37)) - torch.log(
            -torch.log(u))
    return torch.topk(scores, n_samples).indices.to(torch.int32)


def permute(rng: KeyLike, n: int = None, array=None, axis: int = 0,
            device=None):
    """A random permutation of ``n`` (int32), or ``(perm, shuffled)`` of
    ``array`` along ``axis`` (the reference's permute writes both)."""
    if array is not None:
        arr = as_array(array, device)
        g = _key(rng, arr.device)
        perm = torch.randperm(arr.shape[axis], generator=g, device=g.device)
        return perm.to(torch.int32), torch.index_select(arr, axis, perm)
    expects(n is not None, "permute: need n or array")
    g = _key(rng, device)
    return torch.randperm(n, generator=g, device=g.device).to(torch.int32)

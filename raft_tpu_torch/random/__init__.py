"""Random generation (counterpart of ``raft_tpu.random``): the
reference's distribution set and generator-state API on
``torch.Generator`` streams (Philox on CUDA). The bits differ from the
JAX package's; the distributions are the same."""

from raft_tpu_torch.random.make_blobs import make_blobs
from raft_tpu_torch.random.make_regression import make_regression
from raft_tpu_torch.random.multi_variable_gaussian import \
    multi_variable_gaussian
from raft_tpu_torch.random.rmat import rmat, rmat_rectangular_gen
from raft_tpu_torch.random.rng import (GeneratorType, RngState, bernoulli,
                                       discrete, exponential, fill, gumbel,
                                       laplace, logistic, lognormal, normal,
                                       normalInt, normalTable, permute,
                                       rayleigh, sample_without_replacement,
                                       scaled_bernoulli, uniform, uniformInt)

__all__ = [
    "GeneratorType", "RngState",
    "uniform", "uniformInt", "normal", "normalInt", "normalTable", "fill",
    "bernoulli", "scaled_bernoulli", "gumbel", "lognormal", "logistic",
    "exponential", "rayleigh", "laplace", "discrete",
    "sample_without_replacement", "permute",
    "make_blobs", "make_regression", "multi_variable_gaussian",
    "rmat_rectangular_gen", "rmat",
]

"""raft_tpu_torch — the PyTorch/CUDA port of ``raft_tpu``.

Same public functions, parameter dataclasses, index fields and result
conventions as the JAX package (int32 ids, ``-1`` with ``+inf`` for a
missing neighbour, inner-product scores negated inside kernels so that
smaller is always better), on torch tensors.

Device policy: entry points run on ``cuda`` unless the caller asks for
the CPU (``device="cpu"`` or ``Resources(device="cpu")``). Every
hand-written kernel wrapper dispatches on the device of the tensor it
is given: a CPU tensor takes the plain PyTorch version beside the
kernel, a CUDA tensor launches the kernel (built from ``csrc/`` with
``nvcc`` at first use) or raises. There is no silent fallback.

Layout mirrors ``raft_tpu``: ``core/``, ``distance/``, ``cluster/``,
``neighbors/``, ``spatial/``, ``sparse/``, ``stats/``, ``linalg/``,
``matrix/``, ``random/``, ``label/``, ``solver/``, ``spectral/``,
``ops/`` (kernel wrappers), ``serve/``, ``mutate/`` (mutable
indexes), ``obs/`` (counters and gauges), ``testing/`` (fault
injection), ``util/`` and ``csrc/`` (CUDA sources).
"""

__version__ = "0.1.0"

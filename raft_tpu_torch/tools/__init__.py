"""Command-line tools of the port (counterparts of the JAX package's
root ``tools/`` scripts), each run as a module:

* :mod:`raft_tpu_torch.tools.doctor` — the offline post-mortem of a
  black-box dump (``python -m raft_tpu_torch.tools.doctor <dir>``);
* :mod:`raft_tpu_torch.tools.loadgen` — the open-loop load generator
  (``python -m raft_tpu_torch.tools.loadgen``), on the card unless
  ``--device cpu``.

This package imports nothing at import: ``tools.doctor`` sets the
black-box knob off before the observability package loads.
"""

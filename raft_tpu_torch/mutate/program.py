"""The mutable-serving program: the main IVF search, then the tombstone
filter and the delta merge (counterpart of ``raft_tpu.mutate.program``).

The family builders of :mod:`raft_tpu_torch.neighbors.plan` give the
bound serving function ``fn(q) -> (d, i)`` of the wrapped index; this
module composes two stages after it:

* **tombstone filter** — each main result id is looked up in a packed
  bitmap (one gather and one shift a candidate); dead ids drop to the
  metric's worst value before the merge, so a deleted row never outranks
  a live one. The bitmap covers the main index's id space ``[0,
  id_base)`` only: a delta row that dies is invalidated in place (its
  slot id flips to -1). The words are ``int32`` holding the JAX
  package's ``uint32`` bits: ``(word >> (id & 31)) & 1`` reads bit 31
  right under the arithmetic shift, and torch's ``uint32`` has few ops.
* **delta merge** — the delta segment (a flat buffer at one of the
  config's rung capacities) is scored exactly against every query (one
  full-fp32 ``torch.matmul`` over ``(cap, dim)``), its top-k taken, and
  merged with the filtered main results. Both selections run kernel 2
  (``ops.select_k``: the column select for the delta, the payload select
  with the ids riding along for the merge), which keeps ``lax.top_k``'s
  order: ascending, ties to the lower column. ``k > 256`` takes a stable
  sort, the same contract. CPU tensors take the kernel's plain version.

All stages keep the family's output convention (``ivf_flat._postprocess``):
L2 metrics ascending, InnerProduct descending (the selection key flips
sign), cosine as 1 - cos over normalized rows; invalid and dead slots sit
at the convention's worst value with id -1.

Nothing is compiled ahead of time: eager PyTorch has nothing to compile,
so a "program" is the composed callable, and its preparation (the one
cap measurement) is what the plan counters count.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.obs import profiler
from raft_tpu_torch.ops import select_k as _select_op
from raft_tpu_torch.ops._util import stable_topk_min
from raft_tpu_torch.util.host import host_array

__all__ = ["compile_mutate_program", "compile_tail_program",
           "delta_scores", "mutate_tail"]

_SQRT_METRICS = (DistanceType.L2SqrtExpanded,
                 DistanceType.L2SqrtUnexpanded)


def _descending(metric: DistanceType) -> bool:
    """True when the family's OUTPUT distances sort larger-is-better
    (InnerProduct returns similarities)."""
    return metric == DistanceType.InnerProduct


def delta_scores(q, delta_data, delta_norms, delta_ids,
                 metric: DistanceType) -> torch.Tensor:
    """Exact (nq, cap) delta-segment scores in the family OUTPUT
    convention; invalid slots (id < 0) land at the worst value."""
    from raft_tpu_torch.neighbors.ivf_flat import (_metric_kind,
                                                   _normalize_rows,
                                                   _postprocess)
    kind = _metric_kind(metric)
    if metric == DistanceType.CosineExpanded:
        # delta rows are stored normalized (upsert normalizes as build
        # does); the queries normalize here as the main phase's do
        q = _normalize_rows(q)
    full_fp32_matmul()
    ip = torch.matmul(q, delta_data.T)
    if kind == "ip":
        s = -ip
    else:
        qq = (q * q).sum(dim=1)
        s = torch.clamp(qq[:, None] + delta_norms[None, :] - 2.0 * ip,
                        min=0.0)
        if metric in _SQRT_METRICS:
            s = torch.sqrt(s)
    s = torch.where(delta_ids[None, :] >= 0, s, float("inf"))
    return _postprocess(s, metric)


def _tombstone_dead(ids, tomb_words) -> torch.Tensor:
    """Per-candidate dead mask from the packed int32 bitmap. -1 (pad)
    ids read word 0 through the clamp but are dead regardless."""
    word = tomb_words[torch.clamp(ids >> 5, 0,
                                  tomb_words.shape[0] - 1).long()]
    bit = (word >> (ids & 31)) & 1
    return (ids < 0) | (bit != 0)


def _select_min(v: torch.Tensor, k: int):
    """Per-row k smallest → (vals, columns): kernel 2 at k <= 256, else
    a stable sort with its +inf slots at column -1, as the kernel's."""
    if k <= _select_op.MAX_K:
        return _select_op.select_k(v.contiguous(), k)
    vals, sel = stable_topk_min(v, k)
    return vals, torch.where(torch.isinf(vals) & (vals > 0), -1,
                             sel).to(torch.int32)


def mutate_tail(d_main, i_main, ds, delta_ids, tomb_words, k: int,
                metric: DistanceType) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tombstone-filter the main results, top-k the delta scores, and
    merge: the postprocess stages of the mutable serving program."""
    desc = _descending(metric)
    worst = -float("inf") if desc else float("inf")
    dead = _tombstone_dead(i_main, tomb_words)
    d_main = torch.where(dead, worst, d_main)
    i_main = torch.where(dead, -1, i_main)
    # the delta top-k (the smallest rung may hold fewer than k slots:
    # merging fewer candidates is still exact, the delta has no more)
    kd = min(k, ds.shape[1])
    vd, sel = _select_min(-ds if desc else ds, kd)
    dd = -vd if desc else vd
    id_d = delta_ids[torch.clamp(sel, min=0).long()]
    id_d = torch.where(torch.isfinite(dd), id_d, -1)
    cat_d = torch.cat([d_main, dd], dim=1)
    cat_i = torch.cat([i_main, id_d.to(i_main.dtype)], dim=1)
    v, ids = _select_op.select_k_payload_any(-cat_d if desc else cat_d,
                                             cat_i, k)
    return (-v if desc else v), ids


class MutateExecutable:
    """One prepared (nq, n_probes, delta-rung) operating point of a
    mutable index's epoch: ``run(q, dd, dn, di, tw)`` calls the main
    phase over its bound index operands and the tail over the CURRENT
    delta and tombstone device tensors (the same shapes each call: the
    rung contract). ``operands`` is empty: the main phase's closure holds
    the index's tensors."""

    __slots__ = ("executable", "operands", "nq", "k", "n_probes", "cap",
                 "delta_cap", "tomb_words")

    def __init__(self, executable, operands, nq, k, n_probes, cap,
                 delta_cap, tomb_words):
        self.executable = executable
        self.operands = operands
        self.nq = int(nq)
        self.k = int(k)
        self.n_probes = int(n_probes)
        self.cap = int(cap)
        self.delta_cap = int(delta_cap)
        self.tomb_words = int(tomb_words)

    def run(self, q, delta_data, delta_norms, delta_ids, tomb_words):
        return self.executable(q, *self.operands, delta_data,
                               delta_norms, delta_ids, tomb_words)


def _host_rows(x) -> np.ndarray:
    """Rows as a float32 numpy array (a tensor is copied to the host)."""
    return host_array(x, np.float32)


def compile_mutate_program(index, rep_queries, nq: int, k: int, params,
                           delta_cap: int, tomb_words: int,
                           slack: int = 16) -> MutateExecutable:
    """Prepare the mutable serving program for one (nq, n_probes,
    delta-rung) point: the family's plan function (its kernels and
    route), built from the builder directly at ``k + slack`` candidates,
    then the tombstone filter and the delta merge. The one
    cap-measurement sync of the program's life happens here, never on
    the serving path. Counted under ``raft.plan.cache.misses`` and
    ``raft.plan.build.total``, so the zero-steady-state-build check
    reads the same counters as the immutable tier."""
    from raft_tpu_torch.neighbors import _ivf_scan
    from raft_tpu_torch.neighbors import plan as plan_mod

    family, builder = plan_mod._resolve_builder(index)
    q = _host_rows(rep_queries)
    expects(q.ndim == 2 and q.shape[1] == index.dim,
            "mutate: rep_queries must be (nq, dim=%d), got %s",
            index.dim, q.shape)
    reps = -(-nq // q.shape[0])
    q = np.tile(q, (reps, 1))[:nq]
    k_main = k + max(0, int(slack))
    make, n_probes, kind = builder(index, k_main, params)
    metric = index.metric
    obs.counter("raft.plan.cache.misses").inc()
    obs.counter("raft.plan.build.total").inc()
    with obs.timed("raft.mutate.plan.build", family=family):
        t_c0 = time.perf_counter()
        cap = _ivf_scan.resolve_cap(
            index.cap_cache, torch.from_numpy(q).to(index.device),
            index.centers, params, n_probes, index.n_lists, kind=kind)
        fn_main, _key_bits, sync_free = make(nq, cap)
        expects(sync_free,
                "mutate: the wrapped %s plan needs a host-side rescore "
                "epilogue (raw corpus off-device) — mutable serving "
                "requires a sync-free plan (keep_raw=False, or device "
                "rescore)", family)

        def fused(q_in, dd, dn, di, tw):
            d, i = fn_main(q_in)
            ds = delta_scores(q_in, dd, dn, di, metric)
            return mutate_tail(d, i.to(torch.int32), ds, di, tw, k,
                               metric)

        # the compile ledger: nothing is compiled, so the preparation
        # (the cap measurement) is what it records
        profiler.note_compile("mutate", time.perf_counter() - t_c0)
    return MutateExecutable(fused, (), nq, k, n_probes, cap, delta_cap,
                            tomb_words)


class TailExecutable:
    """The tombstone filter and the delta merge ALONE, composed after a
    search whose main phase is its own dispatch (the mesh-wide tier's
    cross-shard merge, ROADMAP.md queue 1 item 6)."""

    __slots__ = ("executable", "nq", "k", "delta_cap", "tomb_words")

    def __init__(self, executable, nq, k, delta_cap, tomb_words):
        self.executable = executable
        self.nq = int(nq)
        self.k = int(k)
        self.delta_cap = int(delta_cap)
        self.tomb_words = int(tomb_words)

    def run(self, q, d, i, delta_data, delta_norms, delta_ids,
            tomb_words):
        return self.executable(q, d, i, delta_data, delta_norms,
                               delta_ids, tomb_words)


def compile_tail_program(nq: int, k: int, dim: int, metric,
                         delta_cap: int, tomb_words: int,
                         k_main: Optional[int] = None,
                         d_dtype=torch.float32, i_dtype=torch.int32
                         ) -> TailExecutable:
    """Prepare the standalone tail for one (nq, delta-rung) point
    (counted under the same plan counters as the full program).
    ``k_main`` is the width of the incoming main-phase results (``k +
    tombstone_slack`` when the upstream search over-fetches); they are
    taken as ``d_dtype``/``i_dtype`` and widened to float32/int32."""
    obs.counter("raft.plan.cache.misses").inc()
    obs.counter("raft.plan.build.total").inc()
    k_main = k if k_main is None else int(k_main)

    def tail(q, d, i, dd, dn, di, tw):
        expects(tuple(q.shape) == (nq, dim)
                and tuple(d.shape) == (nq, k_main) and d.dtype == d_dtype
                and i.dtype == i_dtype,
                "mutate tail: queries %s, main results %s %s/%s; "
                "prepared for (%d, %d), (%d, %d) %s/%s", tuple(q.shape),
                tuple(d.shape), d.dtype, i.dtype, nq, dim, nq, k_main,
                d_dtype, i_dtype)
        ds = delta_scores(q, dd, dn, di, metric)
        return mutate_tail(d.float(), i.to(torch.int32), ds, di, tw, k,
                           metric)

    profiler.note_compile("mutate", 0.0)
    return TailExecutable(tail, nq, k, delta_cap, tomb_words)

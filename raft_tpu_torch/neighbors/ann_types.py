"""Query batching and the scan-order heuristic (counterpart of
``raft_tpu.neighbors.ann_types``)."""

from __future__ import annotations

import dataclasses

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.interruptible import wait_ready
from raft_tpu_torch.obs import spans

# searches run in query batches of at most this many rows, so per-batch
# scratch (probe tables, candidate blocks) stays bounded
MAX_QUERY_BATCH = 4096


def batched_search(search_one_batch, queries: torch.Tensor,
                   max_batch: int = 0, pad_partial: bool = False,
                   block: bool = False):
    """Run ``search_one_batch(q_slice) -> (d, i)`` over query batches of
    ``max_batch`` rows (default :data:`MAX_QUERY_BATCH`) and concatenate.
    A ragged last batch is padded to the batch size with real rows from
    the batch before it (a lone short batch cycles its own rows) and the
    pad results are dropped, so every call sees one shape.
    ``pad_partial`` pads a whole query set smaller than ``max_batch``
    too; ``block`` ends with one wait for the results on the stream they
    were made on (not for the whole device). Each sub-batch is a
    ``raft.ann.sub_batch`` span under the caller's."""
    mb = max_batch if max_batch > 0 else MAX_QUERY_BATCH
    nq = queries.shape[0]
    if nq <= mb and not (pad_partial and nq < mb):
        return _finish(search_one_batch(queries), block)
    outs = []
    n_sub = 0
    for s in range(0, nq, mb):
        qb = queries[s:s + mb]
        short = mb - qb.shape[0]
        n_sub += 1
        # one child span per launched sub-batch (launch walls: nothing
        # here waits)
        with spans.span("raft.ann.sub_batch", index=n_sub - 1,
                        offset=s, rows=int(qb.shape[0]), padded=short):
            if short:
                # real rows keep the pad in the queries' distribution
                # (one repeated row would crowd its lists and could
                # overflow a cached cap); earlier rows where there are
                # enough
                if s >= short:
                    fill = queries[s - short:s]
                else:
                    fill = qb.repeat(-(-short // qb.shape[0]), 1)[:short]
                d, i = search_one_batch(torch.cat([qb, fill], dim=0))
                outs.append((d[:mb - short], i[:mb - short]))
            else:
                outs.append(search_one_batch(qb))
    obs.counter("raft.ann.batched_search.sub_batches").inc(n_sub)
    d, i = zip(*outs)
    return _finish((torch.cat(d, dim=0), torch.cat(i, dim=0)), block)


def _finish(out, block: bool):
    """``out``, after waiting for it on its stream when ``block``."""
    if block:
        wait_ready(out)
    return out


def list_order_auto(nq: int, n_probes: int, n_lists: int) -> bool:
    """Probe-major vs list-major auto rule (reuse factor
    ``nq * n_probes / n_lists``), shared by the search and the batching
    pin so batched and unbatched searches take the same path."""
    return nq >= 64 and nq * n_probes >= 4 * n_lists


def pin_scan_order(params, nq: int, n_lists: int):
    """Resolve ``scan_order='auto'`` from the full query count."""
    if getattr(params, "scan_order", None) != "auto":
        return params
    n_pr = min(params.n_probes, n_lists)
    so = "list" if list_order_auto(nq, n_pr, n_lists) else "probe"
    return dataclasses.replace(params, scan_order=so)

"""Times, on one CUDA card, where a distributed IVF-Flat search's time
goes on a mesh of eight logical ranks on that card (``chip_smoke.py``
``serve_dist``'s mesh): the smoke's 10M x 128 mixture (seed 5), a
list-sharded index of 1024 lists built over the mesh, 12 probes a shard,
k = 32.

    python3 tools/time_dist_parts.py [--n ROWS]

Prints the card's name and power limit, then one JSON line a part, each
the median host milliseconds of 7 calls after 2 warm-ups, the card
synchronised around each call (``wall``: the host clock):

* ``dist_search``: ``distributed_ivf_flat_search`` at 1, 32 and 128
  queries, f32 and int8 merges;
* ``one_shard``: one rank's local search alone (its 128 lists, the same
  probes and k) on the calling thread, at 1, 32 and 128 queries;
* ``ranks_serial``: the eight ranks' local searches one after another on
  the calling thread (no worker threads, no collective);
* ``shard_map_empty``: a ``shard_map`` of an empty body over the mesh
  (the workers' hand-off alone);
* ``merge``: the f32 cross-shard merge's select at (nq, 8 x 32);
* ``switch_interval``: ``dist_search`` at 128 queries with the
  interpreter's thread switch interval at 0.5 ms (default 5 ms);
* ``profile``: ten 128-query searches under ``torch.profiler`` (the
  device's own records): the device's busy share, the union of its
  kernels' and copies' intervals clipped to the searches' window over
  that window (overlapping streams count once), beside the summed
  kernel time (which counts overlaps twice), and its top kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

K, N_LISTS, PROBES, RANKS = 32, 1024, 12, 8


def wall_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def busy_union_us(intervals, lo: float, hi: float) -> float:
    """The length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(lo, s), min(hi, e)) for s, e in intervals
                       if min(hi, e) > max(lo, s)):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def line(part: str, **fields) -> None:
    print(json.dumps({"part": part, **fields}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_dist_parts: needs a CUDA card")
    import chip_smoke as cs
    from raft_tpu_torch import parallel
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import select_k as sel_op
    from raft_tpu_torch.parallel.mesh import P, shard_map
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    x, q, _ = cs.ann_dataset(args.n, 128, 256, 5, dev)
    mesh = parallel.make_mesh(devices=[dev] * RANKS)
    index = parallel.sharded_ivf_flat_build(x, ivf_flat.IndexParams(
        n_lists=N_LISTS, kmeans_n_iters=10), mesh=mesh)
    del x
    sp = ivf_flat.SearchParams(n_probes=PROBES)
    shapes = (1, 32, 128)
    for merge in ("f32", "int8"):
        line("dist_search", merge=merge, ms={
            nq: wall_ms(lambda: parallel.distributed_ivf_flat_search(
                index, q[:nq], K, sp, mesh=mesh, merge=merge))
            for nq in shapes})
    blocks = [[getattr(index, f).blocks[r] for f in
               ("centers", "lists_data", "lists_indices", "lists_norms")]
              for r in range(RANKS)]

    def local(r, qb):
        c, data, ids, norms = blocks[r]
        return ivf_flat._search_impl(qb, c, data, ids, norms, K, PROBES,
                                     False)

    line("one_shard", ms={nq: wall_ms(lambda: local(0, q[:nq]))
                          for nq in shapes})
    line("ranks_serial", ms={
        nq: wall_ms(lambda: [local(r, q[:nq]) for r in range(RANKS)])
        for nq in shapes})
    empty = shard_map(lambda: None, mesh, (), P())
    line("shard_map_empty", ms=wall_ms(empty))
    rows = {nq: (torch.rand(nq, RANKS * K, device=dev),
                 torch.randint(0, args.n, (nq, RANKS * K), device=dev,
                               dtype=torch.int32)) for nq in shapes}
    line("merge", ms={nq: wall_ms(lambda: sel_op.select_k_payload(
        *rows[nq], K)) for nq in shapes})
    old = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        line("switch_interval", interval_s=5e-4, ms={
            merge: wall_ms(lambda: parallel.distributed_ivf_flat_search(
                index, q[:128], K, sp, mesh=mesh, merge=merge))
            for merge in ("f32", "int8")})
    finally:
        sys.setswitchinterval(old)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    window = "time_dist_parts.window"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(window):
            for _ in range(10):
                parallel.distributed_ivf_flat_search(
                    index, q[:128], K, sp, mesh=mesh, merge="int8")
            torch.cuda.synchronize()
    events = prof.events()
    win = [e for e in events if e.name == window
           and e.device_type == DeviceType.CPU][0].time_range
    # the device's own records: kernels and copies, not the annotations
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name != window and not e.name.startswith("raft.")]
    wall_us = win.end - win.start
    busy_us = busy_union_us([(e.time_range.start, e.time_range.end)
                             for e in dev], win.start, win.end)
    rows_p = sorted(((e.key, e.self_device_time_total, e.count)
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and e.self_device_time_total > 0
                     and e.key != window
                     and not e.key.startswith("raft.")),
                    key=lambda r: -r[1])
    line("profile", searches=10, wall_ms=wall_us / 1e3,
         device_busy_ms=busy_us / 1e3, busy_share=busy_us / wall_us,
         kernel_ms_summed=sum(r[1] for r in rows_p) / 1e3,
         device_records=len(dev),
         top=[{"name": n[:60], "device_ms": t / 1e3, "calls": c}
              for n, t, c in rows_p[:8]])
    mesh.close()


if __name__ == "__main__":
    main()

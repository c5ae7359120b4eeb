#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, one line each:

1. build    — compile every CUDA kernel of ``raft_tpu_torch/csrc`` with
              nvcc (one process per source, all at once) into
              ``raft_tpu_torch/_build``.
2. kernels  — each kernel against its plain PyTorch version on CUDA
              tensors at the main path's shapes: fused L2-NN at
              (262144, 128) x (1024, 128), select-k at (128, 1024) k=96,
              and (after phase 3) the fused IVF-Flat scan over the real
              index for one 128-query batch. Kernel, plain and library
              times from CUDA events after warm-up.
3. main     — the port's serving path: a 10M x 128 clustered dataset
              (the benchmark's gaussian mixture, made on the card from a
              seed), IVF-Flat build (1024 lists, 10 k-means sweeps),
              ``SearchServer.from_index`` (batch shapes 1/8/32/128,
              96 probes, k=32), a burst of 512 single-query requests from
              128 threads; recall@32 against exact search, QPS, p50/p99,
              device memory, and each kernel's launch count over the run.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
the last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before the last line. There is no CPU path: without CUDA the
script fails. ``--n`` cuts the dataset (the cut is printed).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32, non-tensor-core
# kernel vs plain distance tolerance: rtol 1e-5 of the scale of the
# expanded-L2 terms (|x|^2 + |y|^2), where fp32 rounding of
# |x|^2 + |y|^2 - 2 x.y lives (a distance near 0 keeps that error)
RTOL = 1e-5
MIN_ID_AGREEMENT = 0.999
RECALL_FLOOR = 0.5

D, K, N_PROBES, N_LISTS, KMEANS_ITERS = 128, 32, 96, 1024, 10
KM_ROWS = 1 << 18             # the k-means trainer's subsample
BATCH_SIZES = (1, 8, 32, 128)
N_QUERIES, N_REQUESTS, N_THREADS = 256, 512, 128

OUT_DIR = "chiprun_out"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(n_bytes: float, n_flops: float):
    tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def ann_dataset(n: int, d: int, nq: int, seed: int, dev):
    """The benchmark's clustered mixture: ``nc = max(64, min(8192,
    n // 125))`` standard-normal centres, rows = centre + unit noise;
    queries from the same mixture. Drawn on the card from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nc = max(64, min(8192, n // 125))
    centers = torch.randn((nc, d), generator=g, device=dev)
    x = torch.empty((n, d), device=dev)
    step = 1 << 20
    for s in range(0, n, step):
        e = min(n, s + step)
        lab = torch.randint(0, nc, (e - s,), generator=g, device=dev)
        x[s:e] = centers[lab] + torch.randn((e - s, d), generator=g,
                                            device=dev)
    qlab = torch.randint(0, nc, (nq,), generator=g, device=dev)
    q = centers[qlab] + torch.randn((nq, d), generator=g, device=dev)
    return x, q


def exact_knn(x: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """Exact squared-L2 k-NN ids: chunked ``torch.matmul`` + ``topk``."""
    best_d = torch.full((q.shape[0], k), float("inf"), device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64,
                        device=q.device)
    step = 1 << 20
    for s in range(0, x.shape[0], step):
        xb = x[s:s + step]
        d = (xb * xb).sum(1)[None, :] - 2.0 * (q @ xb.T)
        cd = torch.cat([best_d, d], 1)
        ci = torch.cat([best_i, torch.arange(s, s + xb.shape[0],
                                             device=q.device)
                        .expand(q.shape[0], -1)], 1)
        best_d, sel = torch.topk(cd, k, dim=1, largest=False)
        best_i = torch.gather(ci, 1, sel)
    return best_i


def compare(name, d_k, i_k, d_p, i_p, exact_ids: bool, scale=None):
    """Hold a kernel's (dists, ids) against the plain version's: exact
    equality, or ids agreeing on >= 99.9% of slots with every distance
    (so every disagreement is a near-tie) within ``RTOL * scale``."""
    d_k, d_p = d_k.double(), d_p.double()
    fin = torch.isfinite(d_p)
    if not torch.equal(torch.isfinite(d_k), fin):
        fail(f"{name}: finite pattern differs from the plain version")
    err = (d_k[fin] - d_p[fin]).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    agree = float((i_k == i_p).double().mean())
    if exact_ids:
        if not (torch.equal(i_k, i_p) and torch.equal(d_k, d_p)):
            fail(f"{name}: output differs from the plain version "
                 f"(id agreement {agree})")
    else:
        tol = RTOL * scale.double()[fin]
        if bool((err > tol).any()):
            fail(f"{name}: distances off by up to {max_abs} "
                 f"(tolerance rtol {RTOL} of |x|^2 + |y|^2)")
        if agree < MIN_ID_AGREEMENT:
            fail(f"{name}: ids agree on {agree:.5f} < {MIN_ID_AGREEMENT}")
    return max_abs, agree


def kernel_row(name, src, replaces, max_abs, ms, plain_ms, bnd, lib_ms):
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms}


def check_fused_l2_nn(x, dev):
    from raft_tpu_torch.ops import fused_l2_nn as op
    m, n = KM_ROWS, N_LISTS
    g = torch.Generator(device=dev).manual_seed(11)
    xa = x[torch.randperm(x.shape[0], generator=g, device=dev)[:m]]
    ya = x[torch.randperm(x.shape[0], generator=g, device=dev)[:n]]
    xa, ya = xa.contiguous(), ya.contiguous()
    saved = op.launches
    i_k, d_k = op.fused_l2_nn_cuda(xa, ya)
    i_p, d_p = op.fused_l2_nn_plain(xa, ya)
    torch.cuda.synchronize()
    scale = (xa * xa).sum(1) + (ya * ya).sum(1)[i_p.long()]
    max_abs, agree = compare("fused_l2_nn", d_k, i_k, d_p, i_p, False,
                             scale)
    ms = cuda_ms(lambda: op.fused_l2_nn_cuda(xa, ya), 10)
    plain_ms = cuda_ms(lambda: op.fused_l2_nn_plain(xa, ya), 5)
    op.launches = saved
    bnd = bound(4 * (m * D + n * D) + 8 * m, 2 * m * n * D)
    phase("kernels", kernel="fused_l2_nn", shape=[m, n, D],
          id_agreement=agree, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
          bound_ms=bnd[0])
    return kernel_row("fused_l2_nn", "raft_tpu_torch/csrc/fused_l2_nn.cu",
                      "raft_tpu/ops/pallas_fused_l2_nn.py:34", max_abs, ms,
                      plain_ms, bnd, None)


def check_select_k(q, centers):
    from raft_tpu_torch.neighbors._ivf_scan import coarse_scores
    from raft_tpu_torch.ops import select_k as op
    v = coarse_scores(q[:128].contiguous(), centers).contiguous()
    m, n = v.shape
    saved = op.launches
    d_k, i_k = op.select_k_cuda(v, N_PROBES)
    d_p, i_p = op.select_k_plain(v, N_PROBES)
    torch.cuda.synchronize()
    max_abs, agree = compare("select_k", d_k, i_k, d_p, i_p, True)
    ms = cuda_ms(lambda: op.select_k_cuda(v, N_PROBES), 50)
    plain_ms = cuda_ms(lambda: op.select_k_plain(v, N_PROBES), 20)
    lib_ms = cuda_ms(lambda: torch.topk(v, N_PROBES, dim=1, largest=False),
                     50)
    op.launches = saved
    bnd = bound(4 * m * n + 8 * m * N_PROBES, m * n)
    phase("kernels", kernel="select_k", shape=[m, n, N_PROBES],
          id_agreement=agree, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
          library_ms=lib_ms, bound_ms=bnd[0])
    return kernel_row("select_k", "raft_tpu_torch/csrc/select_k.cu",
                      "raft_tpu/ops/pallas_select_k.py:47", max_abs, ms,
                      plain_ms, bnd, lib_ms)


def check_scan(index, q):
    from raft_tpu_torch.neighbors import _ivf_scan
    from raft_tpu_torch.ops import ivf_scan as op
    qb = q[:128].contiguous()
    cap = index.cap_cache.get((128, N_PROBES))
    if cap is None:
        fail("scan: the 128-row plan measured no cap")
    probes = _ivf_scan.coarse_probes(qb, index.centers, N_PROBES)
    qmap, inv_pos = _ivf_scan._invert_probes(probes, index.n_lists, cap)
    args = (qb, index.lists_data, index.lists_norms, index.lists_indices,
            probes, inv_pos)
    saved = op.launches
    d_k, i_k = op.fused_list_scan_cuda(*args, cap, K, 0, False, "l2")
    d_p, i_p = op.fused_list_scan_plain(*args, qmap, cap, K, 0, False, "l2")
    torch.cuda.synchronize()
    ids_all = index.lists_indices.reshape(-1)
    norm_by_id = torch.zeros(index.size, device=qb.device)
    norm_by_id[ids_all[ids_all >= 0].long()] = \
        index.lists_norms.reshape(-1)[ids_all >= 0]
    scale = (qb * qb).sum(1)[:, None] + norm_by_id[i_p.clamp(min=0).long()]
    max_abs, agree = compare("ivf_flat_scan", d_k, i_k, d_p, i_p, False,
                             scale)
    ms = cuda_ms(lambda: op.fused_list_scan_cuda(*args, cap, K, 0, False,
                                                 "l2"), 5)
    plain_ms = cuda_ms(lambda: op.fused_list_scan_plain(
        *args, qmap, cap, K, 0, False, "l2"), 2)
    op.launches = saved
    # what this batch needs: each probed list's real rows (and their
    # norms and ids) read once, the queries once, (nq, k) results out;
    # a dot product per kept (query, row) pair
    kept = inv_pos < cap
    sizes = index.list_sizes.long()
    lists = torch.unique(probes[kept].long())
    rows_once = int(sizes[lists].sum())
    pair_rows = int(sizes[probes[kept].long()].sum())
    n_bytes = rows_once * (D * 4 + 8) + qb.numel() * 4 + 8 * 128 * K
    bnd = bound(n_bytes, 2 * pair_rows * D)
    phase("kernels", kernel="ivf_flat_scan", nq=128, cap=cap,
          probed_lists=int(lists.numel()), rows_once=rows_once,
          pair_rows=pair_rows, id_agreement=agree, max_abs_err=max_abs,
          ms=ms, plain_ms=plain_ms, bound_ms=bnd[0])
    return kernel_row("ivf_flat_scan", "raft_tpu_torch/csrc/ivf_flat_scan.cu",
                      "raft_tpu/ops/pallas_ivf_scan.py:360", max_abs, ms,
                      plain_ms, bnd, None)


def serve_burst(srv, q_np):
    """512 single-query requests from 128 threads, each thread sending
    its share one after another; returns per-request (dists, ids),
    latencies and the burst's wall time."""
    dists = [None] * N_REQUESTS
    ids = [None] * N_REQUESTS
    lat = [0.0] * N_REQUESTS
    errors = []
    barrier = threading.Barrier(N_THREADS + 1)

    def worker(t):
        barrier.wait()
        for r in range(t, N_REQUESTS, N_THREADS):
            t0 = time.perf_counter()
            try:
                d, i = srv.search(q_np[r % len(q_np)], timeout=600)
            except Exception as e:  # reported after the join
                errors.append(repr(e))
                return
            lat[r] = time.perf_counter() - t0
            dists[r], ids[r] = d[0], i[0]

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(N_THREADS)]
    for th in threads:
        th.start()
    barrier.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"serve: {len(errors)} requests failed, first {errors[0]}")
    return np.stack(dists), np.stack(ids), np.asarray(lat), wall


def profile_burst(srv, q_np) -> None:
    """Trace one more burst with ``torch.profiler``: device time by
    kernel into ``chiprun_out/profile_burst.txt``, and the device's
    busy share of the burst's wall time (kernels on one stream do not
    overlap, so their summed self time is the busy time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = serve_burst(srv, q_np)[-1]
    ka = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in ka
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    with open(os.path.join(OUT_DIR, "profile_burst.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    phase("profile", wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
          busy_share=busy_us / 1e3 / (wall * 1e3),
          top=[{"name": n[:60], "device_ms": t / 1e3, "calls": c}
               for n, t, c in rows[:8]])


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000,
                    help="dataset rows (default 10M; a cut is printed)")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="after the measured burst, trace a second one "
                    "with torch.profiler (device time by kernel)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs only on a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "raft_tpu_torch")):
        fail("raft_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, here)
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.serve import SearchServer, ServeConfig

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = gpu_line()
    os.makedirs(OUT_DIR, exist_ok=True)

    # 1. build
    secs, reports = _build.build_all(verbose=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in reports.items():
            f.write(f"== {name}\n{text}\n")
    phase("build", seconds=secs, kernels=list(_build.KERNEL_SOURCES))

    x, q = ann_dataset(args.n, D, N_QUERIES, args.seed, dev)
    if args.n != 10_000_000:
        phase("cut", n=args.n, note="dataset cut from 10,000,000 rows")

    # 2a. kernels vs plain at the k-means and coarse shapes
    rows = [check_fused_l2_nn(x, dev)]
    g = torch.Generator(device=dev).manual_seed(12)
    cent = x[torch.randperm(x.shape[0], generator=g, device=dev)[:N_LISTS]]
    rows.append(check_select_k(q, cent.contiguous()))

    # 3. main path: build, serve; launch counts over exactly this run
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = ivf_flat.build(x, ivf_flat.IndexParams(
        n_lists=N_LISTS, kmeans_n_iters=KMEANS_ITERS))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = ops.launch_counts()
    t0 = time.perf_counter()
    q_np = q.cpu().numpy()
    srv = SearchServer.from_index(
        index, q_np[:128], K, params=ivf_flat.SearchParams(n_probes=N_PROBES),
        config=ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                           max_wait_ms=2.0))
    ladder_s = time.perf_counter() - t0
    from raft_tpu_torch import obs
    before = obs.snapshot()
    pre_burst = ops.launch_counts()
    try:
        served_d, served, lat, wall = serve_burst(srv, q_np)
        launches = ops.launch_counts()
        after = obs.snapshot()
        if args.profile:
            profile_burst(srv, q_np)
    finally:
        srv.close()
    batches = {k_: after["counters"].get(k_, 0) - before["counters"].get(k_, 0)
               for k_ in after["counters"] if k_.startswith("raft.serve.batch")}
    burst_launches = {k_: launches[k_] - pre_burst[k_] for k_ in launches}
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"main path never launched the {name} kernel")

    if served.shape != (N_REQUESTS, K):
        fail(f"served ids have shape {served.shape}")
    if (served < 0).any() or (served >= args.n).any():
        fail("served ids out of range")
    if not np.isfinite(served_d).all() or (np.diff(served_d, axis=1) < 0).any():
        fail("served distances are not finite and ascending")
    truth = exact_knn(x, q, K).cpu().numpy()
    hits = [len(set(served[r]) & set(truth[r % N_QUERIES]))
            for r in range(N_REQUESTS)]
    recall = float(np.mean(hits)) / K
    if recall < RECALL_FLOOR:
        fail(f"recall@{K} = {recall} < {RECALL_FLOOR}")
    p50, p99 = (float(v) * 1e3 for v in np.percentile(lat, [50, 99]))
    phase("main", n=args.n, dim=D, n_lists=N_LISTS, max_list=
          int(index.lists_data.shape[1]), build_s=build_s, ladder_s=ladder_s,
          requests=N_REQUESTS, threads=N_THREADS, burst_s=wall,
          qps=N_REQUESTS / wall, p50_ms=p50, p99_ms=p99,
          recall_at_32=recall, batches=batches,
          build_launches=build_launches, burst_launches=burst_launches,
          launches=launches,
          mem_allocated_gb=torch.cuda.memory_allocated() / 1e9,
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    # 2b. the fused scan against its plain version on the real index
    rows.append(check_scan(index, q))
    for row, name in zip(rows, ("fused_l2_nn", "select_k", "ivf_scan")):
        row["launches"] = launches[name]

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

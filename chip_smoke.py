#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, one line each:

1. build    — compile every CUDA kernel of ``raft_tpu_torch/csrc`` with
              nvcc (one process per source, all at once) into
              ``raft_tpu_torch/_build``.
2. kernels  — each kernel against its plain PyTorch version on CUDA
              tensors at each path's shapes: fused L2-NN at the card's
              default bf16x3 (tensor cores) at the k-means sweeps'
              (262144, 128) x (1024, 128) and the build's predict over
              all n rows (``fused_l2_nn@predict``), and select-k at
              (128, 1024) k=96 for IVF-Flat; the fused IVF-Flat scan over the real
              index for one 128-query batch, and the unfused list scan
              at k=512 on the same batch (after phase 3; both bf16x3 on
              the tensor cores, held to bf16x3 plain versions); on the real
              PQ index (after phase 4) both IVF-PQ scans for one
              128-query batch, the fused one at k=32 (kk=256), the
              unfused one at k=64 (kk=512), both on the list-major route
              of the default bf16 LUT tier and on the f32 body of the
              float32 tier (rows ``...@f32``), fused L2-NN at
              (262144, 128) x (4096, 128) and (n, 128) x (4096, 128)
              and select-k at (128, 4096) k=128 (rows tagged
              ``@ivf_pq``, ``@ivf_pq_predict``); on the real BQ index
              (after phase 5) both IVF-BQ scans likewise (kk=256 fused,
              kk=512 unfused) and select-k at (128, 1024) k=128
              (``select_k@ivf_bq``). Pass B alone, the payload radix
              select, on each fused user's candidate rows: IVF-Flat,
              IVF-PQ and IVF-BQ (one 128-query batch each; rows
              ``select_k_payload@ivf_flat|ivf_pq|ivf_bq``) and kernel
              5's L2 rows in phase 6 (``select_k_payload@bf``), against
              its plain version and ``torch.topk``; these rows carry the
              launches of the fused scan that runs them. Kernel, plain
              and library times from CUDA events after warm-up.
2b. kmeans_tiers — the trainer at kernel 1's other tiers, through
              ``balanced_kmeans`` on the 262144-row subsample: 10 sweeps
              at ``"bf16"`` (the tensor-core kernel, one pass; row
              ``fused_l2_nn@bf16``), then 10 sweeps at ``"highest"`` and
              the predict over all n rows through ``fused_l2_nn`` (the
              f32 body; rows ``fused_l2_nn@highest...`` at every shape of
              the bf16x3 rows, so each shape has a same-run comparison);
              each tier's seconds, launches by shape and mean squared
              distance to the assigned centre. Reproducible builds: two
              runs at one seed at bf16x3, bit for bit after each sweep
              and at the end (the smoke fails otherwise), and whether
              ``index_add_``, the fixed-order segment sum and
              ``torch.topk`` give the same bits twice on the card.
3. main     — the IVF-Flat serving path: a 10M x 128 clustered dataset
              (the benchmark's gaussian mixture, made on the card from a
              seed), IVF-Flat build (1024 lists, 10 k-means sweeps),
              ``SearchServer.from_index`` (batch shapes 1/8/32/128,
              96 probes, k=32), a burst of 512 single-query requests from
              128 threads; recall@32 against exact search, QPS, p50/p99,
              device memory, and each kernel's launch count over the run;
              then ``wide_flat``: one list-major ``ivf_flat.search`` of
              128 queries at k=512 (the unfused list scan and the
              candidate merge), its recall of the top 32 and its launch
              counts; then the index is dropped (``free``: device memory
              after the ``del`` and after a collection pass).
              ``serve_faults`` (after the main burst, on the same index):
              a server with the dispatch watchdog (2000 ms, 2 retries,
              1 ms backoff) serves the burst (the same checks, its
              QPS and p50/p99 beside the main burst's); 4 x 25 serial
              128-query requests through its ladder with and without
              the watchdog, and 4 x 100 through a plan that replays one
              result (the helper thread's cost per dispatch); one
              128-query request under an injected 4 s stall, retried
              once to ids equal to a direct ``plan.search``; three
              injected ``ShardFailedError`` that exhaust the retries,
              and the next request served.
3b. main_flat_bf16 — the same path at ``storage_dtype="bfloat16"``: build,
              burst, ``wide_flat`` (kernels 3 and 4 at ``Bf16Rows``, launch
              keys ``ivf_scan_bf16``, ``ivf_list_scan_bf16``), both scans
              against their plain versions (rows ``ivf_flat_scan@bf16``,
              ``ivf_list_scan@bf16``), ``free``.
3c. main_flat_int8 — at ``storage_dtype="int8"``: build on the first 90%
              of the rows, ``ivf_flat.extend`` with the rest (ids
              continuing the index's; the scale before and after), then
              as 3b (``Int8Rows``, keys ``..._int8``, rows ``...@int8``).
4. main_pq  — the IVF-PQ serving path on the same dataset, after the
              IVF-Flat index is freed: build (4096 lists, pq_dim 32 x 8
              bits, 10 sweeps, raw vectors kept), ``SearchServer`` with
              128 probes, k=32, rescore_factor 8 re-ranked on the card,
              the same burst, then one ``ivf_pq.search`` at k=64 (the
              unfused scan); the same measurements; then ``pq_f32``: one
              search at k=32 and one at k=64 at ``lut_dtype`` float32
              (the f32 body's two launch keys, counted alone); the index
              is then dropped (``free``), as after phase 5.
5. main_bq  — the IVF-BQ serving path on the same dataset, after the
              IVF-PQ index is freed: build (1024 lists, 10 sweeps, raw
              vectors kept; ``tools/north_star_recall.py``'s 10M BQ
              point), ``SearchServer`` with 128 probes, k=32,
              rescore_factor 8 re-ranked on the card (kk=256: the fused
              scan serves every batch), the same burst, then one
              ``ivf_bq.search`` at k=64 (kk=512, the unfused scan); the
              same measurements.
5b. main_pq_pc — phase 4's point with ``codebook_kind=PER_CLUSTER``,
              built on the first 90% of the rows and ``ivf_pq.extend``-ed
              with the rest (build and extend seconds), the same burst and
              k=64 search (main_pq's recall beside), both PQ scans against
              their plain versions (rows ``ivf_pq_scan_fused@per_cluster``,
              ``ivf_pq_scan@per_cluster``), then ``pq_scan_modes``: one
              128-query search at ``scan_mode="reconstruct"`` (list-major)
              and one at ``"lut"``, each with recall@32, seconds and the
              decode cache's device memory.
5c. main_bq_extend — phase 5's point built on 90% and ``ivf_bq.extend``-ed
              with the rest: the burst, recall@32, extend seconds and the
              launches of kernels 10 and 11.
5d. kmeans_two_level — ``build_hierarchical`` at 32768 lists on the
              10M rows (the two-level trainer), then the predict of every
              row: seconds, kernel 1's launches by shape, list sizes and
              the mean squared distance to the assigned centre.
6. main_bf  — brute-force k-NN on the same 10M x 128 dataset (the
              reference's ``knn.cuh`` case): 1000 queries from the same
              mixture, k=32, ``brute_force_knn(mode="fused")`` for
              L2Expanded, InnerProduct and CosineExpanded at the card's
              default precision (kernel 5's bf16x3 pass A on the tensor
              cores), then L2 at ``kernel_precision="highest"`` (its f32
              body); time and QPS over 3 reps after a warm-up, recall@32
              against ``mode="exact"`` and the exact scan's time, peak
              memory, launch counts, and kernel 5 against its plain
              version at the same arithmetic on the same inputs (rows
              ``fused_knn``, ``fused_knn@<metric>``,
              ``fused_knn@highest``).
7. wide_bf  — 10,000 x 8192 normal rows, 1000 queries, k=32, fused: the
              d > 4096 route (kernel 6) at the card's default bf16x3 on
              the tensor cores (row ``fused_knn_ktiled``) and at
              ``"highest"`` (its f32 body, ``fused_knn_ktiled@highest``),
              each against its plain version and recall against exact
              (gate 0.95).
8. pairwise — ``pairwise_distance`` at 8192 x 8192 x 256 on uniform
              [0, 1) data (hamming on values rounded to {0..3}) for
              every elementwise metric name (kernel 7, rows
              ``elementwise_dist@<name>``), each against its plain
              version, with one ``torch.cdist`` call as the library time
              where one computes the same function (hamming: the p=0
              count, divided by the dim for its error); the expanded
              metrics' times for context; one exact L1 ``brute_force_knn``
              of 100 queries over the first 1M rows (kernel 7 inside the
              exact scan). Two more rows: canberra where |a| + |b| lies in
              (2^126, 2^128) (``elementwise_dist@canberra_big``) and
              minkowski at p = 0 (``elementwise_dist@minkowski_p0``, +inf
              everywhere at dim 256), each against its plain version.
9. cluster  — the host-side users of the distances. ``kmeans.fit`` on the
              first 1M rows, k = 1024, 20 iterations, Random then
              k-means++ init (kernel 1 at bf16x3 for every assignment):
              seconds, iterations, inertia, kernel 1's launches by shape;
              a second fit at one seed bit for bit and the inertia within
              1e-3 of ``cluster_cost`` (fails otherwise); row
              ``fused_l2_nn@kmeans`` at (1M, 128) x (1024, 128).
              ``single_linkage`` over the kNN graph of the first 100,000
              rows (c = 15, 100 clusters): the seconds of the kNN graph,
              of each connectivity round (with the components before it),
              of the MST and of the dendrogram; the dendrogram checked
              (n - 1 merges of rising height, the last of size n, 100
              labels); then PAIRWISE on 4,096 rows against
              ``scipy.cluster.hierarchy.linkage(method="single")`` cut at
              100 clusters (labels equal up to renaming, heights within
              1e-4). ``silhouette_score`` of 50,000 rows at the fit's
              labels, euclidean and cityblock, each within 1e-4 of the
              port's CPU run on 5,000 of them (row
              ``elementwise_dist@silhouette_l1`` at (256, 50000, 128)). The
              sparse stack: the repo's wide case (512 x 256 rows of
              100,000 features, 64 nonzeros, col_tile 4096) against the
              dense distance of the densified rows; a narrow case (8192 x
              8192 rows of 1024 features at 5%) at cityblock and
              jensenshannon, bit for bit against the dense distance (rows
              ``elementwise_dist@sparse_narrow_l1|js``); a sparse k-NN of
              2000 queries over 50,000 rows of the wide form, k = 32, its
              first queries against ``torch.sparse.mm``. ``select_k`` at
              ``mode="approx"`` on one (128, 4096) batch at k = 128: the
              exact mode's ids, and kernel 2 launched.
10. primitives — the dense primitives and spectral partitioning.
              ``random.make_blobs`` of 1,048,576 x 32 points round 16
              centres on the card; their kNN graph at k = 15 in
              ``knn_graph``'s form (unit weights, CSR) from the fused
              brute force (kernel 5 and its pass B);
              ``spectral.partition`` into 16 clusters (normalized
              Laplacian, Lanczos, k-means on the 16-d embedding: kernel 1
              at (1,048,576, 16) x 16), ``analyze_partition``,
              ``analyze_modularity``, then ``modularity_maximization``:
              each part's seconds, the eigenvalues, the adjusted Rand index
              against the blob labels, edge cut, cost, modularity and
              kernel 1's launches by shape; fails unless the labels lie in
              [0, 16), everything is finite, the Laplacian's eigenvalues
              ascend within [-1e-3, 2 + 1e-3] and kernel 1 was launched;
              row ``fused_l2_nn@spectral`` (the embedding against the
              partition's centroids). Dense linear algebra: ``rsvd`` at
              rank 64 of a 262,144 x 1024 rank-64-plus-noise matrix (its
              singular values within 1e-2 of ``torch.linalg.svdvals``),
              ``eig_dc`` and ``svd_qr`` at 4096 x 4096 and ``lstsq_qr`` at
              262,144 x 256 (reconstruction and normal-equations residuals
              within 1e-4), ``stats.cov`` and ``stats.meanvar`` of the
              blobs against float64. ``linear_assignment`` at 2048 x 2048
              on integer costs in [0, 1000): a permutation, its objective
              beside scipy's and the auction rounds of each phase. R-MAT at
              Graph500's scale 20, edge factor 16, theta (0.57, 0.19, 0.19,
              0.05): the top-level quadrant shares within 0.01 of theta;
              ``make_regression`` at 1,048,576 x 128: the noise-free targets
              within 1e-4 of x @ coef + bias.

The exact search's truth for phases 3-5 (256 queries, k=32) comes from
the port's own ``brute_force_knn(mode="exact")``.

The build line reports the registers, shared memory and spills of the
radix select (both modes), the tensor-core fused L2-NN, the tensor-core
passes A of kernels 5/6, 3/4 (f32, bf16 and int8 rows), 8/9 and 10/11,
the IVF-PQ f32 body and every core of kernel 7 (``nvcc -Xptxas -v``).
Then a ``{"kernels": [...]}`` line, the card's name and power limit, and the
last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before the last line. There is no CPU path: without CUDA the
script fails. ``--n`` cuts the dataset of every path (the cut is
printed).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

# peaks of the H100 SXM, NVIDIA's data sheet (dense rates, 700 W)
HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_FLOPS = 67e12             # float32 outside the tensor cores
BF16_FLOPS = 989e12            # bf16 on the tensor cores
# instruction rates: the fp32 peak counts an FMA as two operations, so
# 128 lanes x 132 SMs x 1.98 GHz issue 33.5e12 fp32 instructions a
# second; special functions (log, exp, reciprocal) at 16 results a clock
# per SM (CUDA C++ Programming Guide, throughput table, compute 9.0)
FP32_INSTR = FP32_FLOPS / 2
SFU_OPS = 16 * 132 * 1.98e9
# kernel vs plain distance tolerance: rtol 1e-5 of the scale of the
# expanded-L2 terms (|x|^2 + |y|^2), where fp32 rounding of
# |x|^2 + |y|^2 - 2 x.y lives (a distance near 0 keeps that error)
RTOL = 1e-5
MIN_ID_AGREEMENT = 0.999
RECALL_FLOOR = 0.5

D, K, N_PROBES, N_LISTS, KMEANS_ITERS = 128, 32, 96, 1024, 10
# the IVF-Flat route for k > 256: list-major, the unfused list scan
FLAT_WIDE_K = 512
# IVF-Flat's narrow list storages: storage_dtype -> the tag of their phase,
# launch keys and rows; the int8 index is built on the first 1 - 1/10 of
# the rows and extended with the rest
FLAT_STORAGES = {"bfloat16": "bf16", "int8": "int8"}
EXTEND_SHARE = 10
# the IVF-PQ point: bench_suite.bench_ivf_pq(n=10M, nlists=4096,
# n_probes=128) with its defaults (k=32, pq_bits 8, pq_dim dim/4,
# rescore_factor 8), the re-rank kept on the card
PQ_LISTS, PQ_PROBES, PQ_BITS = 4096, 128, 8
# the IVF-BQ point: tools/north_star_recall.py's 10M BQ build (1024
# lists, 10 sweeps, raw kept) at its 128-probe operating point, k=32,
# rescore_factor 8 (the SearchParams default), the re-rank on the card
BQ_LISTS, BQ_PROBES = 1024, 128
# both quantized paths: kk = 8 * 32 = 256 takes the fused scan; one
# search at k=64 (kk = 512 > 256) takes the unfused scan and the merge
RESCORE, WIDE_K = 8, 64
KM_ROWS = 1 << 18             # the k-means trainer's subsample
# the two-level trainer's point: about sqrt(n) lists for a billion rows
TWO_LEVEL_LISTS = 32768
BATCH_SIZES = (1, 8, 32, 128)
N_QUERIES, N_REQUESTS, N_THREADS = 256, 512, 128
SERIAL_REQUESTS = 25          # a round of serve_faults' serial requests
FAULTS_GUARD = dict(dispatch_timeout_ms=2000.0, max_retries=2,
                    retry_backoff_ms=1.0)
# brute force: the reference's cpp/bench/neighbors/knn.cuh:380-389 cases
# (10M x 128 and 10k x 8192, 1000 queries, k=32); the JAX package's
# recall gate for the fused kernel (BASELINE.md:43)
BF_QUERIES, BF_REPS, BF_RECALL_GATE = 1000, 3, 0.95
WIDE_N, WIDE_D = 10_000, 8192
# pairwise distances at bench_suite.py:37-51's 8192 x 8192 x 256; one
# exact L1 scan of L1_QUERIES queries over the first L1_ROWS rows
PAIR_N, PAIR_D = 8192, 256
L1_ROWS, L1_QUERIES = 1_000_000, 100
# elementwise kernel vs plain: float32 sums of 256 terms in two orders
# differ by up to ~2 x 256 x 2^-24 relative (logarithm cores alike)
ELT_RTOL, ELT_ATOL = 1e-4, 1e-5
# the elementwise metric names: name -> (core, sqrt, torch.cdist p giving
# the same function or None; p=0 counts the differing coordinates, which
# hamming divides by the dim)
PAIR_NAMES = {
    "cityblock": ("l1", False, 1.0),
    "sqeuclidean": ("l2unexp", False, None),
    "euclidean": ("l2unexp", True, 2.0),
    "chebyshev": ("linf", False, float("inf")),
    "canberra": ("canberra", False, None),
    "minkowski": ("minkowski", False, 3.0),
    "hamming": ("hamming", False, 0.0),
    "jensenshannon": ("jensen_shannon", False, None),
    "kl_divergence": ("kl", False, None),
    "braycurtis": ("braycurtis", False, None),
}
# the least work of each core per (i, j, dimension) element:
# (fp32 instructions, special-function results) — a difference and an
# add of its absolute value for l1; for canberra a reciprocal; for
# minkowski a log2 and an exp2; for jensen_shannon the log of the mean
# (the logs of a and b can be taken once a row, as for kl)
ELT_WORK = {"l1": (2, 0), "l2unexp": (2, 0), "linf": (2, 0),
            "canberra": (5, 1), "minkowski": (3, 2), "hamming": (2, 0),
            "jensen_shannon": (8, 1), "kl": (2, 0), "braycurtis": (4, 0)}
PAIR_EXPANDED = ("inner_product", "cosine", "correlation", "hellinger",
                 "russellrao", "jaccard", "dice")

# the pairwise_distance names of the rows that are not PAIR_NAMES keys
PAIR_ENTRY = {"canberra_big": "canberra", "minkowski_p0": "minkowski"}

# phase 9, cluster: Lloyd k-means on the first KM_FIT_ROWS rows (the
# survey's 1M-row k-means workload at the smoke's width), k = 1024, 20
# iterations, Random then k-means++ init; single-linkage on the first
# SL_ROWS rows (kNN graph, c = 15) and SL_PAIR_ROWS rows (pairwise),
# SL_CLUSTERS clusters; the silhouette of SIL_ROWS rows at the fit's
# labels, held to the CPU on SIL_SUB of them; the sparse cases: the
# repo's wide case (bench_suite.py bench_sparse_wide: 512 x 256 rows of
# 100,000 features, 64 nonzeros a row, col_tile 4096), a narrow one
# (8192 x 8192 rows of 1024 features at 5% density) and a k-NN (2000
# queries over 50,000 rows of the wide rows' form, k = 32); select_k at
# mode="approx" on one (128, 4096) batch at k = 128
KM_FIT_ROWS, KM_FIT_CLUSTERS, KM_FIT_ITERS = 1_000_000, 1024, 20
SL_ROWS, SL_C, SL_CLUSTERS, SL_PAIR_ROWS = 100_000, 15, 100, 4096
SIL_ROWS, SIL_SUB, SIL_TOL = 50_000, 5_000, 1e-4
SP_WIDE = (512, 256, 100_000, 64, 4096)     # m, n, features, nnz, col_tile
SP_NARROW = (8192, 8192, 1024, 0.05)        # m, n, features, density
SP_KNN = (2000, 50_000, 32, 64)             # queries, rows, k, checked
SP_TOL = 1e-4
APPROX = (128, 4096, 128)

# phase 10, primitives: spectral partition of SPEC_N blob points
# (SPEC_D features, SPEC_CLUSTERS centres) on their kNN graph at
# SPEC_KNN (unit weights); rsvd of a RSVD_SHAPE matrix of rank RSVD_K plus
# noise (a PCA sketch of embeddings), eig_dc and svd_qr at DENSE_N,
# lstsq_qr at LSTSQ_SHAPE, the auction at LAP_N on integer costs in
# [0, 1000); R-MAT at Graph500's scale and edge factor and theta;
# make_regression at REG_SHAPE. Residual gates: float32 factorisations
# give ~1e-6 (the CPU at these sizes), so 1e-4 catches a wrong result
SPEC_N, SPEC_D, SPEC_CLUSTERS, SPEC_KNN = 1 << 20, 32, 16, 15
RSVD_SHAPE, RSVD_K, RSVD_TOL = (262_144, 1024), 64, 1e-2
DENSE_N, LSTSQ_SHAPE, RESID_TOL = 4096, (262_144, 256), 1e-4
LAP_N = 2048
RMAT_SCALE, RMAT_EDGE_FACTOR = 20, 16
RMAT_THETA, RMAT_TOL = (0.57, 0.19, 0.19, 0.05), 0.01
REG_SHAPE, REG_TOL = (1 << 20, 128), 1e-4

# kernels whose compiled resources the build line reports
PTXAS_KERNELS = ("radix_select_kernel", "knn_bins_tc_kernel",
                 "list_scan_tc_kernel", "fused_l2_nn_tc_kernel",
                 "pq_pairs_kernel", "elementwise_dist_kernel")

OUT_DIR = "chiprun_out"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def ptxas_summary(reports: dict) -> dict:
    """Registers, shared memory and spills of each PTXAS_KERNELS entry
    function, from ``nvcc -Xptxas -v`` output."""
    import re
    out, cur = {}, None
    for text in reports.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                hit = [kn for kn in PTXAS_KERNELS if kn in name]
                cur = (hit[0] + name.split(hit[0], 1)[1].split("Ev", 1)[0]
                       if hit else None)
                if cur:
                    out[cur] = {}
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[cur]["spill_stores"] = int(m.group(1))
                out[cur]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[cur]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                out[cur]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


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


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Mean device milliseconds of ``fn()`` with the host's launch cost
    taken out: ``reps`` calls captured into one CUDA graph, replayed
    ``replays`` times between two events. For kernels of a few
    microseconds, where a Python launch takes longer than the kernel and
    ``cuda_ms`` would time the host."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (reps * replays)


def bound(n_bytes: float, *work):
    """The least milliseconds for a function's work, and what bounds it:
    its bytes at the memory rate, or its operations, given as
    ``(count, rate)`` pairs at the card's peak rate for each operand
    type (units of different types can run at once, so the longest pair
    counts), whichever takes longer."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = max(n / rate * 1e3 for n, rate in work)
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def ann_dataset(n: int, d: int, nq: int, seed: int, dev):
    """The benchmark's clustered mixture: ``nc = max(64, min(8192,
    n // 125))`` standard-normal centres, rows = centre + unit noise;
    ``nq`` queries from the same mixture, then ``BF_QUERIES`` more for
    brute force. Drawn on the card from ``seed``."""
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
    qs = []
    for m in (nq, BF_QUERIES):
        qlab = torch.randint(0, nc, (m,), generator=g, device=dev)
        qs.append(centers[qlab] + torch.randn((m, d), generator=g,
                                              device=dev))
    return x, qs[0], qs[1]


def compare(name, d_k, i_k, d_p, i_p, exact_ids: bool, scale=None):
    """Hold a kernel's (dists, ids) against the plain version's: exact
    equality, or the same empty (+inf) slots with the same ids there,
    and ids agreeing on >= 99.9% of the filled slots with every distance
    (so every disagreement is a near-tie) within ``RTOL * scale``."""
    d_k, d_p = d_k.double(), d_p.double()
    fin = torch.isfinite(d_p)
    if not torch.equal(torch.isfinite(d_k), fin):
        fail(f"{name}: finite pattern differs from the plain version")
    if not torch.equal(i_k[~fin], i_p[~fin]):
        fail(f"{name}: ids of the empty slots differ from the plain version")
    err = (d_k[fin] - d_p[fin]).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    agree = float((i_k[fin] == i_p[fin]).double().mean()) if err.numel() \
        else 1.0
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


def probe_stats(list_sizes, probes, inv_pos, cap: int) -> dict:
    """One batch's kept (query, probe) pairs (``inv_pos < cap``): the
    distinct probed lists, their rows counted once, the pairs, and the
    rows scored over all pairs."""
    kept = inv_pos < cap
    sizes = list_sizes.long()
    lists = torch.unique(probes[kept].long())
    return {"probed_lists": int(lists.numel()),
            "rows_once": int(sizes[lists].sum()), "pairs": int(kept.sum()),
            "pair_rows": int(sizes[probes[kept].long()].sum())}


def sample_rows(x, m: int, seed: int):
    g = torch.Generator(device=x.device).manual_seed(seed)
    return x[torch.randperm(x.shape[0], generator=g,
                            device=x.device)[:m]].contiguous()


# kernel 1's tiers: the plain version's arithmetic, the launch key, the
# source and the operations of its products: (passes, rate)
NN_TIERS = {
    "bf16x3": ("bf16x3", "fused_l2_nn",
               "raft_tpu_torch/csrc/fused_l2_nn_tc.cu", 3, BF16_FLOPS),
    "bf16": ("bf16", "fused_l2_nn",
             "raft_tpu_torch/csrc/fused_l2_nn_tc.cu", 1, BF16_FLOPS),
    "highest": ("f32", "fused_l2_nn_f32",
                "raft_tpu_torch/csrc/fused_l2_nn.cu", 1, FP32_FLOPS),
}


def check_fused_l2_nn(xa, ya, name, tier="bf16x3"):
    """fused L2-NN of ``xa`` against the centres ``ya`` at ``tier``
    (``kernel_precision``), against its plain version at the same
    arithmetic; ``name`` tags the path and shape. The bf16 tier's
    products are exact in f32 like bf16x3's, so the same rtol holds."""
    from raft_tpu_torch.ops import fused_l2_nn as op
    precision, _, src, passes, rate = NN_TIERS[tier]
    (m, dim), n = xa.shape, ya.shape[0]
    saved = (op.launches, op.launches_f32, dict(op.shapes))
    kernel = lambda: op.fused_l2_nn_cuda(xa, ya, False, precision)  # noqa: E731
    i_k, d_k = kernel()
    (i_p, d_p), plain_ms = cuda_once(
        lambda: op.fused_l2_nn_plain(xa, ya, False, precision))
    scale = (xa * xa).sum(1) + (ya * ya).sum(1)[i_p.long()]
    max_abs, agree = compare(name, d_k, i_k, d_p, i_p, False, scale)
    del i_k, d_k, i_p, d_p, scale
    ms = cuda_ms(kernel, 3 if m > KM_ROWS else 10)
    op.launches, op.launches_f32 = saved[:2]
    op.shapes.clear()
    op.shapes.update(saved[2])
    bnd = bound(4 * (m * dim + n * dim) + 8 * m,
                (passes * 2 * m * n * dim, rate))
    phase("kernels", kernel=name, shape=[m, n, dim], precision=precision,
          id_agreement=agree, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
          bound_ms=bnd[0], bound_by=bnd[1])
    return kernel_row(name, src, "raft_tpu/ops/pallas_fused_l2_nn.py:34",
                      max_abs, ms, plain_ms, bnd, None)


def l2nn_shapes() -> dict:
    """Fused L2-NN launches since the last reset, by ``"m x n"``."""
    from raft_tpu_torch.ops import fused_l2_nn as op
    return {f"{m}x{n}": c for (m, n), c in sorted(op.shapes.items())}


def check_select_k(q, centers, k, name):
    """select-k of the coarse scores of one 128-query batch against
    ``centers`` at ``k`` probes, against its plain version."""
    from raft_tpu_torch.neighbors._ivf_scan import coarse_scores
    from raft_tpu_torch.ops import select_k as op
    v = coarse_scores(q[:128].contiguous(), centers).contiguous()
    m, n = v.shape
    saved = op.launches
    d_k, i_k = op.select_k_cuda(v, k)
    d_p, i_p = op.select_k_plain(v, k)
    torch.cuda.synchronize()
    max_abs, agree = compare(name, d_k, i_k, d_p, i_p, True)
    # device times by graph replay (the kernel takes ~10 us, less than a
    # Python launch); the eager per-call times, host included, beside them
    kernel = lambda: op.select_k_cuda(v, k)  # noqa: E731
    lib = lambda: torch.topk(v, k, dim=1, largest=False)  # noqa: E731
    ms, lib_ms = graph_ms(kernel), graph_ms(lib)
    eager_ms, lib_eager_ms = cuda_ms(kernel, 50), cuda_ms(lib, 50)
    plain_ms = cuda_ms(lambda: op.select_k_plain(v, k), 20)
    op.launches = saved
    bnd = bound(4 * m * n + 8 * m * k, (m * n, FP32_FLOPS))
    phase("kernels", kernel=name, shape=[m, n, k],
          id_agreement=agree, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
          library_ms=lib_ms, eager_ms=eager_ms, library_eager_ms=lib_eager_ms,
          bound_ms=bnd[0])
    return kernel_row(name, "raft_tpu_torch/csrc/select_k.cu",
                      "raft_tpu/ops/pallas_select_k.py:47", max_abs, ms,
                      plain_ms, bnd, lib_ms)


def check_pass_b(name, rows_d, rows_i, k: int, launches: int,
                 replaces: str):
    """Pass B alone, the payload radix select, on a fused scan's candidate
    rows ``rows_d``/``rows_i`` (m, n) at ``k``, against its plain version
    (exact: selection does no arithmetic) and ``torch.topk`` of the same
    rows; ``launches`` is the fused scan's (each of its launches runs pass
    B once). Rows of the IVF batches (~2M entries) are timed by graph
    replay, the brute-force rows eagerly."""
    from raft_tpu_torch.ops import select_k as op
    m, n = rows_d.shape
    saved = op.launches_payload
    d_k, i_k = op.select_k_payload_cuda(rows_d, rows_i, k)
    d_p, i_p = op.select_k_payload_plain(rows_d, rows_i, k)
    torch.cuda.synchronize()
    max_abs, agree = compare(name, d_k, i_k, d_p, i_p, True)
    del d_k, i_k, d_p, i_p
    kernel = lambda: op.select_k_payload_cuda(rows_d, rows_i, k)  # noqa: E731
    lib = lambda: torch.topk(rows_d, k, dim=1, largest=False)  # noqa: E731
    if m * n <= 1 << 22:
        ms, lib_ms = graph_ms(kernel), graph_ms(lib)
    else:
        ms, lib_ms = cuda_ms(kernel, 10), cuda_ms(lib, 10)
    plain_ms = cuda_ms(lambda: op.select_k_payload_plain(rows_d, rows_i, k),
                       3, warmup=1)
    op.launches_payload = saved
    # the values read once, the k ids of the kept columns, values and ids
    # written; a comparison per value
    bnd = bound(4 * m * n + 12 * m * k, (m * n, FP32_FLOPS))
    phase("kernels", kernel=name, shape=[m, n, k], id_agreement=agree,
          max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          bound_ms=bnd[0], bound_by=bnd[1], launches=launches)
    row = kernel_row(name, "raft_tpu_torch/csrc/radix_select.cuh", replaces,
                     max_abs, ms, plain_ms, bnd, lib_ms)
    row["launches"] = launches
    return row


def run_kmeans_tiers(x, sample, cents, cents_pq):
    """Phase 2b: ``balanced_kmeans`` on ``sample`` at each tier of kernel
    1 (``bf16x3`` the default, ``bf16``, ``highest``), the highest run
    followed by the predict over every row of ``x``; each run's seconds,
    launches by shape and mean squared distance of the sample to its
    nearest centre (by the plain f32 version). Then kernel 1 at the bf16
    tier (the sweeps' shape) and the f32 body at every shape of the
    bf16x3 rows, against their plain versions; the rows carry the
    launches of their tier's run."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.cluster.kmeans_balanced import balanced_kmeans
    from raft_tpu_torch.distance import fused_l2_nn
    from raft_tpu_torch.ops import fused_l2_nn as op
    launches = {}
    # one untimed sweep first: the first call of the trainer pays one-time
    # costs (allocator growth, the kernels' first launches)
    balanced_kmeans(sample, N_LISTS, 1, seed=3)
    torch.cuda.synchronize()
    for tier in ("bf16x3", "bf16", "highest"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        centers = balanced_kmeans(sample, N_LISTS, KMEANS_ITERS, seed=3,
                                  kernel_precision=tier)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        predict_s = None
        if tier == "highest":
            t0 = time.perf_counter()
            fused_l2_nn(x, centers, kernel_precision=tier)
            torch.cuda.synchronize()
            predict_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        launches[tier] = counts[NN_TIERS[tier][1]]
        if launches[tier] < KMEANS_ITERS:
            fail(f"kmeans at {tier}: {launches[tier]} launches of "
                 f"{NN_TIERS[tier][1]}")
        cost = float(op.fused_l2_nn_plain(sample, centers, False,
                                          "f32")[1].mean())
        phase("kmeans_tiers", tier=tier, n_clusters=N_LISTS,
              rows=sample.shape[0], sweeps=KMEANS_ITERS, train_s=train_s,
              predict_n=x.shape[0] if predict_s else None,
              predict_s=predict_s, mean_sq_dist=cost,
              fused_l2_nn_shapes=l2nn_shapes(),
              launches={k_: v for k_, v in counts.items() if v})
        del centers
    check_determinism(sample)
    rows = [check_fused_l2_nn(sample, cents, "fused_l2_nn@bf16", "bf16")]
    rows[0]["launches"] = launches["bf16"]
    for xa, ya, name in ((sample, cents, ""), (x, cents, "_predict"),
                         (sample, cents_pq, "_ivf_pq"),
                         (x, cents_pq, "_ivf_pq_predict")):
        row = check_fused_l2_nn(xa, ya, f"fused_l2_nn@highest{name}",
                                "highest")
        row["launches"] = launches["highest"]
        rows.append(row)
    return rows


def check_determinism(sample):
    """Reproducible builds: two runs of the trainer at one seed at the
    card's default bf16x3, compared bit for bit after each sweep (its own
    sweep, ``kmeans_balanced._em``, one at a time) and at the end of two
    ``balanced_kmeans`` calls; fails unless every comparison is equal.
    Beside it, on the labels of the last sweep, whether ``index_add_``
    (the sums the trainer took before) and the fixed-order
    ``segment_sum`` give the same bits twice, and whether ``torch.topk``
    of the costs (the reseed's earlier selection) gives the same rows
    twice."""
    from raft_tpu_torch.cluster import kmeans_balanced as kb
    from raft_tpu_torch.util.host_sample import sample_rows as host_rows
    from raft_tpu_torch.util.segment import segment_sum
    c0 = sample[host_rows(sample.shape[0], N_LISTS, 3, sample.device)]
    ca, cb, equal_after = c0, c0, []
    for _ in range(KMEANS_ITERS):
        ca = kb._em(sample, ca, N_LISTS, 1, 0.25)
        cb = kb._em(sample, cb, N_LISTS, 1, 0.25)
        equal_after.append(bool(torch.equal(ca, cb)))
    t1 = kb.balanced_kmeans(sample, N_LISTS, KMEANS_ITERS, seed=3)
    t2 = kb.balanced_kmeans(sample, N_LISTS, KMEANS_ITERS, seed=3)
    trained_equal = bool(torch.equal(t1, t2))
    labels, d = kb._nn(sample, ca)
    lab = labels.long()
    ia = [torch.zeros((N_LISTS, D), device=sample.device).index_add_(
        0, lab, sample) for _ in range(2)]
    ss = [segment_sum(sample, lab, N_LISTS)[0] for _ in range(2)]
    tk = [torch.topk(d, N_LISTS).indices for _ in range(2)]
    phase("kmeans_tiers", check="determinism", tier="bf16x3",
          rows=sample.shape[0], n_clusters=N_LISTS, sweeps=KMEANS_ITERS,
          sweeps_equal=equal_after, trained_equal=trained_equal,
          index_add_equal=bool(torch.equal(*ia)),
          index_add_max_abs_diff=float((ia[0] - ia[1]).abs().max()),
          index_add_rows_differing=int((ia[0] != ia[1]).any(1).sum()),
          segment_sum_equal=bool(torch.equal(*ss)),
          segment_sum_max_abs_diff_vs_index_add=float(
              (ss[0] - ia[0]).abs().max()),
          topk_equal=bool(torch.equal(*tk)))
    if not (all(equal_after) and trained_equal):
        fail(f"kmeans at one seed is not reproducible: sweeps "
             f"{equal_after}, trained {trained_equal}")


class Batch(NamedTuple):
    """One 128-query batch on a served index: the queries, the cap its
    plan measured, the coarse probes and their inversion."""
    qb: torch.Tensor
    cap: int
    probes: torch.Tensor
    qmap: torch.Tensor
    inv_pos: torch.Tensor


def probe_batch(index, q, n_probes: int, name: str) -> Batch:
    from raft_tpu_torch.neighbors import _ivf_scan
    qb = q[:128].contiguous()
    cap = index.cap_cache.get((128, n_probes))
    if cap is None:
        fail(f"{name}: the 128-row plan measured no cap")
    probes = _ivf_scan.coarse_probes(qb, index.centers, n_probes)
    qmap, inv_pos = _ivf_scan._invert_probes(probes, index.n_lists, cap)
    return Batch(qb, cap, probes, qmap, inv_pos)


def scan_bound(index, b: Batch, row_bytes: int, list_bytes: int, work):
    """``bound_fn`` of a batch's scan: each probed list's real rows
    (``row_bytes`` each, ids and norms included) and its ``list_bytes``
    read once, the queries once, the output written once; the
    operations ``work(info)``, ``(count, rate)`` pairs."""
    def bound_fn(out_bytes: int):
        info = probe_stats(index.list_sizes, b.probes, b.inv_pos, b.cap)
        n_bytes = (info["rows_once"] * row_bytes
                   + info["probed_lists"] * list_bytes + b.qb.numel() * 4
                   + out_bytes)
        return bound(n_bytes, *work(info)), info
    return bound_fn


def check_scan_kernel(name, op, counter: str, kernel, plain, scale,
                      reps: int, src: str, replaces: str, bound_fn,
                      **fields):
    """Hold one scan kernel's (dists, ids) against its plain version's
    on the same batch, within ``RTOL * scale(d_p, i_p)``; time both and
    return the kernel's row. ``op.<counter>`` is left as it was found,
    so the comparison adds no launch; ``bound_fn(out_bytes)`` gives the
    bound and the batch's sizes."""
    saved = getattr(op, counter)
    d_k, i_k = kernel()
    d_p, i_p = plain()
    torch.cuda.synchronize()
    max_abs, agree = compare(name, d_k, i_k, d_p, i_p, False,
                             scale(d_p, i_p))
    out_bytes = 8 * d_k.numel()
    del d_k, i_k, d_p, i_p
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, 1, warmup=1)
    setattr(op, counter, saved)
    bnd, info = bound_fn(out_bytes)
    phase("kernels", kernel=name, nq=128, **fields, **info,
          out_bytes=out_bytes, id_agreement=agree, max_abs_err=max_abs,
          ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1])
    return kernel_row(name, src, replaces, max_abs, ms, plain_ms, bnd, None)


def check_flat_scans(index, q, tag: str = ""):
    """Kernels 3 and 4 against their plain versions at the kernels'
    arithmetic on the served IVF-Flat index, one 128-query batch at the
    plan's cap: the fused scan at k=K and the unfused list scan at
    k=FLAT_WIDE_K. f32 rows: bf16x3, the kernels summing the three bf16
    products in one accumulator in the wgmma's order, the plain versions
    as three f32 products; bf16 and int8 rows (``tag`` "bf16", "int8"):
    one product of the rows and the bf16-rounded queries, exact either
    way. ``compare``'s tolerance covers the order. Rows ``...@<tag>``;
    for f32 rows, also kernel 3's candidate rows for pass B alone."""
    from raft_tpu_torch.ops import ivf_scan as op
    b = probe_batch(index, q, N_PROBES, "flat scan")
    data = (b.qb, index.lists_data, index.lists_norms, index.lists_indices)
    scale = index.scale
    suffix = f"_{tag}" if tag else ""
    at = f"@{tag}" if tag else ""
    src = "raft_tpu_torch/csrc/ivf_flat_scan.cu"
    # a dot product per kept (query, row) pair on the tensor cores: three
    # bf16 products for f32 rows (bf16x3, the TPU kernel's), one for
    # narrow rows; each row read once with its norm and id
    passes = 1 if tag else 3
    bound_fn = scan_bound(
        index, b, D * index.lists_data.element_size() + 8, 0,
        lambda info: [(passes * 2 * info["pair_rows"] * D, BF16_FLOPS)])
    qq = (b.qb * b.qb).sum(1)
    # fused: |q|^2 plus the norm of the row found
    ids_all = index.lists_indices.reshape(-1)
    norm_by_id = torch.zeros(index.size, device=b.qb.device)
    norm_by_id[ids_all[ids_all >= 0].long()] = \
        index.lists_norms.reshape(-1)[ids_all >= 0]
    fused = check_scan_kernel(
        "ivf_flat_scan" + at, op, "launches" + suffix,
        lambda: op.fused_list_scan_cuda(*data, b.probes, b.inv_pos, b.qmap,
                                        b.cap, K, 0, False, "l2", scale),
        lambda: op.fused_list_scan_plain(*data, b.probes, b.inv_pos, b.qmap,
                                         b.cap, K, 0, False, "l2", "bf16x3",
                                         scale),
        lambda d_p, i_p: qq[:, None] + norm_by_id[i_p.clamp(min=0).long()],
        5, src, "raft_tpu/ops/pallas_ivf_scan.py:360", bound_fn, k=K,
        cap=b.cap)
    del norm_by_id
    bins, _ = op.resolve_bins(0, FLAT_WIDE_K, index.lists_indices.shape[1])
    # per (list, slot): |q|^2 of the slot's query plus the list's
    # largest row norm
    slot = (qq[b.qmap.clamp(min=0).long()]
            + index.lists_norms.max(dim=1).values[:, None])
    wide = check_scan_kernel(
        "ivf_list_scan" + at, op, "launches_list" + suffix,
        lambda: op.list_scan_cuda(*data, b.qmap, bins, "l2", torch.float32,
                                  scale),
        lambda: op.list_scan_plain(*data, b.qmap, bins, "l2", torch.float32,
                                   "bf16x3", scale),
        lambda d_p, i_p: slot[:, :, None].expand_as(d_p),
        3, src, "raft_tpu/ops/pallas_ivf_scan.py:105", bound_fn,
        k=FLAT_WIDE_K, bins=bins, cap=b.cap)
    if tag:
        return fused, wide, None
    # kernel 3's candidate rows (pass A at the fused route's bins, through
    # kernel 4's blocks) for pass B alone
    saved = op.launches_list
    fbins, _ = op.resolve_bins(0, K, index.lists_indices.shape[1])
    rows = op.candidate_rows(*op.list_scan_cuda(*data, b.qmap, fbins, "l2"),
                             b.probes, b.inv_pos, b.cap)
    op.launches_list = saved
    return fused, wide, rows


def _pq_calls(index, params, b: Batch, q_rot, route):
    """The IVF-PQ scan that ``route`` takes on batch ``b``: kernel and
    plain callables, the code norms, the bins."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import ivf_pq_scan as op
    from raft_tpu_torch.ops.ivf_scan import resolve_bins
    books, round_q = ivf_pq._lut_books(index, params.lut_dtype)
    pc = route.per_cluster
    norms = ivf_pq._ensure_code_norms(index, params, pc, "l2")
    bins, _ = resolve_bins(route.bins, route.kk, index.codes.shape[1])
    a = (q_rot, index.centers_rot, books, index.codes, norms,
         index.lists_indices)
    if route.fused:
        return (lambda: op.pq_scan_fused_cuda(
                    *a, b.probes, b.inv_pos, b.qmap, b.cap, route.kk, bins,
                    False, "l2", round_q, pc),
                lambda: op.pq_scan_fused_plain(
                    *a, b.qmap, route.kk, bins, False, "l2", round_q, pc),
                norms, bins)
    return (lambda: op.pq_scan_cuda(*a, b.qmap, bins, "l2", round_q, pc,
                                    False),
            lambda: op.pq_scan_plain(*a, b.qmap, bins, "l2", round_q, pc,
                                     False),
            norms, bins)


def _pq_blocks(index, params, b: Batch, q_rot, bins: int):
    """Kernel 8's blocks at ``bins`` (the fused route's pass A, but for
    the IP centre term)."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import ivf_pq_scan as op
    books, round_q = ivf_pq._lut_books(index, params.lut_dtype)
    norms = ivf_pq._ensure_code_norms(index, params, False, "l2")
    return op.pq_scan_cuda(q_rot, index.centers_rot, books, index.codes,
                           norms, index.lists_indices, b.qmap, bins, "l2",
                           round_q, False, False)


def _bq_calls(index, params, b: Batch, q_rot, route):
    """The IVF-BQ scan that ``route`` takes on batch ``b``: kernel and
    plain callables, the rows' norms2, the bins."""
    from raft_tpu_torch.ops import ivf_bq_scan as op
    a = (q_rot, index.centers_rot, index.bits, index.norms2, index.scales,
         index.lists_indices)
    if route.fused:
        return (lambda: op.bq_scan_fused_cuda(
                    *a, b.probes, b.inv_pos, b.qmap, b.cap, route.kk,
                    route.bins, "l2"),
                lambda: op.bq_scan_fused_plain(*a, b.qmap, route.kk,
                                               route.bins, "l2"),
                index.norms2, route.bins)
    return (lambda: op.bq_scan_cuda(*a, b.qmap, route.bins, "l2"),
            lambda: op.bq_scan_plain(*a, b.qmap, route.bins, "l2"),
            index.norms2, route.bins)


def _bq_blocks(index, params, b: Batch, q_rot, bins: int):
    """Kernel 10's blocks at ``bins``."""
    from raft_tpu_torch.ops import ivf_bq_scan as op
    return op.bq_scan_cuda(q_rot, index.centers_rot, index.bits,
                           index.norms2, index.scales, index.lists_indices,
                           b.qmap, bins, "l2")


class Family(NamedTuple):
    """A quantized family's served point and how the smoke drives its
    two scans (``raft_tpu_torch.ops.<op>``, launch keys ``<op>`` and
    ``<op>_fused``, source ``csrc/<op>.cu``)."""
    tag: str             # phase main_<tag>, profile_burst_<tag>.txt
    label: str
    module: str          # raft_tpu_torch.neighbors.<module>
    op: str
    n_lists: int
    n_probes: int
    index_params: dict   # beyond n_lists, the sweeps and keep_raw
    fields: Callable     # index -> the family's fields of its phase
    calls: Callable      # _pq_calls / _bq_calls
    blocks: Callable     # _pq_blocks / _bq_blocks: the unfused blocks
    row_bytes: Callable  # index -> bytes of one list row (code, norms, id)
    work: Callable       # (index, params, info) -> (operations, rate) pairs
    replaces: tuple      # TPU kernels: (fused, unfused)
    f32_tier: bool       # IVF-PQ: the float32 LUT tier takes the f32 body
    grow: bool = False   # build on the first rows, extend with the rest
    row_tag: str = ""    # suffix of its scan rows' names
    # its rows: "all" (scans at each tier, pass B, kernel 1 and select-k
    # at its shapes), "scans" (the two scans), "none"
    rows: str = "all"
    scan_modes: bool = False  # IVF-PQ: one search at "reconstruct", "lut"


FAMILIES = (
    Family("pq", "IVF-PQ", "ivf_pq", "ivf_pq_scan", PQ_LISTS, PQ_PROBES,
           {"pq_bits": PQ_BITS, "pq_dim": 0},
           lambda index: {"pq_dim": index.pq_dim, "pq_bits": PQ_BITS},
           _pq_calls, _pq_blocks,
           lambda index: index.pq_dim + 8,
           # bf16 and fp8 tiers (list-major): the decoded rows against
           # the bf16 queries, a multiply and an add per (scored pair,
           # row, dimension) on the tensor cores; float32 (the f32 body):
           # an f32 table per kept (query, list) pair, then a pq_dim-term
           # f32 sum per (pair, row)
           lambda index, params, info: [
               (info["pairs"] * index.pq_dim * index.pq_centers.shape[1]
                * index.pq_len * 2, FP32_FLOPS),
               (info["pair_rows"] * index.pq_dim, FP32_FLOPS)]
           if params.lut_dtype == torch.float32 else [
               (2 * info["pair_rows"] * index.rot_dim, BF16_FLOPS)],
           ("raft_tpu/ops/pallas_ivf_scan.py:499",
            "raft_tpu/ops/pallas_ivf_scan.py:851"), True),
    Family("bq", "IVF-BQ", "ivf_bq", "ivf_bq_scan", BQ_LISTS, BQ_PROBES, {},
           lambda index: {},
           _bq_calls, _bq_blocks,
           lambda index: index.words * 4 + 12,
           # the estimator's product of a +-1 tile and the bf16 query, a
           # multiply and an add per (scored pair, row, dimension): bf16
           # operands, so the tensor cores' bf16 rate
           lambda index, params, info: [
               (2 * info["pair_rows"] * D, BF16_FLOPS)],
           ("raft_tpu/ops/pallas_ivf_scan.py:428",
            "raft_tpu/ops/pallas_ivf_scan.py:737"), False),
)
# the same two points grown by extend: IVF-PQ with per-cluster books
# (phase main_pq_pc: rows "...@per_cluster" of kernels 8 and 9, and the
# "reconstruct" and "lut" scans) and IVF-BQ (phase main_bq_extend)
GROWN = (
    FAMILIES[0]._replace(
        tag="pq_pc", label="IVF-PQ per-cluster",
        index_params={"pq_bits": PQ_BITS, "pq_dim": 0,
                      "codebook_kind": 1},
        fields=lambda index: {"pq_dim": index.pq_dim, "pq_bits": PQ_BITS,
                              "codebook_kind": "PER_CLUSTER"},
        f32_tier=False, grow=True, row_tag="@per_cluster", rows="scans",
        scan_modes=True),
    FAMILIES[1]._replace(tag="bq_extend", label="IVF-BQ extended", grow=True,
                         rows="none"),
)


def check_family_scans(fam: Family, index, q, params, launches: dict,
                       f32_launches: dict):
    """Both scans of ``fam`` against their plain versions on the served
    index, one 128-query batch: the fused one at k=K (kk = 256), the
    unfused one at k=WIDE_K (kk = 512); for IVF-PQ the same two at the
    float32 LUT tier (the f32 body, rows ``...@f32``, launches from the
    ``pq_f32`` searches); then pass B alone on the fused route's candidate
    rows. ``launches``: the path's main-path counts."""
    mod = importlib.import_module(f"raft_tpu_torch.neighbors.{fam.module}")
    op = importlib.import_module(f"raft_tpu_torch.ops.{fam.op}")
    b = probe_batch(index, q, fam.n_probes, fam.op)
    q_rot = (b.qb @ index.rotation_matrix.T).contiguous()
    c_rot = index.centers_rot
    # (params, row tag, counter and launch-key suffix, launch counts)
    tiers = [(params, fam.row_tag, "", launches)]
    if fam.f32_tier:
        tiers.append((dataclasses.replace(params, lut_dtype=torch.float32),
                      "@f32", "_f32", f32_launches))
    rows = []
    for prm, tag, suffix, counts in tiers:
        bound_fn = scan_bound(index, b, fam.row_bytes(index), D * 4,
                              lambda info, prm=prm: fam.work(index, prm,
                                                             info))
        for k, key, replaces in (
                (K, fam.op + "_fused", fam.replaces[0]),
                (WIDE_K, fam.op, fam.replaces[1])):
            route = mod._Route(index, k, prm)
            kernel, plain, norms, bins = fam.calls(index, prm, b, q_rot,
                                                   route)
            if route.fused:
                # per query: the largest |qsub|^2 of its probes plus the
                # largest row norm
                rr = ((q_rot[:, None, :] - c_rot[b.probes.long()]) ** 2
                      ).sum(-1)
                sc = rr.max(dim=1).values + norms.max()
                scale = lambda d_p, i_p, sc=sc: sc[:, None].expand_as(d_p)  # noqa: E731
            else:
                # per (list, slot): |qsub|^2 of the slot's query plus the
                # list's largest row norm
                qs = q_rot[b.qmap.clamp(min=0).long()] - c_rot[:, None, :]
                sc = (qs * qs).sum(-1) + norms.max(dim=1).values[:, None]
                del qs
                scale = lambda d_p, i_p, sc=sc: sc[:, :, None].expand_as(d_p)  # noqa: E731
            counter = ("launches_fused" if route.fused else "launches") \
                + suffix
            row = check_scan_kernel(
                key + tag, op, counter, kernel, plain, scale,
                10 if route.fused else 5, f"raft_tpu_torch/csrc/{fam.op}.cu",
                replaces, bound_fn, kk=route.kk, bins=bins, cap=b.cap,
                **({"lut": str(prm.lut_dtype).replace("torch.", "")}
                   if fam.f32_tier else {}))
            row["launches"] = counts[key + suffix]
            rows.append(row)
    if fam.rows == "scans":
        return rows
    # pass B alone on the fused route's candidate rows (the unfused
    # blocks at the fused bins; L2, so no centre term)
    from raft_tpu_torch.ops.ivf_scan import candidate_rows
    route = mod._Route(index, K, params)
    bins = fam.calls(index, params, b, q_rot, route)[3]
    saved = op.launches
    cand = candidate_rows(*fam.blocks(index, params, b, q_rot, bins),
                          b.probes, b.inv_pos, b.cap)
    op.launches = saved
    rows.append(check_pass_b(f"select_k_payload@{fam.module}", *cand,
                             route.kk, launches[fam.op + "_fused"],
                             "raft_tpu/ops/pallas_ivf_scan.py:241"))
    return rows


def run_pq_f32(mod, index, q, params):
    """The float32 LUT tier through the entry point (the f32 body): one
    128-query search at k=K (the fused scan) and one at k=WIDE_K (the
    unfused scan and the merge), the counts reset just before and read
    just after."""
    from raft_tpu_torch import ops
    prm = dataclasses.replace(params, lut_dtype=torch.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for k in (K, WIDE_K):
        d, i = mod.search(index, q[:128], k, prm)
        if tuple(i.shape) != (128, k) or bool((i < 0).any()) or \
                not bool(torch.isfinite(d).all()):
            fail(f"IVF-PQ float32 tier k={k}: missing neighbours")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launched("IVF-PQ float32", launches, ("ivf_pq_scan_f32",
                                                "ivf_pq_scan_fused_f32"))
    phase("pq_f32", nq=128, k=[K, WIDE_K], seconds=time.perf_counter() - t0,
          launches={k_: v for k_, v in launches.items() if v})
    return launches


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


def profile_burst(srv, q_np, tag: str) -> None:
    """Trace one more burst (``profile_run``)."""
    profile_run(lambda: serve_burst(srv, q_np)[-1], tag,
                f"profile_burst_{tag}")


def profile_run(run, tag: str, out_name: str) -> None:
    """Trace ``run()`` (which returns its wall seconds) with
    ``torch.profiler``: device time by kernel into
    ``chiprun_out/<out_name>.txt``, and the device's busy share of the
    wall time (kernels on one stream do not overlap, so their summed self
    time is the busy time). Only the device's own records (kernels,
    copies, fills) count: an operator's row repeats its kernels' time,
    as the table's "Self CUDA time total" leaves it out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    ka = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in ka
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    with open(os.path.join(OUT_DIR, f"{out_name}.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    phase("profile", path=tag, wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
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


def counter_deltas(before: dict, after: dict, prefix: str) -> dict:
    """How far each counter series under ``prefix`` moved."""
    return {k_: after["counters"][k_] - before["counters"].get(k_, 0)
            for k_ in after["counters"] if k_.startswith(prefix)}


def serve_phase(srv, q_np, truth, n_rows: int, profile: str = "",
                close: bool = True):
    """The burst through a started server: checked results, recall@K,
    QPS and latency; the server is closed afterwards unless ``close`` is
    false."""
    from raft_tpu_torch import obs
    before = obs.snapshot()
    try:
        served_d, served, lat, wall = serve_burst(srv, q_np)
        after = obs.snapshot()
        if profile:
            profile_burst(srv, q_np, profile)
    finally:
        if close:
            srv.close()
    batches = counter_deltas(before, after, "raft.serve.batch")
    if served.shape != (N_REQUESTS, K):
        fail(f"served ids have shape {served.shape}")
    if (served < 0).any() or (served >= n_rows).any():
        fail("served ids out of range")
    if not np.isfinite(served_d).all() or (np.diff(served_d, axis=1) < 0).any():
        fail("served distances are not finite and ascending")
    hits = [len(set(served[r]) & set(truth[r % N_QUERIES]))
            for r in range(N_REQUESTS)]
    recall = float(np.mean(hits)) / K
    if recall < RECALL_FLOOR:
        fail(f"recall@{K} = {recall} < {RECALL_FLOOR}")
    p50, p99 = (float(v) * 1e3 for v in np.percentile(lat, [50, 99]))
    return dict(requests=N_REQUESTS, threads=N_THREADS, burst_s=wall,
                qps=N_REQUESTS / wall, p50_ms=p50, p99_ms=p99,
                **{f"recall_at_{K}": recall}, batches=batches)


def check_launched(path: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] <= 0:
            fail(f"the {path} path never launched the {name} kernel")


def serve_flat(index, q_np, truth, n_rows: int, profile: str):
    """``SearchServer`` over an IVF-Flat index (96 probes, k=K) and the
    burst: ``(ladder seconds, serve_phase's fields, the burst's
    launches)``."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    t0 = time.perf_counter()
    srv = SearchServer.from_index(
        index, q_np[:128], K, params=ivf_flat.SearchParams(n_probes=N_PROBES),
        config=ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                           max_wait_ms=2.0))
    ladder_s = time.perf_counter() - t0
    pre_burst = ops.launch_counts()
    served = serve_phase(srv, q_np, truth, n_rows, profile)
    after = ops.launch_counts()
    return ladder_s, served, {k_: after[k_] - pre_burst[k_] for k_ in after}


class Replay(NamedTuple):
    """A plan that returns one result it was given: a dispatch without
    its work, so a server over it times only its own path."""

    nq: int
    n_probes: int
    device: torch.device
    out: tuple

    def search(self, queries, block: bool = False):
        return self.out


def serial_ms(ladder, q_np, requests: int, rounds: int = 4) -> dict:
    """Median latency (ms) of ``requests`` 128-query requests sent one
    after another to a server over ``ladder`` with the serve_faults
    watchdog and to one without it (no batching window), the two taking
    turns in alternating order for ``rounds`` rounds."""
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    servers = {tag: SearchServer(ladder, ServeConfig(
        batch_sizes=ladder.shapes, max_wait_ms=0.0, **kw))
        for tag, kw in (("watchdog", FAULTS_GUARD), ("inline", {}))}
    lat = {tag: [] for tag in servers}
    try:
        for rnd in range(rounds):
            for tag in list(servers)[::1 if rnd % 2 == 0 else -1]:
                for r in range(requests):
                    t0 = time.perf_counter()
                    servers[tag].search(np.roll(q_np, r, axis=0)[:128],
                                        timeout=600)
                    lat[tag].append(time.perf_counter() - t0)
    finally:
        for srv in servers.values():
            srv.close()
    return {tag: float(np.median(v)) * 1e3 for tag, v in lat.items()}


def run_serve_faults(index, q_np, truth, n_rows: int, main: dict) -> None:
    """Phase 3 ``serve_faults``: the served burst through the dispatch
    watchdog (each dispatch on its helper thread), the helper's cost per
    dispatch, an injected 4 s stall retried to a direct
    ``plan.search``'s ids, and injected shard failures that exhaust the
    retries, with the request after them served."""
    from raft_tpu_torch import obs, ops
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import (PlanLadder, SearchServer, ServeConfig,
                                      ShardFailedError)
    from raft_tpu_torch.testing import faults
    ops.reset_launch_counts()
    srv = SearchServer.from_index(
        index, q_np[:128], K, params=ivf_flat.SearchParams(n_probes=N_PROBES),
        config=ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                           max_wait_ms=2.0, **FAULTS_GUARD))
    try:
        served = serve_phase(srv, q_np, truth, n_rows, close=False)
        burst = ops.launch_counts()
        check_launched("watchdog burst", burst, ("select_k", "ivf_scan"))
        # the helper's cost per dispatch: the 128-row plan with and
        # without the watchdog, and a replay of its result (the
        # dispatch path alone)
        q128 = q_np[:128]
        plan = srv.ladder.plan_for(128, 0)[1]
        serial = serial_ms(srv.ladder, q_np, SERIAL_REQUESTS)
        replay = serial_ms(PlanLadder((128,), (N_PROBES,), {(128, 0): Replay(
            128, N_PROBES, plan.device, plan.search(q128, block=True))},
            plan.dim, plan.k), q_np, 4 * SERIAL_REQUESTS)
        before = obs.snapshot()
        t0 = time.perf_counter()
        with faults.delay_execute(4000.0, max_hits=1) as rule:
            _, i_served = srv.search(q128, timeout=600)
        retried_s = time.perf_counter() - t0
        stall = counter_deltas(before, obs.snapshot(), "raft.serve.")
        want = {"raft.serve.dispatch.timeouts.total": 1,
                "raft.serve.retry.total": 1,
                "raft.serve.retry.success.total": 1}
        if rule.hits != 1 or any(stall.get(k_, 0) != v
                                 for k_, v in want.items()):
            fail(f"serve_faults: the stalled request moved {stall}, "
                 f"{rule.hits} stall(s), not one timeout and one retry")
        i_direct = plan.search(q128, block=True)[1].cpu().numpy()
        if not np.array_equal(i_served, i_direct):
            fail(f"serve_faults: the retried request's ids differ from a "
                 f"direct plan.search in {(i_served != i_direct).sum()} "
                 f"places")

        before = obs.snapshot()
        with faults.inject_fault(
                "serve.execute", error=lambda: ShardFailedError("chaos"),
                max_hits=3) as rule:
            try:
                srv.search(q_np[:1], timeout=600)
                fail("serve_faults: three shard failures were served")
            except ShardFailedError:
                pass
        d_after, i_after = srv.search(q_np[1:2], timeout=600)
        chaos = counter_deltas(before, obs.snapshot(), "raft.serve.")
        if rule.hits != 3 or \
                chaos.get("raft.serve.retry.exhausted.total", 0) != 1:
            fail(f"serve_faults: {rule.hits} injected failures moved "
                 f"{chaos}, not one exhausted retry budget")
        if i_after.shape != (1, K) or (i_after < 0).any() or \
                (i_after >= n_rows).any() or not np.isfinite(d_after).all():
            fail("serve_faults: the request after the failures was not "
                 "served")
    finally:
        srv.close()
        # the abandoned helper ends once its stalled call returns
        for th in threading.enumerate():
            if th.name == "raft-serve-watchdog":
                th.join(timeout=60)
                if th.is_alive():
                    fail("serve_faults: a dispatch helper still runs 60 s "
                         "after the server closed")
    phase("serve_faults", **FAULTS_GUARD, **served,
          main_burst={k_: main[k_] for k_ in ("qps", "p50_ms", "p99_ms")},
          serial_requests=4 * SERIAL_REQUESTS, serial_median_ms=serial,
          replay_requests=16 * SERIAL_REQUESTS, replay_median_ms=replay,
          helper_ms_per_dispatch=replay["watchdog"] - replay["inline"],
          helper_ms_per_plan_dispatch=serial["watchdog"] - serial["inline"],
          burst_launches=burst, stalled_request_s=retried_s,
          stalled_ids_equal_direct=True, stall_counters=stall,
          chaos_counters=chaos)


def run_flat(x, q, q_np, truth, args):
    """Phase 3: IVF-Flat build + serving; the fused scan checked against
    its plain version on the served index afterwards."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors import ivf_flat
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = ivf_flat.build(x, ivf_flat.IndexParams(
        n_lists=N_LISTS, kmeans_n_iters=KMEANS_ITERS))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = ops.launch_counts()
    build_shapes = l2nn_shapes()
    ladder_s, served, burst = serve_flat(index, q_np, truth, x.shape[0],
                                         "flat" if args.profile else "")
    launches = ops.launch_counts()
    check_launched("IVF-Flat", launches, ("fused_l2_nn", "select_k",
                                          "ivf_scan"))
    phase("main", n=x.shape[0], dim=D, n_lists=N_LISTS, max_list=
          int(index.lists_data.shape[1]), build_s=build_s, ladder_s=ladder_s,
          **served, build_launches=build_launches,
          build_fused_l2_nn_shapes=build_shapes, burst_launches=burst,
          launches=launches,
          mem_allocated_gb=torch.cuda.memory_allocated() / 1e9,
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    run_serve_faults(index, q_np, truth, x.shape[0], served)
    wide_launches = run_wide_flat(index, q, truth)
    row, wide_row, rows = check_flat_scans(index, q)
    pass_b = check_pass_b("select_k_payload@ivf_flat", *rows, K,
                          launches["ivf_scan"],
                          "raft_tpu/ops/pallas_ivf_scan.py:241")
    del index, rows
    free_phase("flat")
    return [row, pass_b], launches, [wide_row], wide_launches


def run_flat_narrow(x, q, q_np, truth, args, storage: str):
    """Phases 3b, 3c: IVF-Flat at ``storage`` (bfloat16: built on every
    row; int8: built on the first rows, then ``extend``-ed with the last
    1/EXTEND_SHARE, ids continuing), served as phase 3, then its k=512
    search; both scans against their plain versions afterwards. Returns
    the rows, each with its kernel's launches over this path's run."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors import ivf_flat
    tag = FLAT_STORAGES[storage]
    n = x.shape[0]
    params = ivf_flat.IndexParams(n_lists=N_LISTS,
                                  kmeans_n_iters=KMEANS_ITERS,
                                  storage_dtype=storage)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grown = {}
    if storage == "int8":
        n0 = n - n // EXTEND_SHARE
        index = ivf_flat.build(x[:n0], params)
        torch.cuda.synchronize()
        scale0, t1 = index.scale, time.perf_counter()
        index = ivf_flat.extend(index, x[n0:])
        torch.cuda.synchronize()
        ids = index.lists_indices[index.lists_indices >= 0]
        if ids.numel() != n or int(ids.min()) != 0 or int(ids.max()) != n - 1:
            fail(f"IVF-Flat int8 extend: {ids.numel()} ids, not 0..{n - 1}")
        grown = dict(built_rows=n0, extended_rows=n - n0, extend_s=
                     time.perf_counter() - t1, scale_before=scale0,
                     scale_after=index.scale)
        del ids
    else:
        index = ivf_flat.build(x, params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if index.lists_data.dtype != getattr(torch, storage) or index.size != n:
        fail(f"IVF-Flat {storage}: lists of {index.lists_data.dtype}, "
             f"size {index.size}")
    build_launches = ops.launch_counts()
    ladder_s, served, burst = serve_flat(index, q_np, truth, n,
                                         f"flat_{tag}" if args.profile
                                         else "")
    launches = ops.launch_counts()
    check_launched(f"IVF-Flat {storage}", launches,
                   ("fused_l2_nn", "select_k", f"ivf_scan_{tag}"))
    if launches["ivf_scan"] or launches["ivf_list_scan"]:
        fail(f"IVF-Flat {storage}: the f32 row policy was launched")
    phase(f"main_flat_{tag}", n=n, dim=D, n_lists=N_LISTS,
          storage_dtype=storage, scale=index.scale, **grown,
          max_list=int(index.lists_data.shape[1]), build_s=build_s,
          ladder_s=ladder_s, **served, build_launches=build_launches,
          burst_launches=burst, launches=launches,
          index_gb=(index.lists_data.numel()
                    * index.lists_data.element_size()) / 1e9,
          mem_allocated_gb=torch.cuda.memory_allocated() / 1e9,
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    wide_launches = run_wide_flat(index, q, truth, tag)
    fused, wide, _ = check_flat_scans(index, q, tag)
    fused["launches"] = launches[f"ivf_scan_{tag}"]
    wide["launches"] = wide_launches[f"ivf_list_scan_{tag}"]
    del index
    free_phase(f"flat_{tag}")
    return [fused, wide]


def run_wide_flat(index, q, truth, tag: str = ""):
    """The k > 256 route: one list-major search of 128 queries at
    k=FLAT_WIDE_K through the unfused list scan (at the storage ``tag``
    names, "" for f32) and the merge."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors import ivf_flat
    params = ivf_flat.SearchParams(n_probes=N_PROBES, scan_order="list")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    d_w, i_w = ivf_flat.search(index, q[:128], FLAT_WIDE_K, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_launched("wide IVF-Flat", launches,
                   ("select_k", "ivf_list_scan" + (f"_{tag}" if tag else "")))
    i_w = i_w.cpu().numpy()
    if i_w.shape != (128, FLAT_WIDE_K) or (i_w < 0).any() or \
            not bool(torch.isfinite(d_w).all()) or \
            bool((torch.diff(d_w, dim=1) < 0).any()):
        fail("the k=512 IVF-Flat search returned missing or unsorted "
             "neighbours")
    recall = float(np.mean([len(set(i_w[r][:K]) & set(truth[r]))
                            for r in range(128)])) / K
    if recall < RECALL_FLOOR:
        fail(f"wide IVF-Flat recall@{K} of the top {K} = {recall}")
    phase("wide_flat", storage=tag or "f32", nq=128, k=FLAT_WIDE_K,
          n_probes=N_PROBES, order="list", search_s=wall,
          **{f"recall_at_{K}_of_top_{K}": recall}, launches=launches,
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def free_phase(path: str) -> None:
    """After the caller's ``del`` of an index: device memory then and
    after a collection pass (what the pass frees, reference cycles
    held)."""
    after_del = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    phase("free", path=path, allocated_gb_after_del=after_del / 1e9,
          allocated_gb_after_gc=torch.cuda.memory_allocated() / 1e9)


def run_family(fam: Family, x, q, q_np, truth, args, beside=None):
    """Phases 4 and 5, and their grown forms: ``fam``'s build (for a
    ``grow`` point on the first 1 - 1/EXTEND_SHARE of the rows, then
    ``extend`` with the rest) + serving + one k=WIDE_K search; the scans
    named by ``fam.rows``, and the path's k-means and coarse shapes,
    checked against their plain versions on the served index; then the
    index is dropped. ``beside``: fields printed with the phase (the
    point's recall before it grew). Returns (rows, launches, the served
    recall)."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    mod = importlib.import_module(f"raft_tpu_torch.neighbors.{fam.module}")
    params = mod.SearchParams(n_probes=fam.n_probes, rescore_factor=RESCORE,
                              rescore_on_device="always")
    index_params = mod.IndexParams(
        n_lists=fam.n_lists, kmeans_n_iters=KMEANS_ITERS, keep_raw=True,
        **fam.index_params)
    n = x.shape[0]
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grown = {}
    if fam.grow:
        n0 = n - n // EXTEND_SHARE
        index = mod.build(x[:n0], index_params)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        built = ops.launch_counts()
        index = mod.extend(index, x[n0:])
        torch.cuda.synchronize()
        after = ops.launch_counts()
        ids = index.lists_indices[index.lists_indices >= 0]
        if ids.numel() != n or int(ids.min()) != 0 or int(ids.max()) != n - 1 \
                or index.size != n or index.raw.shape[0] != n:
            fail(f"{fam.label} extend: {ids.numel()} ids, not 0..{n - 1}")
        grown = dict(built_rows=n0, extended_rows=n - n0,
                     build_only_s=t1 - t0, extend_s=time.perf_counter() - t1,
                     extend_launches={k_: after[k_] - built[k_]
                                      for k_ in after if after[k_] - built[k_]})
        del ids
    else:
        index = mod.build(x, index_params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = ops.launch_counts()
    build_shapes = l2nn_shapes()
    t0 = time.perf_counter()
    srv = SearchServer.from_index(
        index, q_np[:128], K, params=params,
        config=ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                           max_wait_ms=2.0))
    ladder_s = time.perf_counter() - t0
    pre_burst = ops.launch_counts()
    served = serve_phase(srv, q_np, truth, n, fam.tag if args.profile else "")
    pre_wide = ops.launch_counts()
    d_w, i_w = mod.search(index, q[:128], WIDE_K, params)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    fused = fam.op + "_fused"
    check_launched(fam.label, launches, ("fused_l2_nn", "select_k", fam.op,
                                         fused))
    n_batches = sum(v for k_, v in served["batches"].items()
                    if k_.startswith("raft.serve.batch.total"))
    if pre_wide[fused] - pre_burst[fused] < n_batches:
        fail(f"{fam.label}: {pre_wide[fused] - pre_burst[fused]} fused-scan "
             f"launches for {n_batches} served batches")
    i_w = i_w.cpu().numpy()
    if i_w.shape != (128, WIDE_K) or (i_w < 0).any() or \
            not bool(torch.isfinite(d_w).all()):
        fail(f"the k={WIDE_K} {fam.label} search returned missing neighbours")
    wide_recall = float(np.mean([len(set(i_w[r][:K]) & set(truth[r]))
                                 for r in range(128)])) / K
    if wide_recall < RECALL_FLOOR:
        fail(f"the k={WIDE_K} {fam.label} search: recall@{K} of the top "
             f"{K} = {wide_recall}")
    phase(f"main_{fam.tag}", n=n, dim=D, n_lists=fam.n_lists,
          **fam.fields(index), n_probes=fam.n_probes, rescore_factor=RESCORE,
          **grown, max_list=int(index.lists_indices.shape[1]),
          build_s=build_s, ladder_s=ladder_s, **served, **(beside or {}),
          served_batches=n_batches,
          wide_k=WIDE_K, **{f"wide_recall_at_{K}_of_top_{K}": wide_recall},
          build_launches=build_launches,
          build_fused_l2_nn_shapes=build_shapes,
          burst_launches={k_: pre_wide[k_] - pre_burst[k_] for k_ in launches},
          wide_launches={k_: launches[k_] - pre_wide[k_] for k_ in launches},
          launches=launches,
          mem_allocated_gb=torch.cuda.memory_allocated() / 1e9,
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    f32_launches = run_pq_f32(mod, index, q, params) if fam.f32_tier else {}
    if fam.scan_modes:
        run_scan_modes(mod, index, q, truth, params, args.profile)
    centers = index.centers.contiguous()
    rows = (check_family_scans(fam, index, q, params, launches, f32_launches)
            if fam.rows != "none" else [])
    if fam.rows == "all" and fam.n_lists != N_LISTS:
        # fused L2-NN at this path's shapes: the sampled rows (the sweeps)
        # and every row (the build's predict) against its n_lists centres
        rows.append(check_fused_l2_nn(sample_rows(x, KM_ROWS, 13), centers,
                                      f"fused_l2_nn@{fam.module}"))
        rows.append(check_fused_l2_nn(x, centers,
                                      f"fused_l2_nn@{fam.module}_predict"))
    if fam.rows == "all":
        # select-k at this path's coarse shape: n_probes of n_lists scores
        rows.append(check_select_k(q, centers, fam.n_probes,
                                   f"select_k@{fam.module}"))
    del index, srv, centers
    free_phase(fam.tag)
    return rows, launches, served[f"recall_at_{K}"]


def run_scan_modes(mod, index, q, truth, params, profile: bool):
    """IVF-PQ's torch-op scans through the entry point: one 128-query
    search at ``scan_mode="reconstruct"`` (list-major, the first call
    filling the bf16 decode cache) and one at ``"lut"``, each at k=K with
    the served point's re-rank; recall@K, the first and a second call's
    seconds, the cache's device memory and the launches. ``profile``:
    trace a third reconstruct search (``profile_pq_reconstruct.txt``)."""
    from raft_tpu_torch import ops
    for mode in ("reconstruct", "lut"):
        prm = dataclasses.replace(params, scan_mode=mode,
                                  scan_order="list")
        mem0 = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        d, i = mod.search(index, q[:128], K, prm)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        cache_b = (index.decoded.numel() * index.decoded.element_size()
                   if index.decoded is not None else 0)
        t0 = time.perf_counter()
        mod.search(index, q[:128], K, prm)
        torch.cuda.synchronize()
        again_s = time.perf_counter() - t0
        if profile and mode == "reconstruct":
            def wall_s():
                t0 = time.perf_counter()
                mod.search(index, q[:128], K, prm)
                torch.cuda.synchronize()
                return time.perf_counter() - t0
            profile_run(wall_s, "pq_reconstruct", "profile_pq_reconstruct")
        i = i.cpu().numpy()
        if i.shape != (128, K) or (i < 0).any() or \
                not bool(torch.isfinite(d).all()):
            fail(f"IVF-PQ {mode}: missing neighbours")
        recall = float(np.mean([len(set(i[r]) & set(truth[r]))
                                for r in range(128)])) / K
        if recall < RECALL_FLOOR:
            fail(f"IVF-PQ {mode}: recall@{K} = {recall} < {RECALL_FLOOR}")
        phase("pq_scan_modes", mode=mode, nq=128, k=K,
              n_probes=params.n_probes, rescore_factor=RESCORE,
              order="list" if mode == "reconstruct" else "probe",
              **{f"recall_at_{K}": recall}, first_s=first_s, again_s=again_s,
              again_ms_per_query=again_s * 1e3 / 128,
              decode_cache_gb=cache_b / 1e9,
              mem_added_gb=(torch.cuda.memory_allocated() - mem0) / 1e9,
              launches={k_: v for k_, v in launches.items() if v})
    index.decoded = index.decoded_norms = None


def run_two_level(x):
    """Phase 5d: ``build_hierarchical`` at TWO_LEVEL_LISTS centres over
    the dataset (the two-level path: isqrt(k) mesoclusters, fine centres
    in each, two balancing sweeps over all), then the predict of every
    row; seconds, kernel 1's launches by shape, list sizes and the mean
    squared distance to the assigned centre."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.cluster.kmeans_balanced import build_hierarchical
    from raft_tpu_torch.distance import fused_l2_nn
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    centers = build_hierarchical(x, TWO_LEVEL_LISTS, KMEANS_ITERS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_shapes = l2nn_shapes()
    launches = ops.launch_counts()
    check_launched("two-level k-means", launches, ("fused_l2_nn",))
    if tuple(centers.shape) != (TWO_LEVEL_LISTS, D) or \
            not bool(torch.isfinite(centers).all()):
        fail(f"two-level k-means: centres of shape {tuple(centers.shape)}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    kv = fused_l2_nn(x, centers)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    sizes = torch.bincount(kv.key.long(), minlength=TWO_LEVEL_LISTS)
    phase("kmeans_two_level", n=x.shape[0], dim=D,
          n_clusters=TWO_LEVEL_LISTS, sweeps=KMEANS_ITERS, train_s=train_s,
          predict_s=predict_s, fused_l2_nn_shapes=train_shapes,
          distinct_shapes=len(train_shapes),
          predict_fused_l2_nn_shapes=l2nn_shapes(),
          list_size_max=int(sizes.max()),
          list_size_mean=float(sizes.float().mean()),
          empty_lists=int((sizes == 0).sum()),
          mean_sq_dist=float(kv.value.double().mean()),
          launches={k_: v for k_, v in launches.items() if v},
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del centers, kv, sizes


def cuda_once(fn):
    """``(fn(), device milliseconds of that one call)``."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def recall_at(ids: torch.Tensor, truth: torch.Tensor) -> float:
    """Mean share of each row's ``truth`` ids that ``ids`` holds."""
    ids, truth = ids.cpu().numpy(), truth.cpu().numpy()
    return float(np.mean([len(set(a) & set(b))
                          for a, b in zip(ids, truth)])) / truth.shape[1]


def check_knn_result(what: str, d, i, n: int, descending: bool) -> None:
    """(BF_QUERIES, K) neighbours, ids in range, finite sorted values."""
    if tuple(i.shape) != (d.shape[0], K) or bool((i < 0).any()) \
            or bool((i >= n).any()) or not bool(torch.isfinite(d).all()):
        fail(f"{what}: missing, out-of-range or non-finite neighbours")
    step = torch.diff(d, dim=1)
    if bool(((step > 0) if descending else (step < 0)).any()):
        fail(f"{what}: neighbours are not sorted")


def check_fused_knn(name, xq, y, metric, replaces, launches, precision,
                    src="raft_tpu_torch/csrc/fused_knn.cu", bound_as=None):
    """The fused k-NN kernel (both passes) at ``precision`` against its
    plain version at the same arithmetic on the main path's inputs, within
    ``RTOL`` of |x|^2 + |y|^2; the plain version is timed on its one
    call. The bound counts the products at ``bound_as`` (default
    ``precision``)."""
    from raft_tpu_torch.ops import fused_knn as op
    m, dim = xq.shape
    n = y.shape[0]
    _, tn, l_bins, kt = op.geometry(m, n, dim, K)
    saved = (op.launches, op.launches_f32, op.launches_ktiled,
             op.launches_ktiled_f32)
    kernel = lambda: op.fused_knn_cuda(xq, y, K, metric, False, tn,  # noqa: E731
                                       l_bins, kt, precision)
    d_k, i_k = kernel()
    (d_p, i_p), plain_ms = cuda_once(lambda: op.fused_knn_plain(
        xq, y, K, metric, False, tn, l_bins, kt, precision))
    scale = (xq * xq).sum(1)[:, None] + (y * y).sum(1)[i_p.clamp(min=0).long()]
    max_abs, agree = compare(name, d_k, i_k, d_p, i_p, False, scale)
    del d_k, i_k, d_p, i_p
    ms = cuda_ms(kernel, BF_REPS, warmup=1)
    (op.launches, op.launches_f32, op.launches_ktiled,
     op.launches_ktiled_f32) = saved
    # the products at the arithmetic asked for: bf16x3 (the TPU kernel's)
    # three bf16 passes on the tensor cores, f32 one pass on the CUDA cores
    ops = 2 * m * n * dim
    bnd = bound(4 * (m + n) * dim + 8 * m * K,
                {"bf16x3": (3 * ops, BF16_FLOPS), "bf16": (ops, BF16_FLOPS),
                 "f32": (ops, FP32_FLOPS)}[bound_as or precision])
    phase("kernels", kernel=name, shape=[m, n, dim], k=K, tn=tn,
          l_bins=l_bins, kt=kt, precision=precision, id_agreement=agree,
          max_abs_err=max_abs,
          ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
          f32_cuda_core_ms=2 * m * n * dim / FP32_FLOPS * 1e3)
    row = kernel_row(name, src, replaces, max_abs, ms, plain_ms, bnd, None)
    row["launches"] = launches
    return row


def run_bf(x, qb, args):
    """Phase 6: fused brute-force k-NN of BF_QUERIES queries over the
    dataset for three metrics at the card's default precision (bf16x3 on
    the tensor cores), and L2 at ``"highest"`` (kernel 5's f32 body), each
    against the exact scan, and kernel 5 against its plain version at the
    same arithmetic on each run's kernel inputs."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    from raft_tpu_torch.neighbors.processing import preprocess_rows
    m, n = qb.shape[0], x.shape[0]
    rows = []
    exact_l2 = None
    for metric, kmetric, label, prec in (
            (DistanceType.L2Expanded, "l2", "l2", None),
            (DistanceType.InnerProduct, "ip", "ip", None),
            (DistanceType.CosineExpanded, "ip", "cosine", None),
            (DistanceType.L2Expanded, "l2", "highest", "highest")):
        def fused(metric=metric, prec=prec):
            return brute_force_knn(x, qb, K, metric, mode="fused",
                                   kernel_precision=prec)
        key = "fused_knn_f32" if prec == "highest" else "fused_knn"
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        d_f, i_f = fused()
        ms = cuda_ms(fused, BF_REPS, warmup=0)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_launched(f"brute force {label}", launches, (key,))
        check_knn_result(f"fused {label}", d_f, i_f, n, label == "ip")
        exact_ms = None
        if exact_l2 is not None and kmetric == "l2":
            i_e = exact_l2  # the same function: L2's exact scan
        else:
            (d_e, i_e), exact_ms = cuda_once(
                lambda: brute_force_knn(x, qb, K, metric, mode="exact"))
            check_knn_result(f"exact {label}", d_e, i_e, n, label == "ip")
            del d_e
            if kmetric == "l2":
                exact_l2 = i_e
        recall = recall_at(i_f, i_e)
        floor = BF_RECALL_GATE if kmetric == "l2" else RECALL_FLOOR
        if recall < floor:
            fail(f"fused {label}: recall@{K} {recall} < {floor}")
        phase("main_bf", metric=label, precision=prec or "bf16x3", n=n,
              dim=D, nq=m, k=K, ms=ms, qps=m / (ms / 1e3),
              **{f"recall_at_{K}": recall}, exact_ms=exact_ms,
              exact_qps=m / (exact_ms / 1e3) if exact_ms else None,
              mem_peak_gb=peak / 1e9, launches=launches)
        if args.profile and label == "l2":
            def wall_s(fused=fused):
                t0 = time.perf_counter()
                fused()
                torch.cuda.synchronize()
                return time.perf_counter() - t0
            profile_run(wall_s, "bf", "profile_bf")
        del d_f, i_f, i_e
        if label == "cosine":
            xq, y = preprocess_rows(qb, metric), preprocess_rows(x, metric)
        else:
            xq, y = qb, x
        rows.append(check_fused_knn(
            "fused_knn" if label == "l2" else f"fused_knn@{label}", xq, y,
            kmetric, "raft_tpu/ops/pallas_fused_knn.py:100", launches[key],
            "f32" if prec == "highest" else "bf16x3",
            "raft_tpu_torch/csrc/fused_knn.cu" if prec == "highest"
            else "raft_tpu_torch/csrc/fused_knn_tc.cu"))
        if label == "l2":
            # pass B alone on kernel 5's candidate rows (pass A's plain
            # version at the kernel's bf16x3, the same bins)
            from raft_tpu_torch.ops import fused_knn as kop
            _, tn, l_bins, kt = kop.geometry(m, n, D, K)
            cand = kop.bin_candidates_plain(qb, x, "l2", tn, l_bins, kt,
                                            "bf16x3")
            rows.append(check_pass_b("select_k_payload@bf", *cand, K,
                                     launches[key],
                                     "raft_tpu/ops/pallas_fused_knn.py:100"))
            del cand
        del xq, y
    return rows


def run_wide_bf(seed: int, dev):
    """Phase 7: the d > 4096 route (kernel 6) on WIDE_N x WIDE_D normal
    rows, BF_QUERIES queries, at the card's default bf16x3 (the
    tensor-core pass A) and at ``"highest"`` (its f32 body), each against
    the exact scan (recall gate BF_RECALL_GATE) and its plain version at
    the same arithmetic."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    y = torch.randn((WIDE_N, WIDE_D), generator=g, device=dev)
    qw = torch.randn((BF_QUERIES, WIDE_D), generator=g, device=dev)
    (_, i_e), exact_ms = cuda_once(lambda: brute_force_knn(
        y, qw, K, DistanceType.L2Expanded, mode="exact"))
    rows = []
    for prec, key, tag, src in (
            (None, "fused_knn_ktiled", "", "fused_knn_tc.cu"),
            ("highest", "fused_knn_ktiled_f32", "@highest", "fused_knn.cu")):
        def fused(prec=prec):
            return brute_force_knn(y, qw, K, DistanceType.L2Expanded,
                                   mode="fused", kernel_precision=prec)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        d_f, i_f = fused()
        ms = cuda_ms(fused, BF_REPS, warmup=0)
        launches = ops.launch_counts()
        check_launched(f"wide brute force{tag}", launches, (key,))
        check_knn_result(f"wide fused{tag}", d_f, i_f, WIDE_N, False)
        recall = recall_at(i_f, i_e)
        if recall < BF_RECALL_GATE:
            fail(f"wide fused{tag}: recall@{K} {recall} < {BF_RECALL_GATE}")
        precision = "f32" if prec else "bf16x3"
        phase("wide_bf", precision=prec or "bf16x3", n=WIDE_N, dim=WIDE_D,
              nq=BF_QUERIES, k=K, ms=ms, qps=BF_QUERIES / (ms / 1e3),
              **{f"recall_at_{K}": recall}, exact_ms=exact_ms,
              launches={k_: v for k_, v in launches.items() if v},
              mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del d_f, i_f
        rows.append(check_fused_knn(
            "fused_knn_ktiled" + tag, qw, y, "l2",
            "raft_tpu/ops/pallas_fused_knn.py:121", launches[key], precision,
            "raft_tpu_torch/csrc/" + src))
    return rows


def pair_row(name, tag, sqrt, p_lib, xa, ya, p: float = 3.0):
    """One ``elementwise_dist@<name>`` row: ``pairwise_distance`` of the
    metric ``tag`` names at exponent ``p`` (launches counted), the kernel
    against its plain version (hamming exactly) and, where ``p_lib`` is
    not None, one ``torch.cdist`` call as the library time."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.distance import pairwise_distance
    from raft_tpu_torch.ops import elementwise_dist as op
    metric = PAIR_ENTRY.get(name, name)
    m, dim = xa.shape
    n = ya.shape[0]

    def entry():
        return pairwise_distance(xa, ya, metric, p=p)

    def kernel():
        return op.elementwise_dist_cuda(xa, ya, tag, p, sqrt)
    ops.reset_launch_counts()
    out = entry()
    entry_ms = cuda_ms(entry, 3, warmup=0)
    launches = ops.launch_counts()["elementwise_dist"]
    if launches < 4:
        fail(f"pairwise {name}: {launches} elementwise_dist launches")
    saved = op.launches
    d_k = kernel()
    d_p, plain_ms = cuda_once(lambda: op.elementwise_dist_plain(
        xa, ya, tag, p, sqrt))
    fin = torch.isfinite(d_p)
    err = torch.where(fin, d_k - d_p, torch.zeros_like(d_k)).abs()
    max_abs = float(err.max())
    exact = name == "hamming" or p == 0.0
    if not torch.equal(torch.isfinite(d_k), fin) or not torch.equal(out, d_k) \
            or (exact and not torch.equal(d_k, d_p)) \
            or bool((err > ELT_ATOL + ELT_RTOL * d_p.abs()).any()):
        fail(f"pairwise {name}: kernel differs from its plain version "
             f"by up to {max_abs}")
    del out, d_p, err, fin
    ms = cuda_ms(kernel, 5)
    op.launches = saved
    lib_ms = lib_err = None
    if p_lib is not None:
        def lib():
            return torch.cdist(xa, ya, p=p_lib,
                               compute_mode="donot_use_mm_for_euclid_dist")
        d_l = lib()
        if p_lib == 0.0:  # the count, timed alone; hamming divides
            d_l = d_l / dim
        lib_err = float((d_l - d_k).abs().max())
        del d_l
        lib_ms = cuda_ms(lib, 5)
    del d_k
    fp, sfu = ELT_WORK[tag]
    elems = m * n * dim
    bnd = bound(4 * (m + n) * dim + 4 * m * n, (fp * elems, FP32_INSTR),
                (sfu * elems, SFU_OPS))
    phase("pairwise", metric=name, core=tag, sqrt=sqrt, p=p,
          shape=[m, n, dim], entry_ms=entry_ms, ms=ms,
          plain_ms=plain_ms, library_ms=lib_ms,
          library_max_abs_err=lib_err, max_abs_err=max_abs,
          bound_ms=bnd[0], bound_by=bnd[1], launches=launches)
    row = kernel_row(f"elementwise_dist@{name}",
                     "raft_tpu_torch/csrc/elementwise_dist.cu",
                     "raft_tpu/ops/pallas_elementwise_dist.py:49",
                     max_abs, ms, plain_ms, bnd, lib_ms)
    row["launches"] = launches
    return row


def run_pairwise(x1m, q100, seed: int, dev):
    """Phase 8: every elementwise metric name through ``pairwise_distance``
    at PAIR_N x PAIR_N x PAIR_D (kernel 7), each against its plain version
    and, where one computes the same function, ``torch.cdist``; canberra
    on data whose |a| + |b| lies in (2^126, 2^128) and minkowski at p = 0
    (rows ``@canberra_big``, ``@minkowski_p0``); the expanded metrics'
    times; one exact L1 scan through kernel 7."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    a = torch.rand((PAIR_N, PAIR_D), generator=g, device=dev)
    b = torch.rand((PAIR_N, PAIR_D), generator=g, device=dev)
    ai, bi = torch.floor(a * 4), torch.floor(b * 4)  # {0, 1, 2, 3}
    rows = []
    for name, (tag, sqrt, p_lib) in PAIR_NAMES.items():
        xa, ya = (ai, bi) if name == "hamming" else (a, b)
        rows.append(pair_row(name, tag, sqrt, p_lib, xa, ya))
    # |a|, |b| in [2^125, 2^126) with random signs: |a| + |b| in
    # [2^126, 2^127), where a lone __fdividef would return 0
    sign = torch.where(b < 0.5, -1.0, 1.0)
    big_a, big_b = (1.0 + a) * 2.0 ** 125 * sign, (1.0 + b) * 2.0 ** 125
    rows.append(pair_row("canberra_big", "canberra", False, None, big_a,
                         big_b))
    del big_a, big_b, sign
    rows.append(pair_row("minkowski_p0", "minkowski", False, None, a, b,
                         p=0.0))
    expanded = {name: cuda_ms(lambda name=name: pairwise_distance(a, b, name),
                              3) for name in PAIR_EXPANDED}
    # kernel 7 inside the exact scan: L1 k-NN of 100 queries over 1M rows
    ops.reset_launch_counts()
    (d1, i1), l1_ms = cuda_once(lambda: brute_force_knn(
        x1m, q100, K, DistanceType.L1))
    launches = ops.launch_counts()
    check_launched("exact L1 scan", launches, ("elementwise_dist",))
    d_ref, i_ref = torch.topk(torch.cdist(q100, x1m, p=1.0), K, dim=1,
                              largest=False)
    agree = float((i1.long() == i_ref).double().mean())
    if agree < MIN_ID_AGREEMENT or bool(
            ((d1 - d_ref).abs() > ELT_ATOL + ELT_RTOL * d_ref).any()):
        fail(f"exact L1 scan: ids agree on {agree} with torch.cdist + topk")
    phase("pairwise", expanded_ms=expanded, l1_scan={
        "n": x1m.shape[0], "nq": q100.shape[0], "k": K, "ms": l1_ms,
        "id_agreement_vs_cdist": agree, "launches": launches})
    return rows


def elt_row(name, tag, xa, ya, launches, p_lib=None):
    """Kernel 7 at one path's shape, ``(xa, ya)`` under core ``tag``,
    against its plain version (``ELT_ATOL + ELT_RTOL * |plain|``), with
    ``torch.cdist`` at ``p_lib`` as the library time where it computes
    the same function; ``launches`` are the path's."""
    from raft_tpu_torch.ops import elementwise_dist as op
    m, dim = xa.shape
    n = ya.shape[0]
    saved = op.launches
    kernel = lambda: op.elementwise_dist_cuda(xa, ya, tag)  # noqa: E731
    d_k = kernel()
    d_p, plain_ms = cuda_once(lambda: op.elementwise_dist_plain(xa, ya,
                                                                tag))
    err = (d_k - d_p).abs()
    max_abs = float(err.max())
    if bool((err > ELT_ATOL + ELT_RTOL * d_p.abs()).any()):
        fail(f"{name}: kernel differs from its plain version by up to "
             f"{max_abs}")
    del d_k, d_p, err
    ms = cuda_ms(kernel, 3)
    op.launches = saved
    lib_ms = None
    if p_lib is not None:
        lib_ms = cuda_ms(lambda: torch.cdist(
            xa, ya, p=p_lib, compute_mode="donot_use_mm_for_euclid_dist"), 3)
    fp, sfu = ELT_WORK[tag]
    elems = m * n * dim
    bnd = bound(4 * (m + n) * dim + 4 * m * n, (fp * elems, FP32_INSTR),
                (sfu * elems, SFU_OPS))
    phase("kernels", kernel=name, core=tag, shape=[m, n, dim],
          max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          bound_ms=bnd[0], bound_by=bnd[1], launches=launches)
    row = kernel_row(name, "raft_tpu_torch/csrc/elementwise_dist.cu",
                     "raft_tpu/ops/pallas_elementwise_dist.py:49",
                     max_abs, ms, plain_ms, bnd, lib_ms)
    row["launches"] = launches
    return row


def run_kmeans_fit(xk):
    """Phase 9a: ``kmeans.fit`` at KM_FIT_CLUSTERS centres, Random then
    k-means++ init; each fit's seconds, iterations, inertia and kernel
    1's launches by shape; a second fit at one seed bit for bit; the
    inertia against ``cluster_cost`` of the centres. Returns the Random
    fit's centres, the kernel 1 row and the launches of both fits."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
    total, kept = 0, None
    for init in (InitMethod.Random, InitMethod.KMeansPlusPlus):
        params = KMeansParams(n_clusters=KM_FIT_CLUSTERS, init=init,
                              max_iter=KM_FIT_ITERS, seed=7, n_init=1)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        centers, inertia, n_iter = kmeans.fit(xk, params)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        shapes = l2nn_shapes()
        launches = ops.launch_counts()
        check_launched(f"kmeans.fit {init.name}", launches, ("fused_l2_nn",))
        total += launches["fused_l2_nn"]
        again = kmeans.fit(xk, params)
        repeat = bool(torch.equal(again[0], centers)
                      and torch.equal(again[1], inertia))
        cost = float(kmeans.cluster_cost(xk, centers))
        rel = abs(float(inertia) - cost) / cost
        phase("cluster", part="kmeans.fit", init=init.name,
              rows=xk.shape[0], n_clusters=KM_FIT_CLUSTERS,
              max_iter=KM_FIT_ITERS, seconds=fit_s, n_iter=n_iter,
              inertia=float(inertia), cluster_cost=cost,
              inertia_vs_cost_rel=rel, repeat_bit_identical=repeat,
              fused_l2_nn_shapes=shapes,
              launches={k_: v for k_, v in launches.items() if v})
        if not repeat:
            fail(f"kmeans.fit {init.name}: two fits at one seed differ")
        if rel > 1e-3 or not bool(torch.isfinite(centers).all()):
            fail(f"kmeans.fit {init.name}: inertia {float(inertia)} vs "
                 f"cluster_cost {cost}")
        if kept is None:
            kept = centers
    row = check_fused_l2_nn(xk, kept, "fused_l2_nn@kmeans")
    row["launches"] = total
    return kept, row


def run_single_linkage(x):
    """Phase 9b: ``single_linkage`` over the kNN graph of SL_ROWS rows
    (its parts' seconds and the components before each connectivity
    round; a valid dendrogram: n - 1 merges of rising height ending at
    size n, SL_CLUSTERS labels), then PAIRWISE on SL_PAIR_ROWS rows
    against ``scipy.cluster.hierarchy.linkage(method="single")``."""
    import importlib
    from scipy.cluster.hierarchy import cut_tree, linkage
    from raft_tpu_torch import ops
    from raft_tpu_torch.cluster import LinkageDistance, single_linkage
    sl = importlib.import_module("raft_tpu_torch.cluster.single_linkage")
    for route, n in (("KNN_GRAPH", SL_ROWS), ("PAIRWISE", SL_PAIR_ROWS)):
        xs = x[:n].contiguous()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        labels, children = single_linkage(xs, SL_CLUSTERS,
                                          LinkageDistance[route], SL_C)
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        run = dict(sl.last_run)
        heights = run.pop("heights")
        ch = children.cpu().numpy()
        size = np.ones(2 * n - 1, np.int64)
        for e, (a, b) in enumerate(ch):
            size[n + e] = size[a] + size[b]
        lab = labels.cpu().numpy()
        valid = (ch.shape == (n - 1, 2) and bool(np.all(np.diff(heights)
                                                        >= 0))
                 and int(size[-1]) == n
                 and len(np.unique(lab)) == SL_CLUSTERS)
        fields = {}
        if route == "PAIRWISE":
            t1 = time.perf_counter()
            z = linkage(xs.cpu().double().numpy(), method="single")
            ref = cut_tree(z, n_clusters=SL_CLUSTERS).reshape(-1)
            fields = {"scipy_s": time.perf_counter() - t1,
                      "heights_max_rel_err": float(np.max(np.abs(
                          np.sort(z[:, 2]) - heights)
                          / np.maximum(np.sort(z[:, 2]), 1e-30))),
                      "label_pairs": len(set(zip(lab.tolist(),
                                                 ref.tolist())))}
        phase("cluster", part="single_linkage", route=route, rows=n,
              c=SL_C, n_clusters=SL_CLUSTERS, seconds=seconds,
              dendrogram_valid=valid, **run, **fields,
              launches={k_: v for k_, v in launches.items() if v})
        if not valid:
            fail(f"single_linkage {route}: invalid dendrogram")
        if route == "PAIRWISE" and (fields["heights_max_rel_err"] > 1e-4
                                    or fields["label_pairs"] != SL_CLUSTERS):
            fail(f"single_linkage PAIRWISE: differs from scipy {fields}")
        del labels, children, xs


def run_silhouette(x, centers):
    """Phase 9c: ``silhouette_score`` of SIL_ROWS rows at the fit's
    labels, euclidean and cityblock, each held to the port's CPU run on
    SIL_SUB of them; the cityblock run's tiles make the kernel 7 row."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.stats import silhouette_score
    xs = x[:SIL_ROWS].contiguous()
    labels = kmeans.predict(xs, centers)
    row = None
    for metric in ("euclidean", "cityblock"):
        ops.reset_launch_counts()
        score, ms = cuda_once(lambda: silhouette_score(xs, labels,
                                                       metric=metric))
        launches = ops.launch_counts()
        sub = float(silhouette_score(xs[:SIL_SUB], labels[:SIL_SUB],
                                     metric=metric))
        t0 = time.perf_counter()
        cpu = float(silhouette_score(xs[:SIL_SUB].cpu(),
                                     labels[:SIL_SUB].cpu(), metric=metric))
        cpu_s = time.perf_counter() - t0
        phase("cluster", part="silhouette", metric=metric, rows=SIL_ROWS,
              score=float(score), ms=ms, subset=SIL_SUB, subset_score=sub,
              subset_cpu_score=cpu, cpu_s=cpu_s,
              launches={k_: v for k_, v in launches.items() if v})
        if not (abs(sub - cpu) <= SIL_TOL and -1.0 <= float(score) <= 1.0):
            fail(f"silhouette {metric}: card {sub} vs CPU {cpu}")
        if metric == "cityblock":
            check_launched("silhouette cityblock", launches,
                           ("elementwise_dist",))
            row = elt_row("elementwise_dist@silhouette_l1", "l1",
                          xs[:256].contiguous(), xs,
                          launches["elementwise_dist"], 1.0)
    return row


def sparse_rows(g, m: int, k: int, nnz: int, dev):
    """CSR rows of ``bench_suite.bench_sparse_wide``'s form: ``nnz``
    random columns of ``k`` a row (a repeat keeps one value) with
    uniform values, made on the card."""
    from raft_tpu_torch import sparse
    dense = torch.zeros((m, k), device=dev)
    cols = torch.randint(0, k, (m, nnz), generator=g, device=dev)
    dense.scatter_(1, cols, torch.rand((m, nnz), generator=g, device=dev))
    out = sparse.dense_to_csr(dense)
    del dense
    return out


def run_sparse(seed: int, dev):
    """Phase 9d: the wide case against dense ``pairwise_distance`` of the
    densified rows; the narrow case at cityblock and jensenshannon, bit
    for bit against the dense function (kernel 7 rows); the sparse
    k-NN, its first SP_KNN[3] queries against ``torch.sparse.mm`` of the
    CSR rows."""
    from raft_tpu_torch import ops, sparse
    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    m, n, k, nnz, tile = SP_WIDE
    a, b = sparse_rows(g, m, k, nnz, dev), sparse_rows(g, n, k, nnz, dev)
    wide = lambda: sparse.pairwise_distance(  # noqa: E731
        a, b, DistanceType.L2SqrtExpanded, col_tile=tile)
    got = wide()
    want = pairwise_distance(a.todense(), b.todense(), "euclidean")
    err = float((got - want).abs().max())
    wide_ms = cuda_ms(wide, 3)
    phase("cluster", part="sparse_wide", shape=[m, n, k], nnz_per_row=nnz,
          col_tile=tile, ms=wide_ms, max_abs_err_vs_dense=err)
    if err > SP_TOL * (1.0 + float(want.abs().max())):
        fail(f"sparse wide: {err} from the dense distance")
    del a, b, got, want
    rows = []
    m, n, k, density = SP_NARROW
    dense_a = torch.rand((m, k), generator=g, device=dev)
    dense_a *= torch.rand((m, k), generator=g, device=dev) < density
    dense_b = torch.rand((n, k), generator=g, device=dev)
    dense_b *= torch.rand((n, k), generator=g, device=dev) < density
    a, b = sparse.dense_to_csr(dense_a), sparse.dense_to_csr(dense_b)
    for name, tag, p_lib in (("cityblock", "l1", 1.0),
                             ("jensenshannon", "jensen_shannon", None)):
        from raft_tpu_torch.distance import DISTANCE_TYPES
        ops.reset_launch_counts()
        got, ms = cuda_once(lambda: sparse.pairwise_distance(
            a, b, DISTANCE_TYPES[name]))
        launches = ops.launch_counts()
        check_launched(f"sparse narrow {name}", launches,
                       ("elementwise_dist",))
        same = bool(torch.equal(got, pairwise_distance(dense_a, dense_b,
                                                       name)))
        phase("cluster", part="sparse_narrow", metric=name,
              shape=[m, n, k], density=density, ms=ms,
              equal_to_dense=same,
              launches={k_: v for k_, v in launches.items() if v})
        if not same:
            fail(f"sparse narrow {name}: differs from the dense distance")
        del got
        rows.append(elt_row(
            f"elementwise_dist@sparse_narrow_{'l1' if tag == 'l1' else 'js'}",
            tag, dense_a, dense_b, launches["elementwise_dist"], p_lib))
    del a, b, dense_a, dense_b
    nq, n, kk, checked = SP_KNN
    k, nnz = SP_WIDE[2], SP_WIDE[3]
    db, q = sparse_rows(g, n, k, nnz, dev), sparse_rows(g, nq, k, nnz, dev)
    (d, i), ms = cuda_once(lambda: sparse.brute_force_knn(db, q, kk))
    # the first queries by torch.sparse: |q|^2 + |x|^2 - 2 <q, x>
    qd = sparse.csr_slice_rows(q, 0, checked).todense()
    dbs = torch.sparse_csr_tensor(db.indptr.long(), db.indices.long(),
                                  db.data, db.shape, check_invariants=False)
    ip = torch.sparse.mm(dbs, qd.T).T
    xx = torch.zeros(n, device=dev).index_add_(
        0, db.row_ids().long(), db.data * db.data)
    ref = (qd * qd).sum(1)[:, None] + xx[None, :] - 2.0 * ip
    d_ref, i_ref = torch.topk(ref, kk, dim=1, largest=False)
    agree = float((i[:checked].long() == i_ref).double().mean())
    derr = float((d[:checked] - d_ref).abs().max())
    phase("cluster", part="sparse_knn", queries=nq, rows=n, features=k,
          nnz_per_row=nnz, k=kk, ms=ms, checked=checked,
          id_agreement=agree, max_abs_err=derr)
    if agree < MIN_ID_AGREEMENT or derr > SP_TOL * float(d_ref.max()):
        fail(f"sparse knn: ids agree on {agree}, distances off by {derr}")
    return rows


def run_select_approx(dev):
    """Phase 9e: ``select_k(mode="approx")`` on one batch: the ids of
    ``mode="exact"`` and kernel 2's launches risen."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors.selection import select_k
    rows, cols, k = APPROX
    v = torch.randn((rows, cols), device=dev)
    ops.reset_launch_counts()
    d_a, i_a = select_k(v, k, mode="approx", recall_target=0.9)
    launches = ops.launch_counts()["select_k"]
    d_e, i_e = select_k(v, k)
    same = bool(torch.equal(i_a, i_e) and torch.equal(d_a, d_e))
    phase("cluster", part="select_k_approx", shape=[rows, cols, k],
          equal_to_exact=same, select_k_launches=launches)
    if not same or launches < 1:
        fail(f"select_k approx: equal to exact {same}, launches {launches}")


def run_cluster(x, seed: int, dev):
    """Phase 9: the host-side users of kernels 1, 7 and 2."""
    t0 = time.perf_counter()
    centers, km_row = run_kmeans_fit(x[:KM_FIT_ROWS].contiguous())
    run_single_linkage(x)
    rows = [km_row, run_silhouette(x, centers)]
    rows += run_sparse(seed, dev)
    run_select_approx(dev)
    phase("cluster", seconds=time.perf_counter() - t0)
    return rows


def spectral_graph(x, k: int):
    """The kNN graph of ``x`` in ``sparse.neighbors.knn_graph``'s form
    (self edges dropped, mirrored edges merged) with unit weights, as
    CSR; the neighbours from the fused brute force (kernel 5 and its
    pass B) where ``knn_graph`` takes the exact tile scan."""
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    from raft_tpu_torch.sparse import COO, coo_to_csr, symmetrize
    n = x.shape[0]
    _, idx = brute_force_knn(x, x, k + 1, DistanceType.L2Expanded,
                             mode="fused", device=x.device)
    rows = torch.arange(n, dtype=torch.int32,
                        device=x.device).repeat_interleave(k + 1)
    cols = idx.reshape(-1)
    keep = rows != cols
    ones = torch.ones(int(keep.sum()), device=x.device)
    return coo_to_csr(symmetrize(COO(rows[keep], cols[keep], ones, (n, n)),
                                 "max"))


def timed(fn):
    """``(fn(), seconds)`` with the device synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_spectral(x, truth, blobs_s: float):
    """Phase 10a: ``spectral.partition`` of the blob points ``x`` on their
    kNN graph, its quality measures, then ``modularity_maximization`` on
    the same graph; kernel 1 held to its plain version at the k-means
    shape (the embedding against the partition's centroids)."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.spectral import (analyze_modularity,
                                         analyze_partition,
                                         modularity_maximization, partition)
    from raft_tpu_torch.spectral.partition import _transform_eigen_matrix
    from raft_tpu_torch.stats import adjusted_rand_index
    from raft_tpu_torch.util.segment import segment_sum
    k = SPEC_CLUSTERS
    ops.reset_launch_counts()
    graph, graph_s = timed(lambda: spectral_graph(x, SPEC_KNN))
    graph_launches = ops.launch_counts()
    ops.reset_launch_counts()
    (labels, evals, evecs), part_s = timed(lambda: partition(graph, k))
    part_shapes, part_l1 = l2nn_shapes(), ops.launch_counts()["fused_l2_nn"]
    (cut, cost), cut_s = timed(lambda: analyze_partition(graph, labels, k))
    q, q_s = timed(lambda: analyze_modularity(graph, labels, k))
    ops.reset_launch_counts()
    (m_labels, m_evals, m_evecs), mod_s = timed(
        lambda: modularity_maximization(graph, k))
    mod_shapes, mod_l1 = l2nn_shapes(), ops.launch_counts()["fused_l2_nn"]
    m_q = analyze_modularity(graph, m_labels, k)
    ari = float(adjusted_rand_index(truth, labels))
    m_ari = float(adjusted_rand_index(truth, m_labels))
    finite = all(bool(torch.isfinite(t).all()) for t in (
        evals, evecs, cut, cost, q, m_evals, m_evecs, m_q))
    in_range = all(int(lab.min()) >= 0 and int(lab.max()) < k
                   for lab in (labels, m_labels))
    ascending = bool((evals[1:] >= evals[:-1]).all()) and \
        -1e-3 <= float(evals[0]) and float(evals[-1]) <= 2 + 1e-3
    phase("primitives", part="spectral", n=SPEC_N, dim=SPEC_D, k=k,
          knn=SPEC_KNN, nnz=graph.nnz, seconds={
              "make_blobs": blobs_s, "knn_graph": graph_s,
              "partition": part_s, "analyze_partition": cut_s,
              "analyze_modularity": q_s, "modularity_maximization": mod_s},
          graph_launches={k_: v for k_, v in graph_launches.items() if v},
          eigenvalues=evals.tolist(), ari=ari, edge_cut=float(cut),
          cost=float(cost), modularity=float(q),
          modularity_eigenvalues=m_evals.tolist(), modularity_ari=m_ari,
          modularity_max_modularity=float(m_q),
          partition_fused_l2_nn_shapes=part_shapes,
          modularity_fused_l2_nn_shapes=mod_shapes)
    if not (finite and in_range and ascending):
        fail(f"spectral: finite {finite}, labels in [0, {k}) {in_range}, "
             f"eigenvalues ascending in [-1e-3, 2 + 1e-3] {ascending}")
    if part_l1 < 1 or mod_l1 < 1:
        fail(f"spectral: kernel 1 launches {part_l1} (partition), "
             f"{mod_l1} (modularity_maximization)")
    emb = _transform_eigen_matrix(evecs).contiguous()
    sums, counts = segment_sum(emb, labels, k)
    cents = (sums / counts.clamp(min=1)[:, None].float()).contiguous()
    row = check_fused_l2_nn(emb, cents, "fused_l2_nn@spectral")
    row["launches"] = part_l1 + mod_l1
    return row


def run_dense(x, seed: int, dev):
    """Phase 10b: rsvd of a low-rank-plus-noise matrix against
    ``torch.linalg.svdvals``; eig_dc and svd_qr with their reconstruction
    residuals; lstsq_qr with its normal-equations residual; cov and
    meanvar of the blobs against float64."""
    from raft_tpu_torch import linalg, stats
    g = torch.Generator(device=dev).manual_seed(seed)
    m, n = RSVD_SHAPE

    def orth(rows):
        return torch.linalg.qr(torch.randn((rows, RSVD_K), generator=g,
                                           device=dev))[0]

    sv = torch.logspace(3, 1.7, RSVD_K, device=dev)
    a = (orth(m) * sv) @ orth(n).T + 0.01 * torch.randn(
        (m, n), generator=g, device=dev)
    (_, s, _), rsvd_s = timed(lambda: linalg.rsvd(a, RSVD_K, seed=seed))
    ref, svdvals_s = timed(lambda: torch.linalg.svdvals(
        a, driver="gesvd")[:RSVD_K])
    rsvd_err = float(((s - ref).abs() / ref).max())
    del a
    b = torch.randn((DENSE_N, DENSE_N), generator=g, device=dev)
    sym = (b + b.T) / 2
    (w, v), eig_s = timed(lambda: linalg.eig_dc(sym))
    eig_res = float(torch.linalg.norm(sym @ v - v * w)
                    / torch.linalg.norm(sym))
    (u, sig, vv), svd_s = timed(lambda: linalg.svd_qr(b))
    svd_res = float(torch.linalg.norm(linalg.svd_reconstruction(u, sig, vv)
                                      - b) / torch.linalg.norm(b))
    del b, sym, w, v, u, sig, vv
    lm, ln = LSTSQ_SHAPE
    la = torch.randn((lm, ln), generator=g, device=dev)
    lb = la @ torch.randn(ln, generator=g, device=dev) + 0.1 * torch.randn(
        lm, generator=g, device=dev)
    sol, lstsq_s = timed(lambda: linalg.lstsq_qr(la, lb))
    lstsq_res = float(torch.linalg.norm(la.T @ (la @ sol - lb))
                      / torch.linalg.norm(la.T @ lb))
    del la, lb
    c, cov_s = timed(lambda: stats.cov(x))
    (mu, var), mv_s = timed(lambda: stats.meanvar(x))
    xd = x.double()
    c64 = torch.cov(xd.T)
    cov_err = float((c.double() - c64).abs().max() / c64.abs().max())
    mv_err = max(float((mu.double() - xd.mean(0)).abs().max()),
                 float(((var.double() - xd.var(0)) / xd.var(0)).abs().max()))
    del xd
    phase("primitives", part="dense", rsvd_shape=[m, n, RSVD_K],
          rsvd_max_rel_err=rsvd_err, eig_dc_residual=eig_res,
          svd_qr_residual=svd_res, lstsq_qr_shape=list(LSTSQ_SHAPE),
          lstsq_normal_residual=lstsq_res, cov_rel_err=cov_err,
          meanvar_err=mv_err, seconds={
              "rsvd": rsvd_s, "svdvals": svdvals_s, "eig_dc": eig_s,
              "svd_qr": svd_s, "lstsq_qr": lstsq_s, "cov": cov_s,
              "meanvar": mv_s})
    if not (rsvd_err <= RSVD_TOL and max(eig_res, svd_res, lstsq_res,
                                         cov_err, mv_err) <= RESID_TOL):
        fail(f"dense: rsvd {rsvd_err}, eig {eig_res}, svd {svd_res}, "
             f"lstsq {lstsq_res}, cov {cov_err}, meanvar {mv_err}")


def run_assignment(seed: int, dev):
    """Phase 10c: the auction at LAP_N on integer costs, a permutation,
    its objective beside scipy's optimum (not gated: six ε-phases stop
    short of ε·n < 0.5 at this n) and the rounds of each phase."""
    from scipy.optimize import linear_sum_assignment
    from raft_tpu_torch.solver import LinearAssignmentProblem
    g = torch.Generator(device=dev).manual_seed(seed)
    cost = torch.randint(0, 1000, (LAP_N, LAP_N), generator=g,
                         device=dev).float()
    lap = LinearAssignmentProblem(LAP_N)
    obj, secs = timed(lambda: lap.solve(cost))
    rows = lap.get_row_assignment_vector()
    perm = bool(torch.equal(torch.sort(rows.long()).values,
                            torch.arange(LAP_N, device=dev)))
    c = cost.cpu().numpy()
    t0 = time.perf_counter()
    ri, ci = linear_sum_assignment(c)
    scipy_s = time.perf_counter() - t0
    phase("primitives", part="linear_assignment", n=LAP_N,
          objective=float(obj), scipy_objective=float(c[ri, ci].sum()),
          rounds_per_phase=lap.rounds_per_phase, permutation=perm,
          seconds=secs, scipy_seconds=scipy_s)
    if not perm:
        fail("linear_assignment: the row assignment is not a permutation")


def run_generators(seed: int, dev):
    """Phase 10d: R-MAT at Graph500's scale 20, edge factor 16 (top-level
    quadrant shares against theta), make_regression's noise-free targets
    against x @ coef + bias."""
    from raft_tpu_torch.random import (RngState, make_regression,
                                       rmat_rectangular_gen)
    n_edges = RMAT_EDGE_FACTOR << RMAT_SCALE
    (src, dst), rmat_s = timed(lambda: rmat_rectangular_gen(
        RngState(seed, device=dev), list(RMAT_THETA), RMAT_SCALE, RMAT_SCALE,
        n_edges))
    top = RMAT_SCALE - 1
    quad = ((src >> top) * 2 + (dst >> top)).long()
    shares = (torch.bincount(quad, minlength=4).double() / n_edges).tolist()
    in_range = int(src.min()) >= 0 and int(max(src.max(), dst.max())) < \
        (1 << RMAT_SCALE) and int(dst.min()) >= 0
    del src, dst, quad
    rows, cols = REG_SHAPE
    (x, y, w), reg_s = timed(lambda: make_regression(
        rows, cols, bias=2.5, coef=True, seed=RngState(seed, device=dev)))
    ref = (x @ w)[:, 0] + 2.5
    reg_err = float((y - ref).abs().max() / ref.abs().max())
    phase("primitives", part="generators", rmat_scale=RMAT_SCALE,
          rmat_edges=n_edges, rmat_top_shares=shares, rmat_in_range=in_range,
          regression_shape=list(REG_SHAPE), regression_rel_err=reg_err,
          seconds={"rmat": rmat_s, "make_regression": reg_s})
    off = max(abs(a - b) for a, b in zip(shares, RMAT_THETA))
    if off > RMAT_TOL or not in_range or not reg_err <= REG_TOL:
        fail(f"generators: rmat shares {shares} (theta {RMAT_THETA}), in "
             f"range {in_range}; make_regression rel err {reg_err}")


def run_primitives(seed: int, dev):
    """Phase 10: the dense primitives and spectral partitioning."""
    from raft_tpu_torch.random import make_blobs
    t0 = time.perf_counter()
    (x, truth), blobs_s = timed(lambda: make_blobs(
        SPEC_N, SPEC_D, centers=SPEC_CLUSTERS, cluster_std=1.0, seed=seed,
        device=dev))
    row = run_spectral(x, truth, blobs_s)
    run_dense(x, seed, dev)
    del x, truth
    run_assignment(seed, dev)
    run_generators(seed, dev)
    phase("primitives", seconds=time.perf_counter() - t0)
    return [row]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000,
                    help="dataset rows (default 10M; a cut is printed)")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="after each measured burst, trace a second one "
                    "with torch.profiler (device time by kernel)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs only on a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "raft_tpu_torch")):
        fail("raft_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, here)
    from raft_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = gpu_line()
    os.makedirs(OUT_DIR, exist_ok=True)

    # 1. build
    secs, reports = _build.build_all(verbose=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in reports.items():
            f.write(f"== {name}\n{text}\n")
    phase("build", seconds=secs, kernels=list(_build.KERNEL_SOURCES),
          ptxas=ptxas_summary(reports))

    x, q, q_bf = ann_dataset(args.n, D, N_QUERIES, args.seed, dev)
    if args.n != 10_000_000:
        phase("cut", n=args.n, note="dataset cut from 10,000,000 rows")
    q_np = q.cpu().numpy()

    # 2a. kernels vs plain at the IVF-Flat path's k-means, predict and
    # coarse shapes (the sampled rows stand in for N_LISTS centres)
    cent = sample_rows(x, N_LISTS, 12)
    sample = sample_rows(x, KM_ROWS, 11)
    flat_rows = [check_fused_l2_nn(sample, cent, "fused_l2_nn"),
                 check_fused_l2_nn(x, cent, "fused_l2_nn@predict"),
                 check_select_k(q, cent, N_PROBES, "select_k")]
    # 2b. the trainer and kernel 1 at its other tiers
    tier_rows = run_kmeans_tiers(x, sample, cent,
                                 sample_rows(x, PQ_LISTS, 14))
    del cent, sample

    # the exact truth of the 256 queries, by the port's exact scan
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    t0 = time.perf_counter()
    truth = brute_force_knn(x, q, K, DistanceType.L2Expanded,
                            mode="exact")[1].cpu().numpy()
    phase("truth", nq=N_QUERIES, k=K, seconds=time.perf_counter() - t0)

    # 3. the IVF-Flat path, with its k > 256 search; 3b, 3c. the same at
    # bf16 and int8 list storage (rows carry their own launches)
    scan_rows, flat_launches, wide_rows, wide_launches = run_flat(
        x, q, q_np, truth, args)
    flat_rows += scan_rows
    narrow_rows = [r for st in FLAT_STORAGES
                   for r in run_flat_narrow(x, q, q_np, truth, args, st)]

    # 4., 5. the IVF-PQ and IVF-BQ paths; 5b, 5c. the same points grown by
    # extend (IVF-PQ with per-cluster books), their recall beside the
    # first's
    paths = [(flat_rows, flat_launches), (wide_rows, wide_launches)]
    recalls = {}
    for fam in FAMILIES:
        rows, counts, recalls[fam.module] = run_family(fam, x, q, q_np,
                                                       truth, args)
        paths.append((rows, counts))
    for fam in GROWN:
        rows, counts, _ = run_family(
            fam, x, q, q_np, truth, args,
            {f"main_{fam.tag.split('_')[0]}_recall_at_{K}":
             recalls[fam.module]})
        paths.append((rows, counts))
    # 5d. the two-level trainer at the 10M rows
    run_two_level(x)

    # launches: each row's kernel over the main-path run of its path,
    # where the row does not carry its own
    for rows, counts in paths:
        for row in rows:
            if row["launches"] is not None:
                continue
            key = row["name"].split("@")[0]
            row["launches"] = counts["ivf_scan" if key == "ivf_flat_scan"
                                     else key]

    # 2b, 3b, 3c, 6.-9. kernel 1's tiers, IVF-Flat's narrow storages,
    # brute force and pairwise distances: rows carry their own path's
    # launches
    paths.append((tier_rows, None))
    paths.append((narrow_rows, None))
    paths.append((run_bf(x, q_bf, args), None))
    paths.append((run_wide_bf(args.seed, dev), None))
    paths.append((run_pairwise(x[:L1_ROWS], q_bf[:L1_QUERIES], args.seed,
                               dev), None))
    # 9. the host-side users of the distances
    paths.append((run_cluster(x, args.seed, dev), None))
    # 10. the dense primitives and spectral partitioning
    paths.append((run_primitives(args.seed, dev), None))

    kernels = [r for rows, _ in paths for r in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

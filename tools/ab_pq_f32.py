"""Holds the IVF-PQ float32 tier's CUDA-core body (``pq_f32_kernel`` in
``csrc/ivf_pq_scan.cu``, kernels 8 and 9 at ``lut_dtype=float32``) to
another tree's body bit for bit, and times the two in turns, on one CUDA
card.

    python3 tools/ab_pq_f32.py --parent DIR [--reps N] [--quick] [--parts]

``DIR`` holds the other tree's ``ivf_pq_scan.cu`` with its headers, e.g.
``git archive <commit> raft_tpu_torch/csrc | tar -x -C chip_parent`` and
``--parent chip_parent/raft_tpu_torch/csrc``. It is compiled with ``nvcc``
into a temporary directory and called through its own C interface: the
entries this tree's wrappers call (``raft_ivf_pq_scan_f32``,
``raft_ivf_pq_scan_f32_fused``, pass B ``raft_ivf_pq_topk``) where it has
them, swapped into those wrappers; else an older tree's pair-major
``raft_ivf_pq_scan`` (one block per (query, list) pair, a whole table in
shared memory) with the arguments its wrapper gave it. Both take the
same inputs:

* the served point of ``chip_smoke.py`` (10M x 128 rows of its mixture,
  seed 5, 4096 lists, pq_dim 32 x 8 bits, 128 probes, one 128-query
  batch): the fused scan at kk = 256 and the unfused one at kk = 512, the
  ``@f32`` rows; ``--quick`` cuts the rows to 1M;
* ragged synthetic lists (the card test's cases: pq_len 1 to 5, 4 and 8
  bits, per-subspace and per-cluster books, L2 and IP, empty and 5-row
  lists, bins of 1 to exact, an overflowing cap, a list holding more
  than one tile of slots; rot_dim 768 too where the other tree has no
  table limit).

Every float is compared as its 32 bits, every id exactly: the fused
scan's (nq, k) results and the unfused scan's (n_lists, cap, bins)
blocks. At the served point it then times other, this, this, other
(CUDA events, the median of ``--reps`` runs after one warm-up): the whole
scan, and for the fused one its pass A alone and pass B alone; with
``--parts``, this tree's fused pass A rebuilt from copies of its source
with the edits of ``PARTS`` (other widths, the generic path forced,
parts cut out). Prints the card's name and power limit, the two bodies'
registers and spills, and one JSON line a case (the served ones again
with their times). Exits non-zero if any case differs.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch.neighbors import _ivf_scan, ivf_pq  # noqa: E402
from raft_tpu_torch.ops import _build  # noqa: E402
from raft_tpu_torch.ops import ivf_pq_scan as op  # noqa: E402
from raft_tpu_torch.ops import ivf_scan as scan_op  # noqa: E402
from raft_tpu_torch.ops._build import INT, PTR  # noqa: E402
from raft_tpu_torch.ops._util import round_up  # noqa: E402

# (pq_dim, pq_bits, pq_len) x (k, bins, cap) x per_cluster x metric: the
# card test's float32 shapes; RAGGED_WIDE (rot_dim 768, a 196,608 B table)
# only against a tree without the pair-major body's 160 KB table limit
RAGGED_BOOKS = [(16, 4, 2), (32, 8, 2), (64, 8, 2), (24, 8, 2), (32, 8, 4),
                (16, 8, 8), (64, 4, 1), (24, 8, 3), (64, 8, 5)]
RAGGED_WIDE = [(192, 8, 4)]
RAGGED_SCANS = [(1, 16, 32), (10, 128, 32), (256, 64, 32), (10, 16, 8),
                (10, 0, 32), (10, -1, 32), (10, 16, 200)]
# --parts: (name, [(text, replacement), ...]) edits of a copy of this
# tree's ivf_pq_scan.cu, each text found exactly once; its fused pass A
# is timed at the served point beside the whole
PARTS = [
    ("generic path", [("const int pl = vec && sps >= 2 && sps <= 16 ? "
                       "a.pq_len : 0;", "const int pl = 0;")]),
    ("bins 32", [("constexpr int kF32Bins = 64;",
                  "constexpr int kF32Bins = 32;")]),
    ("step 8", [("constexpr int kF32K = 16;", "constexpr int kF32K = 8;")]),
    ("step 32", [("constexpr int kF32K = 16;",
                  "constexpr int kF32K = 32;")]),
    ("slots 16", [("constexpr int kF32Slots = 32;",
                   "constexpr int kF32Slots = 16;")]),
    ("no codebook copies", [("if (r < 0) return;", "return;")]),
    ("no products", [("if (scorer && w0 < nw) {", "if (false) {")]),
    ("neither", [("if (r < 0) return;", "return;"),
                 ("if (scorer && w0 < nw) {", "if (false) {")]),
    ("subspace loop not unrolled", [("#pragma unroll(PL <= 1 ? 1 : SPS)",
                                     "#pragma unroll 1")]),
]


def ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def ptxas_lines(text: str, names) -> list:
    """Registers, shared memory and spills of the kernels named."""
    out, keep = [], False
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            keep = any(n in m.group(1) for n in names)
            if keep:
                out.append(m.group(1))
        elif keep and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


class Other:
    """The other tree's f32 body and pass B, through its C interface: the
    entries of this tree's wrappers where it has them (``same``), else the
    pair-major ``raft_ivf_pq_scan`` with its wrapper's arguments."""

    def __init__(self, src_dir: str, out_dir: str):
        out = os.path.join(out_dir, "libivf_pq_scan_other.so")
        p = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                            "-Xptxas=-v", "-I", src_dir, "-o", out,
                            os.path.join(src_dir, "ivf_pq_scan.cu")],
                           capture_output=True, text=True)
        if p.returncode != 0:
            sys.exit(f"nvcc failed for the other tree:\n{p.stdout}{p.stderr}")
        lib = ctypes.CDLL(out)
        self.same = hasattr(lib, "raft_ivf_pq_scan_f32_fused")
        self.ptxas = ptxas_lines(p.stdout + p.stderr, (
            "pq_f32_kernel" if self.same else "pq_pairs_kernel",))
        self.topk = entry_of(lib, op._TOPK)
        if self.same:
            self.f32 = entry_of(lib, op._F32_SCAN)
            self.f32_fused = entry_of(lib, op._F32_FUSED)
        else:
            self.scan = lib.raft_ivf_pq_scan
            self.scan.argtypes = [PTR] * 8 + [INT] * 15 + [PTR] * 3
            self.scan.restype = ctypes.c_int

    @contextlib.contextmanager
    def swapped(self):
        """This tree's wrappers calling the other tree's entries."""
        pairs = [(op._F32_SCAN, self.f32), (op._F32_FUSED, self.f32_fused),
                 (op._TOPK, self.topk)]
        saved = [e._fn for e, _ in pairs]
        try:
            for e, fn in pairs:
                e._fn = fn
            yield
        finally:
            for (e, _), fn in zip(pairs, saved):
                e._fn = fn

    def pairs(self, q_rot, c_rot, books, codes, norms, ids, qsel, lsel,
              n_pairs, div, bins, metric, per_cluster, center_term,
              round_out, out_d, out_i):
        n_lists, max_list, pq_dim = codes.shape
        vec16 = pq_dim % 16 == 0 and codes.data_ptr() % 16 == 0
        rc = self.scan(q_rot.data_ptr(), c_rot.data_ptr(), books.data_ptr(),
                       codes.data_ptr(), norms.data_ptr(), ids.data_ptr(),
                       qsel.data_ptr() if qsel is not None else None,
                       lsel.data_ptr() if lsel is not None else None,
                       n_pairs, div, q_rot.shape[1], pq_dim, books.shape[2],
                       books.shape[1], max_list, bins,
                       round_up(max_list, bins), int(metric == "ip"),
                       int(per_cluster), 0, int(center_term),
                       int(round_out), int(vec16), out_d.data_ptr(),
                       out_i.data_ptr(), _build.stream_handle(q_rot.device))
        _build.check(rc, "the other tree's raft_ivf_pq_scan")

    def unfused(self, a, qmap, bins, metric, per_cluster, round_out):
        if self.same:
            with self.swapped():
                return op.pq_scan_cuda(*a, qmap, bins, metric, False,
                                       per_cluster, round_out)
        n_lists, cap = qmap.shape
        dev = qmap.device
        out_d = torch.empty((n_lists, cap, bins), device=dev)
        out_i = torch.empty((n_lists, cap, bins), dtype=torch.int32,
                            device=dev)
        self.pairs(*a, qmap, None, n_lists * cap, cap, bins, metric,
                   per_cluster, False, round_out, out_d, out_i)
        return out_d, out_i

    def fused_a(self, a, probes, inv_pos, qmap, cap, bins, metric,
                per_cluster):
        if self.same:
            return this_fused_a(a, probes, inv_pos, qmap, cap, bins, metric,
                                per_cluster, self.f32_fused)
        kp = scan_op.kept_probes_sorted(probes, inv_pos, cap)
        nq, n_probes = kp.shape
        dev = kp.device
        cand_d = torch.empty((nq, n_probes * bins), device=dev)
        cand_i = torch.empty((nq, n_probes * bins), dtype=torch.int32,
                             device=dev)
        self.pairs(*a, None, kp, nq * n_probes, n_probes, bins, metric,
                   per_cluster, True, False, cand_d, cand_i)
        return cand_d, cand_i

    def pass_b(self, cand_d, cand_i, k, sqrt):
        nq, n = cand_d.shape
        dev = cand_d.device
        out_d = torch.empty((nq, k), device=dev)
        out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
        rc = self.topk(cand_d.data_ptr(), cand_i.data_ptr(), nq, n, k,
                       int(sqrt), out_d.data_ptr(), out_i.data_ptr(),
                       _build.stream_handle(dev))
        _build.check(rc, "the other tree's raft_ivf_pq_topk")
        return out_d, out_i

    def fused(self, a, probes, inv_pos, qmap, cap, k, bins, sqrt, metric,
              per_cluster):
        return self.pass_b(*self.fused_a(a, probes, inv_pos, qmap, cap,
                                         bins, metric, per_cluster), k, sqrt)


def entry_of(lib, entry):
    """``entry``'s symbol in ``lib``, with its argument types."""
    fn = getattr(lib, entry.symbol)
    fn.argtypes, fn.restype = entry.argtypes, ctypes.c_int
    return fn


def build_parts(out_dir: str, parts) -> dict:
    """This tree's ``ivf_pq_scan.cu`` rebuilt from a copy of its sources
    with each part's edits: {name: its kernel 9 f32 pass A entry}."""
    procs, entries = {}, {}
    for n, (name, edits) in enumerate(parts):
        src = os.path.join(out_dir, f"part{n}")
        shutil.copytree(_build.CSRC, src)
        path = os.path.join(src, "ivf_pq_scan.cu")
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"part {name!r}: {old!r} is not in the source once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        out = os.path.join(out_dir, f"libivf_pq_scan_part{n}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-I", src,
             "-o", out, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    for name, (p, out) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"nvcc failed for the part {name!r}:\n{text}")
        print(json.dumps({"part": name, "ptxas": ptxas_lines(
            text, ("pq_f32_kernel",))}), flush=True)
        entries[name] = entry_of(ctypes.CDLL(out), op._F32_FUSED)
    return entries


def this_fused_a(a, probes, inv_pos, qmap, cap, bins, metric, per_cluster,
                 entry=op._F32_FUSED):
    """This tree's kernel 9 f32 pass A alone (its entry without pass B,
    or another build's ``entry``)."""
    q_rot, c_rot, books, codes, norms, ids = a
    kp = scan_op.kept_probes_sorted(probes, inv_pos, cap)
    nq, n_probes = kp.shape
    n_lists, max_list = ids.shape
    dev = q_rot.device
    cand_d = torch.empty((nq, n_probes * bins), device=dev)
    cand_i = torch.empty((nq, n_probes * bins), dtype=torch.int32,
                         device=dev)
    lists = torch.empty(2 * n_lists, dtype=torch.int32, device=dev)
    rc = entry(q_rot.data_ptr(), q_rot.shape[1], qmap.data_ptr(), n_lists,
               cap, kp.data_ptr(), n_probes, nq, c_rot.data_ptr(),
               books.data_ptr(), codes.data_ptr(),
               *op._book_args(codes, books, per_cluster), norms.data_ptr(),
               ids.data_ptr(), max_list, bins, int(metric == "ip"),
               cand_d.data_ptr(), cand_i.data_ptr(), lists.data_ptr(),
               _build.stream_handle(dev))
    _build.check(rc, "raft_ivf_pq_scan_f32_fused")
    return cand_d, cand_i


def compare_case(name, other, a, probes, inv_pos, qmap, cap, k, bins,
                 metric, per_cluster, round_out) -> dict:
    """Both bodies' fused (nq, k) results (k <= 256) and unfused blocks,
    bit for bit."""
    sqrt = metric == "l2"
    same = {}
    if k <= op.MAX_K:
        mine = op.pq_scan_fused_cuda(*a, probes, inv_pos, qmap, cap, k,
                                     bins, sqrt, metric, False, per_cluster)
        theirs = other.fused(a, probes, inv_pos, qmap, cap, k, bins, sqrt,
                             metric, per_cluster)
        torch.cuda.synchronize()
        same["fused"] = all(bits_equal(x, y) for x, y in zip(mine, theirs))
    mine = op.pq_scan_cuda(*a, qmap, bins, metric, False, per_cluster,
                           round_out)
    theirs = other.unfused(a, qmap, bins, metric, per_cluster, round_out)
    torch.cuda.synchronize()
    same["unfused"] = all(bits_equal(x, y) for x, y in zip(mine, theirs))
    row = {"case": name, "bit_identical": all(same.values()), **same,
           "finite_bins": int(torch.isfinite(mine[0]).sum())}
    print(json.dumps(row), flush=True)
    return row


def ragged_cases(other, dev) -> list:
    rows = []
    for (pq_dim, bits, pl), (k, bins, cap), pc, metric in itertools.product(
            RAGGED_BOOKS + (RAGGED_WIDE if other.same else []),
            RAGGED_SCANS, (False, True), ("l2", "ip")):
        rng = np.random.default_rng(pq_dim * pl + bits + k + cap + bins)
        nq = 256 if cap > 128 else 32
        n_lists, max_list, n_probes = 16, 100, 6
        rot, n_codes = pq_dim * pl, 1 << bits
        sizes = rng.integers(0, max_list + 1, size=n_lists)
        sizes[0], sizes[1], sizes[2] = max_list, 0, 5
        ids = np.full((n_lists, max_list), -1, np.int32)
        nxt = 0
        for l_, s in enumerate(sizes):
            ids[l_, :s] = np.arange(nxt, nxt + s)
            nxt += s
        ids[3, 1] = -1  # a hole inside a list
        codes = rng.integers(0, n_codes, size=(n_lists, max_list, pq_dim)
                             ).astype(np.uint8)
        books = rng.normal(size=(n_lists if pc else pq_dim, n_codes, pl)
                           ).astype(np.float32)
        q = rng.normal(size=(nq, rot)).astype(np.float32)
        cr = rng.normal(size=(n_lists, rot)).astype(np.float32)
        w = 1.0 / np.arange(1, n_lists + 1) if cap > 128 else \
            np.ones(n_lists)
        probes = np.stack([rng.choice(n_lists, n_probes, replace=False,
                                      p=w / w.sum())
                           for _ in range(nq)]).astype(np.int32)
        t = [torch.from_numpy(x).to(dev) for x in (q, cr, books, codes,
                                                    ids, probes)]
        q_t, cr_t, books_t, codes_t, ids_t, probes_t = t
        norms_t = ivf_pq._norms_fn(pc)(codes_t, books_t, ids_t)
        qmap, inv_pos = _ivf_scan._invert_probes(probes_t, n_lists, cap)
        b, _ = scan_op.resolve_bins(bins, k, max_list)
        a = (q_t, cr_t, books_t, codes_t, norms_t, ids_t)
        rows.append(compare_case(
            f"pq {pq_dim}x{bits}b len {pl} k {k} bins {bins} cap {cap} "
            f"{'per_cluster' if pc else 'per_subspace'} {metric}", other,
            a, probes_t, inv_pos, qmap, cap, k, b, metric, pc, pc))
    return rows


def served(other, dev, n: int, reps: int, parts: dict) -> list:
    """The smoke's served IVF-PQ point and its two @f32 scans."""
    x, q, _ = cs.ann_dataset(n, cs.D, cs.N_QUERIES, 5, dev)
    index = ivf_pq.build(x, ivf_pq.IndexParams(
        n_lists=cs.PQ_LISTS, kmeans_n_iters=cs.KMEANS_ITERS,
        pq_bits=cs.PQ_BITS))
    del x
    params = ivf_pq.SearchParams(n_probes=cs.PQ_PROBES,
                                 rescore_factor=cs.RESCORE,
                                 lut_dtype=torch.float32)
    qb = q[:128].contiguous()
    _ivf_scan.resolve_cap(index.cap_cache, qb, index.centers, params,
                          cs.PQ_PROBES, index.n_lists)
    b = cs.probe_batch(index, q, cs.PQ_PROBES, "ab_pq_f32")
    q_rot = (b.qb @ index.rotation_matrix.T).contiguous()
    books, _ = ivf_pq._lut_books(index, torch.float32)
    norms = ivf_pq._ensure_code_norms(index, params, False, "l2")
    a = (q_rot, index.centers_rot, books, index.codes, norms,
         index.lists_indices)
    rows = []
    for k in (cs.K, cs.WIDE_K):
        route = ivf_pq._Route(index, k, params)
        bins, _ = scan_op.resolve_bins(route.bins, route.kk,
                                       index.codes.shape[1])
        row = compare_case(f"served kk={route.kk}", other, a, b.probes,
                           b.inv_pos, b.qmap, b.cap, route.kk, bins, "l2",
                           False, False)
        row.update(rows_n=n, kk=route.kk, bins=bins, cap=b.cap,
                   route="fused" if route.fused else "unfused")
        # (key, this tree's call, the other's): timed other, this, this,
        # other
        if route.fused:
            cand = other.fused_a(a, b.probes, b.inv_pos, b.qmap, b.cap,
                                 bins, "l2", False)
            turns = [
                ("", lambda: op.pq_scan_fused_cuda(
                    *a, b.probes, b.inv_pos, b.qmap, b.cap, route.kk, bins,
                    False, "l2", False, False),
                 lambda: other.fused(a, b.probes, b.inv_pos, b.qmap,
                                     b.cap, route.kk, bins, False, "l2",
                                     False)),
                ("pass_a_", lambda: this_fused_a(
                    a, b.probes, b.inv_pos, b.qmap, b.cap, bins, "l2",
                    False),
                 lambda: other.fused_a(a, b.probes, b.inv_pos, b.qmap,
                                       b.cap, bins, "l2", False))]
            row["pass_b_ms"] = ms(lambda: other.pass_b(*cand, route.kk,
                                                       False), reps)
            del cand
            row["parts_pass_a_ms"] = {name: ms(lambda fn=fn: this_fused_a(
                a, b.probes, b.inv_pos, b.qmap, b.cap, bins, "l2", False,
                fn), reps) for name, fn in parts.items()}
        else:
            turns = [("", lambda: op.pq_scan_cuda(*a, b.qmap, bins, "l2",
                                                  False, False, False),
                      lambda: other.unfused(a, b.qmap, bins, "l2", False,
                                            False))]
        for key, mine, theirs in turns:
            t = [ms(fn, reps) for fn in (theirs, mine, mine, theirs)]
            row[f"{key}ms"] = [t[1], t[2]]
            row[f"{key}other_ms"] = [t[0], t[3]]
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--parts", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, reports = _build.build_all(("ivf_pq_scan", "select_k"), verbose=True)
    tmp = tempfile.mkdtemp(prefix="raft_pq_f32_ab_")
    try:
        other = Other(args.parent, tmp)
        print(json.dumps({
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "ptxas": ptxas_lines("\n".join(reports.values()),
                                 ("pq_f32_kernel",)),
            "other_ptxas": other.ptxas}), flush=True)
        rows = ragged_cases(other, dev)
        parts = build_parts(tmp, PARTS) if args.parts else {}
        rows += served(other, dev, 1_000_000 if args.quick else
                       10_000_000, args.reps, parts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [r["case"] for r in rows if not r["bit_identical"]]
    print(json.dumps({"cases": len(rows), "bit_identical": len(rows) -
                      len(bad)}), flush=True)
    if bad:
        print(f"FAIL: outputs differ from the other tree's at {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

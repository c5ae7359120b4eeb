"""Times, on one CUDA card, the f32 ("highest") bodies of kernel 1
(``csrc/fused_l2_nn.cu``) and of kernels 5 and 6's pass A
(``csrc/fused_knn.cu``) at ``chip_smoke.py``'s shapes, beside the full-f32
product alone (``torch.mm`` with TF32 off: the card's f32 yardstick, not
the kernels' function). Given another tree's sources, it also builds that
tree's two bodies, holds their outputs to this tree's bit for bit (every
float compared as its 32 bits) at those shapes and at ragged ones, and
times both in turns (other, this, this, other).

    python3 tools/time_f32_bodies.py [--parent DIR] [--reps N] [--quick]

``DIR`` holds the other tree's ``fused_l2_nn.cu`` and ``fused_knn.cu``
with their headers, e.g. ``git archive <commit> raft_tpu_torch/csrc |
tar -x -C chip_parent`` and ``--parent chip_parent/raft_tpu_torch/csrc``;
they are compiled with ``nvcc`` into a temporary directory and called
through the same C interfaces. ``--quick`` keeps the ragged shapes and
cuts the 10M-row ones to 1M rows. Prints the card's name and power
limit, this tree's registers and spills of the two bodies, then one
JSON line a shape: ``ms`` (CUDA events, the median of ``--reps`` runs
after one warm-up), ``parent_ms``, ``bit_identical``, ``product_ms``
(``chip_smoke.product_ms``), the SM clock and power while timed, and the
fp32 bound (2mnd at 67 TFLOP/s). Exits non-zero if any shape differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import product_ms  # noqa: E402
from raft_tpu_torch.ops import _build  # noqa: E402
from raft_tpu_torch.ops import fused_knn as kop  # noqa: E402
from raft_tpu_torch.ops import fused_l2_nn as nop  # noqa: E402

FP32_FLOPS = 67e12
# (name, m, n, d): kernel 1 at the k-means and predict shapes of the
# IVF-Flat (1024 lists) and IVF-PQ (4096 lists) builds, then at ragged
# and narrow shapes (the spectral partition's 1M x 16 x 16)
NN_SHAPES = [("F EM", 262144, 1024, 128), ("F predict", 10_000_000, 1024, 128),
             ("PQ EM", 262144, 4096, 128),
             ("PQ predict", 10_000_000, 4096, 128),
             ("spectral", 1_048_576, 16, 16), ("one", 1, 1, 1),
             ("ragged", 129, 65, 17), ("ragged d", 257, 1000, 300)]
# (name, m, n, d, tn, l_bins, ip): kernel 5's pass A at main_bf's L2 shape
# (b 64), kernel 6's at wide_bf's (b 16), then ragged shapes through each
# epilogue (b 1, 2, 8, 128 and 192 in registers, 5 and 300 general)
KNN_SHAPES = [("k5 main_bf", 1000, 10_000_000, 128, 4096, 64, 0),
              ("k6 wide_bf", 1000, 10_000, 8192, 1024, 64, 0),
              ("k5 b1", 130, 5000, 17, 1000, 1000, 0),
              ("k5 b2 ip", 70, 3001, 64, 3000, 1500, 1),
              ("k5 b8", 129, 4097, 33, 4096, 512, 0),
              ("k5 b128", 40, 9000, 24, 4096, 32, 0),
              ("k5 b192", 33, 7000, 40, 3072, 16, 1),
              ("k5 b5", 50, 999, 16, 1000, 200, 0),
              ("k5 b300", 25, 7000, 40, 3000, 10, 0),
              ("k6 d4100", 130, 2100, 4100, 1024, 64, 0),
              ("k6 d4100 ip", 130, 2100, 4100, 1024, 64, 1)]


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


class Clocks:
    """``nvidia-smi`` sampling the SM clock and power draw every 100 ms
    while a shape is timed: the clock the FFMA pipes ran at, which the
    67 TFLOP/s bound assumes to be the 1980 MHz boost."""

    def __enter__(self):
        self.p = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.p.terminate()
        out, _ = self.p.communicate(timeout=30)
        vals = []
        for line in out.splitlines():
            try:
                mhz, watts = (float(v) for v in line.split(","))
            except ValueError:
                continue
            vals.append((mhz, watts))
        self.sm_mhz = sorted(v[0] for v in vals)[len(vals) // 2] \
            if vals else None
        self.power_w = max(v[1] for v in vals) if vals else None


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def build_parent(src_dir: str, out_dir: str) -> dict:
    """The other tree's two libraries, loaded, with their ptxas reports."""
    libs, procs = {}, {}
    for name in ("fused_l2_nn", "fused_knn"):
        out = os.path.join(out_dir, f"lib{name}_parent.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-I",
               src_dir, "-o", out, os.path.join(src_dir, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    for name, (p, out) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"nvcc failed for the other tree's {name}.cu:\n{text}")
        libs[name] = ctypes.CDLL(out)
    f = libs["fused_l2_nn"].raft_fused_l2_nn
    f.argtypes, f.restype = nop._F32.argtypes, ctypes.c_int
    g = libs["fused_knn"].raft_fused_knn_bins
    g.argtypes, g.restype = kop._BINS.argtypes, ctypes.c_int
    return {"nn": f, "bins": g}


def ptxas_lines(reports: dict) -> list:
    """Registers, shared memory and spills of the two bodies' kernels."""
    out, keep = [], False
    for text in reports.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                keep = ("knn_bins_kernel" in m.group(1)
                        or "fused_l2_nn_kernel" in m.group(1))
                if keep:
                    out.append(m.group(1))
            elif keep and ("registers" in line or "spill" in line):
                out.append(line.strip())
    return out


def rows(dev, m: int, d: int, seed: int) -> torch.Tensor:
    """A clustered mixture (64 normal centres plus unit noise)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = torch.randn((64, d), device=dev, generator=g) * 2.0
    out = torch.empty((m, d), device=dev)
    step = 1 << 20
    for s in range(0, m, step):
        e = min(m, s + step)
        lab = torch.randint(0, 64, (e - s,), device=dev, generator=g)
        out[s:e] = c[lab] + torch.randn((e - s, d), device=dev, generator=g)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, reports = _build.build_all(("fused_l2_nn", "fused_knn"), verbose=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "ptxas": ptxas_lines(reports)}), flush=True)
    tmp = tempfile.mkdtemp(prefix="raft_f32_parent_")
    parent = build_parent(args.parent, tmp) if args.parent else None
    stream = _build.stream_handle(dev)
    cut = (lambda n: min(n, 1_000_000)) if args.quick else (lambda n: n)
    bad = []

    for name, m, n, d in NN_SHAPES:
        m, n = cut(m), cut(n)
        x, y = rows(dev, m, d, 1), rows(dev, n, d, 2)
        xx = torch.empty(m, device=dev)
        yy = torch.empty(n, device=dev)

        def call(fn, x=x, y=y, xx=xx, yy=yy, m=m, n=n, d=d):
            idx = torch.empty(m, dtype=torch.int32, device=dev)
            dist = torch.empty(m, device=dev)
            _build.check(fn(x.data_ptr(), y.data_ptr(), xx.data_ptr(),
                            yy.data_ptr(), m, n, d, 0, idx.data_ptr(),
                            dist.data_ptr(), stream), name)
            return idx, dist

        row = nn_row(name, m, n, d, call, nop._F32, parent and parent["nn"],
                     args.reps, x, y)
        print(json.dumps(row), flush=True)
        bad += [name] if row.get("bit_identical") is False else []
        del x, y, xx, yy
        torch.cuda.empty_cache()

    for name, m, n, d, tn, l_bins, ip in KNN_SHAPES:
        n = cut(n)
        x, y = rows(dev, m, d, 3), rows(dev, n, d, 4)
        b = tn // l_bins
        nb = -(-n // b)
        kt = kop.KT if d > 4096 else 0
        xx = yy = None
        if not ip and not kt:
            xx, yy = (x * x).sum(1), (y * y).sum(1)

        def call(fn, x=x, y=y, xx=xx, yy=yy, m=m, n=n, d=d, tn=tn, b=b,
                 nb=nb, kt=kt, ip=ip):
            cd = torch.empty((m, nb), device=dev)
            ci = torch.empty((m, nb), dtype=torch.int32, device=dev)
            _build.check(fn(x.data_ptr(), y.data_ptr(),
                            None if xx is None else xx.data_ptr(),
                            None if yy is None else yy.data_ptr(), m, n, d,
                            tn, b, int(kt > 0), ip, nb, cd.data_ptr(),
                            ci.data_ptr(), stream), name)
            return ci, cd

        row = nn_row(name, m, n, d, call, kop._BINS,
                     parent and parent["bins"], args.reps, x, y)
        row.update(tn=tn, b=b, ip=ip, ktiled=bool(kt))
        print(json.dumps(row), flush=True)
        bad += [name] if row.get("bit_identical") is False else []
        del x, y, xx, yy
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    if bad:
        print(f"FAIL: outputs differ from the other tree's at {bad}",
              file=sys.stderr)
        return 1
    return 0


def nn_row(name, m, n, d, call, entry, parent_fn, reps, x, y) -> dict:
    """One shape's row: this tree's output (and the other's), the times
    in turns, the product yardstick and the bound."""
    mine = call(entry)
    torch.cuda.synchronize()
    row = {"shape": name, "m": m, "n": n, "d": d,
           "bound_ms": 2.0 * m * n * d / FP32_FLOPS * 1e3}
    big = m * n * d >= 1 << 30
    if parent_fn is not None:
        theirs = call(parent_fn)
        torch.cuda.synchronize()
        row["bit_identical"] = all(bits_equal(a, b)
                                   for a, b in zip(mine, theirs))
        del theirs
    del mine
    if big:
        t = []
        for fn in ((parent_fn, entry, entry, parent_fn) if parent_fn
                   else (entry, entry)):
            with Clocks() as clk:
                t.append(ms(lambda fn=fn: call(fn), reps))
            if fn is entry:
                row["sm_mhz"], row["power_w"] = clk.sm_mhz, clk.power_w
        if parent_fn is not None:
            row["parent_ms"] = [t[0], t[3]]
            row["ms"] = [t[1], t[2]]
        else:
            row["ms"] = t
        row["product_ms"] = product_ms(x, y)
    return row


if __name__ == "__main__":
    sys.exit(main())

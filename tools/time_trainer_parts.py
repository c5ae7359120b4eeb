"""Times, on one CUDA card, the parts of a balanced k-means sweep and of
the grouped PQ codebook trainer that changed when their float sums went
to a fixed order, each beside the form it replaced, and the two forms of
the bf16 product of the "reconstruct" scans. CUDA events, the median of
20 runs after 3 warm-ups.

    python3 tools/time_trainer_parts.py

Prints the card's name and power limit, then one JSON line a part:

* ``em_sums``: per-cluster sums and counts of the 262144-row sample at
  dim 128 into 1024 and 4096 clusters: ``index_add_`` (atomics, no fixed
  order) against ``util.segment.segment_sum`` (stable sort by label,
  ``segment_reduce``);
* ``em_reseed``: the reseed's highest-cost rows of the 262144 costs:
  ``torch.topk`` against ``ops._util.stable_topk_min`` (a stable sort);
* ``pq_chunk_sums``: one row chunk of the grouped PQ trainer (4096 rows
  x pq_dim 32 of pq_len 4 into 32 x 256 codewords; a 10M x 128 build
  runs 16 chunks a sweep, 10 sweeps): counts and sums by two
  ``index_add_``, against the trainer's form, the counts of 0/1 flags
  by ``index_add_`` (exact in any order) and the sums by
  ``segment_sum``;
* ``bf16_product``: one list chunk of the list-major reconstruct scan
  (64 lists, ``cap`` queries against 14416 bf16 rows of dim 128):
  bf16-rounded operands widened to f32 for an f32 ``bmm``, against
  ``torch.bmm`` of the bf16 operands into an f32 result
  (``out_dtype``), where this torch has it; the largest difference.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from raft_tpu_torch.ops._util import stable_topk_min  # noqa: E402
from raft_tpu_torch.util.segment import segment_sum  # noqa: E402


def ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def index_add_sums(x, labels, n):
    counts = torch.zeros(n, device=x.device).index_add_(
        0, labels, torch.ones(x.shape[0], device=x.device))
    sums = torch.zeros((n, x.shape[1]), device=x.device).index_add_(
        0, labels, x)
    return sums, counts


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((262144, 128), device=dev, generator=g)
    for n in (1024, 4096):
        lab = torch.randint(0, n, (x.shape[0],), device=dev, generator=g)
        print(json.dumps({
            "part": "em_sums", "rows": x.shape[0], "clusters": n,
            "index_add_ms": ms(lambda: index_add_sums(x, lab, n)),
            "segment_sum_ms": ms(lambda: segment_sum(x, lab, n))}))
        d = torch.rand(x.shape[0], device=dev, generator=g)
        print(json.dumps({
            "part": "em_reseed", "rows": x.shape[0], "k": n,
            "topk_ms": ms(lambda: torch.topk(d, n, largest=True,
                                             sorted=True)),
            "stable_sort_ms": ms(lambda: stable_topk_min(-d, n))}))

    pq_dim, pq_len, n_codes, chunk = 32, 4, 256, 4096
    xb = torch.randn((pq_dim * chunk, pq_len), device=dev, generator=g)
    vb = torch.ones(pq_dim * chunk, device=dev)
    slot = torch.randint(0, pq_dim * n_codes, (pq_dim * chunk,), device=dev,
                         generator=g)

    def pq_index_add():
        torch.zeros(pq_dim * n_codes, device=dev).index_add_(0, slot, vb)
        torch.zeros((pq_dim * n_codes, pq_len), device=dev).index_add_(
            0, slot, xb)

    def pq_trainer_form():
        torch.zeros(pq_dim * n_codes, device=dev).index_add_(0, slot, vb)
        segment_sum(xb, slot, pq_dim * n_codes)

    print(json.dumps({"part": "pq_chunk_sums", "rows": pq_dim * chunk,
                      "slots": pq_dim * n_codes, "per_build": 160,
                      "index_add_ms": ms(pq_index_add),
                      "trainer_ms": ms(pq_trainer_form)}))

    lists, rows, dim = 64, 14416, 128
    data = torch.randn((lists, rows, dim), device=dev,
                       generator=g).bfloat16()
    for cap in (8, 32, 128):
        q = torch.randn((lists, cap, dim), device=dev, generator=g)
        widened = lambda: q.bfloat16().float() @ data.float().transpose(1, 2)  # noqa: E731
        out = {"part": "bf16_product", "lists": lists, "cap": cap,
               "rows": rows, "dim": dim, "widened_f32_ms": ms(widened)}
        try:
            direct = lambda: torch.bmm(q.bfloat16(), data.transpose(1, 2),  # noqa: E731
                                       out_dtype=torch.float32)
            out["bmm_out_dtype_ms"] = ms(direct)
            out["max_abs_diff"] = float((direct() - widened()).abs().max())
        except (TypeError, RuntimeError, NotImplementedError) as e:
            out["bmm_out_dtype"] = f"unavailable: {type(e).__name__}: {e}"
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

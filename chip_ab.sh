#!/usr/bin/env bash
# Parent/change comparison of the smoke on one card, in one call:
#
#     bash chip_ab.sh PARENT_DIR [chip_smoke.py arguments ...]
#
# PARENT_DIR is a checkout of the parent commit (git archive). The script
# runs `python3 chip_smoke.py` from PARENT_DIR and from the tree holding
# this script in the order parent, change, change, parent (two runs of
# each tree give the spread between runs of one tree). Each run's output
# goes to $AB_OUT/ab_<n>_<tree>.log (AB_OUT defaults to ./chiprun_out),
# its profile files beside it as ab_<n>_<tree>_profile_*.txt; the card's
# name and power limit and each run's phase lines for the IVF paths, the
# brute-force batches and their kernels (pass B alone as select_k_payload,
# the IVF-PQ f32 body as ivf_pq_scan...@f32), and the pairwise phase (each
# name through kernel 7, the exact L1 scan) are printed.
set -u
parent=$(cd "$1" && pwd)
shift
change=$(cd "$(dirname "$0")" && pwd)
out=${AB_OUT:-$PWD/chiprun_out}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
n=0
for tree in parent change change parent; do
  n=$((n + 1))
  dir=$change
  [ "$tree" = parent ] && dir=$parent
  log=$out/ab_${n}_${tree}.log
  (cd "$dir" && python3 chip_smoke.py "$@") > "$log" 2>&1
  echo "run $n $tree rc=$?"
  for f in "$dir"/chiprun_out/profile_*.txt; do
    [ -e "$f" ] && mv "$f" "$out/ab_${n}_${tree}_$(basename "$f")"
  done
  grep -E '"phase": "(build|kmeans_tiers|main|wide_flat|main_flat_bf16|main_flat_int8|main_pq|pq_f32|main_bq|main_pq_pc|pq_scan_modes|main_bq_extend|kmeans_two_level|main_bf|wide_bf|pairwise|profile)"|"kernel": "(fused_l2_nn|ivf_flat_scan|ivf_list_scan|ivf_pq_scan|ivf_bq_scan|select_k|fused_knn)' \
    "$log" | cut -c1-700
  tail -n 2 "$log" | cut -c1-300
done

#!/bin/bash
# The runs that set a cell's bounds, on the card, in one call:
#   tunebench/tools/sets.sh <cell> <seconds> <seeds of a set, comma-separated> <traced seeds, comma-separated> [out]
# Two sets of the same seeds, one run a seed, then one traced run a traced
# seed. Each run's result line goes to <out>/<cell>.jsonl (with the set and
# seed), its standard error to <out>/<cell>.<set>.<seed>.err; <out> is
# tunebench_out/sets unless given.
cell=$1; secs=$2; seeds=${3//,/ }; traced=${4//,/ }
out=${5:-tunebench_out/sets}; mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # set seed trace
  t0=$SECONDS
  python3 tunebench/run.py --workload "$cell" --seed "$2" --seconds "$secs" --trace "$3" > $out/cur.out 2> "$out/$cell.$1.$2.err"
  rc=$?
  line=$(tail -n 1 $out/cur.out)
  [ $rc -eq 0 ] || line='{}'
  echo "{\"set\": \"$1\", \"seed\": $2, \"trace\": $3, \"rc\": $rc, \"wall_s\": $((SECONDS - t0)), \"result\": $line}" >> "$out/$cell.jsonl"
  echo "$cell set $1 seed $2 trace $3 rc $rc wall $((SECONDS - t0)) s: $(tail -n 4 "$out/$cell.$1.$2.err" | tr '\n' ' ')"
}
for s in A B; do for seed in $seeds; do run $s $seed 0; done; done
for seed in $traced; do run T $seed 1; done

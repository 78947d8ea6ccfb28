"""Spreads of a cell's sets (``tools/sets.sh``'s ``<cell>.jsonl``): per set and
metric the median and the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median, and every
run's numbers.

    python3 tunebench/tools/spreads.py tunebench_out/sets/<cell>.jsonl
"""
import json
import statistics
import sys


def main(path: str) -> None:
    runs = [json.loads(line) for line in open(path)]
    sets: dict = {}
    for r in runs:
        if r["trace"] == 0 and r["rc"] == 0:
            sets.setdefault(r["set"], []).append(r)
    for name, rs in sorted(sets.items()):
        print(f"set {name}: {len(rs)} runs, correct "
              f"{sum(r['result']['correct'] for r in rs)}")
        for m in rs[0]["result"]["metrics"]:
            v = [r["result"]["metrics"][m]["value"] for r in rs]
            q = statistics.quantiles(v, n=4)
            med = statistics.median(v)
            print(f"  {m}: median {med:.6f}, spread {(q[2] - q[0]) / med:.6f}"
                  f"; runs {', '.join(f'{x:.6f}' for x in v)}")
    for r in runs:
        res = r["result"]
        checks = res.get("checks", {})
        print(f"{r['set']} {r['seed']} trace {r['trace']} rc {r['rc']} wall "
              f"{r['wall_s']} correct {res.get('correct')} "
              + " ".join(f"{k}={c['value']:.3e}" for k, c in checks.items()))


if __name__ == "__main__":
    main(sys.argv[1])

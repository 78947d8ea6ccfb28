"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size, in one process:

    python3 tunebench/tools/readings.py --workload <cell> \
        --seeds s1,s2,... [--control 3] [--faults 3]

For every seed, the program's first updates (set-up's own calls through
``run_epoch``) against the plain reference: the sound readings. On the
first ``--control`` seeds, the control: the reference with its policy
network in bfloat16, in the program's place. On the first ``--faults``
seeds, the program with each fault of ``harness/faults.py`` planted. One
line a reading, then a JSON summary (the largest sound reading and the
smallest control and fault readings of each number)."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    args = p.parse_args()
    import torch

    from tunebench.harness import correct as C
    from tunebench.harness.bench import Cell
    from tunebench.harness.faults import PLANTS
    from tunebench.harness.inputs import make_inputs
    from tunebench.harness.system import build

    cell = Cell(args.workload, ROOT)
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []

    def program(seed, plant=None):
        inputs = make_inputs(cfg, traffic, seed, dev)
        cfgr = build(cfg, traffic, inputs, dev)
        undo = PLANTS[plant](cfgr) if plant else None
        try:
            prog = C.to_host(C.program_first_updates(cfgr, traffic))
        finally:
            if undo:
                undo()
        del cfgr
        _free()
        return inputs, prog

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        inputs, prog = program(seed)
        ref = C.reference_first_updates(cfg, traffic, inputs, dev)
        found = [("sound", C.compare(prog, ref, cfg))]
        if i < args.control:
            ctl = C.reference_first_updates(cfg, traffic, inputs, dev,
                                            policy_dtype=torch.bfloat16)
            found.append(("control", C.compare(ctl, ref, cfg)))
        if i < args.faults:
            for name in PLANTS:
                _, bad = program(seed, name)
                found.append((name, C.compare(bad, ref, cfg)))
        del inputs
        _free()
        for kind, nums in found:
            rows.append({"seed": seed, "kind": kind, **nums})
            print(f"{args.workload} seed {seed} {kind}: " + ", ".join(
                f"{k} {v:.6e}" for k, v in nums.items()), flush=True)
        print(f"  seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    summary = {}
    for k in ("loss_gap", "grad1_gap", "change_gap"):
        summary[k] = {"sound_max": max(r[k] for r in rows
                                       if r["kind"] == "sound")}
        for kind in {r["kind"] for r in rows} - {"sound"}:
            summary[k][f"{kind}_min"] = min(r[k] for r in rows
                                            if r["kind"] == kind)
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

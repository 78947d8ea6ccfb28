"""Run one cell of the benchmark of the PyTorch/CUDA port's tuner once.

    python3 tunebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the card(s) the cell asks
for. The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
and a traffic mix, both files under ``tunebench/``. The run:

1. makes its inputs from ``--seed`` (``harness/inputs.py``) and builds the
   system under test on them (``harness/system.py``);
2. set-up: drives the program's first three policy updates through
   ``Configurator.run_epoch`` (kept for the comparison), then the mix's
   ``warm_chunks`` chunks: the first two capture every program the window
   replays, the rest carry the fleet past the transient of its first
   updates, whose device time runs above the steady state's;
3. ``--trace 0``: calls ``run_epoch(K, records=...)`` back to back for
   ``--seconds`` and reports windows/s, the chunks' 95th percentile and
   the set-up time; ``--trace 1``: runs the mix's ``trace_chunks`` chunks
   untraced, then as many under ``torch.profiler``, and reports the
   per-layer metrics
   (``metrics/<name>.py``) with the device's busy and window seconds and a
   breakdown;
4. after the window frees the program and runs the plain reference
   (``reference/tuner_ref.py``) over the same first updates from the same
   inputs; ``correct`` is every compared number within its limit
   (``limits/<cell>.json``), printed beside it as the last lines of
   standard error and under ``checks``, the last key of the result line.

The result is the last line of standard output, one JSON object. Without a
card, with fewer than the cell asks for, or with JAX or the JAX package
loaded, the run exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``); since this
    module was imported elsewhere."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_START = time.perf_counter() - _process_age_s()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _card_facts() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi: not available"


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_shapes(cfg: dict, traffic: dict, inputs: dict) -> dict:
    """T, S, K, N, fmult and steps of the cell's windows."""
    from tunebench.costs import fleet_tick as ft

    tun = cfg["tuning"]
    configs = inputs["config_overrides"]
    from tunebench.reference.tuner_ref import load_levers

    levers = {lv["name"]: lv for lv in load_levers()}
    b = configs.get("batch_interval_s",
                    levers["batch_interval_s"]["default"])
    if "batch_interval_s" in tun["levers"]:
        T = ft.bucket(192)
    else:
        T = ft.episode_ticks(tun["window_s"], float(b))
    S = ft.lanes(T)
    fmult = any(name not in ("deploy_latency",)
                for evs in (inputs["faults"] or []) for name, _ in evs)
    return {"T": T, "S": S, "K": ft.head(S, T), "N": cfg["clusters"],
            "fmult": fmult, "steps": tun["steps_per_episode"]}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             *, log=print, plant=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result object.
    ``plant`` names a fault of ``harness/faults.py`` to break the program
    with (the tests' runs)."""
    import numpy as np
    import torch

    from tunebench.harness import correct as C
    from tunebench.harness.inputs import make_inputs
    from tunebench.harness.system import build

    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    K, records = traffic["updates_per_chunk"], traffic["records"]
    inputs = make_inputs(cfg, traffic, seed, dev)
    cfgr = build(cfg, traffic, inputs, dev)
    undo = None
    if plant is not None:
        from tunebench.harness.faults import PLANTS

        undo = PLANTS[plant](cfgr)
    N, S = cfg["clusters"], cfg["tuning"]["steps_per_episode"]

    # ---- set-up: the compared updates, then the warm chunks ----
    prog = C.to_host(C.program_first_updates(cfgr, traffic))

    def chunk():
        cfgr.run_epoch(K, records=records)

    for _ in range(int(traffic["warm_chunks"])):
        chunk()
    _sync(dev)
    from repro_torch.core.graphs import CAPTURE_COUNTS
    from repro_torch.kernels import fleet_scan, fleet_tick

    kernel = fleet_scan if traffic["window_impl"] == "scan" else fleet_tick
    captures0, launches0 = dict(CAPTURE_COUNTS), kernel.LAUNCHES
    shapes = launch_shapes(cfg, traffic, inputs)
    result: dict = {"correct": False, "attempted": 0, "failed": 0,
                    "metrics": {}}
    setup_s = time.perf_counter() - PROCESS_START

    # ---- the window ----
    if trace:
        from tunebench.harness.trace import breakdown, profile_chunks

        n = int(traffic["trace_chunks"])
        tr = profile_chunks(chunk, n, K, shapes, cfgr, dev)
        chunks = 2 * n          # untraced, then traced
        for m in cell.per_layer():
            value = cell.reader(m["name"])(tr)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value),
                                                "unit": m["unit"]}
        busy = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        result["breakdown"] = breakdown(tr)
        log(f"traced: {n} chunks in {tr.window_s:.6f} s, busy "
            f"{busy['busy_s']:.6f} s; {n} chunks untraced just before "
            f"{tr.untraced_s:.6f} s (the profiler's slowdown "
            f"{tr.window_s / max(tr.untraced_s, 1e-12):.3f}x)")
    else:
        times = []
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            chunk()
            b = time.perf_counter()
            times.append(b - a)
            if b - t0 >= seconds:
                break
        chunks = len(times)
        window = b - t0
        values = {"windows_per_s": N * S * K * chunks / window,
                  "chunk_p95_ms": float(np.percentile(times, 95)) * 1000.0,
                  "setup_s": setup_s}
        for m in cell.end_to_end():
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
        busy = {}
        tenths = [float(np.median(t)) * 1e3 for t in
                  np.array_split(np.array(times), min(10, len(times)))]
        log(f"window: {chunks} chunks in {window:.6f} s, chunk median "
            f"{float(np.median(times)) * 1e3:.3f} ms (by tenths of the "
            f"window {', '.join(f'{x:.3f}' for x in tenths)}), min "
            f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}; set-up "
            f"{setup_s:.3f} s")
    result["attempted"] = chunks
    flat = dict(CAPTURE_COUNTS) == captures0
    launched = kernel.LAUNCHES - launches0
    log(f"counts: CAPTURE_COUNTS {'flat' if flat else 'GREW'} over the "
        f"window ({sum(captures0.values())} captures in {len(captures0)} "
        f"programs); {kernel.__name__.rsplit('.', 1)[1]} launches "
        f"{launched}, updates x steps {chunks * K * S}"
        f" ({'equal' if launched == chunks * K * S else 'DIFFERENT'})")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(dev),
                            "count": 1, "memory_peak_bytes": int(peak),
                            **busy}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0, **busy}

    # ---- the comparison, after the program is freed ----
    if undo is not None:
        undo()
    del cfgr, chunk
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = C.reference_first_updates(cfg, traffic, inputs, dev)
    numbers = C.compare(prog, ref, cfg)
    log(f"reference: {traffic['compare_updates']} updates in "
        f"{time.perf_counter() - t_ref:.3f} s; losses program "
        f"{prog['losses']}, reference {ref['losses']}")
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from tunebench.harness.bench import Cell

    cell = Cell(args.workload, ROOT)
    import torch

    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"tunebench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    log = lambda s: print(s, file=sys.stderr, flush=True)
    log(f"tunebench {args.workload} seed {args.seed}: {_card_facts()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", log=log)
    found = forbidden_modules()
    if found:
        print(f"tunebench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        log(f"{name} {c['value']:.6e} limit {c['limit']:.6e}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One chip_smoke.py phase, in fresh processes, over checkouts alternated on
one card.

    python3 tools/phase_ab.py [--phase NAME] [--kwargs JSON] ROOT [ROOT ...]

Each ROOT is a checkout of this repo (``.`` for this one). Needs one CUDA
card and nvcc (see src/repro_torch/kernels/build.py). For each ROOT, in the
order given, a fresh process runs that checkout's own chip_smoke.py phase
``NAME`` (default ``phase_main``: 3 ``run_update``s at N=1024 with their
launch count, 10 steady ones and a profiled one) with the keyword arguments
``JSON``, building its kernels from its own sources. Give the roots as
A B B A so that a drift of the card or the host falls on both alike. It
prints each run's lines, then, for ``phase_main``, one line per run with
its steady windows/s and median seconds an update, for ``phase_ssd`` one
line per run with the SSD kernel's time at each zamba2 shape (the device
time where the checkout's phase measures one, else its host loop), for
``phase_tuner`` one line per run with each ``lasso_cd`` case's device time
and analyse's seconds, for ``phase_chaos`` one line per run with the chaos
and clean arms' windows/s and the two shield arms' windows/s and breach
rates, for ``phase_graphs`` one line per run with each schedule's
windows/s (sequential, pipelined, the epoch in its three records modes),
for ``phase_serve_plane`` one line per run with its cycles/s and median
seconds a cycle, and the card's name and power limit. Example: the RWKV-6
path on another seed, ``--phase phase_rwkv --kwargs '{"seed": 1}' .``
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

RUN = ("import json, sys, torch; sys.path.insert(0, 'src'); "
       "import chip_smoke as cs; "
       "getattr(cs, sys.argv[1])(torch.device('cuda'), cs._gpu_facts(), "
       "**json.loads(sys.argv[2]))")
STEADY = re.compile(r"= ([\d.]+) windows/s; per update min [\d.]+, median "
                    r"([\d.]+)")
#: phase_ssd's zamba2 lines: the check line (chunk, dtype), then the time
#: line, "kernel 2.37 ms" (host loop) or "kernel device 0.83 ms (host loop
#: 0.84 ms)"
SSD = re.compile(r"zamba2-mixer .*? chunk=(\d+) (\w+) vs chunked.*\n\s+kernel "
                 r"(device )?([\d.]+) ms(?: \(host loop ([\d.]+) ms\))?")
#: phase_tuner's lines: each Lasso case (label, p, then its device time on
#: the next line) and analyse's split
LASSO = re.compile(r"lasso_cd (.*?) p=(\d+) .*\n\s+kernel device ([\d.]+) ms")
#: phase_chaos's summary line
CHAOS = re.compile(r"chaos summary: chaos ([\d.]+) windows/s, clean ([\d.]+) "
                   r"windows/s, unshielded ([\d.]+) windows/s breach rate "
                   r"([\d.]+), shielded ([\d.]+) windows/s breach rate "
                   r"([\d.]+)")
#: phase_graphs's per-mode lines: mode, then its windows/s over the chunks
GRAPHS = re.compile(r"^  (seq|pipe2|full|summary|off)\s*: \d+ windows in "
                    r"[\d.]+ s = ([\d.]+) windows/s", re.M)
ANALYSE = re.compile(r"  analyse: ([\d.]+) s \(FA ([\d.]+), k-means ([\d.]+), "
                     r"Lasso ([\d.]+)\)")
#: phase_serve_plane's card-scale service line
SERVE = re.compile(r"(\d+) cycles at shadow N=(\d+).*? = ([\d.]+) cycles/s; "
                   r"per cycle min [\d.]+, median ([\d.]+)")


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", default="phase_main")
    ap.add_argument("--kwargs", default="{}")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    json.loads(args.kwargs)
    facts = cs._gpu_facts()
    rows, ssd, tuner, chaos, graphs, serve = [], [], [], [], [], []
    for i, root in enumerate(args.roots):
        path = Path(root).resolve()
        env = dict(os.environ, PYTHONPATH=str(path / "src"))
        proc = subprocess.run(
            [sys.executable, "-c", RUN, args.phase, args.kwargs], cwd=path,
            env=env, capture_output=True, text=True, timeout=900)
        print(f"[run {i + 1}: {root} {args.phase} {args.kwargs}] exit "
              f"{proc.returncode}")
        for line in proc.stdout.splitlines():
            print(f"  {line}")
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        m = STEADY.search(proc.stdout)
        if m is not None:
            rows.append((i + 1, root, float(m.group(1)), float(m.group(2))))
        for m in SSD.finditer(proc.stdout):
            dev, ms, host = m.group(3), m.group(4), m.group(5) or m.group(4)
            ssd.append(f"  run {i + 1} {root}: {m.group(2)} chunk "
                       f"{m.group(1)}: " + (f"device {ms} ms, " if dev else "")
                       + f"host loop {host} ms")
        cases = [f"{m.group(1)} p={m.group(2)} {m.group(3)} ms"
                 for m in LASSO.finditer(proc.stdout)]
        m = CHAOS.search(proc.stdout)
        if m is not None:
            chaos.append(f"  run {i + 1} {root}: chaos {m.group(1)}, clean "
                         f"{m.group(2)} windows/s; unshielded {m.group(3)} "
                         f"windows/s, breach rate {m.group(4)}; shielded "
                         f"{m.group(5)} windows/s, breach rate {m.group(6)}")
        modes = [f"{m.group(1)} {m.group(2)}"
                 for m in GRAPHS.finditer(proc.stdout)]
        if modes:
            graphs.append(f"  run {i + 1} {root}: " + ", ".join(modes))
        m = SERVE.search(proc.stdout)
        if m is not None:
            serve.append(f"  run {i + 1} {root}: {m.group(3)} cycles/s over "
                         f"{m.group(1)} cycles at N={m.group(2)}, median "
                         f"{m.group(4)} s a cycle")
        m = ANALYSE.search(proc.stdout)
        if cases or m:
            tuner.append(f"  run {i + 1} {root}: lasso_cd " + "; ".join(cases)
                         + (f"; analyse {m.group(1)} s (FA {m.group(2)}, "
                            f"k-means {m.group(3)}, Lasso {m.group(4)})"
                            if m else ""))
    if rows:
        print(f"steady windows/s at N=1024 [{facts}]:")
        for i, root, rate, med in rows:
            print(f"  run {i} {root}: {rate} windows/s, median {med} s an "
                  f"update")
    if ssd:
        print(f"SSD kernel at zamba2-2.7b's mixer shape [{facts}]:")
        print("\n".join(ssd))
    if tuner:
        print(f"lasso_cd device time and analyse at N=80 [{facts}]:")
        print("\n".join(tuner))
    if chaos:
        print(f"chaos and shield arms at N=1024 [{facts}]:")
        print("\n".join(chaos))
    if graphs:
        print(f"the fused loop's schedules at N=1024, windows/s [{facts}]:")
        print("\n".join(graphs))
    if serve:
        print(f"the serve control plane [{facts}]:")
        print("\n".join(serve))
    print(f"[{facts}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

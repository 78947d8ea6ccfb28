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
its steady windows/s and median seconds an update, and the card's name and
power limit. Example: the RWKV-6 path on another seed,
``--phase phase_rwkv --kwargs '{"seed": 1}' .``
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


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", default="phase_main")
    ap.add_argument("--kwargs", default="{}")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    json.loads(args.kwargs)
    facts = cs._gpu_facts()
    rows = []
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
    if rows:
        print(f"steady windows/s at N=1024 [{facts}]:")
        for i, root, rate, med in rows:
            print(f"  run {i} {root}: {rate} windows/s, median {med} s an "
                  f"update")
    print(f"[{facts}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

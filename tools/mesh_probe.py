"""Time the fused tuning loop with its cluster axis sharded over R cards
(NCCL, one rank a card, captured graphs) against one card unsharded.

    python3 tools/mesh_probe.py [--ranks R] [--n N [N ...]]

Each fleet is chip_smoke.py's phase-4 configuration at N clusters (10
nodes, 109 levers, 5 steps of 240 s windows, bins frozen). For each N it
first runs the unsharded loop on card 0 in this process (MESH_UPDATES
checked updates, then MESH_STEADY timed ones), then R spawned ranks run the
same configuration sharded over an R-rank fleet mesh: their parameters,
records and configs must be equal on every rank, their launch and
collective counts as the code counts them. It prints windows/s of both,
the median update, and rank 0's host split of two sharded updates under
cProfile (every rank materialises the whole fleet's records). Needs R
cards; ``--ranks 1`` runs a 1-rank mesh.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def _rank(rank: int, world: int, sizes: list, facts: str) -> dict:
    from repro_torch.distribution.sharding import fleet_mesh

    dev = torch.device("cuda", rank)
    mesh = fleet_mesh()
    out = {}
    for N in sizes:
        cfgr = cs._mesh_cfgr(N, mesh, device=dev)
        run = cs._mesh_run(cfgr, cs.MESH_UPDATES)
        rate, med = cs._mesh_steady({"mesh": cfgr})["mesh"]
        # every rank runs the same updates; rank 0 prints its split
        with contextlib.redirect_stdout(sys.stdout if rank == 0
                                        else io.StringIO()):
            cs._host_split(cfgr, 2, facts, top=8)
        out[N] = {"rate": rate, "median_update_s": med,
                  "counts": run["counts"], "collectives": run["collectives"],
                  "captured": run["captured"], "programs": run["programs"],
                  "rewards": np.array(run["state"]["rewards"]),
                  "configs": run["state"]["configs"],
                  "params": {k: v.numpy()
                             for k, v in run["state"]["params"].items()}}
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=torch.cuda.device_count())
    ap.add_argument("--n", type=int, nargs="+", default=[1024, 4096])
    args = ap.parse_args(argv)
    facts = cs._gpu_facts()
    R = args.ranks
    print(f"{R} rank(s) on {torch.cuda.device_count()} card(s): "
          f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))} [{facts}]")
    mods = cs._kernel_mods()
    mods["fleet_tick"]._library()
    base = {}
    for N in args.n:
        cfgr = cs._mesh_cfgr(N, "off", device=torch.device("cuda", 0))
        t0 = time.perf_counter()
        cs._mesh_run(cfgr, cs.MESH_UPDATES)
        base[N] = cs._mesh_steady({"one": cfgr})["one"]
        print(f"  N={N} one card unsharded: {base[N][0]:.1f} windows/s, "
              f"median update {base[N][1]:.6f} s (set-up and checked updates "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        del cfgr
        cs._free()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = cs._mesh_group(_rank, R, "nccl", Path(tmp), args.n, facts)
    for N in args.n:
        r0 = ranks[0][N]
        for r, res in enumerate(ranks[1:], 1):
            got = res[N]
            same = (np.array_equal(got["rewards"], r0["rewards"])
                    and got["configs"] == r0["configs"]
                    and all(np.array_equal(got["params"][k], r0["params"][k])
                            for k in r0["params"]))
            if not same:
                raise AssertionError(f"N={N}: rank {r} differs from rank 0")
        want = 1 + cs.MESH_UPDATES * cs.MESH_S
        if any(res[N]["counts"]["fleet_tick"] != want for res in ranks):
            raise AssertionError(f"N={N}: fleet_tick launches "
                                 f"{[res[N]['counts'] for res in ranks]}")
        rates = [res[N]["rate"] for res in ranks]
        print(f"  N={N} sharded over {R} cards ({N // R} clusters a rank): "
              f"records, configs and parameters equal on every rank; "
              f"{r0['captured']} of {r0['programs']} programs captured; "
              f"fleet_tick launches {want} a rank; "
              f"{r0['collectives'] / cs.MESH_UPDATES:.1f} collectives an "
              f"update; windows/s by rank "
              f"{', '.join(f'{x:.1f}' for x in rates)}, median update "
              f"{r0['median_update_s']:.6f} s; against one card "
              f"{base[N][0]:.1f} ({rates[0] / base[N][0]:.4f}) [{facts}]")
    print(facts)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

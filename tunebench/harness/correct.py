"""What decides ``correct``: the program's first updates, driven from the seed
through the window's own entry, against the plain reference's.

Set-up drives the program's first ``compare_updates`` (three) policy
updates through ``Configurator.run_epoch(k, records=...)``, the call the
measured window makes, as one call of one update and one of the rest, and
keeps what they leave: each update's loss, the rmsprop state after the
first and the parameters after the last. After the window the plain
reference (``tunebench/reference/tuner_ref.py``) runs the same updates from
the same inputs, and three numbers are compared, each by its worst case:

* ``loss_gap``: each update's policy-gradient loss, the gap over the
  largest of the reference's losses (a single loss can lie near zero);
* ``grad1_gap``: the first gradient, as the optimizer got it (its rmsprop
  state after one step from zero, ``sqrt(nu / (1 - decay))``), per leaf the
  gap between the two norms over the larger of the reference's norm of that
  leaf and of the median leaf;
* ``change_gap``: the parameters' change over the updates, the same gap of
  norms per leaf.

Leaves whose reference gradient is under a thousandth of the median leaf's
take no part in the two norm gaps.
"""
from __future__ import annotations

import numpy as np
import torch

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of the norm gaps
QUIET_LEAF = 1e-3


def program_first_updates(cfgr, traffic: dict) -> dict:
    """The program's first updates through the window's entry, split into a
    first call of one update and a second of the rest."""
    n = int(traffic["compare_updates"])
    agent = cfgr.agent
    p0 = {k: v.detach().clone() for k, v in agent.params.items()}
    run = lambda k: cfgr.run_epoch(k, records=traffic["records"])
    stats = run(1)
    nu1 = {k: v.detach().clone() for k, v in agent.opt_state["nu"].items()}
    stats += run(n - 1)
    return {"losses": [s["pg_loss"] for s in stats], "nu1": nu1,
            "params0": p0,
            "params": {k: v.detach().clone() for k, v in agent.params.items()}}


def to_host(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = to_host(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().to("cpu", torch.float64)
        else:
            out[k] = v
    return out


def reference_first_updates(cfg, traffic, inputs, device, *,
                            policy_dtype=torch.float32) -> dict:
    from tunebench.reference.draws import SeedDraws
    from tunebench.reference.tuner_ref import RefTuner

    ref = RefTuner(cfg, inputs, SeedDraws(inputs["draw_seed"], device),
                   device, policy_dtype=policy_dtype)
    return to_host(ref.run(int(traffic["compare_updates"])))


def _norm_gaps(got: dict, want: dict, keep: list) -> float:
    ng = {k: float(torch.linalg.vector_norm(got[k])) for k in keep}
    nw = {k: float(torch.linalg.vector_norm(want[k])) for k in keep}
    med = float(np.median(list(nw.values())))
    return max(abs(ng[k] - nw[k]) / max(nw[k], med) for k in keep)


def compare(prog: dict, ref: dict, cfg: dict) -> dict:
    """The compared numbers of a run (see the module docstring)."""
    decay = cfg["tuning"]["rmsprop"]["decay"]
    g_ref = ref["grad1"]
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in g_ref.items()}
    med = float(np.median(list(norms.values())))
    keep = [k for k, v in norms.items() if v >= QUIET_LEAF * med]
    g_prog = {k: torch.sqrt(v / (1.0 - decay)) for k, v in
              prog["nu1"].items()}
    d_prog = {k: prog["params"][k] - prog["params0"][k] for k in keep}
    d_ref = {k: ref["params"][k] - ref["params0"][k] for k in keep}
    losses = list(zip(prog["losses"], ref["losses"]))
    return {
        "loss_gap": max(abs(p - r) for p, r in losses)
        / max(abs(r) for _, r in losses),
        "grad1_gap": _norm_gaps(g_prog, g_ref, keep),
        "change_gap": _norm_gaps(d_prog, d_ref, keep),
    }

"""The system under test, built from a configuration, a traffic mix and the
run's inputs: the port's ``FleetEnv`` of simulated clusters (with its own
draw source), and the ``Configurator`` that runs Algorithm 1 on
it as the fused device loop.
"""
from __future__ import annotations


def _workload(w: dict):
    from repro_torch.data.workloads import (PoissonWorkload,
                                            SwitchingWorkload,
                                            TrapezoidWorkload,
                                            YahooAdsWorkload)

    k = w["kind"]
    if k == "poisson":
        return PoissonWorkload(w["lam"], w["event_size_mb"])
    if k == "trapezoid":
        return TrapezoidWorkload(peak=w["peak"], ramp_s=w["ramp_s"],
                                 plateau_s=w["plateau_s"], base=w["base"],
                                 event_size_mb=w["event_size_mb"])
    if k == "yahoo_ads":
        return YahooAdsWorkload(base_rate=w["base_rate"],
                                diurnal_amp=w["diurnal_amp"],
                                day_s=w["day_s"],
                                event_size_mb=w["event_size_mb"])
    if k == "switching":
        return SwitchingWorkload(a=_workload(w["a"]), b=_workload(w["b"]),
                                 period_s=w["period_s"])
    raise ValueError(f"workload kind {k!r}")


def _fault(name: str, p: list):
    from repro_torch.core import faults as F

    if name == "failure":
        return F.FailureFault(*p)
    if name == "backlog_shock":
        return F.BacklogShockFault(*p)
    if name == "straggler":
        return F.StragglerFault(*p)
    if name == "deploy_latency":
        return F.DeployLatencyFault(int(round(p[0])))
    raise ValueError(f"fault kind {name!r}")


def build(cfg: dict, traffic: dict, inputs: dict, device):
    """The configurator over the fleet, ready for its first epoch."""
    from repro_torch import configs as model_configs
    from repro_torch.core import Configurator
    from repro_torch.engine import FleetEnv, SimSpec

    for need in traffic.get("requires", ()):
        if not cfg.get(need):
            raise ValueError(f"traffic needs the configuration's {need!r}")
    sim = dict(cfg["sim"])
    sim["straggler_slow"] = tuple(sim["straggler_slow"])
    model = model_configs.get(cfg["model"]["name"])
    N = cfg["clusters"]
    faults = None
    if inputs["faults"] is not None:
        faults = [[_fault(name, p) for name, p in evs]
                  for evs in inputs["faults"]]
    env = FleetEnv([_workload(w) for w in inputs["roster"]], [model] * N,
                   spec=SimSpec(**sim), seeds=inputs["cluster_seeds"],
                   backend="torch", faults=faults, device=device,
                   window_impl=traffic["window_impl"])
    if inputs["config_overrides"]:
        for c in env.configs:
            c.update(inputs["config_overrides"])
        env.invalidate()
    tun = cfg["tuning"]
    bins = dict(tun["bins"])
    cfgr = Configurator(
        env, tun["metrics"], tun["levers"], f_exploit=tun["f_exploit"],
        gamma=tun["gamma"], lr=tun["lr"],
        steps_per_episode=tun["steps_per_episode"],
        window_s=tun["window_s"], reward_mode=tun["reward_mode"],
        slo_ms=tun["slo_ms"], slo_hinge_w=tun["slo_hinge_w"],
        slo_breach_w=tun["slo_breach_w"], seed=inputs["agent_seed"],
        bin_kw=bins, device_loop="on", mesh="off",
        safe=cfg.get("shield") is not None, shield_kw=cfg.get("shield"),
        device=device)
    agent = cfgr.agent
    # the program's own settings that the configuration states
    stated = {"f_warmup_updates": tun["f_warmup_updates"],
              "entropy_beta": tun["entropy_beta"]}
    for key, want in stated.items():
        if getattr(agent, key) != want:
            raise ValueError(f"the program runs {key}={getattr(agent, key)}"
                             f", the configuration states {want}")
    agent.load_reference_params(
        {k: v.detach().cpu().numpy() for k, v in inputs["policy"].items()})
    return cfgr

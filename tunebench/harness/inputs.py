"""The run's inputs, made from ``--seed`` and handed to both sides: the
roster of arrival processes (the configuration's mix, in an order drawn from
the seed), the clusters' seeds, the fault events, the seed of the draw
stream, and the policy's initial weights (made on the device).

Every seed gives the same set of workloads, faults and shapes; only their
order across clusters, the per-cluster seeds, the fault onsets within their
stated jitter, the draws and the initial weights change. The program draws
its random numbers from a stream whose seed it derives from the clusters'
seeds; ``draw_seed`` is that seed, worked out by the same rule, for the
reference to read the same stream.
"""
from __future__ import annotations

import numpy as np
import torch

#: the state encoder's node grid (rows, cols) for n nodes
def node_grid_shape(n_nodes: int) -> tuple[int, int]:
    rows = int(np.ceil(np.sqrt(n_nodes)))
    cols = int(np.ceil(n_nodes / rows))
    return rows, cols


def state_dim(cfg: dict) -> int:
    r, c = node_grid_shape(cfg["sim"]["n_nodes"])
    t = cfg["tuning"]
    return len(t["metrics"]) * r * c + len(t["levers"])


def engine_draw_seed(cluster_seeds) -> int:
    """The seed of the fleet engine's draw stream: the xor over clusters of
    seed * 0x9E3779B9 + index (uint64 arithmetic), kept to 31 bits."""
    s = np.asarray(cluster_seeds, np.uint64)
    mixed = s * np.uint64(0x9E3779B9) + np.arange(s.size, dtype=np.uint64)
    return int(np.bitwise_xor.reduce(mixed) & np.uint64(0x7FFFFFFF))


def _roster(cfg: dict, rng: np.random.Generator) -> list[dict]:
    mix = cfg["roster"]["mix"]
    kinds = cfg["roster"]["workloads"]
    n = cfg["clusters"]
    base = [dict(kinds[mix[i % len(mix)]]) for i in range(n)]
    return [base[i] for i in rng.permutation(n)]


def _faults(cfg: dict, rng: np.random.Generator):
    """Per-cluster fault events ``[(kind, params), ...]`` of the
    configuration's scenario: a correlated failure on the first
    ``fail_frac`` of the fleet, a backlog shock on the next quarter and a
    sustained straggler on the quarter after (onsets jittered by up to
    ``jitter_s``), and every cluster deploying ``deploy_delay`` windows
    late."""
    f = cfg.get("faults")
    if not f:
        return None
    n = cfg["clusters"]
    n_fail = max(1, int(round(f["fail_frac"] * n)))
    q = max(1, n // 4)
    t0, dur = f["t0_s"], f["duration_s"]
    events = [[] for _ in range(n)]
    for i in range(n):
        if i < n_fail:
            events[i].append(("failure", [t0, dur, f["slow_mult"]]))
        elif i < n_fail + q:
            events[i].append(("backlog_shock", [
                t0 + float(rng.uniform(0, f["jitter_s"])), dur,
                f["shock_mult"]]))
        elif i < n_fail + 2 * q:
            events[i].append(("straggler", [
                t0 + float(rng.uniform(0, f["jitter_s"])),
                f["straggler_span"] * dur, f["straggler_mult"]]))
        if f["deploy_delay"] > 0:
            events[i].append(("deploy_latency", [float(f["deploy_delay"])]))
    return events


def policy_weights(cfg: dict, seed: int, device) -> dict:
    """The policy MLP's initial weights in the reference layout
    ``{"w1" (D, H), "b1", "w2" (H, A), "b2"}``: N(0, 1/fan_in) weights and
    zero biases, drawn on ``device`` from a generator of ``seed``."""
    D, H = state_dim(cfg), cfg["tuning"]["hidden"]
    A = 2 * len(cfg["tuning"]["levers"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    w = torch.randn((D * H + H * A,), generator=gen, device=device)
    return {"w1": (w[:D * H].reshape(D, H) / np.sqrt(D)).contiguous(),
            "b1": torch.zeros(H, device=device),
            "w2": (w[D * H:].reshape(H, A) / np.sqrt(H)).contiguous(),
            "b2": torch.zeros(A, device=device)}


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    rng = np.random.default_rng(int(seed))
    roster = _roster(cfg, rng)
    faults = _faults(cfg, rng)
    cluster_seeds = [int(s) for s in rng.integers(0, 2 ** 31, cfg["clusters"])]
    draw_seed = engine_draw_seed(cluster_seeds)
    weight_seed = int(rng.integers(0, 2 ** 62))
    overrides = dict(cfg.get("config_overrides", {}))
    overrides.update(traffic.get("config_overrides", {}))
    return {"roster": roster, "faults": faults,
            "cluster_seeds": cluster_seeds, "draw_seed": draw_seed,
            "config_overrides": overrides, "agent_seed": int(seed % 2 ** 31),
            "policy": policy_weights(cfg, weight_seed, device)}

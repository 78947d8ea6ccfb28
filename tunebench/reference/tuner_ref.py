"""The plain reference of the tuner's fused loop: Algorithm 1 over a fleet of
simulated clusters, written out in plain PyTorch and NumPy, one eager op
after another, with the window's tick loop in torch ops.

It imports nothing of the program. From the run's inputs (the roster, the
clusters' seeds, the fault events, the draw source, the initial policy
weights) and the configuration's file it works out again everything the
program derives: the lever table and its per-bin coefficient tables, the
workload and fault tables, the model constants, the metric emission
factors, the first observation window, every episode step and every policy
update. The simulator's definition (the 109 levers, the 90 metrics'
loadings) is a frozen copy in ``data/``.

``RefTuner.run(n)`` returns what the benchmark compares: each update's
policy-gradient loss, the rmsprop state after the first update and the
parameters after the last. ``policy_dtype=torch.bfloat16`` runs the policy
network (its forward passes, and the loss the update differentiates) in
bfloat16: the control, which the comparison has to reject.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as Fn

DATA = Path(__file__).resolve().parent / "data"

PEAK_FLOPS = 197e12
TOKENS_PER_MB = 16.0
#: cap on latency lanes per tick
MAX_LAT_SAMPLES = 64
#: padded tick / emission-count ladder
SHAPE_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768,
                 1024)
EPISODE_E_BUCKETS = (1, 2, 4, 6, 8, 12, 16, 24, 32)
#: tick budget when the batch interval is itself tuned
TICK_BUDGET = 192
KIND_CLIP, KIND_WRAP, KIND_TOGGLE = 0, 1, 2
R2PI = float(np.sqrt(2.0 / np.pi))
SQRT2 = float(np.float32(np.sqrt(2.0)))

_REMAT = {"none": 1.0, "block": 1.12, "full": 1.35}
_KV_BLOCK = {64: 0.28, 128: 0.18, 256: 0.22, 512: 0.3}
_TP_COMPUTE = {4: 1.18, 8: 1.06, 16: 1.0, 32: 1.07}
_GRAD_COMP = {"int8": 0.55, "topk": 0.4}

#: packed service-model coefficient -> its value from one config
PACKERS = {
    "T_b": lambda c: float(c["batch_interval_s"]),
    "max_batch_events": lambda c: float(c["max_batch_events"]),
    "eff_block_q": lambda c: 1.0 if c["attn_block_q"] == 128 else 0.88,
    "eff_block_k": lambda c: 1.0 if c["attn_block_k"] == 128 else 0.9,
    "eff_dtype": lambda c: 1.0 if c["compute_dtype"] == "bf16" else 0.5,
    "remat": lambda c: _REMAT[c["remat_policy"]],
    "kv_pressure": lambda c: _KV_BLOCK[int(c["kv_block"])],
    "tp": lambda c: float(int(c["model_axis_size"])),
    "tp_compute": lambda c: _TP_COMPUTE[int(c["model_axis_size"])],
    "compression": lambda c: _GRAD_COMP.get(c["grad_compression"], 1.0),
    "mb": lambda c: float(int(c["microbatch_count"])),
    "expert_parallel": lambda c: bool(c["expert_parallel"]),
    "driver_memory_gb": lambda c: float(c["driver_memory_gb"]),
    "allocator_arena_mb": lambda c: float(c["allocator_arena_mb"]),
    "sink_partitions": lambda c: float(int(c["sink_partitions"])),
    "prefetch_depth": lambda c: float(max(int(c["prefetch_depth"]), 0)),
    "backup_tasks": lambda c: bool(c["backup_tasks"]),
    "straggler_timeout_s": lambda c: float(c["straggler_timeout_s"]),
    "failure_inject_frac": lambda c: float(c["failure_inject_frac"]),
    "max_inflight_batches": lambda c: float(c["max_inflight_batches"]),
    "emit_every": lambda c: max(1, int(round(
        60.0 / float(c["batch_interval_s"])))),
}
#: lever -> the packed coefficients it feeds
LEVER_TO_PACKED = {
    "batch_interval_s": ("T_b", "emit_every"),
    "max_batch_events": ("max_batch_events",),
    "attn_block_q": ("eff_block_q",),
    "attn_block_k": ("eff_block_k",),
    "compute_dtype": ("eff_dtype",),
    "remat_policy": ("remat",),
    "kv_block": ("kv_pressure",),
    "model_axis_size": ("tp", "tp_compute"),
    "grad_compression": ("compression",),
    "microbatch_count": ("mb",),
    "expert_parallel": ("expert_parallel",),
    "driver_memory_gb": ("driver_memory_gb",),
    "allocator_arena_mb": ("allocator_arena_mb",),
    "sink_partitions": ("sink_partitions",),
    "prefetch_depth": ("prefetch_depth",),
    "backup_tasks": ("backup_tasks",),
    "straggler_timeout_s": ("straggler_timeout_s",),
    "failure_inject_frac": ("failure_inject_frac",),
    "max_inflight_batches": ("max_inflight_batches",),
}
WORKLOAD_CODES = {"poisson": 0, "trapezoid": 1, "yahoo_ads": 2}
FAULT_CODES = {"straggler": 1, "failure": 2, "backlog_shock": 3,
               "deploy_latency": 4}


# --------------------------------------------------------------------------
# shape rules
# --------------------------------------------------------------------------

def bucket(n: int, ladder: tuple = SHAPE_BUCKETS) -> int:
    for b in ladder:
        if n <= b:
            return b
    return -256 * (-n // 256)


def lanes_per_tick(T: int, device: torch.device) -> int:
    """Latency lanes a tick: the full tile on a card (<= ~2k samples a
    window), the ~1k-sample tier on the CPU."""
    if device.type == "cuda":
        if T * MAX_LAT_SAMPLES <= 2048:
            return MAX_LAT_SAMPLES
        for s in (32, 16, 8):
            if T * s <= 2048:
                return s
        return 8
    s = 8
    while s * 2 <= MAX_LAT_SAMPLES and T * (s * 2) <= 1024:
        s *= 2
    return s


def p99_depth(T: int, S: int) -> int:
    return min(T * S, int(np.ceil(0.01 * (T * S - 1)))) + 2


def head_budget(S: int, p99_k: int) -> int:
    P = 1
    while P < S + p99_k:
        P *= 2
    return P - S


# --------------------------------------------------------------------------
# the simulated engine's definition and the tables derived from it
# --------------------------------------------------------------------------

def load_levers() -> list[dict]:
    return json.loads((DATA / "levers.json").read_text())["levers"]


def load_emission() -> dict:
    return json.loads((DATA / "emission.json").read_text())


def default_value(s: dict):
    if s["kind"] == "choice":
        return s["choices"][0] if s["default"] is None else s["default"]
    if s["kind"] == "bool":
        return bool(s["default"]) if s["default"] is not None else False
    d = s["default"] if s["default"] is not None else (s["lo"] + s["hi"]) / 2
    return int(round(d)) if s["kind"] == "int" else float(d)


class LeverTable:
    """The levers as a table over (lever, bin): ten equal bins over each
    continuous lever's range (in log space for log levers), a category
    index for choice and bool levers."""

    def __init__(self, levers: list[dict], n_bins: int):
        self.specs = levers
        self.names = [s["name"] for s in levers]
        self.index_of = {n: i for i, n in enumerate(self.names)}
        L = len(levers)
        self.n_valid = np.zeros(L, np.int64)
        self.kind_code = np.zeros(L, np.int64)
        self.edges = [None] * L
        for i, s in enumerate(levers):
            if s["kind"] == "bool":
                self.kind_code[i], self.n_valid[i] = KIND_TOGGLE, 2
            elif s["kind"] == "choice":
                self.kind_code[i] = KIND_WRAP
                self.n_valid[i] = len(s["choices"])
            else:
                lin = np.log if s["kind"] == "log" else (lambda x: x)
                self.edges[i] = np.linspace(lin(s["lo"]), lin(s["hi"]),
                                            n_bins + 1)
                self.kind_code[i], self.n_valid[i] = KIND_CLIP, n_bins

    def index_configs(self, configs: list[dict]) -> np.ndarray:
        N = len(configs)
        out = np.zeros((N, len(self.specs)), np.int64)
        for i, s in enumerate(self.specs):
            vals = [c[s["name"]] for c in configs]
            if s["kind"] == "bool":
                out[:, i] = [int(bool(v)) for v in vals]
            elif s["kind"] == "choice":
                out[:, i] = [s["choices"].index(v) for v in vals]
            else:
                e = self.edges[i]
                v = np.asarray(vals, float)
                if s["kind"] == "log":
                    v = np.log(np.clip(v, np.exp(e[0]), np.exp(e[-1])))
                else:
                    v = np.clip(v, e[0], e[-1])
                out[:, i] = np.clip(np.searchsorted(e, v, "right") - 1,
                                    0, self.n_valid[i] - 1)
        return out

    def value_of(self, li: int, b: int):
        s = self.specs[li]
        b = min(max(int(b), 0), int(self.n_valid[li]) - 1)
        if s["kind"] == "bool":
            return bool(b)
        if s["kind"] == "choice":
            return s["choices"][b]
        e = self.edges[li]
        mid = 0.5 * (e[b] + e[b + 1])
        v = float(np.exp(mid)) if s["kind"] == "log" else float(mid)
        return int(round(v)) if s["kind"] == "int" else v


def model_constants(m: dict) -> dict:
    """flops a token (twice the dense parameter count), K/V bytes a token,
    and the MoE flag, of a dense decoder's dimensions."""
    if m["family"] != "dense":
        raise ValueError(f"model family {m['family']!r}: the reference "
                         "counts dense decoders only")
    d = m["d_model"]
    hd = m["head_dim"] or d // m["num_heads"]
    nq, nkv = m["num_heads"], m["num_kv_heads"]
    attn = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
    if m["qkv_bias"]:
        attn += (nq + 2 * nkv) * hd
    block = attn + 3 * d * m["d_ff"] + 2 * d
    emb = m["vocab_size"] * d
    head = 0 if m["tie_embeddings"] else m["vocab_size"] * d
    params = int(m["num_layers"] * block + emb + head + d)
    return {"flops_per_tok": 2.0 * params,
            "kv_per_tok": float(m["num_layers"] * nkv * hd * 2 * 2),
            "is_moe": False}


# --------------------------------------------------------------------------
# arrival and fault laws
# --------------------------------------------------------------------------

def _w_params(w: dict) -> tuple[str, list, float]:
    k = w["kind"]
    if k == "poisson":
        return k, [w["lam"]], w["event_size_mb"]
    if k == "trapezoid":
        return k, [w["base"], w["peak"], w["ramp_s"], w["plateau_s"]], \
            w["event_size_mb"]
    if k == "yahoo_ads":
        return k, [w["base_rate"], w["diurnal_amp"], w["day_s"]], \
            w["event_size_mb"]
    raise ValueError(f"workload kind {k!r}")


def _rate_law(kind: str, p, t, where):
    if kind == "poisson":
        return p[..., 0] + 0.0 * t
    if kind == "trapezoid":
        base, peak, ramp, plateau = (p[..., i] for i in range(4))
        u = t % (2.0 * ramp + plateau)
        up = base + (peak - base) * u / ramp
        down = peak - (peak - base) * (u - ramp - plateau) / ramp
        return where(u < ramp, up, where(u < ramp + plateau, peak, down))
    if kind == "yahoo_ads":
        sin = torch.sin if isinstance(t, torch.Tensor) else np.sin
        return p[..., 0] * (1.0 + p[..., 1] * sin(2.0 * np.pi * t / p[..., 2]))
    raise ValueError(kind)


def host_rate(w: dict, t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One cluster's (rate, mean size) at host times ``t`` in float64."""
    if w["kind"] == "switching":
        ra, sa = host_rate(w["a"], t)
        rb, sb = host_rate(w["b"], t)
        is_a = (t // w["period_s"]) % 2 == 0
        return np.where(is_a, ra, rb), np.where(is_a, sa, sb)
    kind, p, size = _w_params(w)
    if kind == "poisson":
        rate = np.asarray(t) * 0.0 + p[0]
    else:
        rate = _rate_law(kind, np.asarray(p, float), np.asarray(t), np.where)
    return rate, np.asarray(t) * 0.0 + size


def workload_table(roster: list[dict], device) -> dict:
    n = len(roster)
    kind = np.zeros((2, n), np.int32)
    params = np.zeros((2, n, 4), np.float32)
    size = np.zeros((2, n), np.float32)
    period = np.full(n, np.inf, np.float32)
    for i, w in enumerate(roster):
        if w["kind"] == "switching":
            slots = (_w_params(w["a"]), _w_params(w["b"]))
            period[i] = w["period_s"]
        else:
            slots = (_w_params(w),) * 2
        for s, (k, p, sz) in enumerate(slots):
            kind[s, i] = WORKLOAD_CODES[k]
            params[s, i, :len(p)] = p
            size[s, i] = sz
    t = lambda x: torch.as_tensor(x, device=device)
    return {"kind_a": t(kind[0]), "params_a": t(params[0]),
            "size_a": t(size[0]), "kind_b": t(kind[1]),
            "params_b": t(params[1]), "size_b": t(size[1]),
            "period_s": t(period)}


def rate_grid(wl: dict, times) -> tuple[torch.Tensor, torch.Tensor]:
    """(rate, mean size) of every cluster at device ``times`` (..., N)."""
    t = torch.as_tensor(times, dtype=torch.float32)

    def leaf(kind, params):
        out = torch.zeros_like(t)
        for name, code in sorted(WORKLOAD_CODES.items(), key=lambda x: x[1]):
            out = torch.where(kind == code,
                              _rate_law(name, params, t, torch.where), out)
        return out

    ra = leaf(wl["kind_a"], wl["params_a"])
    rb = leaf(wl["kind_b"], wl["params_b"])
    use_a = (t // wl["period_s"]) % 2.0 < 0.5
    return (torch.where(use_a, ra, rb),
            torch.where(use_a, wl["size_a"], wl["size_b"]))


def _fault_law(code: int, p, t, xp):
    """(service multiplier, rate multiplier) of fault ``code``."""
    where = torch.where if xp is torch else np.where
    one = t * 0.0 + 1.0
    if code in (0, 4):
        return one, one
    if code == 1:
        on = (t >= p[..., 0]) & (t < p[..., 0] + p[..., 1])
        return where(on, p[..., 2], 1.0), one
    if code == 2:
        t0, dur, mult = p[..., 0], p[..., 1], p[..., 2]
        end = t0 + dur
        if xp is torch:
            tail = torch.clamp(0.5 * dur, min=1e-9)
            frac = torch.clamp(torch.clamp((t - end) / tail, min=0.0),
                               max=1.0)
        else:
            tail = np.maximum(0.5 * dur, 1e-9)
            frac = np.clip((t - end) / tail, 0.0, 1.0)
        decay = mult + (1.0 - mult) * frac
        out = where((t >= t0) & (t < end), mult,
                    where((t >= end) & (t < end + tail), decay, 1.0))
        return out, one
    if code == 3:
        on = (t >= p[..., 0]) & (t < p[..., 0] + p[..., 1])
        return one, where(on, p[..., 2], 1.0)
    raise ValueError(code)


def fault_table(events, n: int) -> tuple[np.ndarray, np.ndarray]:
    width = max([len(ev) for ev in events] + [1])
    kind = np.zeros((n, width), np.int32)
    params = np.zeros((n, width, 4), np.float32)
    for i, evs in enumerate(events):
        for e, (name, p) in enumerate(evs):
            kind[i, e] = FAULT_CODES[name]
            params[i, e, :len(p)] = p
    return kind, params


def host_fault_effects(kind, params, t: np.ndarray):
    slow = np.ones(np.broadcast_shapes(t.shape, kind[:, 0].shape))
    rate = np.ones_like(slow)
    for e in range(kind.shape[1]):
        s_e, r_e = np.ones_like(slow), np.ones_like(slow)
        for code in range(5):
            with np.errstate(invalid="ignore", divide="ignore"):
                s, r = _fault_law(code, params[:, e], t, np)
            s_e = np.where(kind[:, e] == code, s, s_e)
            r_e = np.where(kind[:, e] == code, r, r_e)
        slow, rate = slow * s_e, rate * r_e
    return slow, rate


def fault_grid(ft: dict, times) -> tuple[torch.Tensor, torch.Tensor]:
    t = torch.as_tensor(times, dtype=torch.float32)
    slow, rate = torch.ones_like(t), torch.ones_like(t)
    for e in range(ft["kind"].shape[1]):
        kind, p = ft["kind"][:, e], ft["params"][:, e]
        s_e, r_e = torch.ones_like(t), torch.ones_like(t)
        for code in range(5):
            s_k, r_k = _fault_law(code, p, t, torch)
            s_e = torch.where(kind == code, s_k, s_e)
            r_e = torch.where(kind == code, r_k, r_e)
        slow, rate = slow * s_e, rate * r_e
    return slow, rate


# --------------------------------------------------------------------------
# the service model and one window's queueing recurrence
# --------------------------------------------------------------------------

def _max(a, b):
    return torch.maximum(a, b) if isinstance(b, torch.Tensor) \
        else torch.clamp(a, min=b)


def service_terms(cc, mc, sim, chips, rate, ev_size, batch_events=None):
    T_b = cc["T_b"]
    if batch_events is None:
        batch_events = torch.minimum(rate * T_b, cc["max_batch_events"])
    tokens = batch_events * ev_size * TOKENS_PER_MB
    eff = sim["base_mfu"] * cc["eff_block_q"] * cc["eff_block_k"] \
        * cc["eff_dtype"]
    t_compute = tokens * mc["flops_per_tok"] * cc["remat"] \
        / (chips * PEAK_FLOPS * eff)
    kv_gb = tokens * mc["kv_per_tok"] / 1e9
    mem_frac = torch.clamp(kv_gb / (chips * sim["hbm_gb_per_chip"])
                           + cc["kv_pressure"], max=1.5)
    t_mem_penalty = 1.0 + torch.clamp(mem_frac - 1.0, min=0.0) * 2.0
    coll = sim["collective_frac"] * t_compute * (cc["tp"] / 16.0) ** 0.5
    coll = coll * cc["compression"]
    coll = coll / (1.0 + 0.45 * (cc["mb"] - 1.0))
    moe = mc["is_moe"] & (cc["expert_parallel"] != 0)
    t_compute = torch.where(moe, t_compute * 0.92, t_compute)
    coll = torch.where(moe, coll * 1.15, coll)
    t_compute = t_compute * cc["tp_compute"]
    ovh = sim["dispatch_overhead_s"] * (1.0 + 0.12 * (cc["mb"] - 1.0))
    ovh = ovh + sim["driver_gc_coeff"] / torch.clamp(
        cc["driver_memory_gb"], min=1.0) * 0.1
    ovh = ovh + 0.12 * torch.clamp(torch.log2(512.0 / torch.clamp(
        cc["allocator_arena_mb"], min=32.0)), min=0.0)
    sink = cc["sink_partitions"]
    ovh = ovh + 0.25 / torch.clamp(sink, min=1.0) + 0.004 * sink
    ovh = ovh * (0.45 + 0.55 / (1.0 + cc["prefetch_depth"]))
    service = ovh + t_compute * t_mem_penalty + coll
    zeros = torch.zeros_like(service)
    return {"service": service, "t_compute": t_compute * t_mem_penalty,
            "t_overhead": ovh, "t_collective": coll,
            "mem_frac": torch.clamp(mem_frac, max=1.0), "eff": eff + zeros}


def tick_consts(cc, mc, sim, chips) -> tuple:
    eff = sim["base_mfu"] * cc["eff_block_q"] * cc["eff_block_k"] \
        * cc["eff_dtype"]
    a0 = mc["flops_per_tok"] * cc["remat"] / (chips * PEAK_FLOPS * eff)
    moe = (mc["is_moe"] != 0) & (cc["expert_parallel"] != 0)
    a_comp = torch.where(moe, a0 * 0.92, a0) * cc["tp_compute"]
    c_coll = (a0 * sim["collective_frac"] * (cc["tp"] / 16.0) ** 0.5
              * cc["compression"] / (1.0 + 0.45 * (cc["mb"] - 1.0)))
    c_coll = torch.where(moe, c_coll * 1.15, c_coll)
    b_mem = mc["kv_per_tok"] / 1e9 / (chips * sim["hbm_gb_per_chip"])
    ovh = sim["dispatch_overhead_s"] * (1.0 + 0.12 * (cc["mb"] - 1.0))
    ovh = ovh + sim["driver_gc_coeff"] / torch.clamp(
        cc["driver_memory_gb"], min=1.0) * 0.1
    ovh = ovh + 0.12 * torch.clamp(torch.log2(512.0 / torch.clamp(
        cc["allocator_arena_mb"], min=32.0)), min=0.0)
    sink = cc["sink_partitions"]
    ovh = ovh + 0.25 / torch.clamp(sink, min=1.0) + 0.004 * sink
    ovh = ovh * (0.45 + 0.55 / (1.0 + cc["prefetch_depth"]))
    T_b = cc["T_b"]
    slow_cap = torch.clamp(1.0 + cc["straggler_timeout_s"]
                           / torch.clamp(T_b, min=1e-3), min=1.2)
    rows = [T_b, cc["max_batch_events"], a_comp, c_coll, b_mem,
            cc["kv_pressure"], ovh, slow_cap,
            (cc["backup_tasks"] != 0).to(a0.dtype),
            cc["failure_inject_frac"],
            torch.clamp(cc["max_inflight_batches"], min=1.0) * T_b]
    return tuple(r.to(torch.float32) for r in rows)


def _tick(backlog, sfree, rate, size, z, u_s, u_r, u_f, active, fm, cv,
          sim):
    (T_b, max_b, a_comp, c_coll, b_mem, kvp, ovh, slow_cap, backup,
     fail_frac, inflight) = cv
    slo, shi = sim["straggler_slow"]
    arrivals = rate * T_b * (1.0 + sim["noise"] * z)
    age = backlog / torch.clamp(rate, min=1.0)
    blg = backlog + torch.clamp(arrivals, min=0.0)
    blg = torch.minimum(blg, rate * sim["retention_s"])
    batch = torch.minimum(blg, max_b)
    tokens = batch * size * TOKENS_PER_MB
    mem_frac = torch.clamp(tokens * b_mem + kvp, max=1.5)
    pen = 1.0 + 2.0 * torch.clamp(mem_frac - 1.0, min=0.0)
    service = ovh + tokens * a_comp * pen + tokens * c_coll
    smask = u_s < sim["straggler_prob"]
    raw = slo + (shi - slo) * u_r
    slow = torch.where(smask, torch.where(backup != 0, 1.1,
                                          torch.minimum(raw, slow_cap)), 1.0)
    fmask = u_f < fail_frac
    slow = torch.where(fmask, slow * 2.0, slow)
    slow = slow * fm
    service = service * slow
    start_rel = torch.maximum(T_b, sfree)
    sfree_new = torch.minimum(start_rel + service, T_b + inflight) - T_b
    processed = torch.where(service <= T_b, batch, batch * (T_b / service))
    blg_after = torch.clamp(blg - processed, min=0.0)
    qd = (start_rel - T_b) + age
    act = active != 0
    carry = (torch.where(act, blg_after, backlog),
             torch.where(act, sfree_new, sfree))
    ys = (service, qd, batch, torch.where(act, processed, 0.0),
          smask.to(torch.float32), fmask.to(torch.float32), blg_after)
    return carry, ys


def _pair_sum(x):
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def window(backlog, sfree, cv, rate, size, z, u_s, u_r, u_f, active,
           u_wait, z2a, fmult, wmask, sim, p99_k):
    """The T-tick recurrence and the latency lanes of one window. Returns
    the carry, ys (7, T, N), stats (5, T, N) s and the ascending top-K head
    of the window's lanes (K, N) s."""
    T, S, N = u_wait.shape
    K = head_budget(S, p99_k)
    if fmult is None:
        fmult = torch.ones_like(rate)
    ys = []
    for t in range(T):
        (backlog, sfree), y = _tick(backlog, sfree, rate[t], size[t], z[t],
                                    u_s[t], u_r[t], u_f[t], active[t],
                                    fmult[t], cv, sim)
        ys.append(torch.stack(y))
    ys = torch.stack(ys, dim=1)
    uw, z2 = u_wait.transpose(0, 1), z2a.transpose(0, 1)     # (S, T, N)
    service, qd, batch = ys[0], ys[1], ys[2]
    lat = uw * cv[0] + qd + service * (1.0 + 0.1 * z2)
    n_s = torch.clamp(batch.to(torch.int32), 1, S)
    lane = torch.arange(S, device=uw.device)[:, None, None]
    valid = (lane < n_s) & (wmask > 0.0)
    lane_sum = _pair_sum(torch.where(valid, lat, 0.0))
    srt = torch.sort(torch.where(valid, lat, float("-inf")), dim=0).values
    base = S - n_s

    def q_at(q):
        pos = (n_s - 1).to(torch.float32) * (q / 100.0)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.ceil(pos).to(torch.int64)
        a = torch.gather(srt, 0, (base + lo)[None])[0]
        b = torch.gather(srt, 0, (base + hi)[None])[0]
        return a + (pos - lo.to(torch.float32)) * (b - a)

    stats = torch.stack([lane_sum, q_at(50.0), q_at(95.0), q_at(99.0),
                         srt[-1]])
    lanes = torch.sort(srt.reshape(S * T, N), dim=0).values
    if S * T < K:
        lanes = torch.cat([torch.full((K - S * T, N), float("-inf"),
                                      device=lanes.device), lanes])
    return (backlog, sfree), ys, stats, lanes[-K:]


def split16(bits):
    u_hi = ((bits >> 16).to(torch.float32) + 0.5) / 65536.0
    u_lo = ((bits & 0xFFFF).to(torch.float32) + 0.5) / 65536.0
    return u_hi, u_lo


def norm16(u):
    return SQRT2 * torch.special.erfinv(2.0 * u - 1.0)


def lerp_quantile(sorted_x, cnt, q: float):
    """q-th percentile of the first ``cnt`` of a descending (..., K) head."""
    pos = (cnt - 1).to(torch.float32) * (q / 100.0)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    ia, ib = cnt - 1 - lo, cnt - 1 - hi
    L = sorted_x.shape[-1]
    a = torch.gather(sorted_x, -1, ia.clamp(0, L - 1)[..., None])[..., 0]
    b = torch.gather(sorted_x, -1, ib.clamp(0, L - 1)[..., None])[..., 0]
    return a + (pos - lo) * (b - a)


# --------------------------------------------------------------------------
# the tuner
# --------------------------------------------------------------------------

class RefTuner:
    """Algorithm 1 on the fleet of ``inputs``, as ``cfg`` states it, on
    ``device``, drawing from ``draws`` (a fresh draw source of the run's
    seed)."""

    def __init__(self, cfg: dict, inputs: dict, draws, device, *,
                 policy_dtype=torch.float32):
        self.cfg = cfg
        self.dev = torch.device(device)
        self.draws = draws
        self.policy_dtype = policy_dtype
        sim = dict(cfg["sim"])
        sim["straggler_slow"] = tuple(sim["straggler_slow"])
        self.sim = sim
        tun = cfg["tuning"]
        self.tun = tun
        N = cfg["clusters"]
        self.N = N
        self.nodes = sim["n_nodes"]
        self.chips = (sim["n_nodes"] - 1) * sim["chips_per_worker"]
        f32 = dict(dtype=torch.float32, device=self.dev)
        i64 = dict(dtype=torch.int64, device=self.dev)

        # ---- levers, configs and the per-bin coefficient tables ----
        levers = load_levers()
        self.table = tab = LeverTable(levers, tun["bins"]["n_bins"])
        configs = [{s["name"]: default_value(s) for s in levers}
                   for _ in range(N)]
        for c in configs:
            c.update(inputs["config_overrides"])
        self.configs = configs
        self.ranked = torch.as_tensor(
            [tab.index_of[n] for n in tun["levers"]], **i64)
        self.n_valid = torch.as_tensor(tab.n_valid, **i64)
        self.kind_code = torch.as_tensor(tab.kind_code, **i64)
        self.reboot_f = torch.as_tensor(
            [1.0 if s["reboot"] else 0.0 for s in levers], **f32)
        self.rejit_f = torch.as_tensor(
            [1.0 if s["group"] in ("kernel", "memory", "parallel") else 0.0
             for s in levers], **f32)
        self.tabs, self.cc_pairs = {}, []
        for lever, keys in LEVER_TO_PACKED.items():
            li = tab.index_of[lever]
            vals = [tab.value_of(li, b) for b in range(int(tab.n_valid[li]))]
            for key in keys:
                self.tabs[key] = torch.as_tensor(
                    np.array([PACKERS[key]({lever: v}) for v in vals],
                             np.float32), **f32)
                self.cc_pairs.append((key, li))

        # ---- the fleet: workloads, faults, model, emission ----
        self.roster = inputs["roster"]
        self.wl = workload_table(self.roster, self.dev)
        mc = model_constants(cfg["model"])
        self.mc = {"flops_per_tok": torch.full((N,), mc["flops_per_tok"],
                                               **f32),
                   "kv_per_tok": torch.full((N,), mc["kv_per_tok"], **f32),
                   "is_moe": torch.zeros(N, dtype=torch.bool,
                                         device=self.dev)}
        self.faults = None
        self.R_max = 0
        if inputs["faults"] is not None:
            kind, params = fault_table(inputs["faults"], N)
            self.fault_np = (kind, params)
            dl = np.where(kind == FAULT_CODES["deploy_latency"],
                          np.round(params[..., 0]), 0.0)
            self.R_max = int(dl.max())
            self.delays = torch.as_tensor(
                np.clip(dl.max(axis=1).astype(np.int32), 0, self.R_max),
                **i64)
            if np.any((kind != 0) & (kind != FAULT_CODES["deploy_latency"])):
                self.faults = {"kind": torch.as_tensor(kind, device=self.dev),
                               "params": torch.as_tensor(params,
                                                         device=self.dev)}
        emc = load_emission()
        self.metric_names = emc["metrics"]
        speed = np.stack([1.0 + 0.03 * np.random.Generator(
            np.random.SFC64(s)).standard_normal(self.nodes)
            for s in inputs["cluster_seeds"]])
        scale = np.asarray(emc["scale"])
        drv = np.asarray(emc["is_driver"])
        F = speed[:, :, None] * scale[None, None, :]
        F[:, :, drv] = scale[drv]
        self.emit_F = F
        self.emc = emc
        self.node_noise = N <= 256
        self.sel = [self.metric_names.index(m) for m in tun["metrics"]]

        # ---- the policy and its optimizer state ----
        pw = inputs["policy"]
        self.params = {"l1.weight": pw["w1"].T.to(**f32).contiguous(),
                       "l1.bias": pw["b1"].to(**f32).clone(),
                       "l2.weight": pw["w2"].T.to(**f32).contiguous(),
                       "l2.bias": pw["b2"].to(**f32).clone()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.n_updates = 0

        # ---- geometry of the episode windows ----
        T_b = np.array([PACKERS["T_b"](c) for c in configs])
        need = int(np.max(np.round(tun["window_s"] / T_b)
                          + np.ceil(180.0 / T_b))) + 1
        if "batch_interval_s" in tun["levers"]:
            need = TICK_BUDGET
        self.T = bucket(need)
        self.E = bucket(int(np.ceil(tun["window_s"] / 60.0)) + 1,
                        EPISODE_E_BUCKETS)

    # ---------------------------------------------------------- emission
    def _emit(self, cols, F, cc, rg, sg, ys, reconfigs, etick, evalid,
              stats5):
        emc = self.emc
        W = torch.as_tensor(np.asarray(emc["W"])[:, cols],
                            dtype=torch.float32, device=self.dev)
        bias = torch.as_tensor(np.asarray(emc["bias"])[cols],
                               dtype=torch.float32, device=self.dev)
        noise_v = torch.as_tensor(np.asarray(emc["noise"])[cols],
                                  dtype=torch.float32, device=self.dev)
        M = len(cols)
        M_pad = M + (M % 2)
        lat_idx = [self.metric_names.index(m) for m in emc["latency_stats"]]
        q_idx = self.metric_names.index(emc["queue_metric"])
        service, qd, batch, _, smask_f, fmask_f, blg_e = ys
        E, N = etick.shape
        g = lambda a: torch.gather(a, 0, etick)
        srv_e, qd_e, batch_e = g(service), g(qd), g(batch)
        rho_e = srv_e / cc["T_b"]
        terms = service_terms(cc, self.mc, self.sim, self.chips, g(rg),
                              g(sg), batch_e)
        s_safe = torch.clamp(srv_e, min=1e-6)
        lvec = torch.stack([
            torch.clamp(rho_e, max=3.0) + 0.2 * torch.log1p(qd_e),
            torch.clamp(terms["t_compute"] / s_safe, max=1.0)
            * torch.clamp(rho_e, max=1.0),
            terms["mem_frac"],
            terms["t_collective"] / s_safe,
            terms["t_overhead"] / s_safe,
            terms["eff"] / self.sim["base_mfu"],
            g(smask_f) + g(fmask_f) + 0.1 * reconfigs[None, :],
            0.6 * torch.clamp(rho_e, max=1.0) + 0.4 * terms["eff"],
        ], dim=-1)
        base = torch.einsum("enf,fk->enk", lvec, W) + bias
        lead = (E, N, self.nodes if self.node_noise else 1)
        bits = self.draws.emit_bits(lead + (M_pad // 2,))
        noise = norm16(torch.cat(split16(bits), dim=-1))[..., :M]
        noisy = base[:, :, None, :] * (1.0 + noise * noise_v)
        ecnt = torch.clamp(evalid.sum(dim=0), min=1)
        emean = torch.where(evalid[:, :, None, None], noisy, 0.0).sum(dim=0) \
            / ecnt[:, None, None]
        per_node = F * emean
        ew = None
        for j, c in enumerate(cols):
            if c in lat_idx or c == q_idx:
                if ew is None:
                    ew = torch.where(evalid[:, :, None], stats5(g), 0.0).sum(
                        dim=0) / ecnt[:, None]
                    qmean = torch.where(evalid, g(blg_e), 0.0).sum(dim=0) \
                        / ecnt
                per_node[:, :, j] = (ew[:, lat_idx.index(c)] if c in lat_idx
                                     else qmean)[:, None]
        return per_node

    def _window_core(self, T, backlog, sfree, cv, rg, sg, tmask, wmask,
                     fmult):
        N = backlog.shape[0]
        S = lanes_per_tick(T, self.dev)
        tick = self.draws.tick_bits(T, N)
        u0, l0 = split16(tick[:, 0])
        u1, l1 = split16(tick[:, 1])
        u_wait, u_z = split16(self.draws.lane_bits(T, S, N))
        z2a = torch.abs(norm16(u_z))
        (backlog, sfree), ys, kstats, head = window(
            backlog, sfree, cv, rg, sg, norm16(u0), l0, u1, l1,
            tmask.to(torch.float32), u_wait, z2a, fmult,
            wmask.to(torch.float32), self.sim, p99_depth(T, S))
        n_s = torch.clamp(ys[2].to(torch.int32), 1, S)
        cnt = (n_s * wmask).sum(dim=0)
        lane_sum_ms = kstats[0] * 1000.0
        tickq_ms = kstats[1:] * 1000.0
        head_ms = head * 1000.0
        mean_ms = lane_sum_ms.sum(dim=0) / torch.clamp(cnt, min=1)
        top = torch.flip(head_ms.T, dims=(-1,))
        p99 = lerp_quantile(top, cnt, 99.0)

        def stats5(g):
            st = [g(lane_sum_ms) / g(n_s)] + [g(tickq_ms[i])
                                              for i in range(4)]
            return torch.stack(st, dim=-1)

        return (backlog, sfree), ys, mean_ms, p99, stats5

    # ------------------------------------------------------ first window
    def observe_first(self) -> tuple:
        """The fleet's first observation window from the default configs,
        as the host would step it (rates and faults in float64 on the
        host). Returns the starting carry of the first episode."""
        N, dev = self.N, self.dev
        f32 = dict(dtype=torch.float32, device=dev)
        win_s = float(self.tun["window_s"])
        packed = {k: np.array([f(c) for c in self.configs])
                  for k, f in PACKERS.items()}
        T_b = packed["T_b"]
        ee = packed["emit_every"].astype(np.int64)
        n_win = np.maximum(1, np.round(np.full(N, win_s) / T_b)).astype(
            np.int64)
        T = bucket(int(n_win.max()))
        forced = n_win < ee
        n_emit = n_win // ee + forced
        E = bucket(int(n_emit.max()), (1, 2, 4, 6) + SHAPE_BUCKETS)
        etick = np.where(forced[None, :], n_win[None, :] - 1,
                         (np.arange(E)[:, None] + 1) * ee[None, :] - 1)
        evalid = np.arange(E)[:, None] < n_emit[None, :]
        etick = np.clip(etick, 0, T - 1)
        clock = np.zeros(N)
        if all(w["kind"] == "poisson" for w in self.roster):
            rate_g = np.array([w["lam"] for w in self.roster])[None, :]
            size_g = np.array([w["event_size_mb"]
                               for w in self.roster])[None, :]
        else:
            times = clock[None, :] + np.arange(T)[:, None] * T_b[None, :]
            rate_g, size_g = np.empty((T, N)), np.empty((T, N))
            for i, w in enumerate(self.roster):
                rate_g[:, i], size_g[:, i] = host_rate(w, times[:, i])
        fmult = None
        if self.faults is not None:
            times = clock[None, :] + np.arange(T)[:, None] * T_b[None, :]
            f_slow, f_rate = host_fault_effects(*self.fault_np, times)
            rate_g = rate_g * f_rate
            fmult = torch.as_tensor(f_slow, **f32)
        backlog = torch.zeros(N, **f32)
        sfree = torch.zeros(N, **f32)
        cc = {k: torch.as_tensor(v, **f32) for k, v in packed.items()}
        cv = tick_consts(cc, self.mc, self.sim, self.chips)
        t_ax = torch.arange(T, device=dev)[:, None]
        n_ticks = torch.as_tensor(n_win, dtype=torch.int64, device=dev)
        tmask = t_ax < n_ticks[None, :]
        wmask = tmask & (t_ax >= 0)
        rg = torch.as_tensor(rate_g, **f32).expand(T, N)
        sg = torch.as_tensor(size_g, **f32).expand(T, N)
        (backlog, sfree), ys, _, _, stats5 = self._window_core(
            T, backlog, sfree, cv, rg, sg, tmask, wmask, fmult)
        clock = clock + n_win * T_b
        cols = list(range(len(self.metric_names)))
        F = torch.as_tensor(self.emit_F, **f32)
        per_node = self._emit(
            cols, F, cc, rg, sg, ys, torch.zeros(N, **f32),
            torch.as_tensor(etick, dtype=torch.int64, device=dev),
            torch.as_tensor(evalid, device=dev), stats5)
        per_node = per_node[:, :, torch.as_tensor(self.sel, device=dev)]
        config_idx = torch.as_tensor(self.table.index_configs(self.configs),
                                     dtype=torch.int64, device=dev)
        M = len(self.sel)
        carry = {"config_idx": config_idx, "backlog": backlog,
                 "sfree": sfree, "clock": torch.as_tensor(clock, **f32),
                 "last_service": torch.full((N,), -1.0, **f32),
                 "reconfigs": torch.zeros(N, **f32),
                 "lo": torch.full((M,), float("inf"), **f32),
                 "hi": torch.full((M,), float("-inf"), **f32),
                 "per_node": per_node}
        if self.R_max:
            carry["hist"] = config_idx[None].expand(self.R_max + 1, -1, -1)
        sh = self.cfg.get("shield")
        if sh is not None:
            carry["lkg"] = config_idx.clone()
            carry["radius"] = torch.full((N,), sh["trust_radius"],
                                         dtype=torch.int64, device=dev)
            carry["streak"] = torch.zeros(N, dtype=torch.int64, device=dev)
            carry["risk"] = torch.zeros(N, **f32)
        return carry

    # ------------------------------------------------------------ policy
    def _logits(self, params: dict, states):
        dt = self.policy_dtype
        x = states.to(dt)
        h = torch.tanh(Fn.linear(x, params["l1.weight"].to(dt),
                                 params["l1.bias"].to(dt)))
        return Fn.linear(h, params["l2.weight"].to(dt),
                         params["l2.bias"].to(dt)).to(torch.float32)

    @staticmethod
    def _pick(logits, g, f: float, exploit: bool):
        g_full, g_sub, u_gate = g
        full_a = torch.argmax(logits + g_full, dim=-1)
        if not exploit:
            return full_a
        sub_a = torch.argmax(logits[:, :2] + g_sub, dim=-1)
        return torch.where(u_gate < f, sub_a, full_a)

    def _step_index(self, cur, li, direction):
        nv = self.n_valid[li]
        code = self.kind_code[li]
        stepped = torch.minimum(torch.clamp(cur + direction, min=0), nv - 1)
        wrapped = (cur + direction) % nv
        return torch.where(code == KIND_TOGGLE, 1 - cur,
                           torch.where(code == KIND_WRAP, wrapped, stepped))

    # ----------------------------------------------------------- episode
    def episode(self, carry: dict, exploit: bool) -> tuple[dict, dict]:
        """One episode batch of S steps on every cluster from ``carry``.
        Returns the carry after it and the (N, S) outputs."""
        tun, sim, dev = self.tun, self.sim, self.dev
        S_steps = tun["steps_per_episode"]
        N, T, E = self.N, self.T, self.E
        f = float(tun["f_exploit"])
        slo = tun["reward_mode"] == "slo"
        slo_ms = float(tun["slo_ms"]) if slo else 0.0
        win_s = float(tun["window_s"])
        sh = self.cfg.get("shield")
        r, c = self._grid()
        rc = r * c
        M = len(self.sel)
        ranked, n_valid = self.ranked, self.n_valid
        F = torch.as_tensor(self.emit_F[:, :, np.asarray(self.sel)],
                            dtype=torch.float32, device=dev)
        t_ax = torch.arange(T, device=dev)[:, None]
        e_ax = torch.arange(E, device=dev)[:, None]
        S_lanes = lanes_per_tick(T, dev)

        config_idx = carry["config_idx"].clone()
        backlog, sfree, clock = carry["backlog"], carry["sfree"], \
            carry["clock"]
        last_service, reconfigs = carry["last_service"], carry["reconfigs"]
        lo, hi, per_node = carry["lo"], carry["hi"], carry["per_node"]
        hist = carry.get("hist")
        rows = torch.arange(N, device=dev)
        if sh is not None:
            lkg, radius, streak, risk = (carry["lkg"], carry["radius"],
                                         carry["streak"], carry["risk"])
            budget = torch.full((N,), sh["breach_budget"], dtype=torch.int64,
                                device=dev)
        frac_den = torch.clamp(n_valid[ranked].to(torch.float32) - 1.0,
                               min=1.0)
        outs: dict = {}
        for _ in range(S_steps):
            # ---- the state: per-node metrics over the fleet's range ----
            raw = per_node.permute(0, 2, 1)
            lo = torch.minimum(lo, raw.amin(dim=(0, 2)))
            hi = torch.maximum(hi, raw.amax(dim=(0, 2)))
            span = torch.where(hi > lo, hi - lo, 1.0)
            lo_eff = torch.where(torch.isfinite(lo), lo, 0.0)
            normed = torch.clamp(torch.nan_to_num(
                (raw - lo_eff[None, :, None]) / span[None, :, None]), 0.0, 1.0)
            grids = Fn.pad(normed, (0, rc - self.nodes))
            fracs = config_idx[:, ranked].to(torch.float32) / frac_den
            states = torch.cat([grids.reshape(N, M * rc), fracs],
                               dim=1).to(torch.float32)
            # ---- the action ----
            with torch.no_grad():
                logits = self._logits(self.params, states)
            g = self.draws.act(*logits.shape)
            if sh is not None:
                mask = self._shield_mask(config_idx, lkg, radius)
                a = self._pick(torch.where(mask, logits, -1e9), g, f, exploit)
                a_free = self._pick(logits, g, f, exploit)
                diverted = ~torch.gather(mask, 1, a_free[:, None])[:, 0]
            else:
                a = self._pick(logits, g, f, exploit)
            direction = 1 - 2 * (a % 2)
            l_idx = ranked[a // 2]
            cur = config_idx[rows, l_idx]
            new_bin = self._step_index(cur, l_idx, direction)
            if sh is not None:
                nv = n_valid[l_idx]
                lb = lkg[rows, l_idx]
                c_lo = torch.minimum(torch.clamp(lb - radius, min=0), nv - 1)
                c_hi = torch.minimum(torch.clamp(lb + radius, min=0), nv - 1)
                clamped = torch.minimum(torch.maximum(new_bin, c_lo), c_hi)
                sh_clamped = diverted | (clamped != new_bin)
                fallback = (risk > sh["risk_threshold"]) | (budget <= 0)
                config_idx[rows, l_idx] = clamped
                config_idx = torch.where(fallback[:, None], lkg, config_idx)
                new_bin = config_idx[rows, l_idx]
            else:
                config_idx[rows, l_idx] = new_bin
            eff_idx = config_idx
            if self.R_max:
                hist = torch.cat([config_idx[None], hist[:-1]], dim=0)
                eff_idx = hist[self.delays, rows]
            cc = {k: self.tabs[k][eff_idx[:, li]] for k, li in self.cc_pairs}
            # ---- loading: the engine buffers arrivals while it restarts --
            rate_now, _ = rate_grid(self.wl, clock)
            z = self.draws.load(N)
            load_s = (10.0 + 60.0 * self.reboot_f[l_idx]
                      + 8.0 * self.rejit_f[l_idx]) \
                * (1.0 + sim["noise"] * torch.abs(z))
            backlog = backlog + rate_now * load_s
            clock = clock + load_s
            sfree = torch.clamp(sfree - load_s, min=0.0)
            reconfigs = reconfigs + 1.0
            # ---- stabilisation wait from the change in service time ----
            rate_st, size_st = rate_grid(self.wl, clock)
            s_new = service_terms(cc, self.mc, sim, self.chips, rate_st,
                                  size_st)["service"]
            prev = torch.where(last_service < 0.0, s_new, last_service)
            rel = torch.abs(s_new - prev) / torch.clamp(prev, min=1e-6)
            stab = torch.clamp(30.0 + 240.0 * rel, 30.0, 180.0)
            last_service = s_new
            # ---- the preroll, the window and its statistics ----
            T_b = cc["T_b"]
            ee = torch.clamp(cc["emit_every"].to(torch.int64), min=1)
            n_win = torch.clamp(torch.round(win_s / T_b).to(torch.int64), 1,
                                T)
            n_skip = torch.minimum(torch.clamp(torch.round(
                stab / T_b).to(torch.int64), min=0), T - n_win)
            n_ticks = n_skip + n_win
            tmask = t_ax < n_ticks[None, :]
            wmask = tmask & (t_ax >= n_skip[None, :])
            cv = tick_consts(cc, self.mc, sim, self.chips)
            sfree = torch.clamp(sfree, min=0.0)
            times = clock[None, :] + t_ax.to(torch.float32) * T_b[None, :]
            rg, sg = rate_grid(self.wl, times)
            f_slow = None
            if self.faults is not None:
                f_slow, f_rate = fault_grid(self.faults, times)
                rg = rg * f_rate
            (backlog, sfree), ys, mean_ms, p99, stats5 = self._window_core(
                T, backlog, sfree, cv, rg, sg, tmask, wmask, f_slow)
            forced = n_win < ee
            n_emit = n_win // ee + forced
            etick = torch.where(forced[None, :],
                                n_skip[None, :] + n_win[None, :] - 1,
                                n_skip[None, :] + (e_ax + 1) * ee[None, :] - 1)
            etick = torch.clamp(etick, 0, T - 1)
            evalid = e_ax < n_emit[None, :]
            per_node = self._emit(self.sel, F, cc, rg, sg, ys, reconfigs,
                                  etick, evalid, stats5)
            clock = clock + n_ticks.to(torch.float32) * T_b
            # ---- the reward ----
            breach = None
            if slo:
                service, qd = ys[0], ys[1]
                tick_ms = ((qd + service) * 1000.0
                           + 0.5 * (T_b * 1000.0)[None, :]
                           + R2PI * (100.0 * service))
                breach = ((tick_ms > slo_ms) & wmask).sum(dim=0) \
                    / torch.clamp(wmask.sum(dim=0), min=1)
                reward = (-mean_ms / 1000.0
                          - tun["slo_hinge_w"] * torch.clamp(
                              p99 - slo_ms, min=0.0) / 1000.0
                          - tun["slo_breach_w"] * breach)
            elif tun["reward_mode"] == "neg_p99":
                reward = -p99 / 1000.0
            else:
                reward = -mean_ms / 1000.0
            step = {"states": states, "actions": a, "rewards": reward,
                    "p99_ms": p99}
            if sh is not None:
                alpha = torch.as_tensor(sh["risk_alpha"], dtype=torch.float32)
                breached = breach > 0.0
                risk = (1.0 - alpha) * risk + alpha * breach
                budget = budget - torch.where(breached, 1, 0)
                budget_out = budget <= 0
                streak2 = streak + 1
                expand = (~breached) & (streak2 >= sh["expand_every"]) \
                    & (~budget_out)
                radius = torch.where(
                    breached, torch.clamp(radius // 2, min=sh["radius_min"]),
                    torch.where(expand, torch.clamp(radius + 1,
                                                    max=sh["radius_max"]),
                                radius))
                streak = torch.where(breached | expand, 0, streak2)
                lkg = torch.where(breached[:, None], lkg, config_idx)
                step["shield_clamped"] = sh_clamped
                step["shield_fallback"] = fallback
            for k, v in step.items():
                outs.setdefault(k, []).append(v)
        outs = {k: torch.stack(v, dim=1) for k, v in outs.items()}
        carry = {"config_idx": config_idx, "backlog": backlog, "sfree": sfree,
                 "clock": clock, "last_service": last_service,
                 "reconfigs": reconfigs, "lo": lo, "hi": hi,
                 "per_node": per_node}
        if self.R_max:
            carry["hist"] = hist
        if sh is not None:
            carry.update(lkg=lkg, radius=radius, streak=streak, risk=risk)
        return carry, outs

    def _grid(self) -> tuple[int, int]:
        rows = int(np.ceil(np.sqrt(self.nodes)))
        return rows, int(np.ceil(self.nodes / rows))

    def _shield_mask(self, config_idx, lkg, radius):
        ranked = self.ranked
        nv = self.n_valid[ranked]
        cur = config_idx[:, ranked]
        lk = lkg[:, ranked]
        rr = radius[:, None]
        lo = torch.minimum(torch.clamp(lk - rr, min=0), nv - 1)
        hi = torch.minimum(torch.clamp(lk + rr, min=0), nv - 1)
        cand_p = self._step_index(cur, ranked, 1)
        cand_m = self._step_index(cur, ranked, -1)
        ok_p = (cand_p >= lo) & (cand_p <= hi)
        ok_m = (cand_m >= lo) & (cand_m <= hi)
        return torch.stack([ok_p, ok_m], dim=-1).reshape(cur.shape[0], -1)

    # ------------------------------------------------------------ update
    def _pg_loss(self, params, states, actions, adv):
        logp = torch.log_softmax(self._logits(params, states), dim=-1)
        chosen = torch.gather(logp, -1, actions[..., None])[..., 0]
        n = float(actions.numel())
        pg = -(chosen * adv).sum() / n
        ent = -(torch.exp(logp) * logp).sum(-1)
        return pg - self.tun["entropy_beta"] * (ent.sum() / n)

    def update(self, outs: dict) -> tuple[float, dict]:
        """One REINFORCE update with rmsprop on the batch ``outs``: returns,
        the per-step baseline over the episodes, scale-normalised
        advantages, the gradient of the loss, the step. Returns the loss at
        the new parameters and the gradient."""
        tun = self.tun
        rewards, actions, states = (outs["rewards"], outs["actions"],
                                    outs["states"])
        gamma = float(tun["gamma"])
        returns = torch.empty_like(rewards)
        acc = torch.zeros_like(rewards[:, 0])
        for t in range(rewards.shape[1] - 1, -1, -1):
            acc = rewards[:, t] + gamma * acc
            returns[:, t] = acc
        n_ep = float(rewards.shape[0])
        baseline = returns.sum(dim=0) / n_ep
        adv = returns - baseline[None, :]
        n = float(rewards.numel())
        mean_adv = adv.sum() / n
        std = torch.sqrt(torch.clamp(((adv - mean_adv) ** 2).sum() / n,
                                     min=0.0))
        ret_mean = returns.sum() / n
        scale = torch.clamp(torch.maximum(std, 0.05 * torch.abs(ret_mean)),
                            min=1e-8)
        adv = adv / scale
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in self.params.items()}
        loss = self._pg_loss(leaves, states, actions, adv)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        rms = tun["rmsprop"]
        with torch.no_grad():
            for k, gk in grads.items():
                self.nu[k] = rms["decay"] * self.nu[k] \
                    + (1 - rms["decay"]) * torch.square(gk)
                self.params[k] = self.params[k] - tun["lr"] * gk \
                    / (torch.sqrt(self.nu[k]) + rms["eps"])
            loss = self._pg_loss(self.params, states, actions, adv)
        self.n_updates += 1
        return float(loss), grads

    # --------------------------------------------------------------- run
    def run(self, n_updates: int) -> dict:
        """The first ``n_updates`` outer iterations from the fleet's first
        window: each update's loss, the first gradient, the rmsprop state
        after the first update and the parameters before and after."""
        carry = self.observe_first()
        p0 = {k: v.clone() for k, v in self.params.items()}
        losses, grad1, nu1 = [], None, None
        for _ in range(n_updates):
            exploit = self.n_updates >= self.tun["f_warmup_updates"]
            carry, outs = self.episode(carry, exploit)
            loss, grads = self.update(outs)
            losses.append(loss)
            if grad1 is None:
                grad1 = {k: g.clone() for k, g in grads.items()}
                nu1 = {k: v.clone() for k, v in self.nu.items()}
        return {"losses": losses, "grad1": grad1, "nu1": nu1, "params0": p0,
                "params": {k: v.clone() for k, v in self.params.items()}}

"""Metric selection (paper §2.2), on PyTorch: variance filter → standardise
→ spline repair → Factor Analysis (parallel-analysis retention) → k-means on
factor coefficients → keep the medoid metric of each cluster.

The port of ``repro.core.metrics_selection``:

* ``variance_filter``, ``standardise``, ``_natural_cubic_spline``,
  ``spline_repair``, ``parallel_analysis``, ``factor_analysis`` and
  ``retained_factors`` are numpy copies of the reference's (bitwise).
* ``_kmeans_once`` / ``kmeans`` / ``sweep_k`` run in torch on the device:
  k-means++ seeding with draws from an explicit ``torch.Generator`` (seeded
  ``seed * 131 + restart``, the reference's key schedule), then 50 Lloyd
  iterations. The seeding's picks can be injected instead (``init_idx=``,
  or an ``init`` callable through ``kmeans``, ``sweep_k`` and
  ``select_metrics``), so a test can feed the reference's threefry picks.
* ``select_metrics`` / ``select_metrics_split`` — the full pipeline; driver
  and worker metric batches are analysed separately (paper §2.2).

Entry points take ``device=`` (``None`` is the card; ``"cpu"`` runs on the
host).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.utils import resolve_device, strict_f32

VARIANCE_FLOOR = 0.002  # paper: metrics with var <= 0.002 are dropped


# ---------------------------------------------------------------------------
# Cleaning
# ---------------------------------------------------------------------------


def variance_filter(X: np.ndarray, floor: float = VARIANCE_FLOOR) -> np.ndarray:
    """Boolean keep-mask over columns (metrics). X (samples, metrics).

    A metric is dropped when its variance is tiny BOTH absolutely and
    relative to its mean scale (metrics span raw units from ms to fractions;
    a purely absolute floor would drop well-behaved [0,1] utilisation
    metrics, a purely relative one keeps zero-mean numerical noise — the
    paper's intent is 'constant trend or low variance', ~10% of metrics)."""
    var = np.nanvar(X, axis=0)
    mean_sq = np.nanmean(X, axis=0) ** 2
    return (var > floor) & (var > floor * mean_sq)


def standardise(X: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(value - mean) / std per metric, NaN-safe. Returns (Z, mean, std)."""
    mean = np.nanmean(X, axis=0)
    std = np.nanstd(X, axis=0)
    std = np.where(std < 1e-12, 1.0, std)
    return (X - mean) / std, mean, std


def _natural_cubic_spline(xk: np.ndarray, yk: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Evaluate the natural cubic spline through (xk, yk) at xq.

    Classic tridiagonal second-derivative solve; xk strictly increasing.
    """
    n = len(xk)
    if n == 1:
        return np.full_like(xq, yk[0], dtype=float)
    if n == 2:  # degenerate: linear
        t = (xq - xk[0]) / (xk[1] - xk[0])
        return yk[0] + t * (yk[1] - yk[0])
    h = np.diff(xk).astype(float)
    # solve for second derivatives m (natural: m0 = m_{n-1} = 0)
    a = np.zeros(n)
    b = np.ones(n)
    c = np.zeros(n)
    d = np.zeros(n)
    for i in range(1, n - 1):
        a[i] = h[i - 1]
        b[i] = 2.0 * (h[i - 1] + h[i])
        c[i] = h[i]
        d[i] = 6.0 * ((yk[i + 1] - yk[i]) / h[i] - (yk[i] - yk[i - 1]) / h[i - 1])
    # Thomas algorithm
    for i in range(1, n):
        w = a[i] / b[i - 1] if b[i - 1] else 0.0
        b[i] -= w * c[i - 1]
        d[i] -= w * d[i - 1]
    m = np.zeros(n)
    m[-1] = d[-1] / b[-1] if b[-1] else 0.0
    for i in range(n - 2, -1, -1):
        m[i] = (d[i] - c[i] * m[i + 1]) / b[i] if b[i] else 0.0
    # evaluate
    idx = np.clip(np.searchsorted(xk, xq) - 1, 0, n - 2)
    x0, x1 = xk[idx], xk[idx + 1]
    y0, y1 = yk[idx], yk[idx + 1]
    m0, m1 = m[idx], m[idx + 1]
    hh = x1 - x0
    t = (xq - x0) / hh
    return (
        y0 * (1 - t)
        + y1 * t
        + ((1 - t) ** 3 - (1 - t)) * m0 * hh**2 / 6.0
        + (t**3 - t) * m1 * hh**2 / 6.0
    )


def spline_repair(X: np.ndarray) -> np.ndarray:
    """Fill NaN gaps per column with 3rd-order spline interpolation (paper §2.2
    'to reconstruct missing data ... 3rd order spline interpolation')."""
    X = np.array(X, dtype=float, copy=True)
    t = np.arange(X.shape[0], dtype=float)
    for j in range(X.shape[1]):
        col = X[:, j]
        bad = ~np.isfinite(col)
        if not bad.any():
            continue
        good = ~bad
        if good.sum() == 0:
            X[:, j] = 0.0
            continue
        X[bad, j] = _natural_cubic_spline(t[good], col[good], t[bad])
    return X


# ---------------------------------------------------------------------------
# Factor analysis (principal-axis factoring) + parallel analysis
# ---------------------------------------------------------------------------


def parallel_analysis(
    n_samples: int, n_metrics: int, rng: np.random.Generator,
    n_draws: int = 20, percentile: float = 95.0,
) -> np.ndarray:
    """95th-percentile eigenvalue distribution of random-data correlation
    matrices (the paper's factor-retention criterion)."""
    eigs = np.empty((n_draws, n_metrics))
    for i in range(n_draws):
        R = rng.standard_normal((n_samples, n_metrics))
        corr = np.corrcoef(R, rowvar=False)
        eigs[i] = np.sort(np.linalg.eigvalsh(corr))[::-1]
    return np.percentile(eigs, percentile, axis=0)


def factor_analysis(
    Z: np.ndarray, n_factors: int, iters: int = 50, tol: float = 1e-5,
) -> np.ndarray:
    """Principal-axis FA on standardised data Z (samples × metrics).

    Returns loadings U (metrics × n_factors): entry U[i, j] is the coefficient
    of metric i on factor j — the coordinates used for clustering (paper Fig 2).
    """
    corr = np.corrcoef(Z, rowvar=False)
    corr = np.nan_to_num(corr, nan=0.0)
    np.fill_diagonal(corr, 1.0)
    p = corr.shape[0]
    # initial communalities: squared multiple correlation approximation
    try:
        inv = np.linalg.pinv(corr)
        comm = 1.0 - 1.0 / np.maximum(np.diag(inv), 1.0)
    except np.linalg.LinAlgError:
        comm = np.full(p, 0.5)
    comm = np.clip(comm, 0.05, 0.95)
    U = np.zeros((p, n_factors))
    for _ in range(iters):
        R = corr.copy()
        np.fill_diagonal(R, comm)
        w, v = np.linalg.eigh(R)
        order = np.argsort(w)[::-1][:n_factors]
        lam = np.maximum(w[order], 0.0)
        U = v[:, order] * np.sqrt(lam)[None, :]
        new_comm = np.clip((U**2).sum(axis=1), 0.0, 0.995)
        if np.max(np.abs(new_comm - comm)) < tol:
            comm = new_comm
            break
        comm = new_comm
    # sign convention: make the largest-|loading| entry of each factor positive
    for j in range(U.shape[1]):
        i = np.argmax(np.abs(U[:, j]))
        if U[i, j] < 0:
            U[:, j] = -U[:, j]
    return U


def retained_factors(Z: np.ndarray, rng: np.random.Generator,
                     max_factors: int = 10) -> int:
    """Number of factors whose eigenvalue beats the parallel-analysis bar."""
    corr = np.nan_to_num(np.corrcoef(Z, rowvar=False), nan=0.0)
    np.fill_diagonal(corr, 1.0)
    eig = np.sort(np.linalg.eigvalsh(corr))[::-1]
    bar = parallel_analysis(Z.shape[0], Z.shape[1], rng)
    n = int(np.sum(eig[: len(bar)] > bar))
    return int(np.clip(n, 1, max_factors))


# ---------------------------------------------------------------------------
# k-means (torch) with k-sweep
# ---------------------------------------------------------------------------

#: injected k-means++ picks: ``init(points, k, key_seed)`` -> k row indices
#: of ``points`` (``key_seed = seed * 131 + restart``)
KMeansInit = Callable[[np.ndarray, int, int], np.ndarray]


def _sq_dists(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances, summed over the feature axis."""
    return torch.sum((points[:, None, :] - centers[None, :, :]) ** 2, dim=-1)


def _kmeans_once(points: torch.Tensor, k: int, *,
                 generator: Optional[torch.Generator] = None,
                 init_idx=None, iters: int = 50
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd's with k-means++ init. points (n, d) f32. Returns (centers,
    assign, cost) on points' device.

    Seeding: a uniform first pick, then each next centre drawn with
    probability proportional to its squared distance to the nearest chosen
    one (inverse CDF on a uniform from ``generator``, as the reference's
    ``jax.random.choice`` does it). ``init_idx`` (k row indices) replaces
    the draws."""
    n, d = points.shape
    dev = points.device
    if init_idx is not None:
        centers = points[torch.as_tensor(np.array(init_idx), device=dev)]
    else:
        centers = torch.zeros((k, d), dtype=points.dtype, device=dev)
        first = torch.randint(0, n, (1,), generator=generator, device=dev)
        centers[0] = points[first[0]]
        for i in range(1, k):
            d2 = torch.min(_sq_dists(points, centers[:i]), dim=1).values
            probs = d2 / torch.clamp(d2.sum(), min=1e-12)
            cum = torch.cumsum(probs, 0)
            u = torch.rand((1,), generator=generator, device=dev)
            r = cum[-1:] * (1.0 - u)
            idx = torch.clamp(torch.searchsorted(cum, r), max=n - 1)
            centers[i] = points[idx[0]]
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(points, centers), dim=1)
        onehot = Fn.one_hot(assign, k).to(points.dtype)     # (n, k)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ points
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0),
                              centers)
    d2 = _sq_dists(points, centers)
    assign = torch.argmin(d2, dim=1)
    cost = torch.sum(torch.min(d2, dim=1).values)
    return centers, assign, cost


def kmeans(points: np.ndarray, k: int, seed: int = 0, restarts: int = 4, *,
           device=None, init: Optional[KMeansInit] = None):
    """Best-of-restarts k-means. Returns (centers, assignments, cost) on the
    host. Restart r seeds its ``torch.Generator`` with ``seed * 131 + r``
    (or takes ``init(points, k, seed * 131 + r)``'s picks)."""
    dev = resolve_device(device, "kmeans")
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    best = None
    with strict_f32():                  # the centre sums in f32
        for r in range(restarts):
            key_seed = seed * 131 + r
            if init is not None:
                c, a, cost = _kmeans_once(pts, k,
                                          init_idx=init(points, k, key_seed))
            else:
                gen = torch.Generator(device=dev).manual_seed(key_seed)
                c, a, cost = _kmeans_once(pts, k, generator=gen)
            if best is None or float(cost) < best[2]:
                best = (c.cpu().numpy(), a.cpu().numpy(), float(cost))
    return best


def sweep_k(points: np.ndarray, ks: Sequence[int], seed: int = 0,
            elbow: float = 0.75, *, device=None,
            init: Optional[KMeansInit] = None) -> int:
    """Paper: 'iterated over several k values and took the number that
    minimised the cost function'. Raw cost decreases monotonically in k, so
    — as in the OtterTune methodology the paper follows — stop at the
    elbow: the smallest k whose next increment no longer buys a meaningful
    cost reduction (cost(k+1) > elbow · cost(k))."""
    ks = sorted(k for k in ks if k < points.shape[0])
    if not ks:
        return 1
    costs = {k: kmeans(points, k, seed, device=device, init=init)[2]
             for k in ks}
    for a, b in zip(ks, ks[1:]):
        if costs[b] > elbow * costs[a]:
            return a
    return ks[-1]


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


@dataclass
class SelectionResult:
    kept_names: list[str]          # medoid metric per cluster (the output)
    cluster_of: dict[str, int]     # surviving metric -> cluster id
    loadings: np.ndarray           # (n_survivors, n_factors) FA coordinates
    survivor_names: list[str]      # metrics that passed the variance filter
    n_factors: int
    k: int
    reduction: float               # fraction of original metrics removed


def select_metrics(
    X: np.ndarray,
    names: Sequence[str],
    *,
    seed: int = 0,
    k: Optional[int] = None,
    k_candidates: Sequence[int] = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12),
    n_factors: Optional[int] = None,
    var_floor: float = VARIANCE_FLOOR,
    device=None,
    init: Optional[KMeansInit] = None,
    stage_s: Optional[dict] = None,
) -> SelectionResult:
    """Paper §2.2 pipeline on a metric matrix X (samples × metrics); the
    k-means runs on ``device`` (``init`` injects its seeding picks).
    ``stage_s``, when given, receives the wall seconds of the host stages
    (``"fa"``: repair, filter, FA) and of the k-means (``"kmeans"``)."""
    assert X.shape[1] == len(names)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)

    X = spline_repair(X)
    keep = variance_filter(X, var_floor)
    if keep.sum() < 2:  # degenerate; keep the top-variance two
        order = np.argsort(np.nanvar(X, axis=0))[::-1]
        keep = np.zeros(len(names), bool)
        keep[order[: min(2, len(names))]] = True
    Xs = X[:, keep]
    surv = [n for n, k_ in zip(names, keep) if k_]

    Z, _, _ = standardise(Xs)
    nf = n_factors or retained_factors(Z, rng)
    nf = min(nf, Z.shape[1] - 1) or 1
    U = factor_analysis(Z, nf)
    t1 = time.perf_counter()

    kk = k or sweep_k(U, [c for c in k_candidates if c < len(surv)], seed,
                      device=device, init=init)
    kk = max(1, min(kk, len(surv)))
    centers, assign, _ = kmeans(U, kk, seed, device=device, init=init)

    kept: list[str] = []
    for c in range(kk):
        members = np.where(assign == c)[0]
        if len(members) == 0:
            continue
        d2 = np.sum((U[members] - centers[c]) ** 2, axis=1)
        kept.append(surv[members[np.argmin(d2)]])
    if stage_s is not None:
        stage_s["fa"] = t1 - t0
        stage_s["kmeans"] = time.perf_counter() - t1

    return SelectionResult(
        kept_names=kept,
        cluster_of={surv[i]: int(assign[i]) for i in range(len(surv))},
        loadings=U,
        survivor_names=surv,
        n_factors=nf,
        k=kk,
        reduction=1.0 - len(kept) / len(names),
    )


def select_metrics_split(
    X: np.ndarray, names: Sequence[str], is_driver: Sequence[bool], **kw,
) -> tuple[SelectionResult, SelectionResult]:
    """Paper: 'the FA plus clustering analysis is run separately in two
    batches: 1) the Spark driver node and 2) all the Spark worker nodes'."""
    idx_d = [i for i, d in enumerate(is_driver) if d]
    idx_w = [i for i, d in enumerate(is_driver) if not d]
    res_d = select_metrics(X[:, idx_d], [names[i] for i in idx_d], **kw)
    res_w = select_metrics(X[:, idx_w], [names[i] for i in idx_w], **kw)
    return res_d, res_w

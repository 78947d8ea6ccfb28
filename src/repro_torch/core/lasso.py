"""Lasso path lever ranking (paper §2.3), on PyTorch.

The port of ``repro.core.lasso``. Regress the target metric on the
(normalised, polynomially-expanded) configuration levers with an L1
penalty; sweep the penalty from "everything zero" downward and record the
order in which features first enter the active set — that order ranks lever
impact. Cyclic coordinate descent on the normal-equations form,

    min_w  1/(2n) ||y - Xw||^2 + lam * ||w||_1

warm-started along a geometric lambda grid from lam_max down to
eps*lam_max.

* ``normalise_levers`` and ``polynomial_features`` are numpy copies of the
  reference's (bitwise).
* X'X and X'y are one strict-f32 ``torch.matmul`` each on the device (never
  TF32: the entry order is sensitive to them), as the reference leaves them
  to XLA.
* The descent runs on the hand-written CUDA kernel
  ``repro_torch.kernels.lasso_cd`` (its plain version on CPU tensors): one
  launch for a whole ``lasso_path``; ``lasso_solve`` keeps the reference's
  convergence read after each epoch, one launch an epoch.

Entry points take ``device=`` (``None`` is the card; ``"cpu"`` runs the
plain version).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.lasso_cd import lasso_cd
from repro_torch.utils import resolve_device, strict_f32


def normalise_levers(R: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paper: categorical levers are numbered then '(value minus mean divided
    by standard deviation)'. Returns (Z, mean, std)."""
    mean = R.mean(axis=0)
    std = R.std(axis=0)
    std = np.where(std < 1e-12, 1.0, std)
    return (R - mean) / std, mean, std


def polynomial_features(
    Z: np.ndarray, names: Sequence[str], *, degree: int = 2, interactions: bool = False,
) -> tuple[np.ndarray, list[str]]:
    """Degree-2 expansion (paper: 'including polynomial features').

    Squares always; pairwise interaction terms optional (quadratic blow-up —
    109 levers -> 5886 extra columns)."""
    cols = [Z]
    out_names = list(names)
    if degree >= 2:
        cols.append(Z**2)
        out_names += [f"{n}^2" for n in names]
        if interactions:
            n = Z.shape[1]
            inter = []
            for i in range(n):
                for j in range(i + 1, n):
                    inter.append(Z[:, i] * Z[:, j])
                    out_names.append(f"{names[i]}*{names[j]}")
            if inter:
                cols.append(np.stack(inter, axis=1))
    return np.concatenate(cols, axis=1), out_names


def _normal_equations(X: np.ndarray, y: np.ndarray, device):
    """(X'X, X'y) in f32 on ``device``."""
    Xt = torch.as_tensor(np.asarray(X, np.float32), device=device)
    yt = torch.as_tensor(np.asarray(y, np.float32), device=device)
    with strict_f32():
        return Xt.T @ Xt, Xt.T @ yt


def _cd_epoch(w: torch.Tensor, XtX: torch.Tensor, Xty: torch.Tensor,
              lam: float, n: float) -> torch.Tensor:
    """One full cycle of coordinate descent on the normal-equations form
    (one kernel launch on the card). For standardised columns X_j'X_j = n:
      w_j <- soft(Xty_j - sum_{k!=j} XtX_jk w_k, n*lam) / XtX_jj
    """
    lams = torch.tensor([lam], dtype=torch.float32, device=w.device)
    return lasso_cd(XtX, Xty, w, lams, n, epochs=1)[0]


def lasso_solve(
    X: np.ndarray, y: np.ndarray, lam: float, *,
    w0: Optional[np.ndarray] = None, epochs: int = 200, tol: float = 1e-7,
    device=None,
) -> np.ndarray:
    """Coordinate descent to convergence at a single lambda: one epoch a
    launch, the largest coefficient change read on the host after each."""
    dev = resolve_device(device, "lasso_solve")
    n, p = X.shape
    XtX, Xty = _normal_equations(X, y, dev)
    w = (torch.zeros(p, dtype=torch.float32, device=dev) if w0 is None
         else torch.as_tensor(np.asarray(w0, np.float32), device=dev))
    for _ in range(epochs):
        w_new = _cd_epoch(w, XtX, Xty, lam, float(n))
        if float(torch.max(torch.abs(w_new - w))) < tol:
            w = w_new
            break
        w = w_new
    return w.cpu().numpy()


@dataclass
class LassoPathResult:
    order: list[int]            # feature indices in entry order (first = strongest)
    entry_lambda: np.ndarray    # lambda at which each feature entered (inf = never)
    lambdas: np.ndarray         # the grid swept (descending)
    coefs: np.ndarray           # (n_lambdas, p) warm-started solutions
    names: list[str]

    def ranked_names(self) -> list[str]:
        return [self.names[i] for i in self.order]


def entry_order(coefs: np.ndarray, lambdas: np.ndarray
                ) -> tuple[list[int], np.ndarray]:
    """The reference's rule over a path's (n_lambdas, p) coefficients: a
    feature enters at the first lambda where |w| > 1e-8; features entering
    at one lambda are taken in index order. Returns (order, entry_lambda)."""
    entry = np.full(coefs.shape[1], np.inf)
    order: list[int] = []
    for li, lam in enumerate(lambdas):
        for j in np.where(np.abs(coefs[li]) > 1e-8)[0]:
            if entry[j] == np.inf:
                entry[j] = lam
                order.append(int(j))
    return order, entry


def path_inputs(X: np.ndarray, y: np.ndarray, *, n_lambdas: int = 60,
                eps: float = 1e-3, device) -> tuple:
    """What the path's descent runs on: (X'X, X'y) of the centred target
    in f32 on ``device``, and the lambda grid from lam_max (the smallest
    lambda with an all-zero solution, in f64 on the host) down to
    eps * lam_max."""
    n = X.shape[0]
    y = y - y.mean()
    lam_max = float(np.max(np.abs(X.T @ y)) / n) + 1e-12
    lambdas = lam_max * np.geomspace(1.0, eps, n_lambdas)
    XtX, Xty = _normal_equations(X, y, device)
    return XtX, Xty, lambdas


def lasso_path(
    X: np.ndarray, y: np.ndarray, names: Sequence[str], *,
    n_lambdas: int = 60, eps: float = 1e-3, epochs: int = 60, device=None,
) -> LassoPathResult:
    """Sweep lambda from lam_max down (paper: 'decrease the penalty in small
    increments, recompute the regression, and track what features are added
    back to the model at each step'): the whole warm-started path is one
    ``lasso_cd`` launch on the card."""
    dev = resolve_device(device, "lasso_path")
    n, p = X.shape
    XtX, Xty, lambdas = path_inputs(X, y, n_lambdas=n_lambdas, eps=eps,
                                    device=dev)
    coefs = lasso_cd(XtX, Xty, torch.zeros(p, dtype=torch.float32, device=dev),
                     torch.as_tensor(lambdas, dtype=torch.float32, device=dev),
                     float(n), epochs=epochs).cpu().numpy()
    order, entry = entry_order(coefs, lambdas)
    return LassoPathResult(order=order, entry_lambda=entry, lambdas=lambdas,
                           coefs=coefs, names=list(names))


def rank_levers(
    R: np.ndarray, y: np.ndarray, lever_names: Sequence[str], *,
    degree: int = 2, interactions: bool = False, top: Optional[int] = None,
    device=None,
) -> list[str]:
    """End-to-end §2.3: normalise levers, polynomial expansion, Lasso path,
    collapse expanded features back to their base lever, return ranked lever
    names (strongest first)."""
    Z, _, _ = normalise_levers(R)
    Xp, feat_names = polynomial_features(Z, lever_names, degree=degree,
                                         interactions=interactions)
    res = lasso_path(Xp, y, feat_names, device=device)
    seen: list[str] = []
    for fname in res.ranked_names():
        base = fname.split("^")[0].split("*")[0]
        if base not in seen:
            seen.append(base)
    if top:
        seen = seen[:top]
    return seen

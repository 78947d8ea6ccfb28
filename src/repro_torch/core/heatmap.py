"""State representation (paper §3): heat-map images.

'We keep a grid per metric, where each cell represents a node in the cluster
... another [grid] showing the discretised configuration values.'

The policy network input is the concatenation of:
  * one (rows × cols) grid per SELECTED metric — per-node utilisation averaged
    over the observation window, normalised to [0, 1] by running min/max;
  * one grid of the current discretised lever values (bin index / n_bins for
    continuous levers, category index / n_choices otherwise), one cell per
    SELECTED lever.

Grids are fixed-size (pad with zeros) so the network shape never changes when
bins split or the cluster is rescaled elastically.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def node_grid_shape(n_nodes: int) -> tuple[int, int]:
    rows = int(np.ceil(np.sqrt(n_nodes)))
    cols = int(np.ceil(n_nodes / rows))
    return rows, cols


class RunningRange:
    """Per-channel running min/max for [0,1] normalisation."""

    def __init__(self, n: int):
        self.lo = np.full(n, np.inf)
        self.hi = np.full(n, -np.inf)

    def update(self, x: np.ndarray) -> None:  # x (n,) or (n, nodes)
        v = x if x.ndim == 1 else np.nanmean(x, axis=1)
        self.lo = np.minimum(self.lo, np.nanmin(x, axis=-1) if x.ndim > 1 else v)
        self.hi = np.maximum(self.hi, np.nanmax(x, axis=-1) if x.ndim > 1 else v)

    def norm(self, x: np.ndarray) -> np.ndarray:
        span = np.where(self.hi > self.lo, self.hi - self.lo, 1.0)
        lo = np.where(np.isfinite(self.lo), self.lo, 0.0)
        out = (x - (lo if x.ndim == 1 else lo[:, None])) / (
            span if x.ndim == 1 else span[:, None])
        return np.clip(np.nan_to_num(out, nan=0.0), 0.0, 1.0)


@dataclass
class HeatmapSpec:
    metric_names: list[str]   # selected metrics (FA + k-means output)
    lever_names: list[str]    # selected levers (Lasso output)
    n_nodes: int

    @property
    def grid(self) -> tuple[int, int]:
        return node_grid_shape(self.n_nodes)

    @property
    def state_dim(self) -> int:
        r, c = self.grid
        return len(self.metric_names) * r * c + len(self.lever_names)


class HeatmapEncoder:
    """metrics (per node) + lever config -> flat state vector for the policy."""

    def __init__(self, spec: HeatmapSpec):
        self.spec = spec
        self._range = RunningRange(len(spec.metric_names))

    def encode(
        self,
        per_node_metrics: dict[str, np.ndarray],  # name -> (n_nodes,) window avg
        lever_fracs: dict[str, float],            # name -> bin_idx / n_bins in [0,1]
    ) -> np.ndarray:
        r, c = self.spec.grid
        mats = []
        raw = np.stack([
            np.asarray(per_node_metrics.get(m, np.zeros(self.spec.n_nodes)), float)
            for m in self.spec.metric_names
        ])  # (M, nodes)
        self._range.update(raw)
        normed = self._range.norm(raw)
        for i in range(normed.shape[0]):
            g = np.zeros(r * c)
            g[: self.spec.n_nodes] = normed[i][: self.spec.n_nodes]
            mats.append(g)
        levers = np.array([float(np.clip(lever_fracs.get(l, 0.0), 0, 1))
                           for l in self.spec.lever_names])
        return np.concatenate([np.concatenate(mats) if mats else np.zeros(0), levers])

    def encode_fleet(self, node_matrices: np.ndarray,
                     lever_fracs: np.ndarray) -> np.ndarray:
        """Batched fleet encode: (N, nodes, M) selected-metric windows +
        (N, L) lever fractions -> (N, state_dim), with ONE running-range
        update for the whole fleet batch (then every cluster normalised by
        the updated range). This is the fleet-consistent normalisation the
        fused device program (repro_torch.core.device_loop) computes on device —
        unlike the serial ``encode`` path, cluster 0's state no longer
        depends on its position in the encode order."""
        raw = np.transpose(np.asarray(node_matrices, float), (0, 2, 1))
        self._range.lo = np.minimum(self._range.lo, np.nanmin(raw, axis=(0, 2)))
        self._range.hi = np.maximum(self._range.hi, np.nanmax(raw, axis=(0, 2)))
        lo, hi = self._range.lo, self._range.hi
        span = np.where(hi > lo, hi - lo, 1.0)
        lo_eff = np.where(np.isfinite(lo), lo, 0.0)
        normed = (raw - lo_eff[None, :, None]) / span[None, :, None]
        normed = np.clip(np.nan_to_num(normed, nan=0.0), 0.0, 1.0)
        N, M, nodes = normed.shape
        r, c = self.spec.grid
        grids = np.zeros((N, M, r * c))
        grids[:, :, :nodes] = normed
        fracs = np.clip(np.asarray(lever_fracs, float), 0.0, 1.0)
        return np.concatenate([grids.reshape(N, M * r * c), fracs], axis=1)

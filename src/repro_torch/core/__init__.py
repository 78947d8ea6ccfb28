"""The paper's primary contribution on PyTorch: the RL auto-tuning pipeline.

§2.2 metric selection  -> repro_torch.core.metrics_selection
§2.3 lever ranking     -> repro_torch.core.lasso (the lasso_cd kernel)
§2.4.1 discretisation  -> repro_torch.core.discretize
§2.4.2/§3 configurator -> repro_torch.core.policy + repro_torch.core.configurator
                          (+ the fused device loop, repro_torch.core.device_loop)
end-to-end             -> repro_torch.core.tuner.AutoTuner
"""
from repro_torch.core.configurator import (Configurator, StepRecord, TuningEnv,
                                           reward_from_latency)
from repro_torch.core.discretize import DynamicBins, LeverDiscretiser, LeverSpec
from repro_torch.core.heatmap import HeatmapEncoder, HeatmapSpec
from repro_torch.core.lasso import lasso_path, lasso_solve, rank_levers
from repro_torch.core.metrics_selection import (
    SelectionResult,
    factor_analysis,
    kmeans,
    select_metrics,
    select_metrics_split,
    spline_repair,
    variance_filter,
)
from repro_torch.core.policy import ReinforceAgent, Trajectory
from repro_torch.core.tuner import AutoTuner

__all__ = [
    "AutoTuner",
    "Configurator",
    "DynamicBins",
    "HeatmapEncoder",
    "HeatmapSpec",
    "LeverDiscretiser",
    "LeverSpec",
    "ReinforceAgent",
    "SelectionResult",
    "StepRecord",
    "Trajectory",
    "TuningEnv",
    "factor_analysis",
    "kmeans",
    "lasso_path",
    "lasso_solve",
    "rank_levers",
    "reward_from_latency",
    "select_metrics",
    "select_metrics_split",
    "spline_repair",
    "variance_filter",
]

"""The RL auto-tuning pipeline on PyTorch: discretisation, heat-map state,
the REINFORCE policy, the fused device episode loop and the configurator."""
from repro_torch.core.configurator import Configurator, StepRecord
from repro_torch.core.discretize import DynamicBins, LeverDiscretiser, LeverSpec
from repro_torch.core.heatmap import HeatmapEncoder, HeatmapSpec
from repro_torch.core.policy import ReinforceAgent

__all__ = [
    "Configurator",
    "DynamicBins",
    "HeatmapEncoder",
    "HeatmapSpec",
    "LeverDiscretiser",
    "LeverSpec",
    "ReinforceAgent",
    "StepRecord",
]

"""Streaming Mini-Apps (paper §5): MASS sources + MASA processors."""
from repro_torch.miniapps.masa import (
    PROCESSORS,
    AppStats,
    LMServeApp,
    LMTrainApp,
    ReconstructionApp,
    StreamingKMeans,
)
from repro_torch.miniapps.detector import DetectorSimSource
from repro_torch.miniapps.mass import (
    SOURCES,
    KMeansClusterSource,
    KMeansStaticSource,
    LightsourceTemplateSource,
    RateStep,
    RateStepScenario,
    SourceConfig,
    StreamSource,
    TokenSource,
)
from repro_torch.miniapps.state import state_from_jax

__all__ = [
    "AppStats",
    "DetectorSimSource",
    "KMeansClusterSource",
    "KMeansStaticSource",
    "LMServeApp",
    "LMTrainApp",
    "LightsourceTemplateSource",
    "PROCESSORS",
    "RateStep",
    "RateStepScenario",
    "ReconstructionApp",
    "SOURCES",
    "SourceConfig",
    "StreamSource",
    "StreamingKMeans",
    "TokenSource",
    "state_from_jax",
]

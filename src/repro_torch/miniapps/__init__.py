"""Streaming Mini-Apps (paper §5): MASS sources + MASA processors."""
from repro_torch.miniapps.masa import (
    PROCESSORS,
    AppStats,
    LMServeApp,
    ReconstructionApp,
    StreamingKMeans,
)
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
    "KMeansClusterSource",
    "KMeansStaticSource",
    "LMServeApp",
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

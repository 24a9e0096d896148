"""Streaming Mini-Apps (paper §5): MASS sources + MASA processors."""
from repro_torch.miniapps.masa import PROCESSORS, AppStats, ReconstructionApp, StreamingKMeans
from repro_torch.miniapps.mass import (
    SOURCES,
    KMeansClusterSource,
    KMeansStaticSource,
    LightsourceTemplateSource,
    SourceConfig,
    StreamSource,
)
from repro_torch.miniapps.state import state_from_jax

__all__ = [
    "AppStats",
    "KMeansClusterSource",
    "KMeansStaticSource",
    "LightsourceTemplateSource",
    "PROCESSORS",
    "ReconstructionApp",
    "SOURCES",
    "SourceConfig",
    "StreamSource",
    "StreamingKMeans",
    "state_from_jax",
]

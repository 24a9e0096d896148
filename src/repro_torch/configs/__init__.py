from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ARCHS", "ArchConfig", "ShapeConfig", "get_arch"]

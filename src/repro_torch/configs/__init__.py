from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs.registry import (
    ARCHS,
    SUBQUADRATIC,
    all_cells,
    cell_supported,
    get_arch,
    get_shape,
)

__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC", "ArchConfig", "ShapeConfig", "all_cells",
           "cell_supported", "get_arch", "get_shape"]

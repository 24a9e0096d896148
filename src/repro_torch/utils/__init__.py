"""Small shared utilities: pytrees of tensors and timing."""
from repro_torch.utils.timer import Timer, now_monotonic
from repro_torch.utils.tree import (
    tree_bytes,
    tree_count,
    tree_flatten_with_paths,
    tree_map_with_paths,
    tree_zeros_like,
)

__all__ = [
    "Timer",
    "now_monotonic",
    "tree_bytes",
    "tree_count",
    "tree_flatten_with_paths",
    "tree_map_with_paths",
    "tree_zeros_like",
]

from repro_torch.kernels.kmeans.ops import (
    KMEANS_ASSIGN,
    assign,
    assign_cuda,
    minibatch_update,
    minibatch_update_masked,
)
from repro_torch.kernels.kmeans.ref import assign_ref, update_scatter

__all__ = [
    "KMEANS_ASSIGN",
    "assign",
    "assign_cuda",
    "assign_ref",
    "minibatch_update",
    "minibatch_update_masked",
    "update_scatter",
]

from repro_torch.kernels.kmeans.ops import (
    KMEANS_ASSIGN,
    KMEANS_UPDATE,
    AssignPlan,
    assign,
    assign_cuda,
    assign_plan,
    minibatch_update,
    minibatch_update_masked,
    update_cuda,
    update_scatter,
    update_segment_rows,
)
from repro_torch.kernels.kmeans.ref import assign_ref, update_scatter_ref

__all__ = [
    "KMEANS_ASSIGN",
    "KMEANS_UPDATE",
    "AssignPlan",
    "assign",
    "assign_cuda",
    "assign_plan",
    "assign_ref",
    "minibatch_update",
    "minibatch_update_masked",
    "update_cuda",
    "update_scatter",
    "update_scatter_ref",
    "update_segment_rows",
]

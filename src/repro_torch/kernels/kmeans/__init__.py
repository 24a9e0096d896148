from repro_torch.kernels.kmeans.ops import (
    KMEANS_ASSIGN,
    AssignPlan,
    assign,
    assign_cuda,
    assign_plan,
    minibatch_update,
    minibatch_update_masked,
)
from repro_torch.kernels.kmeans.ref import assign_ref, update_scatter

__all__ = [
    "KMEANS_ASSIGN",
    "AssignPlan",
    "assign",
    "assign_cuda",
    "assign_plan",
    "assign_ref",
    "minibatch_update",
    "minibatch_update_masked",
    "update_scatter",
]

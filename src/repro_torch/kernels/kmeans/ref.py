"""Plain PyTorch versions of the K-Means assignment and update steps (MASA
scoring hot loop).

Paper Table 1: "Model score: assign incoming data to centroids,
O(num_points * num_clusters)". These compute the same functions as the
JAX package's ``repro/kernels/kmeans/ref.py``; the CPU path runs them and
the CUDA kernel is held against :func:`assign_ref` on the card.
"""
from __future__ import annotations

import torch


def assign_ref(points: torch.Tensor, centroids: torch.Tensor):
    """points: (N, D); centroids: (K, D) -> (labels (N,) int32, dist2 (N,) f32).

    d^2 = |p|^2 - 2 p.c + |c|^2 in f32, as the reference. Ties go to the
    first index, spelled out rather than left to ``argmin``, whose tie rule
    PyTorch does not document for every device."""
    p = points.to(torch.float32)
    c = centroids.to(torch.float32)
    p2 = (p * p).sum(dim=1, keepdim=True)  # (N, 1)
    c2 = (c * c).sum(dim=1)  # (K,)
    d2 = p2 - 2.0 * (p @ c.T) + c2[None, :]  # (N, K)
    dist = d2.min(dim=1).values
    idx = torch.arange(c.shape[0], device=d2.device).expand_as(d2)
    labels = torch.where(d2 == dist[:, None], idx, c.shape[0]).min(dim=1).values
    return labels.to(torch.int32), dist


def update_scatter_ref(points: torch.Tensor, labels: torch.Tensor, k: int,
                       mask: torch.Tensor | None = None):
    """Centroid sums + counts by a scatter-add over the labels.

    ``mask`` (N,) bool gives rows weight 0. On the CPU ``index_add_`` adds
    in row order, as the reference's scatter; on CUDA it adds with atomics,
    so the order of the sums — and their last bits — is not fixed from run
    to run: CUDA tensors go to the ``kmeans_update`` kernel instead
    (``ops.update_scatter``), and this version is only its yardstick there.
    """
    pts = points.to(torch.float32)
    if mask is not None:
        w = mask.to(torch.float32)
        labels = torch.where(mask, labels, torch.zeros_like(labels))  # in range; weight 0
        pts = pts * w[:, None]
    else:
        w = torch.ones(points.shape[0], dtype=torch.float32, device=points.device)
    idx = labels.to(torch.int64)
    sums = torch.zeros((k, points.shape[1]), dtype=torch.float32,
                       device=points.device).index_add_(0, idx, pts)
    counts = torch.zeros((k,), dtype=torch.float32, device=points.device).index_add_(0, idx, w)
    return sums, counts

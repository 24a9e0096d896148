"""Collectives over a :class:`~repro_torch.launch.mesh.Mesh` axis, with
their autograd rules: the port's counterparts of ``jax.lax.all_gather``
(tiled), ``psum``, ``psum_scatter``, ``pmax``, ``ppermute`` and
``all_to_all`` inside the JAX package's ``shard_map`` bodies (and of the
all-to-all GSPMD makes of the MoE layer's expert-axis constraint).

Gradient convention. Every rank runs its own graph; the objective is the
sum over ranks of what each rank back-propagates, and each collective's
backward is its exact transpose (the JAX package's rules under
``check_vma=False``): ``psum`` -> ``psum``, tiled ``all_gather`` ->
reduce-scatter (sum), ``psum_scatter`` -> tiled ``all_gather``,
``ppermute`` -> the inverse permutation, ``all_to_all`` -> itself (chunk
j of rank i goes to chunk i of rank j, and back). A loss that every rank holds the
same copy of is back-propagated divided by the number of ranks holding it
(``runtime/steps.py``), as ``shard_map``'s transpose divides the cotangent
of a replicated output.

Staging: on a gloo mesh with CUDA tensors (``mesh.staged``), each
collective copies its input to host memory, runs there and copies the
result back; the choice follows the backend, fixed when the mesh was built.
gloo's reduce-scatter is an all-to-all of the chunks, each rank summing
the ones it receives; NCCL's is ``reduce_scatter_tensor``, and so is that
of the ``fake`` group the dry run traces a production mesh with
(``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh


def _host(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return x.detach().cpu() if mesh.staged else x.detach()


def _back(mesh: Mesh, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(like.device) if mesh.staged else x


def _all_gather(mesh: Mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    group, ranks = mesh.group(axes)
    h = _host(mesh, x).contiguous()
    parts = [torch.empty_like(h) for _ in ranks]
    dist.all_gather(parts, h, group=group)
    return _back(mesh, torch.cat(parts, dim=dim), x)


def _all_reduce(mesh: Mesh, axes, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    group, _ = mesh.group(axes)
    h = _host(mesh, x).clone().contiguous()
    dist.all_reduce(h, op=op, group=group)
    return _back(mesh, h, x)


def _reduce_scatter(mesh: Mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    group, ranks = mesh.group(axes)
    n = len(ranks)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of dim {dim} ({x.shape[dim]}) over {n} ranks")
    if mesh.backend in ("nccl", "fake"):  # the fake group stands for NCCL's (the dry run)
        h = x.detach().movedim(dim, 0).contiguous()
        out = torch.empty((h.shape[0] // n,) + h.shape[1:], dtype=h.dtype, device=h.device)
        dist.reduce_scatter_tensor(out, h, group=group)
        return out.movedim(0, dim)
    # gloo has no reduce-scatter: an all-to-all sends chunk j of every rank
    # to rank j, which sums the n it receives in rank order (half an
    # all-reduce's traffic; on the host when staged, so only the chunk comes
    # back to the card)
    h = _host(mesh, x).movedim(dim, 0).contiguous()
    recv = torch.empty_like(h)
    dist.all_to_all_single(recv, h, group=group)
    out = recv.reshape(n, h.shape[0] // n, *h.shape[1:]).sum(0)
    return _back(mesh, out.movedim(0, dim).contiguous(), x)


def _all_to_all(mesh: Mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Rank i sends chunk j of ``dim`` (n equal chunks) to rank j and
    returns the chunks it receives, chunk i from rank i, in rank order."""
    group, ranks = mesh.group(axes)
    n = len(ranks)
    if x.shape[dim] % n:
        raise ValueError(f"all-to-all of dim {dim} ({x.shape[dim]}) over {n} ranks")
    h = _host(mesh, x).movedim(dim, 0).contiguous()
    out = torch.empty_like(h)
    dist.all_to_all_single(out, h, group=group)
    return _back(mesh, out.movedim(0, dim).contiguous(), x)


def _ppermute(mesh: Mesh, axis: str, x: torch.Tensor, shift: int) -> torch.Tensor:
    """Rank i of the axis sends x to rank (i + shift) mod n and returns what
    it receives from rank (i - shift) mod n."""
    group, ranks = mesh.group(axis)
    n, i = len(ranks), mesh.axis_index(axis)
    h = _host(mesh, x).contiguous()
    if n == 1:
        return _back(mesh, h.clone(), x)
    out = torch.empty_like(h)
    ops = [dist.P2POp(dist.isend, h, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _back(mesh, out, x)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.mesh, ctx.axes, g, ctx.dim), None, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, ctx.axes, g), None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _reduce_scatter(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.mesh, ctx.axes, g, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_to_all(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.mesh, ctx.axes, g, ctx.dim), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _ppermute(mesh, axis, x, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(ctx.mesh, ctx.axis, g, -ctx.shift), None, None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axes: str | Sequence[str], *,
               dim: int) -> torch.Tensor:
    """Tiled all-gather along ``dim`` over ``axes`` (row-major order)."""
    return _AllGather.apply(x, mesh, axes, dim % x.ndim)


def all_gather_stack(x: torch.Tensor, mesh: Mesh, axes: str | Sequence[str]) -> torch.Tensor:
    """Untiled all-gather: a new leading dim of the axes' size."""
    return all_gather(x[None], mesh, axes, dim=0)


def psum(x: torch.Tensor, mesh: Mesh, axes: str | Sequence[str]) -> torch.Tensor:
    return _PSum.apply(x, mesh, axes)


def psum_scatter(x: torch.Tensor, mesh: Mesh, axes: str | Sequence[str], *,
                 dim: int) -> torch.Tensor:
    """Sum over ``axes``, each rank keeping its tile of ``dim``."""
    return _PSumScatter.apply(x, mesh, axes, dim % x.ndim)


def pmax(x: torch.Tensor, mesh: Mesh, axes: str | Sequence[str]) -> torch.Tensor:
    """Max over ``axes``; no gradient (the reference takes it under
    ``stop_gradient``)."""
    return _all_reduce(mesh, axes, x.detach(), dist.ReduceOp.MAX)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, *, shift: int = 1) -> torch.Tensor:
    """Rank i of ``axis`` receives rank (i - shift) mod n's ``x``."""
    return _PPermute.apply(x, mesh, axis, int(shift))


def all_to_all(x: torch.Tensor, mesh: Mesh, axes: str | Sequence[str], *,
               dim: int) -> torch.Tensor:
    """Cut ``dim`` into one equal chunk per rank of ``axes``: rank i sends
    its chunk j to rank j, and chunk j of its result is rank j's chunk i
    (every rank passes the same shape)."""
    return _AllToAll.apply(x, mesh, axes, dim % x.ndim)

"""Sequence-parallel linear-recurrence cores (WKV6, Mamba2 SSD) and the
causal depthwise conv with a halo.

Own counterpart of the JAX package's ``runtime/sequence_parallel.py``.
Linear recurrences compose associatively,

    S_shard_i = D_i * S_start_i + S_i^local,   D_i = the shard's total decay,

so each "model" rank (1) runs its local chunked core from a zero state,
(2) all-gathers the small per-shard summaries (S_i^local, D_i), (3) folds
its exclusive prefix S_start_i, and (4) adds the closed-form correction of
the earlier shards to its outputs. One collective of O(H N N) per layer
replaces a scan serialized across shards. The prefix fold keeps every
gathered summary in each rank's graph (``torch.where`` where the reference
has ``jnp.where``), so every rank's backward runs the same collectives.
"""
from __future__ import annotations

import torch

from repro_torch.runtime.collectives import all_gather_stack, ppermute, psum


def _fold(S_all: torch.Tensor, D_all: torch.Tensor, i: int, expand) -> torch.Tensor:
    """Exclusive prefix state of shard ``i``: the earlier shards' states,
    each decayed through the shards after it."""
    S_start = torch.zeros_like(S_all[0])
    for j in range(S_all.shape[0]):
        take = torch.tensor(j < i, device=S_all.device)
        S_start = torch.where(take, S_start * expand(D_all[j]) + S_all[j], S_start)
    return S_start


def _last_shard_state(S_final: torch.Tensor, mesh, i: int, n: int) -> torch.Tensor:
    """The last shard's final state on every rank (a psum of it alone)."""
    return psum(S_final * (1.0 if i == n - 1 else 0.0), mesh, "model")


def wkv6_sharded(r, k, v, w, u, rules, *, chunk: int = 32):
    """Sequence-parallel WKV6. r, k, v, w: (B_l, H, T_l, N), this rank's
    sequence shard; the initial state is zeros (training or prefill from
    scratch). Returns (out (B_l, H, T_l, N), the final state (B_l, H, N, N),
    alike on every "model" rank)."""
    from repro_torch.models.rwkv6 import wkv6_chunked

    mesh = rules.mesh
    n, i = mesh.axis_size("model"), mesh.axis_index("model")
    B, H, T, N = r.shape
    S0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    out_local, S_local = wkv6_chunked(r, k, v, w, u, S0, chunk=chunk)
    # per-shard total decay and the within-shard exclusive cumulative decay
    lw = torch.log(torch.clamp(w, min=1e-38))  # (B, H, T, N)
    clog = torch.cumsum(lw, dim=2)
    D_local = torch.exp(clog[:, :, -1])  # (B, H, N)
    cprev = torch.exp(clog - lw)  # decay from the shard's start, exclusive
    S_all = all_gather_stack(S_local, mesh, "model")  # (n, B, H, N, N)
    D_all = all_gather_stack(D_local, mesh, "model")  # (n, B, H, N)
    S_start = _fold(S_all, D_all, i, lambda d: d[..., :, None])
    out = out_local + torch.einsum("bhtn,bhnm->bhtm", r * cprev, S_start)
    S_final = S_start * D_all[i][..., :, None] + S_local
    return out, _last_shard_state(S_final, mesh, i, n)


def conv1d_sharded(x, w, b, rules):
    """Depthwise causal conv then SiLU over this rank's shard ``x`` (B_l,
    T_l, Ch): the previous shard's last K - 1 rows arrive by ``ppermute``
    (the halo; zeros on the first shard) and the local conv runs on them as
    its state."""
    from repro_torch.models.mamba2 import conv1d_causal

    mesh = rules.mesh
    K = w.shape[0]
    halo = ppermute(x[:, -(K - 1):].contiguous(), mesh, "model", shift=1)
    halo = halo * (0.0 if mesh.axis_index("model") == 0 else 1.0)  # causal start
    return conv1d_causal(x, w, b, halo)[0]


def ssd_sharded(x, dt, A, B, C, D, rules, *, chunk: int = 64):
    """Sequence-parallel SSD. x: (Bt, T_l, H, P), dt: (Bt, T_l, H), B, C:
    (Bt, T_l, 1, N), this rank's shard; zero initial state. Returns (y,
    the final state (Bt, H, P, N), alike on every "model" rank)."""
    from repro_torch.models.mamba2 import ssd_chunked

    mesh = rules.mesh
    n, i = mesh.axis_size("model"), mesh.axis_index("model")
    Bt, T, H, Pd = x.shape
    N = B.shape[-1]
    S0 = torch.zeros((Bt, H, Pd, N), dtype=torch.float32, device=x.device)
    y_local, S_local = ssd_chunked(x, dt, A, B, C, D, S0, chunk=chunk)
    dA = dt * A[None, None]  # (Bt, T, H), <= 0
    cum = torch.cumsum(dA, dim=1)
    D_local = torch.exp(cum[:, -1])  # (Bt, H) the shard's decay
    cincl = torch.exp(cum)  # y_t reads S_t: decay from the shard's start, inclusive
    S_all = all_gather_stack(S_local, mesh, "model")  # (n, Bt, H, P, N)
    D_all = all_gather_stack(D_local, mesh, "model")  # (n, Bt, H)
    S_start = _fold(S_all, D_all, i, lambda d: d[..., None, None])
    y = y_local + torch.einsum("btn,bth,bhpn->bthp", C[:, :, 0], cincl, S_start)
    S_final = S_start * D_all[i][..., None, None] + S_local
    return y, _last_shard_state(S_final, mesh, i, n)

"""Paged serving steps: prefill and decode against a KV page pool.

Own copies of the JAX package's ``build_paged_prefill_step`` and
``build_paged_decode_step`` (``repro/runtime/steps.py``). ``jit`` and
buffer donation have no counterpart: PyTorch runs eagerly, and the steps
update the page pools **in place** (``index_put_``), returning the same
pool tensors so callers read like the JAX package's. A step's logical
context is still gathered from the pool into a dense per-row cache
(``pages[:, table]``) before ``model.decode`` runs on it. Page 0 is the
scratch page: padding rows and columns write there, possibly more than
once per call (the order of those writes is undefined), and nothing ever
reads it.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.base import BaseModel
from repro_torch.models.common import first_argmax


def _check_paged(model: BaseModel) -> None:
    if not getattr(model, "SUPPORTS_PAGED", False):
        raise ValueError(
            f"{type(model).__name__} does not support the paged serving path "
            "(needs last_pos prefill + the standard (L,B,S,KV,hd) cache dict)")


def build_paged_prefill_step(model: BaseModel, *, page_size: int) -> Callable:
    """Prefill that writes the prompt cache straight into pool pages.

    ``fn(params, k_pages, v_pages, tokens, last_pos, table) -> (next_tok,
    k_pages, v_pages)`` with ``tokens``: (B, S) rows right-padded to a
    bucket that is a multiple of ``page_size``, ``last_pos``: (B,) index of
    each row's true last prompt token, ``table``: (B, S // page_size)
    physical page ids covering each row's whole bucket (padding rows and
    columns point at scratch page 0). The pools are updated in place.
    """
    _check_paged(model)
    ps = int(page_size)

    def prefill(params, k_pages, v_pages, tokens, last_pos, table):
        B, S = tokens.shape
        logits, cache = model.prefill(params, {"tokens": tokens, "last_pos": last_pos})
        idx = table.reshape(-1).to(torch.long)

        # (L, B, S, KV, hd) -> (L, B * S/ps, ps, KV, hd): row-major, so page
        # blocks line up with the flattened table
        def to_pages(pages, dense):
            L, _, _, KV, hd = dense.shape
            pages.index_copy_(1, idx, dense.reshape(L, B * (S // ps), ps, KV, hd).to(pages.dtype))

        to_pages(k_pages, cache["k"])
        to_pages(v_pages, cache["v"])
        next_tok = first_argmax(logits[:, -1], dim=-1).to(torch.int32)  # (B,)
        return next_tok, k_pages, v_pages

    return prefill


def build_paged_decode_step(model: BaseModel, *, page_size: int, quantum: int = 1) -> Callable:
    """Decode over gathered pages, one call per scheduling quantum.

    With ``quantum=1``: ``fn(params, k_pages, v_pages, tokens, positions,
    table) -> (next_tok, k_pages, v_pages)`` with ``tokens``: (B, 1)
    current token per live row, ``positions``: (B,) write index (= live
    length) per row, ``table``: (B, max_pages) page ids padded with the
    scratch page 0. Gathers each row's logical context into a dense
    (B, max_pages * page_size) cache, runs ``model.decode`` on it, and
    writes only the new K/V entry back into the row's live page.

    With ``quantum=q > 1`` one call emits q greedy tokens per live row:
    ``fn(..., table, left) -> (tokens (B, q), k_pages, v_pages)`` where
    ``left``: (B,) tokens remaining in each row's budget. The pages are
    gathered once, q decode steps run against that dense cache, and the q
    new entries go back to the pool in one write; entries with
    ``s >= left[row]`` go to scratch page 0, so a row never writes past its
    reservation (the host discards its surplus tokens). Positions past the
    dense cache are clamped on the way back; their values are discarded.

    On CUDA tensors ``model.decode`` runs the decode-attention kernel;
    there is no switch like the JAX package's ``use_kernel``.
    """
    _check_paged(model)
    ps = int(page_size)
    q = max(int(quantum), 1)

    def gather(pages, table):
        B, mp = table.shape
        L, _, _, KV, hd = pages.shape
        return pages[:, table.to(torch.long)].reshape(L, B, mp * ps, KV, hd)

    def scatter(pages, dense, table, pos, write):
        """Write the entries at ``pos`` (B, n) of ``dense`` (L, B, S, KV, hd)
        into the pool; ``write`` False sends an entry to scratch page 0."""
        B, mp = table.shape
        L, _, S, KV, hd = dense.shape
        rows = torch.arange(B, device=pos.device)[:, None].expand_as(pos)
        tab = table.to(torch.long)
        pg = torch.where(write, tab[rows, torch.clamp(pos // ps, max=mp - 1)], 0)
        off = torch.where(write, pos % ps, 0)
        new = dense[:, rows, torch.clamp(pos, max=S - 1)]  # (L, B, n, KV, hd)
        pages[:, pg.reshape(-1), off.reshape(-1)] = new.reshape(L, -1, KV, hd).to(pages.dtype)

    if q == 1:
        def decode(params, k_pages, v_pages, tokens, positions, table):
            cache = {"k": gather(k_pages, table), "v": gather(v_pages, table)}
            logits, cache = model.decode(params, cache, {"tokens": tokens, "positions": positions})
            pos = positions.to(torch.long)[:, None]
            write = torch.ones_like(pos, dtype=torch.bool)
            scatter(k_pages, cache["k"], table, pos, write)
            scatter(v_pages, cache["v"], table, pos, write)
            next_tok = first_argmax(logits[:, -1], dim=-1).to(torch.int32)  # (B,)
            return next_tok, k_pages, v_pages
    else:
        def decode(params, k_pages, v_pages, tokens, positions, table, left):
            cache = {"k": gather(k_pages, table), "v": gather(v_pages, table)}
            tok, pos, toks = tokens, positions, []
            for _ in range(q):
                logits, cache = model.decode(params, cache, {"tokens": tok, "positions": pos})
                nt = first_argmax(logits[:, -1], dim=-1).to(torch.int32)
                toks.append(nt)
                tok, pos = nt[:, None], pos + 1
            steps = torch.arange(q, device=positions.device)[None, :]
            pos_q = positions.to(torch.long)[:, None] + steps  # (B, q)
            write = steps < left.to(torch.long)[:, None]
            scatter(k_pages, cache["k"], table, pos_q, write)
            scatter(v_pages, cache["v"], table, pos_q, write)
            return torch.stack(toks, dim=1), k_pages, v_pages  # (B, q)

    return decode

"""Paged KV cache: fixed-size cache pages + a free-list allocator.

The serving engine's memory problem is that a dense
per-sequence KV cache must be sized for the *longest possible* context, so
heavy-tail prompt/output lengths strand most of the buffer. Paging fixes
that: the cache is one device-resident pool of ``n_pages`` fixed-size pages
per layer, sequences own *page tables* (host-side lists of page ids), and
finished sequences return their pages to the free list immediately — the
freed capacity admits the next queued prompt mid-stream.

Two layers:

* :class:`PagePool` — the pure host-side allocator. O(1) alloc/release via
  a free-list stack, atomic multi-page allocation (all-or-nothing), and an
  owner map whose invariants (no double allocation, conservation, live
  sequences keep their pages) are the JAX package's hypothesis property suite
  (``tests/test_serving_props.py``); the port's copy is held to the same
  cases in ``tests/test_torch_serving.py``.
* :class:`PagedKVCache` — the device half: ``(L, n_pages, page_size, KV,
  hd)`` key/value tensors on one device plus the pool. The steps
  (``runtime/steps.py``) gather a sequence's logical context from its page
  table and write the new token's K/V back into its last page, in place;
  this class only hands out tables and tracks ownership.

Page 0 is **reserved as a scratch page**: page tables are padded with 0, so
the prefill/decode scatters route padding-row writes into page 0 (harmless
garbage, masked by positions on read) instead of colliding with a live
sequence's pages. The allocator never hands out page 0.
"""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.core.service import resolve_device


class PageAllocError(RuntimeError):
    """A sequence asked for pages it cannot ever get (larger than the pool)."""


class PagePool:
    """Free-list allocator over ``n_pages`` pages of ``page_size`` tokens.

    Page 0 is reserved (scratch for padded table entries); ``capacity_pages``
    is therefore ``n_pages - 1``. Allocation is atomic: ``alloc`` either
    hands over all requested pages or none.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the reserved scratch page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently released (cache-warm) pages re-issue first;
        # deterministic order keeps trace replays bit-identical
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self._owned: dict[Any, list[int]] = {}

    # ---- queries ----------------------------------------------------------

    @property
    def capacity_pages(self) -> int:
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.capacity_pages - self.free_pages

    @property
    def utilization(self) -> float:
        return self.used_pages / self.capacity_pages

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache entries."""
        return max(-(-int(n_tokens) // self.page_size), 0)

    def owned(self, seq: Any) -> list[int]:
        return list(self._owned.get(seq, ()))

    def capacity_tokens(self, seq: Any) -> int:
        """Cache entries ``seq``'s current pages can hold."""
        return len(self._owned.get(seq, ())) * self.page_size

    def sequences(self) -> set:
        return set(self._owned)

    # ---- allocation -------------------------------------------------------

    def alloc(self, seq: Any, n: int) -> bool:
        """Give ``seq`` ``n`` more pages; False (and no change) if the free
        list is short. Raises :class:`PageAllocError` if ``n`` exceeds the
        whole pool — that request could never succeed."""
        n = int(n)
        if n > self.capacity_pages:
            raise PageAllocError(
                f"{n} pages requested but the pool holds {self.capacity_pages}")
        if n > len(self._free):
            return False
        if n > 0:
            take = [self._free.pop() for _ in range(n)]
            self._owned.setdefault(seq, []).extend(take)
        elif seq not in self._owned:
            self._owned[seq] = []
        return True

    def ensure(self, seq: Any, n_tokens: int) -> bool:
        """Grow ``seq`` so its pages hold ``n_tokens`` entries (no-op when
        they already do). False (no change) when the pool is out of pages."""
        need = self.pages_for(n_tokens) - len(self._owned.get(seq, ()))
        if need <= 0:
            return True
        return self.alloc(seq, need)

    def release(self, seq: Any) -> int:
        """Return every page ``seq`` owns to the free list; number freed."""
        pages = self._owned.pop(seq, None)
        if not pages:
            return 0
        self._free.extend(reversed(pages))
        return len(pages)

    def reset(self) -> None:
        """Drop every owner (crash recovery: device pages are garbage)."""
        self._owned.clear()
        self._free = list(range(self.n_pages - 1, 0, -1))

    def check_invariants(self) -> None:
        """Assert allocator soundness (test hook; cheap enough for debug use)."""
        allocated = [p for pages in self._owned.values() for p in pages]
        assert 0 not in allocated, "scratch page 0 leaked into an owner"
        assert 0 not in self._free, "scratch page 0 leaked into the free list"
        assert len(set(allocated)) == len(allocated), "page double-allocated"
        assert not set(allocated) & set(self._free), "page both free and owned"
        assert len(allocated) + len(self._free) == self.capacity_pages, \
            "pages leaked or invented"


class PagedKVCache:
    """Device page pool + per-sequence page tables.

    ``k``/``v`` are the live device tensors, shape ``(L, n_pages,
    page_size, KV, hd)``, on ``device`` (CUDA unless a CPU device is
    named); the steps update them in place. Their dtype is the one the
    model's prefill writes its cache in — the compute dtype (bf16 at full
    width, f32 in the reduced configs) — not ``cache_struct``'s bf16, so a
    reduced f32 config is never silently down-cast.
    """

    def __init__(self, n_layers: int, n_kv_heads: int, head_dim: int, *,
                 n_pages: int, page_size: int, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        self.pool = PagePool(n_pages, page_size)
        self.page_size = self.pool.page_size
        self.device = resolve_device(device)
        self._shape = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
        self._dtype = dtype
        self.k = torch.zeros(self._shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(self._shape, dtype=dtype, device=self.device)

    @classmethod
    def from_model(cls, model: Any, *, n_pages: int, page_size: int,
                   device: torch.device | str = "cuda") -> "PagedKVCache":
        cfg = model.cfg
        # prefill's K/V come out of the compute-dtype qkv projection
        return cls(cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim, n_pages=n_pages,
                   page_size=page_size, dtype=model.compute_dtype, device=device)

    # ---- ownership (delegates to the pool) --------------------------------

    def admit(self, seq: Any, n_tokens: int) -> bool:
        """Allocate pages for a ``n_tokens``-entry prompt (bucket-padded
        length — the prefill scatter writes every bucket position)."""
        return self.pool.alloc(seq, self.pool.pages_for(n_tokens))

    def ensure(self, seq: Any, n_tokens: int) -> bool:
        return self.pool.ensure(seq, n_tokens)

    def release(self, seq: Any) -> int:
        return self.pool.release(seq)

    def reset(self) -> None:
        """Crash recovery: forget every owner and zero the device pages."""
        self.pool.reset()
        self.k = torch.zeros(self._shape, dtype=self._dtype, device=self.device)
        self.v = torch.zeros(self._shape, dtype=self._dtype, device=self.device)

    def synchronize(self) -> None:
        """Wait until every queued write to the pools has landed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- tables -----------------------------------------------------------

    def table(self, seqs: Iterable[Any], width: int, rows: int | None = None,
              *, truncate: bool = False) -> np.ndarray:
        """``(rows, width)`` int32 page table: row i = seq i's pages, padded
        with the scratch page 0; extra rows (live-batch bucket padding) are
        all-scratch. ``truncate=True`` takes only the first ``width`` pages
        (the prefill scatter covers just the prompt-bucket prefix of a
        lifetime reservation); otherwise overflowing a row is an error."""
        seqs = list(seqs)
        rows = len(seqs) if rows is None else int(rows)
        out = np.zeros((rows, int(width)), np.int32)
        for i, s in enumerate(seqs):
            pages = self.pool._owned.get(s, ())
            if len(pages) > out.shape[1]:
                if not truncate:
                    raise ValueError(
                        f"seq {s!r} owns {len(pages)} pages > table width {width}")
                pages = pages[: out.shape[1]]
            out[i, : len(pages)] = pages
        return out

    @property
    def utilization(self) -> float:
        return self.pool.utilization

    @property
    def free_pages(self) -> int:
        return self.pool.free_pages

"""Paged KV cache: ring KV allocated in fixed-size blocks via a page table.

The port of ``repro.serve.pages``.  The block-sparse engine manages
matrix panels as fixed-size blocks with host-side liveness maps
(``core.plan``); this module applies the same treatment to KV-cache
liveness.  Instead of one contiguous ``(B, Hkv, S_cache, Dh)`` ring per
layer, each layer holds a **page pool** ``(n_pages, Hkv, page_size, Dh)``
(stacked ``(U, n_pages, ...)`` for the units) and every batch slot owns
an ordered list of page ids recorded in a single **page table** shared
by all layers — layer ``i``'s token ``t`` always lives at
``(table[slot, t // page_size], t % page_size)`` of layer ``i``'s pool.
Admitting a request allocates pages from the free list as its sequence
grows; evicting returns them with **no reshaping or compaction of live
state** — exactly the property the continuous-batching scheduler needs.

Page ``0`` is reserved as the *trash page*: rows with nothing to write
this step (inactive slots, out-of-capacity positions) are routed there,
so the decode step has the same shapes every step and no per-row
branching.

Scope, the reference's: non-windowed archs (a sliding-window ring is
already O(window) and gains nothing from paging), ``tp_size == 1`` and
``kv_quant=False`` — the seq-sharded and int8 decode paths keep the dense
ring layout (``serve.engine``).  A data-parallel grid is in scope, with
the reference's layout: one page table over every slot (kept on the host
alike on every rank, so every page number is the reference's) and a
pool at the reference's shape on every dp rank (the page axis is not
split over dp).  Each rank writes and gathers the pages of its own rows
of the slot pool only (``serve.scheduler``), so of its copy of the pool
only those pages are live.

Like ``engine.decode_step``, ``paged_prefill_write`` and
``paged_decode_step`` update the pools they are given in place.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.dist.context import ParallelCtx
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.serve import engine

__all__ = [
    "OutOfPages",
    "PageAllocator",
    "paged_init_cache",
    "paged_prefill_write",
    "paged_decode_step",
    "gather_pages",
]


class OutOfPages(RuntimeError):
    """The free list is empty — admission must wait for an eviction."""


@dataclasses.dataclass
class PageAllocator:
    """Host-side page-table bookkeeping (numpy; no device state).

    ``n_pages`` counts the pool's physical pages *including* the reserved
    trash page 0, so ``n_pages - 1`` are allocatable.  ``max_pages`` is
    the per-slot table width: slot capacity = ``max_pages * page_size``
    tokens.
    """

    n_pages: int
    page_size: int
    n_slots: int
    max_pages: int

    def __post_init__(self):
        if self.n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self.slot_pages: list[list[int]] = [[] for _ in range(self.n_slots)]
        self._table = np.zeros((self.n_slots, self.max_pages), np.int32)

    @property
    def capacity(self) -> int:
        """Max tokens one slot can hold."""
        return self.max_pages * self.page_size

    def n_free(self) -> int:
        return len(self.free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)  # ceil

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot`` to cover ``n_tokens`` tokens, allocating from the
        free list.  Raises :class:`OutOfPages` (allocating nothing) when
        the free list is short, and ``CacheCapacityError`` past the
        per-slot table width."""
        need = self.pages_needed(n_tokens)
        have = len(self.slot_pages[slot])
        if need > self.max_pages:
            raise engine.CacheCapacityError(
                f"request needs {need} pages > max_pages={self.max_pages} "
                f"({n_tokens} tokens, page_size={self.page_size})"
            )
        grow = need - have
        if grow <= 0:
            return
        if grow > len(self.free):
            raise OutOfPages(
                f"slot {slot} needs {grow} pages, {len(self.free)} free"
            )
        for _ in range(grow):
            pid = self.free.pop()
            self.slot_pages[slot].append(pid)
            self._table[slot, len(self.slot_pages[slot]) - 1] = pid

    def release(self, slot: int) -> int:
        """Return ``slot``'s pages to the free list; returns how many."""
        pages = self.slot_pages[slot]
        n = len(pages)
        self.free.extend(reversed(pages))
        self.slot_pages[slot] = []
        self._table[slot, :] = 0
        return n

    def table(self, device="cpu") -> torch.Tensor:
        """The page table ``(n_slots, max_pages)`` int64 on ``device``
        (trash page 0 for unallocated entries)."""
        return torch.as_tensor(self._table.astype(np.int64), device=device)


# ---------------------------------------------------------------------------
# pool init / prefill scatter / gather
# ---------------------------------------------------------------------------


def _check_paged_supported(cfg: ModelConfig, ctx: ParallelCtx):
    """Refuse what the reference refuses: a window, ``kv_quant`` and a
    tensor-parallel axis of more than one rank.  Data parallelism is
    allowed (see the module's scope)."""
    if cfg.window is not None:
        raise NotImplementedError(
            "paged KV targets non-windowed archs (a sliding-window ring is "
            "already O(window))"
        )
    if ctx.kv_quant:
        raise NotImplementedError("paged + kv_quant: keep the dense ring")
    if ctx.tp_size > 1:
        raise NotImplementedError(
            "paged + TP seq-sharding: keep the dense ring"
        )


def paged_init_cache(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_size: int, ctx: ParallelCtx | None = None, *,
                     device="cuda"):
    """Like ``engine.init_cache`` but every attn cache is a page pool
    ``(n_pages, Hkv, page_size, Dh)`` (stacked ``(U, n_pages, ...)``) —
    there is **no batch axis** on KV leaves; the page table owns the
    slot -> page mapping.  Recurrent/conv states and ``pos`` keep their
    dense per-slot layout (they are O(1) per row; nothing to page), with
    ``n_slots`` rows: on a dp grid, the rows this rank holds."""
    if ctx is not None:
        _check_paged_supported(cfg, ctx)
    dense = engine.init_cache(cfg, n_slots, page_size, device=device)

    def pool(path, leaf):
        if path[-1] not in engine._KV_LEAF_KEYS:
            return leaf
        # dense: (U?, n_slots, Hkv, page_size, Dh) -> (U?, n_pages, ...)
        ax = engine.cache_batch_axis(path)
        shape = leaf.shape[:ax] + (n_pages,) + leaf.shape[ax + 1:]
        return leaf.new_zeros(shape)

    return engine.map_cache(pool, dense)


def _scatter_tokens(pool, kv, pages, n_tokens: int, page_size: int) -> None:
    """Write ``kv`` ``(1, Hkv, S, Dh)`` tokens ``[0, n_tokens)`` into
    ``pool`` ``(n_pages, Hkv, page_size, Dh)`` at the slot's ``pages``,
    in place."""
    t = np.arange(n_tokens)
    page_ids = torch.as_tensor(np.asarray(pages, np.int64)[t // page_size],
                               device=pool.device)
    within = torch.as_tensor(t % page_size, device=pool.device)
    vals = kv[0, :, :n_tokens, :].transpose(0, 1)  # (S, Hkv, Dh)
    pool[page_ids, :, within, :] = vals.to(pool.dtype)


def paged_prefill_write(pools, dense_cache, alloc: PageAllocator, slot: int,
                        n_tokens: int):
    """Scatter one request's dense prefill KV (``engine.prefill`` with
    batch 1) into the page pools at ``slot``'s pages (allocate first with
    ``alloc.ensure``), in place.  Non-KV leaves are left untouched — the
    scheduler writes those rows directly.  Returns the pools tree."""
    pages = alloc.slot_pages[slot]

    def write(path, pool, sub):
        if path[-1] not in engine._KV_LEAF_KEYS:
            return pool
        if engine.cache_batch_axis(path) == 1:  # stacked units
            for u in range(pool.shape[0]):
                _scatter_tokens(pool[u], sub[u], pages, n_tokens,
                                alloc.page_size)
        else:
            _scatter_tokens(pool, sub, pages, n_tokens, alloc.page_size)
        return pool

    return engine.map_cache(write, pools, dense_cache)


def gather_pages(pool, table):
    """``(n_pages, Hkv, ps, Dh)`` x ``(B, max_pages)`` ->
    ``(B, Hkv, max_pages * ps, Dh)`` contiguous per-slot KV."""
    g = pool[table]  # (B, max_pages, Hkv, ps, Dh)
    b, mp, hkv, ps, dh = g.shape
    return g.transpose(1, 2).reshape(b, hkv, mp * ps, dh)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------


def _paged_attend(q_t, k_new, v_new, cache, pos, cfg, ctx, *, table):
    """The paged twin of ``engine._ring_attend``: scatter the new token's
    K/V through the page table (in place), then attend over the gathered
    per-slot views.  Out-of-capacity / unmapped positions write to trash
    page 0 (dropped — same saturating contract as the ring)."""
    b = q_t.shape[0]
    ps = cache["k"].shape[2]
    max_pages = table.shape[1]
    rows = torch.arange(b, device=q_t.device)
    page_idx = torch.clamp(pos // ps, 0, max_pages - 1)
    in_range = pos < max_pages * ps
    page = torch.where(in_range, table[rows, page_idx],
                       torch.zeros((), dtype=table.dtype, device=q_t.device))
    within = pos % ps
    # Every row with nothing to write lands on trash page 0, several at
    # once: index_put_ leaves the order among duplicate indices
    # unspecified (as the reference's scatter does), which is harmless
    # only because nothing ever reads page 0 as live.
    cache["k"][page, :, within, :] = k_new[:, :, 0, :].to(cache["k"].dtype)
    cache["v"][page, :, within, :] = v_new[:, :, 0, :].to(cache["v"].dtype)

    # attention over the gathered per-slot views: the dense ring's
    # softmax pieces (the same function as the reference's softmax)
    n_valid = torch.clamp(pos + 1, max=max_pages * ps)
    _, l, o = engine._partial_attn(q_t, gather_pages(cache["k"], table),
                                   gather_pages(cache["v"], table), n_valid,
                                   0)
    return o / torch.clamp(l[..., None], min=1e-30)


def paged_decode_step(model: LM, cache, tokens, table, cfg: ModelConfig,
                      ctx: ParallelCtx, *, active=None):
    """``engine.decode_step`` over page pools: same per-row ``pos``
    vector and ``active`` advancement, but attn KV lives behind
    ``table`` ``(B, max_pages)`` (on the pools' device).  Like
    ``tokens``, the table holds every row: where the batch is split over
    dp (``engine.decode_rows``) the step reads this rank's rows of it.
    Updates ``cache`` in place and returns (logits, cache)."""
    if ctx.splits_batch(tokens.shape[0]):
        table = ctx.block(table, ctx.dp)
    return engine.decode_step(model, cache, tokens, cfg, ctx, active=active,
                              attend=functools.partial(_paged_attend,
                                                       table=table))

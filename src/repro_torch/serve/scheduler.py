"""Continuous-batching scheduler: the serving front-end's request loop.

The port of ``repro.serve.scheduler``.  The paper's thesis is that
fine-grained tasks plus a multiple-issue window absorb irregular load
without global synchronization; ragged serving traffic is the same
problem one level up.  This scheduler holds a fixed pool of ``n_slots``
batch slots and, **per decode step**, admits queued requests into free
slots and evicts finished ones — requests never wait for the whole batch
to drain (that is ``mode="static"``, the baseline this module exists to
beat).  The enabling engine feature is the per-slot ``(B,)`` position
vector: every slot decodes at its own depth, and ``decode_step(...,
active=...)`` advances only live rows.

Admission control reuses the schedule simulator's machine model
(``sched.simulator.MachineModel``): each admission costs one batch-1
prefill, estimated as ``compute_time(2 * active_params * prompt_len)``
seconds, and at most ``admit_budget_s`` of estimated prefill work is
admitted per step — bounding the per-step latency tail (p99) instead of
letting a burst of arrivals stall every live stream.

Backends: ``"dense"`` uses ``engine``'s ring caches; ``"paged"`` uses
``serve.pages`` pools + page table, so eviction returns pages with no
reshaping of live state.  Each step brings the argmax tokens back to the
host once; on the card a step's latency ends in a synchronize, so p50
and p99 time the work, not the launch queue.  The pool lives on the
model's device.

On a grid of dp ranks (the model holding its blocks,
``dist.partitioning.shard_params``) the slot pool is split over dp:
``n_slots`` must divide by dp, and each DP rank holds its ``n_slots /
dp`` rows of the caches.  Every rank runs the same loop: an admission's
batch-1 prefill runs on every rank (it does not divide dp) and the
slot's owner keeps its cache row; each decode step runs each rank's rows
and gathers the step's logits, so every rank picks the same tokens and
admits and evicts alike.  The paged backend keeps the reference's one
allocator over all ``n_slots`` on every rank (the same admissions and
page numbers everywhere) and a pool of the reference's shape; a rank
writes a slot's pages only where it owns the slot, and decodes its rows
of the page table.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.dist.context import ParallelCtx
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.sched.simulator import DEFAULT_MACHINE, MachineModel
from repro_torch.serve import engine, pages

__all__ = ["Request", "Scheduler", "ragged_trace"]


@dataclasses.dataclass
class Request:
    """One serving request: a prompt plus a greedy-decode length."""

    rid: int
    prompt: np.ndarray  # (S,) int32 token ids
    max_new_tokens: int
    arrival_step: int = 0
    # filled by the scheduler
    out_tokens: list = dataclasses.field(default_factory=list)
    admitted_step: int = -1
    finished_step: int = -1

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


def ragged_trace(n_requests: int, *, prompt_lens=(8, 16),
                 gen_lens=(4, 24), vocab: int = 256, seed: int = 0,
                 arrival_every: int = 0) -> list[Request]:
    """A deterministic ragged arrival trace: prompt/gen lengths cycle
    through the given sets (maximally mixed, so a static batch always
    contains one nearly-finished and one long-running request), tokens
    drawn from ``vocab``.  ``arrival_every > 0`` staggers arrivals."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        # gen length cycles fastest: adjacent requests (which a static
        # batcher pins into one batch) always have different decode depths
        g = int(gen_lens[i % len(gen_lens)])
        s = int(prompt_lens[(i // len(gen_lens)) % len(prompt_lens)])
        reqs.append(
            Request(
                rid=i,
                prompt=rng.integers(0, vocab, size=s).astype(np.int32),
                max_new_tokens=g,
                arrival_step=i * arrival_every if arrival_every else 0,
            )
        )
    return reqs


class Scheduler:
    """Slot-pool scheduler over ``engine``/``pages`` decode.

    ``mode="continuous"`` admits into any free slot every step;
    ``mode="static"`` admits only when *all* slots are free (classic
    batch serving — same code path, so the comparison is fair).
    """

    def __init__(self, params: LM, cfg: ModelConfig, ctx: ParallelCtx, *,
                 n_slots: int, max_len: int, mode: str = "continuous",
                 backend: str = "dense", page_size: int = 8,
                 n_pages: int | None = None,
                 machine: MachineModel = DEFAULT_MACHINE,
                 admit_budget_s: float = float("inf")):
        if mode not in ("continuous", "static"):
            raise ValueError(f"mode={mode!r}")
        if backend not in ("dense", "paged"):
            raise ValueError(f"backend={backend!r}")
        # the pool's rows this rank holds: its share over dp
        if n_slots % ctx.dp_size:
            raise ValueError(
                f"n_slots={n_slots} must divide by dp={ctx.dp_size}: "
                "each DP rank holds an equal share of the slot pool")
        n = n_slots // ctx.dp_size
        r0 = ctx.grid.axis_index(ctx.dp) * n if ctx.dp_size > 1 else 0
        self.rows = range(r0, r0 + n)
        self.params = params
        self.cfg = cfg
        self.ctx = ctx
        self.n_slots = n_slots
        self.max_len = max_len
        self.mode = mode
        self.backend = backend
        self.machine = machine
        self.admit_budget_s = admit_budget_s
        self.s_cache = engine.cache_len(cfg, max_len)
        self.device = next(params.parameters()).device

        if backend == "paged":
            max_pages = -(-max_len // page_size)
            if n_pages is None:
                # enough for every slot full, + the trash page
                n_pages = n_slots * max_pages + 1
            self.alloc = pages.PageAllocator(
                n_pages=n_pages, page_size=page_size, n_slots=n_slots,
                max_pages=max_pages,
            )
            # the pool at the reference's shape; the per-slot leaves
            # (``pos``, recurrent states) hold this rank's rows
            self.cache = pages.paged_init_cache(
                cfg, len(self.rows), n_pages, page_size, ctx,
                device=self.device,
            )
        else:
            self.alloc = None
            # on a tensor-parallel grid the pool holds this rank's S-shard,
            # as prefill's caches do, and over dp its rows
            self.cache = engine._local_kv(engine.init_cache(
                cfg, len(self.rows), max_len, kv_quant=ctx.kv_quant,
                device=self.device,
            ), ctx, len(self.rows))
        # host mirrors of the slots' next tokens and positions: the loop
        # reads them without a wait for the card
        self.tokens = np.zeros(n_slots, np.int64)
        self.pos = np.zeros(n_slots, np.int64)
        self.slot_req: list[Request | None] = [None] * n_slots
        self.remaining = np.zeros(n_slots, np.int64)
        self.queue: deque[Request] = deque()
        self.stats = {
            "steps": 0, "prefills": 0, "evictions": 0,
            "decoded_tokens": 0, "budget_deferrals": 0,
        }
        self.step_latencies: list[float] = []

    # -- request intake ------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request; rejects ones that can never fit the cache."""
        total = req.prompt_len + req.max_new_tokens
        cap = (
            self.alloc.capacity if self.backend == "paged" else self.s_cache
        )
        if self.cfg.window is None and total > cap:
            raise engine.CacheCapacityError(
                f"request {req.rid}: {req.prompt_len} prompt + "
                f"{req.max_new_tokens} new = {total} tokens > cache "
                f"capacity {cap}"
            )
        self.queue.append(req)

    # -- slot plumbing -------------------------------------------------------

    def _decode(self, tokens, active):
        if self.backend == "paged":
            return pages.paged_decode_step(
                self.params, self.cache, tokens,
                self.alloc.table(self.device), self.cfg, self.ctx,
                active=active,
            )
        return engine.decode_step(self.params, self.cache, tokens, self.cfg,
                                  self.ctx, active=active)

    def _write_slot(self, sub_cache, slot: int) -> None:
        """Install a batch-1 prefill cache into batch row ``slot``, in
        place.  KV leaves of the paged backend scatter through the page
        table; every other leaf (recurrent state, ``pos``; dense KV) is a
        row write at the leaf's batch axis."""
        if self.backend == "paged":
            # every rank allocates alike; the slot's owner writes its pages
            req = self.slot_req[slot]
            self.alloc.ensure(slot, req.prompt_len)
            if slot in self.rows:
                pages.paged_prefill_write(
                    self.cache, sub_cache, self.alloc, slot, req.prompt_len
                )

        if slot not in self.rows:  # only the slot's DP rank holds its row
            return
        slot -= self.rows.start

        def row(path, leaf, sub):
            if self.backend == "paged" and (
                path[-1] in engine._KV_LEAF_KEYS
            ):
                return  # already scattered into the pools
            ax = engine.cache_batch_axis(path)
            leaf.select(ax, slot).copy_(sub.select(ax, 0))

        engine.map_cache(row, self.cache, sub_cache)

    def _admit(self, step: int) -> None:
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if self.mode == "static" and len(free) < self.n_slots:
            return  # static batching: wait for the whole batch to drain
        budget = self.admit_budget_s
        admitted = 0
        while self.queue and free:
            req = self.queue[0]
            if req.arrival_step > step:
                break
            cost = self.machine.compute_time(
                2.0 * self.cfg.active_param_count() * req.prompt_len
            )
            # always make progress: the step's first admission is exempt,
            # so one over-budget prompt delays neighbours, never starves.
            if cost > budget and admitted > 0:
                self.stats["budget_deferrals"] += 1
                break
            if self.backend == "paged":
                need = self.alloc.pages_needed(req.prompt_len)
                if need > self.alloc.n_free():
                    break  # wait for an eviction to return pages
            self.queue.popleft()
            slot = free.pop(0)
            self.slot_req[slot] = req
            req.admitted_step = step
            budget -= cost
            prompt = torch.as_tensor(req.prompt.astype(np.int64),
                                     device=self.device)[None]
            logits, sub = engine.prefill(self.params, {"tokens": prompt},
                                         self.cfg, self.ctx,
                                         max_len=self.max_len)
            tok = int(logits[0].argmax())
            req.out_tokens.append(tok)
            self._write_slot(sub, slot)
            self.tokens[slot] = tok
            self.pos[slot] = req.prompt_len
            self.remaining[slot] = req.max_new_tokens - 1
            self.stats["prefills"] += 1
            admitted += 1
            if self.remaining[slot] <= 0:
                self._evict(slot, step)

    def _evict(self, slot: int, step: int) -> None:
        req = self.slot_req[slot]
        req.finished_step = step
        self.slot_req[slot] = None
        self.remaining[slot] = 0
        if self.backend == "paged":
            self.alloc.release(slot)
        self.stats["evictions"] += 1

    # -- the loop ------------------------------------------------------------

    def _active_mask(self) -> np.ndarray:
        return np.array([r is not None for r in self.slot_req])

    def step(self, step_idx: int) -> None:
        """One scheduler step: admit, decode once, harvest, evict."""
        t0 = time.perf_counter()
        self._admit(step_idx)
        active = self._active_mask()
        if active.any():
            # capacity guard: the engine drops over-capacity writes; the
            # loop must never ask for those logits (module contract).
            if self.cfg.window is None and self.backend == "dense":
                if (self.pos[active] >= self.s_cache).any():
                    raise engine.CacheCapacityError(
                        f"active slot at pos {int(self.pos[active].max())} "
                        f">= cache capacity {self.s_cache}"
                    )
            if self.backend == "paged":
                # grow pages on demand: this step writes each active row's
                # KV at ``pos``, which must be page-mapped before decode
                # (an unmapped write lands on the trash page but the
                # position would still be live-masked — garbage reads).
                for i in np.flatnonzero(active):
                    self.alloc.ensure(int(i), int(self.pos[i]) + 1)
            logits, self.cache = self._decode(
                torch.as_tensor(self.tokens, device=self.device),
                torch.as_tensor(active.astype(np.int64), device=self.device),
            )
            toks = logits.argmax(dim=-1).cpu().numpy()  # the step's one sync
            self.pos += active
            for i in np.flatnonzero(active):
                req = self.slot_req[i]
                req.out_tokens.append(int(toks[i]))
                self.tokens[i] = toks[i]
                self.remaining[i] -= 1
                if self.remaining[i] <= 0:
                    self._evict(int(i), step_idx)
            self.stats["decoded_tokens"] += int(active.sum())
        self.stats["steps"] += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.step_latencies.append(time.perf_counter() - t0)

    def run(self, requests, *, max_steps: int = 100_000) -> dict:
        """Serve ``requests`` to completion; returns outputs + metrics.

        ``tokens/s`` counts *generated* tokens (prefill-emitted first
        token + decode tokens) over total wall; p50/p99 are per-step wall
        latencies in ms (admission + decode, the user-visible stall)."""
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        step = 0
        while (self.queue or self._active_mask().any()) and step < max_steps:
            self.step(step)
            step += 1
        wall = time.perf_counter() - t0
        if self.queue:
            raise RuntimeError(f"max_steps hit with {len(self.queue)} queued")
        total_tokens = sum(len(r.out_tokens) for r in requests)
        lat = np.array(self.step_latencies)
        return {
            "mode": self.mode,
            "backend": self.backend,
            "n_slots": self.n_slots,
            "requests": len(requests),
            "outputs": {r.rid: list(r.out_tokens) for r in requests},
            "steps": self.stats["steps"],
            "prefills": self.stats["prefills"],
            "budget_deferrals": self.stats["budget_deferrals"],
            "generated_tokens": int(total_tokens),
            "wall_s": float(wall),
            "tokens_per_s": float(total_tokens / max(wall, 1e-9)),
            "p50_step_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_step_ms": float(np.percentile(lat, 99) * 1e3),
        }

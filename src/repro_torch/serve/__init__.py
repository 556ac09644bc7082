"""Serving: KV/recurrent caches, prefill, decode, and the front-end.

The port of ``repro.serve``.

* ``engine``       — batched prefill + single-token decode over ring
  caches (per-slot position vectors, seq-sharded + int8 KV paths).
* ``scheduler``    — continuous-batching request loop (admit/evict per
  decode step; the sched simulator's machine model as admission control).
* ``pages``        — paged KV cache: pools + page table, block-managed
  cache liveness.
* ``plan_service`` — persistent (shape, structure, grid) -> tuned
  schedule winners + traffic-keyed warm lists.
"""

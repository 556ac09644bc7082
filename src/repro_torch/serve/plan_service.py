"""Persistent plan service: tuned-schedule winners as a first-class cache.

The port of ``repro.serve.plan_service``; keys and files equal the
reference's for the same grid geometry, so one file serves both packages.

``warm_matmul_plans`` moves the simulator search (lookahead x k_blocks x
strategy x stationarity x comm_mode, sched.tuner) out of the
serving path — but every *process* would re-run it.  DBCSR ships its
per-shape tuning results as a persistent library, and
``kernels.autotune.KernelAutotuner`` does the same for kernel winners;
this module gives the schedule layer the same treatment:

* winners are keyed by **(shape, structure digest, mesh fingerprint)** —
  ``m x k x n x itemsize``, the sha1 of the weight block mask (or
  ``"dense"``), and the grid's axis names x sizes — so a cache tuned on
  one grid never steers another;
* :meth:`PlanService.plan_projection` is the consult point used by
  ``serve.engine.warm_matmul_plans``: a hit re-applies the stored
  (strategy, k_blocks, lookahead, stationarity, comm_mode) through
  ``ParallelCtx.plan_projection``'s explicit pins — **zero tuner runs**
  — while a miss tunes once and records;
* the observed traffic distribution (``(batch, prompt_len)`` counts) is
  recorded alongside, so a fresh process can :meth:`prewarm` the plan
  *and executable* caches for the shapes production traffic actually
  hits before the first request lands;
* JSON persistence mirrors ``KernelAutotuner.save/load`` exactly —
  stable fingerprint, process singleton seeded from the
  ``REPRO_PLAN_CACHE`` env var, ``REPRO_PLAN_SERVICE=0`` kill switch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

__all__ = [
    "PlanService",
    "plan_service",
    "set_plan_service",
    "mesh_fingerprint",
    "structure_digest",
    "plan_service_enabled",
]

#: the tuned fields a winner record persists and re-applies.
WINNER_FIELDS = ("strategy", "k_blocks", "lookahead", "stationarity",
                 "comm_mode")


def plan_service_enabled() -> bool:
    """``REPRO_PLAN_SERVICE=0`` disables consults (tune-every-time)."""
    return os.environ.get("REPRO_PLAN_SERVICE", "1") != "0"


def mesh_fingerprint(ctx) -> str:
    """Stable id of the grid geometry a plan was tuned on: axis names x
    sizes plus the (dp, tp) role assignment (the reference's string for a
    mesh of the same axes)."""
    if not ctx.has_grid:
        return "nomesh"
    shape = ctx.grid.shape
    axes = ",".join(f"{a}={shape[a]}" for a in ctx.grid.axis_names)
    return f"{axes};dp={'+'.join(ctx.dp_axes)};tp={ctx.tp_axis}"


def structure_digest(mask) -> str:
    """sha1 of the weight block mask bytes; ``"dense"`` for mask-free."""
    if mask is None:
        return "dense"
    m = np.asarray(mask)
    h = hashlib.sha1(str(m.shape).encode())
    h.update(np.ascontiguousarray(m).tobytes())
    return h.hexdigest()[:16]


def _key_str(m: int, k: int, n: int, itemsize: int, structure: str,
             mesh_fp: str) -> str:
    return f"{m}x{k}x{n}xi{itemsize}|{structure}|{mesh_fp}"


def _winner_from_plan(plan) -> dict:
    """Extract the persisted fields from a (tuned or static) plan."""
    tuned = plan.tuned or {}
    return {
        "strategy": tuned.get("strategy", plan.cfg.strategy),
        "k_blocks": int(tuned.get("k_blocks", plan.k_steps)),
        "lookahead": int(tuned.get("lookahead", plan.resolve_lookahead())),
        "stationarity": tuned.get(
            "stationarity", getattr(plan, "stationarity", "C")
        ),
        "comm_mode": tuned.get(
            "comm_mode", getattr(plan, "comm_mode", "broadcast")
        ),
    }


@dataclasses.dataclass
class PlanService:
    """Persistent (shape, structure, mesh) -> tuned-schedule winners plus
    the recorded traffic distribution.  See the module docstring."""

    table: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(
        default_factory=lambda: {"tunes": 0, "hits": 0, "untuned": 0}
    )

    # -- consult -------------------------------------------------------------

    def lookup(self, m: int, k: int, n: int, *, itemsize: int,
               structure: str, mesh_fp: str) -> dict | None:
        """The stored winner, or ``None`` (miss / disabled).  Never tunes."""
        if not plan_service_enabled():
            return None
        return self.table.get(_key_str(m, k, n, itemsize, structure, mesh_fp))

    def record(self, m: int, k: int, n: int, *, itemsize: int,
               structure: str, mesh_fp: str, winner: dict) -> None:
        key = _key_str(m, k, n, itemsize, structure, mesh_fp)
        self.table[key] = {f: winner[f] for f in WINNER_FIELDS}

    def plan_projection(self, ctx, m: int, k: int, n: int, *, itemsize: int,
                        tune: bool, stationarity: str = "C"):
        """``ctx.plan_projection`` with the service in the loop.

        Hit: re-apply the stored winner through the explicit schedule
        pins (no tuner).  Miss with ``tune=True``: run the tuner once and
        record the winner.  Miss without ``tune``: plan statically (there
        is no search to persist).  Returns the plan (``None`` on the
        xla / pure-DP path, like ``ctx.plan_projection``).
        """
        if (
            not ctx.has_grid
            or ctx.matmul_strategy == "xla"
            or ctx.pure_dp
        ):
            return None
        structure = structure_digest(ctx.weight_mask((k, n)))
        mesh_fp = mesh_fingerprint(ctx)
        win = self.lookup(m, k, n, itemsize=itemsize, structure=structure,
                          mesh_fp=mesh_fp)
        if win is not None:
            self.stats["hits"] += 1
            return ctx.plan_projection(
                m, k, n, itemsize=itemsize, tune=False,
                strategy=win["strategy"], lookahead=win["lookahead"],
                stationarity=win["stationarity"],
                comm_mode=win["comm_mode"], k_blocks=win["k_blocks"],
            )
        plan = ctx.plan_projection(
            m, k, n, itemsize=itemsize, tune=tune, stationarity=stationarity
        )
        if plan is None:
            return None
        if tune:
            self.stats["tunes"] += 1
            if plan_service_enabled():
                self.record(
                    m, k, n, itemsize=itemsize, structure=structure,
                    mesh_fp=mesh_fp, winner=_winner_from_plan(plan),
                )
        else:
            self.stats["untuned"] += 1
        return plan

    # -- traffic-keyed pre-warming -------------------------------------------

    def record_traffic(self, batch: int, prompt_len: int) -> None:
        """Count one occurrence of a serving shape (the warm list)."""
        key = f"{batch}x{prompt_len}"
        self.traffic[key] = self.traffic.get(key, 0) + 1

    def top_traffic(self, top: int | None = None) -> list[tuple[int, int]]:
        """Most frequent ``(batch, prompt_len)`` shapes, by count."""
        items = sorted(self.traffic.items(), key=lambda kv: (-kv[1], kv[0]))
        if top is not None:
            items = items[:top]
        return [tuple(int(x) for x in k.split("x")) for k, _ in items]

    def prewarm(self, cfg, ctx, *, top: int | None = 4,
                warm_executables: bool = True) -> int:
        """Warm plans (+ executables) for the recorded traffic shapes —
        call at process start so the first request of every common shape
        dispatches a pre-compiled program.  Returns shapes warmed."""
        from repro_torch.serve import engine

        shapes = self.top_traffic(top)
        for batch, prompt_len in shapes:
            engine.warm_matmul_plans(
                cfg, ctx, batch, prompt_len,
                warm_executables=warm_executables, service=self,
            )
        return len(shapes)

    # -- persistence (mirrors KernelAutotuner.save/load) ---------------------

    def fingerprint(self) -> str:
        """Content digest of the winner table; ``""`` when empty/disabled."""
        if not plan_service_enabled() or not self.table:
            return ""
        h = hashlib.sha1()
        for k in sorted(self.table):
            h.update(k.encode())
            e = self.table[k]
            for f in WINNER_FIELDS:
                h.update(str(e.get(f)).encode())
        return h.hexdigest()[:16]

    def save(self, path: str) -> None:
        data = {
            "version": 1,
            "entries": self.table,
            "traffic": self.traffic,
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)

    def load(self, path: str, *, merge: bool = True) -> int:
        """Install entries from ``path``; returns how many winners loaded.

        ``merge=True`` (default): the file is the persisted truth on key
        collisions, exactly like ``KernelAutotuner.load``."""
        with open(path) as f:
            data = json.load(f)
        if not merge:
            self.table.clear()
            self.traffic.clear()
        self.table.update(data.get("entries", {}))
        for k, v in data.get("traffic", {}).items():
            self.traffic[k] = self.traffic.get(k, 0) + int(v)
        return len(data.get("entries", {}))


_SERVICE: PlanService | None = None


def plan_service() -> PlanService:
    """The process singleton; seeded from ``REPRO_PLAN_CACHE`` if the env
    var names an existing JSON file (the fresh-process warm restore)."""
    global _SERVICE
    if _SERVICE is None:
        _SERVICE = PlanService()
        path = os.environ.get("REPRO_PLAN_CACHE", "")
        if path and os.path.exists(path):
            _SERVICE.load(path)
    return _SERVICE


def set_plan_service(service: PlanService | None) -> None:
    """Swap the process singleton (tests; ``None`` resets to empty-lazy)."""
    global _SERVICE
    _SERVICE = service

"""Dry run: count every (arch x shape x mesh) cell without a card.

The port of ``repro.launch.dryrun``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh 1 \\
        --arch llama3.2-1b --shape train_4k [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1

Where the reference lowers and compiles each cell for 256 or 512 TPU
chips and reads its HLO, the port builds the cell on the ``meta`` device
(shapes and dtypes, nothing allocated) and counts one step of it with
``analysis.cost``.  A cell runs on one of three meshes: ``1``, the
card's 1x1 grid, or ``16x16`` and ``2x16x16``, the production grids.
On each, one rank's step is run and counted on ``meta`` — rank (0, ...,
0)'s program on a production grid's counting grid (``core.grid``): its
shards of the parameters, optimizer state, batch and caches, its
collectives' bytes — giving the FLOPs, bytes and collectives per device,
the roofline on ``cost.DEFAULT_HW``, ``memory_analysis`` (arguments,
outputs, peak live bytes per device) and, under ``summa``/``auto``, the
simulated schedules.  Repeated
  work is weighted, as the reference's HLO analysis weights a while body
  by its trip count: one of several identical microbatches is run and
  counted ``microbatches`` times (the optimizer's update once), a model
  of L identical units is counted as count(1) + (L - 1) · (count(2) -
  count(1)) from models of one and two units (its memory linearly), and
  the sLSTM's loop over the sequence likewise from runs of one and two of
  its steps (``cost.loop_steps``).  A production cell also records the
  model FLOPs and ``argument_bytes_per_rank``, the bytes of the arguments
  a rank holds under the spec tuples of ``param_shardings``,
  ``state_shardings``, ``batch_shardings`` and ``cache_shardings``.

Each cell is one JSON with the reference's keys, less
``xla_cost_analysis``: ``lower_s`` is the seconds spent building the
abstract cell, ``compile_s`` those spent counting it.  ``--save-ops PATH``
writes the counter's table of ops (calls, FLOPs, bytes by op and kernel)
where the reference's ``--save-hlo`` wrote HLO text.  ``--mesh`` picks the
mesh (``--multi-pod`` and ``--both-meshes`` are the reference's aliases
for ``2x16x16`` and both production grids); ``--smoke`` takes the
configs' reduced variants.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.analysis import cost
from repro_torch.configs.registry import ARCH_IDS, cell_skip_reason, get_config
from repro_torch.core.grid import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.dist.partitioning import param_shardings
from repro_torch.launch.mesh import make_production_grid
from repro_torch.models import layers as L
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.model import LM
from repro_torch.serve import engine
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.tree import leaves

DEFAULT_MICROBATCHES = 16
#: the card's grid, and the reference's single- and two-pod grids
MESHES = ("1", "16x16", "2x16x16")
_MESH_TAGS = {"1": "1card", "16x16": "1pod", "2x16x16": "2pod"}


def make_ctx(
    grid,
    multi_pod: bool,
    matmul_strategy: str = "xla",
    attention_impl: str = "ref",
    mlstm_chunk: int | None = None,
    zero1: bool = False,
    kv_quant: bool = False,
    slstm_replicated: bool = False,
    pure_dp: bool = False,
) -> ParallelCtx:
    if pure_dp:
        dp = ("pod", "data", "model") if multi_pod else ("data", "model")
    else:
        dp = ("pod", "data") if multi_pod else ("data",)
    return ParallelCtx(
        grid=grid,
        dp_axes=dp,
        tp_axis="model",
        matmul_strategy=matmul_strategy,
        attention_impl=attention_impl,
        mlstm_chunk=mlstm_chunk,
        zero1=zero1,
        kv_quant=kv_quant,
        slstm_replicated=slstm_replicated,
        pure_dp=pure_dp,
    )


# ---------------------------------------------------------------------------
# input specs (meta tensors — never allocated)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta") -> dict:
    """Abstract train/prefill batch for this arch family, with the
    reference's shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len

    def spec(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=device)

    if cfg.family == "audio":
        return {
            "embeds": spec(b, s, cfg.d_model, dtype=torch.bfloat16),
            "labels": spec(b, s),
        }
    if cfg.family == "vlm":
        s_vis = s // 4
        s_text = s - s_vis
        return {
            "tokens": spec(b, s_text),
            "embeds": spec(b, s_vis, cfg.d_model, dtype=torch.bfloat16),
            "positions": spec(b, s, 3),
            "labels": spec(b, s_text),
        }
    return {"tokens": spec(b, s), "labels": spec(b, s)}


def model_flops_per_step(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (forward-only), N = active."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# cell builders: return (fn, example args on the meta device)
# ---------------------------------------------------------------------------


def _optimizer(cfg: ModelConfig):
    return make_optimizer(OptimizerConfig(
        name="adafactor" if cfg.name.startswith("kimi") else "adamw"))


def build_train_cell(cfg, shape, ctx, microbatches, opt=None, remat=True):
    opt = opt or _optimizer(cfg)
    state = ts.abstract_train_state(cfg, ctx, opt)
    batch = input_specs(cfg, shape)
    step = ts.build_train_step(cfg, ctx, opt, microbatches=microbatches,
                               remat=remat)
    return step, (state, batch)


def build_prefill_cell(cfg, shape, ctx):
    params = ts.shard_model(LM(cfg, device="meta", ep=ctx.tp_size), ctx)
    batch = input_specs(cfg, shape)
    batch.pop("labels", None)

    def fn(p, b):
        return engine.prefill(p, b, cfg, ctx, max_len=shape.seq_len)

    return fn, (params, batch)


def build_decode_cell(cfg, shape, ctx):
    b = shape.global_batch
    params = ts.shard_model(LM(cfg, device="meta", ep=ctx.tp_size), ctx)
    # the rank's rows of the cache (where the batch divides dp), its
    # S-shard of each KV leaf
    rows = b // ctx.dp_size if ctx.splits_batch(b) else b
    cache = engine._local_kv(engine.init_cache(
        cfg, rows, shape.seq_len, kv_quant=ctx.kv_quant, device="meta"),
        ctx, rows)
    tokens = torch.empty((b,), dtype=torch.int32, device="meta")

    def fn(p, c, t):
        return engine.decode_step(p, c, t, cfg, ctx)

    return fn, (params, cache, tokens)


def _cache_shardings(cache, ctx: ParallelCtx, batch: int):
    # One cache-sharding function for the whole codebase: the engine owns
    # the leaf classification (KV + quant scales vs recurrent state).
    return engine.cache_shardings(cache, ctx, batch)


# ---------------------------------------------------------------------------
# counting a cell on the card's grid
# ---------------------------------------------------------------------------


def with_units(cfg: ModelConfig, units: int) -> ModelConfig:
    """``cfg`` cut to ``units`` units of its block pattern, its tail kept."""
    return dataclasses.replace(
        cfg, num_layers=units * len(cfg.block_pattern) + len(cfg.tail))


def _count_one(cfg, shape, ctx, microbatches, times: dict,
               sample_loops=None, opt=None, remat=True):
    """(WeightedCost, MemoryCost, loop trip counts) of one step."""
    t0 = time.perf_counter()
    if shape.kind == "train":
        step, (state, batch) = build_train_cell(cfg, shape, ctx,
                                                microbatches, opt, remat)

        def fn(state, batch):
            if microbatches == 1:
                return step(state, batch)
            # identical microbatches: one counted microbatches times
            batch, grads = step.begin(state, batch)
            with cost.active_counter().weighted(microbatches):
                step.accumulate(state["params"],
                                ts.microbatch_of(batch, 0, microbatches),
                                grads)
            step.finish(state, grads)
            return state

        args = (state, batch)
    elif shape.kind == "prefill":
        fn, args = build_prefill_cell(cfg, shape, ctx)
    else:
        fn, args = build_decode_cell(cfg, shape, ctx)
    t1 = time.perf_counter()
    counter = cost.CostCounter("meta", sample_loops=sample_loops)
    _, wc, mem = cost.analyze_step(fn, *args, counter=counter)
    times["lower_s"] += t1 - t0
    times["compile_s"] += time.perf_counter() - t1
    return wc, mem, counter.loop_trips


def _count_model(cfg, shape, ctx, microbatches, times, opt=None,
                 remat=True):
    """One model's step; its sequence loops (the sLSTM's), if it runs any,
    counted from runs of one and two steps."""
    wc, mem, trips = _count_one(cfg, shape, ctx, microbatches, times,
                                sample_loops=1, opt=opt, remat=remat)
    if not trips:
        return wc, mem
    if len(trips) > 1:
        raise ValueError(f"loops of several trip counts {sorted(trips)}")
    wc2, mem2, _ = _count_one(cfg, shape, ctx, microbatches, times,
                              sample_loops=2, opt=opt, remat=remat)
    n = trips.pop()
    return cost.extrapolate(wc, wc2, n), cost.extrapolate(mem, mem2, n)


def count_cell(cfg: ModelConfig, shape: ShapeConfig, ctx: ParallelCtx,
               microbatches: int, times: dict | None = None, *, opt=None,
               remat: bool = True):
    """``(WeightedCost, MemoryCost)`` of one step of the cell on the meta
    device, its repeats weighted (see the module's docstring).  ``times``
    (if given) accumulates ``lower_s`` and ``compile_s``; ``opt`` and
    ``remat`` replace a train cell's default optimizer and remat."""
    times = times if times is not None else {}
    times.setdefault("lower_s", 0.0)
    times.setdefault("compile_s", 0.0)
    if cfg.units <= 2:
        return _count_model(cfg, shape, ctx, microbatches, times, opt, remat)
    wc1, mem1 = _count_model(with_units(cfg, 1), shape, ctx, microbatches,
                             times, opt, remat)
    wc2, mem2 = _count_model(with_units(cfg, 2), shape, ctx, microbatches,
                             times, opt, remat)
    return (cost.extrapolate(wc1, wc2, cfg.units),
            cost.extrapolate(mem1, mem2, cfg.units))


# ---------------------------------------------------------------------------
# per-rank argument bytes on a planning-only grid
# ---------------------------------------------------------------------------


def rank_bytes(shape, itemsize: int, spec, grid_shape: dict) -> int:
    """Bytes of one rank's block of a leaf of ``shape`` under ``spec`` (one
    entry per leading dim: an axis, a tuple of axes or None)."""
    n = math.prod(shape) * itemsize
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                n //= grid_shape[axis]
    return n


def _tree_rank_bytes(tree, specs, grid_shape) -> int:
    spec_of = dict(leaves(specs))
    return sum(rank_bytes(tuple(x.shape), x.element_size(), spec_of[path],
                          grid_shape)
               for path, x in leaves(tree))


def argument_bytes_per_rank(cfg: ModelConfig, shape: ShapeConfig,
                            ctx: ParallelCtx) -> int:
    """Bytes of the step's arguments one rank of ``ctx``'s grid holds under
    the spec tuples of the train state (``state_shardings``), the
    parameters (``param_shardings``), the batch (``batch_shardings``) and
    the serving cache (``cache_shardings``)."""
    grid_shape = ctx.grid.shape
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        # the abstract state holds the rank's blocks already (built on a
        # counting grid: moving a leaf into its slot's layout gathers)
        grid = ctx.grid
        meta = dataclasses.replace(
            ctx, grid=Grid(sizes=grid.sizes, axis_names=grid.axis_names,
                           coords=grid.coords, device=torch.device("meta")),
            tp_axis=ctx._tp_axis_raw)
        state = ts.abstract_train_state(cfg, meta, _optimizer(cfg))
        return (sum(x.numel() * x.element_size()
                    for _, x in leaves(ts.state_tree(state)))
                + _tree_rank_bytes(batch, ts.batch_shardings(batch, ctx),
                                   grid_shape))
    model = LM(cfg, device="meta", ep=ctx.tp_size)
    named = dict(model.named_parameters())
    out = _tree_rank_bytes(named, param_shardings(
        {n: p.shape for n, p in named.items()}, ctx.grid), grid_shape)
    if shape.kind == "prefill":
        batch.pop("labels", None)
        return out + _tree_rank_bytes(
            batch, ts.batch_shardings(batch, ctx), grid_shape)
    b = shape.global_batch
    cache = engine.init_cache(cfg, b, shape.seq_len, kv_quant=ctx.kv_quant,
                              device="meta")
    tokens = {"tokens": torch.empty((b,), dtype=torch.int32, device="meta")}
    t_spec = {"tokens": (ctx.dp if b % ctx.dp_size == 0 else None,)}
    return (out + _tree_rank_bytes(cache, _cache_shardings(cache, ctx, b),
                                   grid_shape)
            + _tree_rank_bytes(tokens, t_spec, grid_shape))


# ---------------------------------------------------------------------------
# run one cell
# ---------------------------------------------------------------------------


def _mesh_name(mesh) -> str:
    """A mesh of ``MESHES``; ``True``/``False`` are the reference's
    ``multi_pod``."""
    if isinstance(mesh, bool):
        return "2x16x16" if mesh else "16x16"
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r}; known: {MESHES}")
    return mesh


def run_cell(
    arch: str,
    shape_name: str,
    mesh="16x16",
    *,
    microbatches: int = DEFAULT_MICROBATCHES,
    matmul_strategy: str = "xla",
    attention_impl: str = "ref",
    mlstm_chunk: int | None = None,
    zero1: bool = False,
    kv_quant: bool = False,
    slstm_replicated: bool = False,
    pure_dp: bool = False,
    save_ops: str | None = None,
    smoke: bool = False,
) -> dict:
    mesh = _mesh_name(mesh)
    shape = SHAPES[shape_name]
    skip = cell_skip_reason(arch, shape_name)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh,
        "matmul_strategy": matmul_strategy,
        "attention_impl": attention_impl,
        "mlstm_chunk": mlstm_chunk,
        "zero1": zero1,
        "kv_quant": kv_quant,
        "microbatches": microbatches if shape.kind == "train" else None,
    }
    if skip:
        result["status"] = skip
        return result
    cfg = get_config(arch, smoke=smoke)
    multi_pod = mesh == "2x16x16"
    grid = (Grid.local("meta") if mesh == "1"
            else make_production_grid(multi_pod=multi_pod, device="meta"))
    ctx = make_ctx(grid, multi_pod, matmul_strategy, attention_impl,
                   mlstm_chunk, zero1, kv_quant, slstm_replicated, pure_dp)
    # per-microbatch batch must divide the DP degree, or sharding degrades
    # to replicated compute (the reference's clamp)
    if shape.kind == "train":
        microbatches = max(1, min(microbatches,
                                  shape.global_batch // ctx.dp_size))
        result["microbatches"] = microbatches
    try:
        sched = sched_section(cfg, shape, ctx, microbatches)
    except Exception as e:  # simulation must never sink a dry-run cell
        sched = [{"status": f"sched-error: {type(e).__name__}: {e}"}]
    if sched is not None:
        result["sched"] = sched
    chips = math.prod(grid.sizes)
    mf = model_flops_per_step(cfg, shape)
    if mesh != "1":
        result.update(model_flops=mf,
                      argument_bytes_per_rank=argument_bytes_per_rank(
                          cfg, shape, ctx))
    times = {}
    wc, mem = count_cell(cfg, shape, ctx, microbatches, times)
    rep = cost.roofline(
        flops=wc.flops,
        hbm_bytes=wc.hbm_bytes,
        coll_bytes=wc.wire_bytes,  # ring wire-cost model (analysis.cost)
        chips=chips,
        model_flops=mf,
    )
    result.update(
        status="ok",
        lower_s=round(times["lower_s"], 1),
        compile_s=round(times["compile_s"], 1),
        chips=chips,
        flops_per_device=wc.flops,
        hbm_bytes_per_device=wc.hbm_bytes,
        collective_bytes_per_device=wc.coll_bytes,
        collective_wire_bytes_per_device=wc.wire_bytes,
        collective_breakdown=wc.coll_bytes_by_op,
        collective_counts=wc.coll_counts_by_op,
        roofline=rep.row(),
        memory_analysis=_mem_dict(mem),
    )
    if save_ops:
        os.makedirs(os.path.dirname(save_ops) or ".", exist_ok=True)
        table = {name: {"calls": c, "flops": f, "bytes": b}
                 for name, (c, f, b) in sorted(
                     wc.by_op.items(), key=lambda kv: -kv[1][2])}
        with open(save_ops, "w") as f:
            json.dump(table, f, indent=1)
    return result


def sched_section(cfg, shape, ctx, microbatches: int) -> list | None:
    """Simulated projection schedules for this cell (repro_torch.sched).

    For every FFN projection shape the cell will run, derive (and with
    ``matmul_strategy="auto"`` tune) the ``MatmulPlan``, then run its task
    DAG through the discrete-event simulator: predicted makespan,
    imbalance, and the executed lookahead land next to the roofline terms
    in the cell JSON.  Plans are cached, so the count that follows reuses
    them.
    """
    if not ctx.has_grid or ctx.matmul_strategy == "xla" or ctx.pure_dp:
        return None
    if not cfg.d_ff:
        return None
    from repro_torch.sched.simulator import simulate_plan

    if shape.kind == "train":
        m = (shape.global_batch // max(microbatches, 1)) * shape.seq_len
    elif shape.kind == "prefill":
        m = shape.global_batch * shape.seq_len
    else:
        m = shape.global_batch
    tune = ctx.matmul_strategy == "auto"
    # plan under the activation dtype's itemsize, as the projections will
    itemsize = L.torch_dtype(cfg.dtype).itemsize
    out = []
    d = cfg.d_model
    for k_in, n_out in ((d, cfg.d_ff), (cfg.d_ff, d)):
        plan = ctx.plan_projection(
            m, k_in, n_out, itemsize=itemsize, tune=tune
        )
        if plan is None:
            continue
        sim = simulate_plan(plan)
        out.append(
            {
                "proj": [m, k_in, n_out],
                "strategy": plan.cfg.strategy,
                "lookahead": plan.resolve_lookahead(),
                "k_steps": plan.k_steps,
                "sim_makespan_s": sim.makespan_s,
                "sim_imbalance": sim.imbalance_ratio,
                "sim_efficiency": sim.efficiency,
                "tuned": plan.tuned,
            }
        )
    return out


def _mem_dict(mem) -> dict:
    if mem is None:
        return {}
    out = {}
    for attr in (
        "argument_size_in_bytes",
        "output_size_in_bytes",
        "alias_size_in_bytes",
        "temp_size_in_bytes",
        "peak_live_bytes",
    ):
        if hasattr(mem, attr):
            out[attr] = int(getattr(mem, attr))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default=None, choices=MESHES)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's alias of --mesh 2x16x16")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the reference's alias of 16x16 and 2x16x16")
    ap.add_argument("--microbatches", type=int, default=DEFAULT_MICROBATCHES)
    ap.add_argument("--matmul-strategy", default="xla",
                    choices=["xla", "summa", "allgather", "auto"])
    ap.add_argument("--attention", default="ref", choices=["ref", "chunked"])
    ap.add_argument("--mlstm-chunk", type=int, default=None)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--slstm-replicated", action="store_true")
    ap.add_argument("--pure-dp", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the configs' reduced variants")
    ap.add_argument("--tag", default=None,
                    help="suffix for the result filename (perf variants)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--save-ops", default=None,
                    help="write the counter's table of ops here")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    if args.mesh:
        meshes = [args.mesh]
    elif args.both_meshes:
        meshes = ["16x16", "2x16x16"]
    else:
        meshes = ["2x16x16" if args.multi_pod else "16x16"]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    os.makedirs(args.out, exist_ok=True)
    for a, s, m in cells:
        tag = f"{a}__{s}__{_MESH_TAGS[m]}"
        if args.matmul_strategy != "xla":
            tag += f"__{args.matmul_strategy}"
        if args.tag:
            tag += f"__{args.tag}"
        out_path = os.path.join(args.out, tag + ".json")
        if os.path.exists(out_path):
            print(f"[skip-existing] {tag}")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            res = run_cell(
                a, s, m,
                microbatches=args.microbatches,
                matmul_strategy=args.matmul_strategy,
                attention_impl=args.attention,
                mlstm_chunk=args.mlstm_chunk,
                zero1=args.zero1,
                kv_quant=args.kv_quant,
                slstm_replicated=args.slstm_replicated,
                pure_dp=args.pure_dp,
                save_ops=args.save_ops,
                smoke=args.smoke,
            )
        except Exception as e:  # record failures — they are findings
            res = {
                "arch": a, "shape": s, "mesh": m,
                "status": f"error: {type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1, default=str)
        print(f"[done] {tag}: {res.get('status')}", flush=True)


if __name__ == "__main__":
    main()

"""Collective matmuls: the paper's engine embedded in the LM stack.

The port of ``repro.dist.collective_matmul``.  ``project`` is the single
entry point the model code uses for its big projections (models/ffn.py).
It routes by ``ctx.matmul_strategy``:

* ``"xla"`` — one ``torch.matmul`` (the reference's einsum).  The default,
  and the route of every context without a grid.
* ``"summa"`` — the task-based multiple-issue SUMMA schedule
  (core.summa, paper §3.2) over the (dp x tp) grid, via the
  ``DistributedMatmul`` built by ``ctx.matmul()``.
* ``"allgather"`` — the engine's all-gather strategy (the ``I = K``
  endpoint of Eq. (1)); when tp > 1, the shapes divide and no mask is
  given, the ring collective matmul over the TP axis instead
  (``allgather_matmul``), as in the reference.
* ``"auto"`` — per-shape pick by *simulated time*: the schedule tuner
  (``sched.tuner``) searches lookahead x k_blocks x strategy over the
  discrete-event simulator and the engine executes the winner.  Where
  the ring is eligible (tp > 1) and its pipeline estimate
  (``ring_makespan``) beats the tuned makespan, the ring runs instead.

``allgather_matmul`` is the reference's ``shard_map`` program as a
per-rank program on a ``Grid``: each rank holds its M-chunk of the
activations and its N-columns of the weight, and the chunks travel the
TP ring (``Grid.ring_shift``) while each rank multiplies the one in
hand.

On a grid ``project`` takes the rank's operands as the FFN holds them
(``dist.partitioning.shard_params``): ``x`` its batch rows, whole over
tp (``split_in=False``, the up and gate projections) or its part of the
hidden (``split_in=True``, the down projection), and ``w`` the stored
block (a weight without a spec is whole on every rank).  It returns the
layout the reference's next constraint names: the rank's hidden columns
where ``w``'s stored columns split them over tp, the whole output
(summed over tp) after the down projection.  Each route takes the
rank's shards as they come:

* ``"xla"`` multiplies the rank's shards (``ParallelCtx.weight``: the
  weight gathered over the FSDP axis), the down projection's partial
  products summed over tp in fp32;
* the ring (``"allgather"``/``"ring"``, or ``"auto"`` where it wins)
  sends the rank's rows over tp round the TP ring against its columns
  of the weight and returns its tile, the rank's hidden columns (the
  down projection gathers the hidden first, and an output whole over tp
  is gathered from the tiles);
* the engine (``"summa"``, ``"auto"``) runs SUMMA on the rank's tiles
  (``core.summa.execute_plan``): A its rows and its K-part over tp, B
  the stored block itself (K over ``data``, N over ``model``, the
  engine's own layout), C its tile — where the plan pads nothing and the
  weight's spec is exactly that layout.

A block-masked weight, and a plan or spec the tiles do not fit, gather
the operands whole (autograd-aware collectives whose transposes cut the
gradient back), run the engine's product on them, and cut the result to
the rank's layout.

``project`` also accepts an optional block mask over the weight
(``w_mask``, or one registered in ``ctx.weight_block_masks``): the
planned schedule then prunes dead K panels; the xla path zeroes masked
blocks so every strategy computes the same masked product.  All
strategies accumulate in fp32 and return the activation dtype, so
swapping them changes only the schedule, not the arithmetic contract.

Gradients.  The xla route differentiates through ``matmul_f32``; the
ring through ``_RingMatmul``, whose backward is the reference's
transpose: dW by the same ring over the activation chunks, dX by a ring
reduce-scatter of dY·Wᵀ.  The engine routes run as ``_EngineMatmul``,
an autograd Function whose backward runs two more engine products with
the same schedule: dX = dY·Wᵀ (under Wᵀ's block mask) and dW = Xᵀ·dY
(the weight's masked blocks zeroed), so the paper's algorithm runs in
the backward too, as the reference's autodiff of its ``shard_map``
program does.  Autograd never traces the executors (their in-place
accumulation and the ``Grid``'s plain collectives are not
autograd-aware): every rank holds whole operands, runs the same
products and so gets the whole gradient; on the rank's tiles
(``_SummaTiles``) the backward runs the same two products on the
operands gathered whole and keeps the rank's tile of each.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import summa as sm
from repro_torch.core.summa import _apply_block_mask
from repro_torch.models.layers import fill_after_node, matmul_f32

__all__ = ["allgather_matmul", "project"]


def _mask_weight(w: torch.Tensor, w_mask: np.ndarray) -> torch.Tensor:
    """Zero masked blocks of a (d_in, d_out) weight (einsum-path parity)."""
    return _apply_block_mask(w, np.asarray(w_mask, dtype=bool))


class _EngineMatmul(torch.autograd.Function):
    """The node of ``mm(x2, w)`` on the engine, with an engine backward.
    Its forward only saves the operands and allocates the result (in
    ``x2``'s dtype, the engine's); ``project`` fills it
    (``layers.fill_after_node``)."""

    @staticmethod
    def forward(ctx, x2, w, mm, w_mask, strategy, tune):
        ctx.save_for_backward(x2, w)
        ctx.route = (mm, w_mask, strategy, tune)
        return x2.new_empty((x2.shape[0], w.shape[1]))

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        mm, w_mask, strategy, tune = ctx.route
        dy = dy.to(x2.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt_mask = None if w_mask is None else np.asarray(w_mask).T
            dx = mm(dy, w.t().contiguous(), b_mask=wt_mask,
                    strategy=strategy, tune=tune)
        if ctx.needs_input_grad[1]:
            dw = mm(x2.t().contiguous(), dy, strategy=strategy, tune=tune)
            if w_mask is not None:
                dw = _mask_weight(dw, w_mask)
            dw = dw.to(w.dtype)
        return dx, dw, None, None, None, None


def _ring(grid, axis, chunk, lookahead: int, consume) -> None:
    """Send ``chunk`` around the ring of ``axis``: ``consume(src, c)``
    for each of the ring's chunks ``c`` (``src`` its owner's index along
    the axis) in the order they arrive.  ``lookahead`` = I hops are in
    flight, clamped to the ring's size: hop g + I is posted before chunk
    g is consumed."""
    p, me = grid.axis_size(axis), grid.axis_index(axis)
    la = max(1, min(lookahead, p))
    bufs = [chunk.contiguous()]
    for _ in range(la - 1):  # prologue: I hops in flight
        bufs.append(grid.ring_shift(bufs[-1], axis)[0])
    steady = p - la
    for g in range(steady):
        nxt, work = grid.ring_shift(bufs[-1], axis, async_op=True)
        consume((me - g) % p, bufs[0])
        if work is not None:
            work.wait()
        bufs = bufs[1:] + [nxt]
    for i in range(la):  # epilogue: drain the I chunks in hand
        consume((me - steady - i) % p, bufs[i])


class _RingMatmul(torch.autograd.Function):
    """``allgather_matmul``'s rank program, with the reference's
    transpose as its backward: dW_loc by the same ring over the chunks of
    x (summed over the batch axes, over which W_loc is replicated), dX_loc
    by a ring reduce-scatter of dY·W_locᵀ, each hop overlapping the next
    chunk's product."""

    @staticmethod
    def forward(ctx, x, w, grid, axis, batch_axes, lookahead, accum_dtype):
        ctx.save_for_backward(x, w)
        ctx.route = (grid, axis, batch_axes, lookahead)
        m = x.shape[0]
        acc = torch.zeros((grid.axis_size(axis) * m, w.shape[1]),
                          dtype=accum_dtype, device=x.device)

        def tile(src, c):
            acc[src * m:(src + 1) * m] = matmul_f32(c, w,
                                                    out_dtype=accum_dtype)

        _ring(grid, axis, x, lookahead, tile)
        return acc.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        grid, axis, batch_axes, lookahead = ctx.route
        p, me = grid.axis_size(axis), grid.axis_index(axis)
        m = x.shape[0]
        rows = [dy[src * m:(src + 1) * m] for src in range(p)]
        dx = dw = None
        if ctx.needs_input_grad[1]:
            acc = torch.zeros(w.shape, dtype=torch.float32, device=w.device)

            def add(src, c):
                acc.add_(matmul_f32(c.t(), rows[src]))

            _ring(grid, axis, x, lookahead, add)
            if batch_axes:
                acc = grid.all_reduce(acc, batch_axes)
            dw = acc.to(w.dtype)
        if ctx.needs_input_grad[0]:
            # the partial sum for chunk t travels t+1 -> ... -> t
            wt = w.t()
            part = matmul_f32(rows[(me - 1) % p], wt)
            for s in range(1, p):
                recv, work = grid.ring_shift(part, axis, async_op=True)
                mine = matmul_f32(rows[(me - 1 - s) % p], wt)
                work.wait()
                part = recv + mine
            dx = part.to(x.dtype)
        return dx, dw, None, None, None, None, None


def allgather_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    grid,
    axis: str,
    batch_axes: tuple[str, ...] = (),
    lookahead: int = 2,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Ring all-gather matmul with multiple-issue lookahead, one rank's
    program (the reference's ``shard_map`` body).

    ``x`` is this rank's (m_loc, K) chunk of the (M, K) activations,
    whose M is sharded over ``(*batch_axes, axis)``; ``w`` its (K, N/P)
    columns of the weight, sharded over ``axis`` (P ranks) and replicated
    over ``batch_axes``.  The chunks travel the ring one hop a step while
    each rank multiplies the one in hand against its columns, accumulating
    in ``accum_dtype``; ``lookahead`` is the pipeline depth I of paper Eq.
    (1), clamped to P.  Each product's tile goes to rows ``src·m_loc`` of
    its owner.  Global FLOP are exactly 2·M·K·N.

    Returns the rank's (M / |batch_axes|, N / P) tile in ``x.dtype``.
    Differentiable (``_RingMatmul``).
    """
    (_, k), (k2, _) = x.shape, w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    return _RingMatmul.apply(x, w, grid, axis, tuple(batch_axes), lookahead,
                             accum_dtype)


def project(
    x: torch.Tensor,
    w: torch.Tensor,
    ctx,
    *,
    w_mask: np.ndarray | None = None,
    split_in: bool = False,
) -> torch.Tensor:
    """``x @ w`` with the context's matmul strategy.

    ``x``: (..., d_in) activations; ``w``: (d_in, d_out) kernel, or this
    rank's stored block of it (see the module's docstring for the
    layouts, and ``split_in``).  Leading dims are flattened into SUMMA's M
    dimension and restored afterwards.  ``w_mask`` is an optional (Kblk,
    Nblk) block mask over the whole weight; when omitted,
    ``ctx.weight_block_masks`` is consulted for the weight's whole shape.
    Contexts without a grid always take the matmul path.
    """
    full = tuple(getattr(w, "full_shape", w.shape))
    if w_mask is None:
        w_mask = ctx.weight_mask(full)
    split_out = not split_in and ctx.tp_sharded(w, 1)
    plain = (not ctx.has_grid or ctx.matmul_strategy == "xla"
             or ctx.pure_dp)
    if plain and w_mask is None:
        if split_in:  # the partial products summed over tp in fp32
            y = matmul_f32(x, ctx.weight(w, tp_dim=0))
            return ctx.tp_exit(y, True).to(x.dtype)
        return matmul_f32(ctx.tp_enter(x, split_out),
                          ctx.weight(w, tp_dim=1 if split_out else None),
                          out_dtype=x.dtype)
    grid, lead = ctx.grid, x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    strategy, tune = ("xla", False) if plain else _route(
        ctx, x2.shape[0] * ctx.dp_size, full, x2.element_size(), w_mask,
        x2.shape[0] % ctx.tp_size == 0)
    if strategy == "ring":
        # the rank's rows over tp into the ring, its columns out of it
        if split_in:
            x2 = grid.gather(x2, ctx.tp_axis, 1)
        tile = allgather_matmul(grid.shard(x2, ctx.tp_axis, 0),
                                ctx.weight(w, tp_dim=1), grid=grid,
                                axis=ctx.tp_axis)
        if not split_out:
            tile = grid.gather(tile, ctx.tp_axis, 1)
        return tile.reshape(*lead, tile.shape[-1])
    summa = None if strategy == "summa" else strategy
    m = x2.shape[0] * ctx.dp_size  # the rows of the global product
    if (not plain and w_mask is None and (split_in or split_out)
            and getattr(w, "spec", None) == (ctx.dp, ctx.tp_axis)):
        mm = ctx.matmul()
        plan = mm.plan(m, full[0], full[1], itemsize=x2.element_size(),
                       strategy=summa, tune=tune)
        if plan.padded_shapes == ((m, full[0]), full):
            # SUMMA on the rank's tiles: A its rows and K-part, B the
            # stored block, C its rows and N-part
            a = x2 if split_in else grid.shard(x2, ctx.tp_axis, 1)
            c = _summa_tiles(a, w, mm, plan, summa, tune)
            if split_in:
                c = grid.gather(c, ctx.tp_axis, 1)
            return c.reshape(*lead, c.shape[-1])
    # the operands gathered whole, the product every rank repeats, and
    # the rank's part of the result
    if split_in and ctx.tp_size > 1:
        x2 = grid.gather(x2, ctx.tp_axis, 1)
    if ctx.dp_size > 1:
        x2 = grid.gather(x2, ctx.dp, 0)
    y = _project_whole(x2, ctx.weight(w, repeat=True), ctx, w_mask, summa,
                       tune)
    if ctx.dp_size > 1:
        y = grid.shard(y, ctx.dp, 0)
    if split_out:
        y = grid.shard(y, ctx.tp_axis, 1)
    return y.reshape(*lead, y.shape[-1])


def _route(ctx, m: int, shape, itemsize: int, w_mask, rows_ok: bool):
    """``(strategy, tune)`` of an engine product of ``m`` rows by a
    weight of ``shape``: ``"ring"`` where the strategy asks for it (or
    ``"auto"`` finds its pipeline estimate faster) and it is eligible
    (tp > 1, the rows and columns divide, no mask), else the engine's."""
    strategy, tune = ctx.matmul_strategy, False
    ring_ok = (ctx.tp_size > 1 and rows_ok and m % ctx.dp_size == 0
               and shape[1] % ctx.tp_size == 0 and w_mask is None)
    if strategy == "auto":
        if w_mask is not None:
            # Masked plans always execute the planned broadcast schedule
            # (DAG or BSMM); the tuner still picks the lookahead window.
            return "summa", True
        # One cached tuned plan per shape: the simulator-searched
        # schedule, vs. the ring's pipeline estimate where it is eligible.
        from repro_torch.sched.tuner import ring_makespan

        plan = ctx.matmul().plan(m, shape[0], shape[1], itemsize=itemsize,
                                 tune=True)
        if ring_ok and ring_makespan(plan) < plan.tuned["makespan_s"]:
            return "ring", False
        return "summa", True
    if strategy in ("allgather", "ring") and ring_ok:
        return "ring", False
    return strategy, tune


class _SummaTiles(torch.autograd.Function):
    """The engine's ``plan`` on this rank's tiles (``core.summa.
    execute_plan``), returning its tile of C.  The backward runs the
    engine's two products, dA = dC·Bᵀ and dB = Aᵀ·dC, on the operands
    gathered whole (every rank the same products, as the engine's
    whole-operand route) and keeps this rank's tile of each.  Its forward
    only saves the operands and allocates the tile; ``_summa_tiles``
    fills it (``layers.fill_after_node``)."""

    @staticmethod
    def forward(ctx, a_loc, b_loc, mm, plan, strategy, tune):
        ctx.save_for_backward(a_loc, b_loc)
        ctx.route = (mm, plan, strategy, tune)
        (mp, _), (_, np_) = plan.padded_shapes
        return a_loc.new_empty((mp // plan.p_row, np_ // plan.p_col))

    @staticmethod
    def backward(ctx, dc):
        a_loc, b_loc = ctx.saved_tensors
        mm, plan, strategy, tune = ctx.route
        g, rows, cols = mm.grid, mm.row_axis, mm.col_axis

        def whole(t):
            return g.all_gather(g.all_gather(t.contiguous(), cols, 1), rows, 0)

        dc = whole(dc.to(a_loc.dtype))
        da = db = None
        if ctx.needs_input_grad[0]:
            da = sm.local_tile(mm(dc, whole(b_loc).t().contiguous(),
                                  strategy=strategy, tune=tune), plan.cfg)
        if ctx.needs_input_grad[1]:
            db = sm.local_tile(mm(whole(a_loc).t().contiguous(), dc,
                                  strategy=strategy, tune=tune),
                               plan.cfg).to(b_loc.dtype)
        return da, db, None, None, None, None


def _summa_tiles(a_loc, b_loc, mm, plan, strategy, tune) -> torch.Tensor:
    a_loc = a_loc.contiguous()

    def run(_out=None):
        return sm.execute_plan(a_loc, b_loc, plan)

    if torch.is_grad_enabled() and (a_loc.requires_grad
                                    or b_loc.requires_grad):
        return fill_after_node(_SummaTiles.apply(
            a_loc, b_loc, mm, plan, strategy, tune), run)
    return run()


def _project_whole(x2, w, ctx, w_mask, strategy, tune) -> torch.Tensor:
    """``x2 @ w`` on whole operands, the product every rank repeats: one
    ``matmul_f32`` of the masked weight without a grid or under
    ``"xla"``/``pure_dp``, else the engine's ``strategy``."""
    if not ctx.has_grid or ctx.matmul_strategy == "xla" or ctx.pure_dp:
        if w_mask is not None:
            w = _mask_weight(w, w_mask)
        return matmul_f32(x2, w, out_dtype=x2.dtype)
    mm = ctx.matmul()

    def run(_out=None):  # the engine allocates its own result
        return mm(x2, w, b_mask=w_mask, strategy=strategy, tune=tune)

    if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        return fill_after_node(_EngineMatmul.apply(
            x2, w, mm, w_mask, strategy, tune), run)
    return run()

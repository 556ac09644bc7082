"""Mixture-of-Experts layer with expert parallelism over the tp axis.

The port of ``repro.models.moe``.  MoE *is* block-sparse tensor
computing: each token-group x expert pair is a nonuniformly sized block
of a block-diagonal matmul, the irregular structure the paper targets.

  1. Router (fp32) + top-k on the whole activation stream.
  2. Each expert-parallel rank gathers only the token copies routed to
     ITS experts into a static per-expert capacity buffer ``(B, E_loc,
     C, D)`` (sorted dispatch, no all-to-all, no one-hot blow-up;
     overflow copies are dropped — standard capacity discipline).
  3. Batched per-expert GEMMs over the buffer: ``torch.einsum`` as the
     reference's einsums, or with ``use_kernel=True`` the grouped-GEMM
     CUDA kernel (``kernels.ops.grouped_gemm``, the port of the
     reference's own MoE kernel) — gate and up as two launches, down as
     one.  The buffer makes every expert's rows one ``C``-row tile, so
     the tile -> expert map is a function of the shapes alone, built on
     the host.
  4. Each rank scatters its partial outputs back to token order and one
     ``Grid.sum`` over the tp axis combines the ranks.

Where the reference runs step 2-4 as a ``shard_map`` over the mesh,
each rank here runs ``_dispatch_compute_combine_local`` on its own
experts, ``[ep·E_loc, (ep+1)·E_loc)``, and its batch rows; one rank (no
grid, or tp 1) holds every expert.  The expert weights are stored as
the rank's experts over tp and ``d_model`` over the FSDP axis
(``dist.partitioning.shard_params``), gathered over the FSDP axis only.
Gradients flow
through expert parallelism as through the reference's ``psum`` under
``shard_map``: the activations' and router gates' summed over the tp
axis (``Grid.replicate``), the output summed by ``Grid.sum``.  The
load-balance loss reads means over the global batch (summed over dp
where the rows are split).  Experts are zero-padded to a multiple of the
expert-parallel degree (``MoE(..., ep=...)``), so one grid axis serves
any expert count.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.dist.context import ParallelCtx
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.ffn import FFN, ffn

__all__ = ["MoE", "capacity", "init_moe", "moe_ffn", "padded_experts"]


def padded_experts(moe: MoEConfig, ep: int) -> int:
    return -(-moe.num_experts // ep) * ep


def capacity(moe: MoEConfig, seq: int, e_pad: int) -> int:
    c = math.ceil(seq * moe.top_k / e_pad * moe.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _shared_view(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg, activation="swiglu",
        d_ff=cfg.moe.d_ff * cfg.moe.num_shared_experts,
    )


class MoE(nn.Module):
    """``norm``, ``router.w`` (fp32), the stacked expert weights
    ``w_gate``/``w_up`` (E_pad, D, F) and ``w_down`` (E_pad, F, D), and,
    with shared experts, ``shared`` (a SwiGLU FFN of width F times their
    count).  ``ep`` is the expert-parallel degree the experts are padded
    for (``ctx.tp_size`` of the contexts that run it)."""

    def __init__(self, cfg: ModelConfig, *, ep: int = 1,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        moe = cfg.moe
        d, f = cfg.d_model, moe.d_ff
        e_pad = padded_experts(moe, ep)
        self.norm = L.RMSNorm(d, device=device)
        self.router = L.Dense(d, moe.num_experts, dtype=torch.float32,
                              device=device)
        self.w_gate = L._param((e_pad, d, f), dtype, device)
        self.w_up = L._param((e_pad, d, f), dtype, device)
        self.w_down = L._param((e_pad, f, d), dtype, device)
        self.shared = (FFN(_shared_view(cfg), dtype=dtype, device=device)
                       if moe.num_shared_experts else None)

    def reset_parameters(self, generator=None) -> None:
        """The expert weights, drawn as the reference draws them: gate and
        up N(0, 1/D), down N(0, 1/F), in fp32 and cast (the norm, router
        and shared FFN draw their own).  One expert at a time, so the fp32
        draw never holds more than one expert's weight."""
        for w in (self.w_gate, self.w_up, self.w_down):
            for e in range(w.shape[0]):
                x = torch.randn(w.shape[1:], generator=generator,
                                device=w.device, dtype=torch.float32)
                w.data[e].copy_(x * (1.0 / math.sqrt(w.shape[1])))


def init_moe(cfg: ModelConfig, *, generator: torch.Generator, ep: int = 1,
             dtype=torch.bfloat16, device="cuda") -> MoE:
    return L.init_params(MoE(cfg, ep=ep, dtype=dtype, device=device),
                         generator)


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig, ctx: ParallelCtx, *,
            use_kernel: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_load_balance_loss).  ``use_kernel=True`` runs
    the expert GEMMs through the grouped-GEMM kernel (its plain version
    on CPU tensors), else as ``torch.einsum``."""
    moe = cfg.moe
    h = L.rmsnorm(p.norm, x, cfg.norm_eps)
    b, s, d = h.shape

    logits = torch.matmul(h.float(), ctx.weight(p.router.w))  # fp32 router
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(logits, moe.top_k, dim=-1)
    gates = torch.softmax(topv, dim=-1)  # renormalised over the selected

    # Switch-style load-balance aux loss.  The one-hot of each token's
    # first expert is a scatter of ones (``F.one_hot`` checks its input
    # and decomposes differently on each device, so a count on ``meta``
    # would not be the card's; the values are the same)
    ones = torch.zeros(logits.shape, dtype=torch.float32,
                       device=logits.device).scatter_(-1, topi[..., :1], 1.0)
    if ctx.dp_size > 1:
        # the means over the global batch: the ranks' rows, or every
        # rank's whole batch where it does not divide dp (a mean all the
        # same)
        n = b * s * ctx.dp_size
        density = ctx.grid.all_reduce(ones.sum(dim=(0, 1)), ctx.dp) / n
        mean_prob = ctx.grid.sum(probs.sum(dim=(0, 1)), ctx.dp) / n
    else:
        density = ones.mean(dim=(0, 1))
        mean_prob = probs.mean(dim=(0, 1))
    del ones
    aux = moe.num_experts * (density * mean_prob).sum()

    e_pad = padded_experts(moe, ctx.tp_size)
    e_held = getattr(p.w_gate, "full_shape", p.w_gate.shape)[0]
    if e_held != e_pad:
        raise ValueError(
            f"the experts are padded to {e_held}, but a tp "
            f"size of {ctx.tp_size} needs {e_pad}: build the MoE with "
            f"ep={ctx.tp_size}"
        )
    cap = capacity(moe, s, e_pad)

    # this rank's experts, whole over d_model and d_ff
    w_gate, w_up, w_down = (ctx.weight(w, tp_dim=0)
                            for w in (p.w_gate, p.w_up, p.w_down))
    # Registered block masks over the (d, f) expert weight shapes zero the
    # masked blocks, so every expert computes the block-sparse product the
    # planned FFN path would.
    m_in = ctx.weight_mask(tuple(w_gate.shape[1:]))
    m_out = ctx.weight_mask(tuple(w_down.shape[1:]))
    if m_in is not None:
        w_gate = _mask_expert_weight(w_gate, m_in)
        w_up = _mask_expert_weight(w_up, m_in)
    if m_out is not None:
        w_down = _mask_expert_weight(w_down, m_out)

    kw = dict(e_pad=e_pad, top_k=moe.top_k, cap=cap, use_kernel=use_kernel)
    if ctx.tp_size == 1:
        y = _dispatch_compute_combine_local(h, topi, gates, w_gate, w_up,
                                            w_down, **kw)
    else:
        y = ctx.tp_exit(_dispatch_compute_combine_local(
            ctx.tp_enter(h, True), topi, ctx.tp_enter(gates, True), w_gate,
            w_up, w_down, ep=ctx.grid.axis_index(ctx.tp_axis), **kw), True)
    if p.shared is not None:
        # the shared expert norms x itself (its own ``norm``)
        y = y + ffn(p.shared, x, _shared_view(cfg), ctx)
    return y.to(x.dtype), aux


def _mask_expert_weight(w: torch.Tensor, mask) -> torch.Tensor:
    """Zero masked (d, f) blocks of a stacked (E, d, f) expert weight."""
    mask = np.asarray(mask, dtype=bool)
    _, d, f = w.shape
    rb, cb = mask.shape
    if d % rb or f % cb:
        raise ValueError(
            f"weight {tuple(w.shape)} not divisible by mask {mask.shape}"
        )
    fine = torch.as_tensor(mask, device=w.device)
    fine = fine.repeat_interleave(d // rb, 0).repeat_interleave(f // cb, 1)
    return torch.where(fine[None], w, torch.zeros((), dtype=w.dtype,
                                                  device=w.device))


def _dispatch_compute_combine_local(h, topi, gates, w_gate, w_up, w_down, *,
                                    e_pad, top_k, cap, ep=0,
                                    use_kernel=False):
    """One rank's dispatch -> expert GEMMs -> combine: with every expert
    (``ep`` = 0, ``E_loc`` = ``E_pad``), the layer's output; with ``ep``
    and a slice of ``E_loc`` experts (``w_gate.shape[0]``), the partial
    output of experts ``[ep·E_loc, (ep+1)·E_loc)``.  A token's output is
    zero where its copies went elsewhere or overflowed their expert's
    capacity."""
    b, s, d = h.shape
    tk = s * top_k
    e_loc = w_gate.shape[0]
    dev = h.device

    eid = topi.reshape(b, tk)
    order = torch.argsort(eid, dim=-1, stable=True)  # (B, Tk)
    inv = torch.argsort(order, dim=-1)  # sorted position of each copy
    counts = torch.zeros((b, e_pad), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, eid, torch.ones_like(eid))  # per-batch bincount
    offsets = torch.cumsum(counts, dim=-1) - counts  # (B, E_pad)

    # ---- gather my experts' token copies into (B, E_loc, C, D) buffers
    my_counts = counts[:, ep * e_loc:(ep + 1) * e_loc]
    my_offsets = offsets[:, ep * e_loc:(ep + 1) * e_loc]
    slots = torch.arange(cap, device=dev)
    slot = my_offsets[:, :, None] + slots  # (B, E_loc, C)
    slot_valid = slots < my_counts[:, :, None]
    slot_c = slot.clamp(0, tk - 1).reshape(b, -1)
    copy_idx = torch.gather(order, 1, slot_c)  # (B, E_loc*C)
    tok_idx = copy_idx // top_k
    x_buf = torch.gather(h, 1, tok_idx[:, :, None].expand(-1, -1, d))
    x_buf = torch.where(slot_valid.reshape(b, -1, 1), x_buf,
                        torch.zeros((), dtype=h.dtype, device=dev))
    x_buf = x_buf.reshape(b, e_loc, cap, d)

    # ---- expert GEMMs (SwiGLU)
    if use_kernel:
        y_buf = _expert_gemms_kernel(x_buf, w_gate, w_up, w_down)
    else:
        g = torch.einsum("becd,edf->becf", x_buf, w_gate)
        u = torch.einsum("becd,edf->becf", x_buf, w_up)
        mid = L.silu(g) * u
        del g, u
        y_buf = torch.einsum("becf,efd->becd", mid, w_down)
    del x_buf

    # ---- combine back to token order (partial: only my experts)
    rank = inv - torch.gather(offsets, 1, eid)  # (B, Tk)
    keep = ((eid // e_loc) == ep) & (rank < cap)
    local_e = (eid - ep * e_loc).clamp(0, e_loc - 1)
    flat = (local_e * cap + rank).clamp(0, e_loc * cap - 1)
    z = torch.gather(y_buf.reshape(b, e_loc * cap, d), 1,
                     flat[:, :, None].expand(-1, -1, d))  # (B, Tk, D)
    z = torch.where(keep[:, :, None], z,
                    torch.zeros((), dtype=z.dtype, device=dev))
    z = z.reshape(b, s, top_k, d) * gates[..., None].to(z.dtype)
    return z.sum(dim=2)


def _expert_gemms_kernel(x_buf, w_gate, w_up, w_down):
    """The SwiGLU expert GEMMs over the capacity buffer ``(B, E_loc, C,
    D)`` as three grouped-GEMM launches (gate, up, down): the buffer's
    rows are B·E_loc tiles of C rows, tile ``(b, e)`` owned by expert
    ``e``; the map is built on the host from the shapes."""
    from repro_torch.kernels import ops as kops

    b, e_loc, cap, d = x_buf.shape
    tile_expert = np.tile(np.arange(e_loc, dtype=np.int32), b)
    x = x_buf.reshape(b * e_loc * cap, d)
    g = kops.grouped_gemm(x, w_gate, tile_expert, bt=cap)
    u = kops.grouped_gemm(x, w_up, tile_expert, bt=cap)
    mid = L.silu(g) * u
    del g, u
    y = kops.grouped_gemm(mid, w_down, tile_expert, bt=cap)
    return y.reshape(b, e_loc, cap, d)

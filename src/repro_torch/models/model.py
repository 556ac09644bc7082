"""The assembled LM: block stacks, the forward and the loss.

The port of ``repro.models.model``.  A model is ``embed -> [units of
the repeating block pattern] -> tail -> norm -> head``.  The reference scans the
stacked unit parameters with ``jax.lax.scan`` under remat; here ``LM``
holds one module per unit (``units.<i>.b<j>``, so every parameter path
is the reference's with the scan axis unstacked) and ``forward`` loops
over them in Python.  Remat (the reference's ``jax.checkpoint`` of each
unit) is ``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` of
each unit, applied only while autograd records: an inference forward
runs as it would without it.

An attention block holds a mixture of experts (``models.moe``) in place
of its FFN when the config has one (``cfg.moe``: mixtral-8x7b,
kimi-k2); its load-balance loss is the forward's aux loss.  The
recurrent kinds (``models.recurrent``) hold ``rec`` and, for ``rglru``,
an FFN: RecurrentGemma's units (rglru, rglru, attn), xLSTM's (mlstm×7,
slstm).

Inputs are a dict: ``tokens`` (B, S) int64 and/or ``embeds`` (B, S, D)
(the audio and VLM frontends are the reference's stubs: precomputed
frame or patch embeddings, placed before the tokens), and optionally
``positions`` (B, S), or (B, S, 3) for M-RoPE.

On a grid every rank is given the global batch and runs its rows (over
dp; a batch that does not divide dp runs whole on every rank), the
reference's constraint at the forward's entry, on its blocks of the
parameters (``dist.partitioning.shard_params``).  The embedding's
vocab is split over tp where its stored rows are: a rank looks up the
tokens of its rows (zeros elsewhere) and ``Grid.sum`` adds the ranks'
lookups.  The head's logits keep the same split, so ``forward`` returns
the rank's rows and vocab columns, and ``loss_fn`` takes the
cross-entropy over the split vocab (the max and the sum of exponentials
reduced over tp, the label's logit from the rank that holds it) and the
mean over the global batch (local sums over the global count, summed
over dp).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.context import ParallelCtx
from repro_torch.models import layers as L
from repro_torch.models.attention import Attention, attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import FFN, ffn
from repro_torch.models.moe import MoE, moe_ffn
from repro_torch.models.recurrent import (
    MLSTMBlock,
    RGLRUBlock,
    SLSTMBlock,
    mlstm_block,
    rglru_block,
    slstm_block,
)

__all__ = [
    "AUX_LOSS_COEF", "Block", "LM", "Z_LOSS_COEF", "apply_block",
    "embed_inputs", "forward", "head_logits", "init_model",
    "local_batch", "loss_fn", "vocab_part", "whole_logits",
]

_RECURRENT = {"rglru": RGLRUBlock, "mlstm": MLSTMBlock, "slstm": SLSTMBlock}


class Block(nn.Module):
    """One block of ``kind``, with the reference's parameter tree: an
    attention block holds ``attn`` and either ``moe`` (a config with
    experts, padded for ``ep``) or, when the config has a width for one,
    ``ffn``; ``rglru`` holds ``rec`` and ``ffn``; ``mlstm`` and ``slstm``
    hold ``rec``."""

    def __init__(self, kind: str, cfg: ModelConfig, *, dtype, device,
                 ep: int = 1):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attn = self.moe = self.ffn = self.rec = None
        if kind == "attn":
            self.attn = Attention(cfg, **kw)
            if cfg.moe is not None:
                self.moe = MoE(cfg, ep=ep, **kw)
            elif cfg.d_ff:
                self.ffn = FFN(cfg, **kw)
        elif kind in _RECURRENT:
            self.rec = _RECURRENT[kind](cfg, **kw)
            if kind == "rglru":
                self.ffn = FFN(cfg, **kw)
        else:
            raise ValueError(kind)


class LM(nn.Module):
    """Parameters of a model, laid out as the reference's pytree:
    ``units.<i>.b<j>``, ``tail.<j>``, ``final_norm``, ``embed`` (when
    tokens are embedded) and ``head`` (untied).  ``ep`` is
    the expert-parallel degree (``ctx.tp_size``) the experts of a MoE
    config are padded for, as the reference's ``init_model`` pads them
    for its context."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", ep: int = 1):
        super().__init__()
        dtype = L.torch_dtype(cfg.dtype)
        kw = dict(dtype=dtype, device=device)
        self.units = nn.ModuleList(
            nn.ModuleDict({f"b{j}": Block(kind, cfg, **kw, ep=ep)
                           for j, kind in enumerate(cfg.block_pattern)})
            for _ in range(cfg.units)
        )
        self.tail = nn.ModuleList(Block(kind, cfg, **kw, ep=ep)
                                  for kind in cfg.tail)
        self.final_norm = L.RMSNorm(cfg.d_model, device=device)
        self.embed = (L.Embedding(cfg.vocab_size, cfg.d_model, **kw)
                      if cfg.embed_inputs else None)
        self.head = (L.Dense(cfg.d_model, cfg.vocab_size, **kw)
                     if not cfg.tie_embeddings or not cfg.embed_inputs
                     else None)


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device="cuda", ep: int = 1) -> LM:
    """A model of ``cfg`` with parameters drawn from ``generator`` (on
    ``device``) with the reference's shapes, dtypes and distributions:
    dense kernels N(0, 1/d_in) drawn in fp32 and cast to ``cfg.dtype``
    (expert weights likewise, the router in fp32), embeddings N(0, 1),
    biases zero and norm scales one (fp32); the recurrent blocks' own
    parameters as ``models.recurrent`` says."""
    return L.init_params(LM(cfg, device=device, ep=ep), generator)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def apply_block(
    kind: str,
    p: Block,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    ctx: ParallelCtx,
    *,
    use_kernel: bool = False,
):
    """Residual application of one block; returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "attn":
        x = x + attention(
            p.attn, x, positions, cfg, ctx, window=cfg.window,
            use_kernel=use_kernel,
        )
        if p.moe is not None:
            y, aux = moe_ffn(p.moe, x, cfg, ctx, use_kernel=use_kernel)
            x = x + y
        elif p.ffn is not None:
            x = x + ffn(p.ffn, x, cfg, ctx)
    elif kind == "rglru":
        x = x + rglru_block(p.rec, x, cfg, ctx)
        x = x + ffn(p.ffn, x, cfg, ctx)
    elif kind == "mlstm":
        x = x + mlstm_block(p.rec, x, cfg, ctx)
    elif kind == "slstm":
        x = x + slstm_block(p.rec, x, cfg, ctx)
    else:
        raise ValueError(kind)
    return x, aux


def local_batch(batch: dict, ctx: ParallelCtx) -> dict:
    """This rank's rows of a global ``batch`` (every leaf's first dim over
    dp) where it divides dp > 1; else ``batch`` (a batch that does not
    divide dp stays whole on every rank, the reference's fallback to
    replicated)."""
    if ctx.dp_size == 1:
        return batch
    return {k: ctx.block(v, ctx.dp)
            if isinstance(v, torch.Tensor) and v.ndim else v
            for k, v in batch.items()}


def vocab_part(model: LM, cfg: ModelConfig, ctx: ParallelCtx):
    """``(start, count)`` of the vocab this rank's logits hold, or None
    where they hold it whole."""
    w = model.embed.embedding if model.head is None else model.head.w
    if not ctx.tp_sharded(w, 0 if model.head is None else 1):
        return None
    return ctx.tp_part(cfg.vocab_size)


def whole_logits(model: LM, logits: torch.Tensor, cfg: ModelConfig,
                 ctx: ParallelCtx, rows: bool) -> torch.Tensor:
    """The logits of every row and the whole vocab, on every rank, from
    this rank's (its vocab part, ``vocab_part``; its rows where ``rows``,
    the batch being split over dp)."""
    if vocab_part(model, cfg, ctx) is not None:
        logits = ctx.grid.all_gather(logits, ctx.tp_axis, logits.ndim - 1)
    if rows:
        logits = ctx.grid.all_gather(logits, ctx.dp, 0)
    return logits


def _embed(p: L.Embedding, tokens, cfg: ModelConfig, ctx: ParallelCtx):
    if not ctx.tp_sharded(p.embedding, 0):
        return F.embedding(tokens, ctx.weight(p.embedding))
    v0, n = ctx.tp_part(cfg.vocab_size)
    local = tokens - v0
    own = (local >= 0) & (local < n)
    x = F.embedding(local.clamp(0, n - 1), ctx.weight(p.embedding, tp_dim=0))
    x = torch.where(own[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return ctx.tp_exit(x, True)


def embed_inputs(model: LM, inputs: dict, cfg: ModelConfig,
                 ctx: ParallelCtx) -> torch.Tensor:
    parts = []
    if inputs.get("embeds") is not None:
        parts.append(inputs["embeds"])
    if cfg.embed_inputs and inputs.get("tokens") is not None:
        parts.append(_embed(model.embed, inputs["tokens"], cfg, ctx))
    if not parts:
        raise ValueError("inputs must contain 'tokens' and/or 'embeds'")
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def head_logits(model: LM, x: torch.Tensor, cfg: ModelConfig,
                ctx: ParallelCtx) -> torch.Tensor:
    """The fp32 logits of the normed ``x`` on this rank's vocab
    (``vocab_part``)."""
    split = vocab_part(model, cfg, ctx) is not None
    x = ctx.tp_enter(x, split)
    if model.head is not None:
        w = ctx.weight(model.head.w, tp_dim=1 if split else None)
        return torch.matmul(x, w).float()
    e = ctx.weight(model.embed.embedding, tp_dim=0 if split else None)
    return L.matmul_f32(x, e.t())


def _records(model: LM, x: torch.Tensor) -> bool:
    """Whether autograd records this forward: grad mode is on and the
    input or a parameter requires grad."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in model.parameters()))


def forward(
    model: LM,
    inputs: dict,
    cfg: ModelConfig,
    ctx: ParallelCtx,
    *,
    use_kernel: bool = False,
    remat: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) fp32, aux_loss scalar).

    ``use_kernel=True`` runs every attention block through the
    flash-attention kernel (one launch per attention block on a CUDA
    model) and every MoE block's expert GEMMs through the grouped-GEMM
    kernel (three launches per layer); recurrent blocks have no kernel
    of their own.  ``remat=True`` recomputes each unit in the backward
    instead of keeping its activations, when autograd records.  On a
    grid, ``inputs`` is the global batch and the logits are this rank's
    rows and vocab (``local_batch``, ``vocab_part``)."""
    return _forward(model, local_batch(inputs, ctx), cfg, ctx,
                    use_kernel=use_kernel, remat=remat)


def _forward(model, inputs, cfg, ctx, *, use_kernel, remat):
    x = embed_inputs(model, inputs, cfg, ctx)
    x = ctx.wsc(x, ctx.dp, None, None)
    positions = inputs.get("positions")
    if positions is None:
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)

    def unit_fn(x, unit):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, kind in enumerate(cfg.block_pattern):
            x, a = apply_block(kind, unit[f"b{j}"], x, positions, cfg, ctx,
                               use_kernel=use_kernel)
            aux = aux + a
        return x, aux

    remat = remat and _records(model, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit in model.units:
        if remat:
            x, a = checkpoint(unit_fn, x, unit, use_reentrant=False)
        else:
            x, a = unit_fn(x, unit)
        aux = aux + a
    for kind, p in zip(cfg.tail, model.tail):
        x, a = apply_block(kind, p, x, positions, cfg, ctx,
                           use_kernel=use_kernel)
        aux = aux + a
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = head_logits(model, x, cfg, ctx)
    return ctx.wsc(logits, ctx.dp, None, ctx.tp_axis), aux


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

AUX_LOSS_COEF = 0.01
Z_LOSS_COEF = 1e-4


def loss_fn(
    model: LM,
    batch: dict,
    cfg: ModelConfig,
    ctx: ParallelCtx,
    *,
    remat: bool = True,
) -> tuple[torch.Tensor, dict]:
    """Cross-entropy (+ MoE aux + z-loss).  ``batch`` must contain
    ``labels``; a negative label masks its position.  On a grid
    ``batch`` is the global batch, and every rank returns the loss of the
    whole of it."""
    rows = batch["labels"].shape[0]
    batch = local_batch(batch, ctx)
    logits, aux = _forward(model, batch, cfg, ctx, use_kernel=False,
                           remat=remat)
    labels = batch["labels"]
    # labels may cover the token tail only (a prefix without labels)
    logits = logits[:, -labels.shape[1]:, :]
    part = vocab_part(model, cfg, ctx)
    if part is None:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    else:  # the vocab split over tp
        v0, n = part
        grid, tp = ctx.grid, ctx.tp_axis
        m = grid.all_reduce(logits.detach().amax(dim=-1), tp, op="max")
        logz = m + torch.log(ctx.tp_exit(
            torch.exp(logits - m[..., None]).sum(dim=-1), True))
        local = labels - v0
        own = (local >= 0) & (local < n)
        ll = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        ll = ctx.tp_exit(torch.where(own, ll, torch.zeros_like(ll)), True)
    mask = (labels >= 0).float()
    dp = ctx.dp_size
    split = dp > 1 and rows % dp == 0  # each dp rank holds its rows
    count = ctx.grid.all_reduce(mask.sum(), ctx.dp) if split else mask.sum()
    denom = count.clamp(min=1.0)

    def total(x):  # over the global batch
        x = x.sum()
        if dp == 1:
            return x
        # rows split: the ranks' sums; else every rank holds every row,
        # and its share of the gradient summed over dp is 1/dp
        return ctx.grid.sum(x if split else x / dp, ctx.dp)

    ce = total((logz - ll) * mask) / denom
    z_loss = Z_LOSS_COEF * total((logz * mask) ** 2) / denom
    total = ce + z_loss + AUX_LOSS_COEF * aux
    metrics = {"ce": ce, "z_loss": z_loss, "aux": aux, "loss": total}
    return total, metrics

"""Serving engine: batched prefill + single-token decode with caches.

The port of ``repro.serve.engine``.  Cache kinds per block:

* ``attn``  — KV cache (B, Hkv, S_cache, Dh); rolling ring buffer of size
  ``window`` for sliding/local-attention archs, so a long prompt holds
  only O(window) state.  On a grid with a tensor-parallel axis decode
  attention runs as a per-rank program: each rank holds its S-shard of
  the cache and the partial softmaxes combine with the log-sum-exp trick
  (flash-decoding across ranks).
* ``rglru`` / ``mlstm`` / ``slstm`` — O(1) recurrent state; prefill
  derives the closed-form final state where the math allows it.

The cache is a nested dict of tensors with the reference's tree:
``{"units": {"b<j>": {leaf: (U, B, ...)}}, "tail": [{leaf: (B, ...)}],
"pos": (B,)}``, leaves ``k``, ``v``, ``k_s``, ``v_s`` (int8 scales),
``h``, ``c``, ``n``, ``m``, ``conv``.  Stacked unit leaves keep the
leading unit axis; layer ``i`` of a unit reads the view ``leaf[i]``.
``pos`` is a per-slot ``(B,)`` vector counting tokens written so far in
each batch row — rows decode at independent positions, which is what the
continuous-batching scheduler (``serve.scheduler``) relies on to admit
and evict requests per step without reshaping live state.  A scalar
``pos`` is still accepted and broadcast.

Where the reference's JAX functions return updated copies, the port's
decode updates in place: ``decode_step`` and ``_decode_attention`` write
the cache they are given (ring slots with ``index_put_``, recurrent
states with ``copy_``) and return it.  ``prefill`` and ``init_cache``
build a fresh cache.

Prefill attention goes through the flash-attention kernel
(``attention(..., use_kernel=True)``): a CUDA tensor launches it, a CPU
tensor runs its plain version, which computes the reference's function
(the reference's prefill calls its plain attention).  Decode attention
and the MoE blocks are torch ops, as the reference's einsums are.

On a grid of more than one rank, where the model holds its blocks
(``dist.partitioning.shard_params``), ``prefill`` and ``decode_step``
take the global batch and run this rank's rows (where the batch divides
dp; else every row, ``decode_rows``), so every leaf of the cache holds
the rank's rows and a KV leaf its S-shard (``cache_shardings``);
prefill runs the sharded attention and FFN, decode gathers the
attention and recurrent weights whole (its attention is
sequence-sharded over tp), and both return the logits of every row and
the whole vocab, so every rank picks the same tokens.

Capacity contract (non-windowed archs): decoding a token at position
``>= S_cache`` never corrupts the cache — the ring write is dropped — but
the returned logits for that row attend only to the first ``S_cache``
tokens, so they are not the true model output.  Callers must not decode
past capacity: the serving loops raise :class:`CacheCapacityError`
instead (windowed archs wrap by design and have no capacity limit).
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from repro_torch.dist.context import ParallelCtx
from repro_torch.dist.partitioning import block_of
from repro_torch.models import layers as L
from repro_torch.models.attention import _project_qkv, attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn
from repro_torch.models.model import (
    LM,
    _embed,
    embed_inputs,
    head_logits,
    local_batch,
    whole_logits,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.recurrent import (
    mlstm_block,
    mlstm_step,
    rglru_block,
    rglru_step,
    slstm_block,
    slstm_step,
)

__all__ = [
    "CacheCapacityError",
    "init_cache",
    "cache_shardings",
    "prefill",
    "decode_rows",
    "decode_step",
    "cache_len",
    "map_cache",
    "warm_matmul_plans",
    "warm_kernel_cache",
]


class CacheCapacityError(RuntimeError):
    """Decoding would write past the KV cache capacity of a non-windowed
    arch.  Raised by the serving loops (``launch.serve``,
    ``serve.scheduler``) *before* the overflowing decode step — the
    engine itself drops out-of-capacity writes (never corrupts state) but
    cannot produce correct logits for tokens beyond ``S_cache``."""


def warm_matmul_plans(cfg: ModelConfig, ctx: ParallelCtx, batch: int,
                      prompt_len: int, *, warm_executables: bool = True,
                      service=None):
    """Pre-derive the SUMMA ``MatmulPlan``s for every projection shape the
    serving path will request — prefill flattens (B, S, D) activations
    to M = B*S rows, decode to M = B — so the first prefill and decode
    find them in ``DistributedMatmul``'s plan cache.  With
    ``matmul_strategy="auto"`` each plan is additionally *tuned*
    (``sched.tuner``), once per shape, here.  With ``warm_executables``
    (default) each warmed plan is also run once on zero operands through
    ``core.summa``'s plan-digest-keyed executable cache at the serving
    dtype.

    Tuned winners go through the **persistent plan service**
    (``serve.plan_service``; pass ``service=`` to override the process
    singleton): shapes whose (shape, structure digest, grid fingerprint)
    key is recorded re-apply the stored schedule without re-running the
    simulator search.  The traffic shape ``(batch, prompt_len)`` is
    recorded so the service can pre-warm future processes.
    Returns the warmed plans; empty with no grid, under ``"xla"`` and
    under ``pure_dp``.
    """
    from repro_torch.core import summa as sm
    from repro_torch.serve.plan_service import plan_service

    if not ctx.has_grid or ctx.matmul_strategy == "xla" or ctx.pure_dp:
        return []
    svc = plan_service() if service is None else service
    svc.record_traffic(batch, prompt_len)
    d = cfg.d_model
    ffs = [cfg.d_ff] if cfg.d_ff else []
    if cfg.moe is not None and cfg.moe.num_shared_experts:
        ffs.append(cfg.moe.d_ff * cfg.moe.num_shared_experts)
    dtype = L.torch_dtype(cfg.dtype)
    itemsize = dtype.itemsize
    tune = ctx.matmul_strategy == "auto"
    # "auto" also lets the comm-volume model pick the stationarity
    stationarity = "auto" if tune else "C"
    plans = []
    for m in (batch * prompt_len, batch):
        for f in ffs:
            for k_in, n_out in ((d, f), (f, d)):
                plans.append(
                    svc.plan_projection(
                        ctx, m, k_in, n_out, itemsize=itemsize, tune=tune,
                        stationarity=stationarity,
                    )
                )
    plans = [p for p in plans if p is not None]
    if warm_executables:
        for p in {id(p): p for p in plans}.values():
            sm.warm_plan_executable(p, dtype)
    return plans


def warm_kernel_cache(cfg: ModelConfig, ctx: ParallelCtx, batch: int,
                      prompt_len: int, *, path: str | None = None,
                      routes: tuple[str, ...] | None = None,
                      repeats: int = 3):
    """Tune the kernel-autotune buckets for every *local* gemm shape the
    serving projections produce, and persist the winners.

    The per-plan local panel product is ``(m_loc, kb_width) @ (kb_width,
    n_loc)``: that shape's bucket is what ``summa._local_dot`` looks up.
    ``path`` writes the JSON cache file (restore it in a later process
    via ``REPRO_AUTOTUNE_CACHE`` or ``KernelAutotuner.load``); ``routes``
    restricts the benchmark sweep.  Warm the kernel cache **before**
    :func:`warm_matmul_plans`: executable cache keys carry the autotune
    fingerprint.  Returns the tuned bucket keys.
    """
    from repro_torch.kernels.autotune import autotune_cache, bucket_key

    plans = warm_matmul_plans(cfg, ctx, batch, prompt_len,
                              warm_executables=False)
    cache = autotune_cache()
    tuned = []
    for p in plans:
        m_loc = p.m_pad // p.p_row
        n_loc = p.n_pad // p.p_col
        key = bucket_key(m_loc, p.kb_width, n_loc, dtype=cfg.dtype)
        if key in tuned:
            continue
        cache.tune(m_loc, p.kb_width, n_loc, dtype=cfg.dtype,
                   repeats=repeats, routes=routes, device=ctx.grid.device)
        tuned.append(key)
    if path is not None:
        cache.save(path)
    return tuned


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len


# ---------------------------------------------------------------------------
# the cache tree
# ---------------------------------------------------------------------------

#: attn-cache leaf names — KV values plus their int8 quantization scales;
#: everything else in a block cache is recurrent/conv state.
_KV_LEAF_KEYS = frozenset({"k", "v", "k_s", "v_s"})


def map_cache(fn, cache, *others, path=()):
    """``fn(path, leaf, *other_leaves)`` over every tensor of a cache tree
    (nested dicts and lists), with ``path`` the tuple of keys from the
    root; returns a tree of the results with the same structure."""
    if isinstance(cache, dict):
        return {k: map_cache(fn, v, *(o[k] for o in others), path=path + (k,))
                for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return [map_cache(fn, v, *(o[i] for o in others), path=path + (i,))
                for i, v in enumerate(cache)]
    return fn(path, cache, *others)


def cache_batch_axis(path) -> int:
    """Batch axis of a cache leaf from its tree path: stacked unit caches
    carry a leading unit dimension, tail caches and ``pos`` do not."""
    return 1 if path[0] == "units" else 0


def cache_shardings(cache, ctx: ParallelCtx, batch: int):
    """Per-leaf sharding specs of a serving cache: a tree of tuples, one
    entry per dimension (an axis name, a tuple of names or ``None``),
    equal to the reference's ``PartitionSpec`` entries.

    * KV values **and their int8 scales** (``k``/``v``/``k_s``/``v_s``,
      ``(units?, B, Hkv, S, Dh|1)``): batch over DP, S over TP — the
      seq-sharded decode-attention layout.
    * recurrent / conv states (``h``/``c``/``n``/``m``/``conv``) and the
      per-slot ``pos`` vector: batch over DP only.  Classification is by
      leaf *name and tree path*, never by shape.
    * batch not divisible by the DP degree: the batch axis is replicated
      (the same explicit fallback ``decode_rows`` warns about).
    """
    if not ctx.has_grid:
        raise ValueError("cache_shardings needs a grid; got grid=None")
    bs = ctx.dp if batch % max(ctx.dp_size, 1) == 0 else None

    def spec(path, leaf):
        base = [None] * leaf.ndim
        if path[-1] in _KV_LEAF_KEYS:
            base[-4] = bs  # B
            base[-2] = ctx.tp_axis  # S
            return tuple(base)
        if leaf.ndim > 0:  # recurrent state or pos: batch over DP
            base[cache_batch_axis(path)] = bs
        return tuple(base)

    return map_cache(spec, cache)


def _sharded(ctx: ParallelCtx) -> bool:
    """Whether ``ctx``'s grid has more than one rank."""
    return ctx.has_grid and math.prod(ctx.grid.sizes) > 1


_block_of = block_of


def _local_kv(cache, ctx: ParallelCtx, batch: int):
    """The cache of this rank's ``batch`` rows with each KV leaf cut to
    its S-shard of :func:`cache_shardings` (the rows are the rank's
    already); every other leaf as it is."""
    if not _sharded(ctx):
        return cache
    specs = cache_shardings(cache, ctx, batch)

    def cut(path, leaf, spec):
        if path[-1] not in _KV_LEAF_KEYS:
            return leaf
        spec = tuple(None if d == leaf.ndim - 4 else e
                     for d, e in enumerate(spec))
        return _block_of(leaf, spec, ctx.grid)

    return map_cache(cut, cache, specs)


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------


def _quantize_kv(x: torch.Tensor):
    """(.., S, Dh) -> int8 values + per-(token, head) fp32 absmax scales
    (round half to even, as ``jnp.round``)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                 kv_quant: bool, device) -> dict:
    dh = cfg.resolved_head_dim
    dtype = L.torch_dtype(cfg.dtype)
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "attn":
        s_c = cache_len(cfg, max_len)
        shape = (batch, cfg.num_kv_heads, s_c, dh)
        if kv_quant:
            sshape = (batch, cfg.num_kv_heads, s_c, 1)
            return {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(sshape, **f32),
                "v_s": torch.zeros(sshape, **f32),
            }
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    d = cfg.d_model
    if kind == "rglru":
        return {"h": torch.zeros((batch, d), **f32),
                "conv": torch.zeros((batch, 3, d), **f32)}
    if kind == "mlstm":
        di = 2 * d
        nh = cfg.num_heads
        dh_i = di // nh
        return {
            "c": torch.zeros((batch, nh, dh_i, dh_i), **f32),
            "n": torch.zeros((batch, nh, dh_i), **f32),
            "m": torch.full((batch, nh), -1e30, **f32),
            "conv": torch.zeros((batch, 3, di), **f32),
        }
    if kind == "slstm":
        return {
            "c": torch.zeros((batch, d), **f32),
            "n": torch.ones((batch, d), **f32),
            "m": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32),
        }
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               kv_quant: bool = False, device="cuda"):
    """An empty cache for ``batch`` rows of up to ``max_len`` tokens, on
    ``device``; ``units`` leaves carry a leading axis of ``cfg.units``
    (empty when there are none)."""
    def stacked(kind):
        one = _block_cache(kind, cfg, batch, max_len, kv_quant, device)
        return {k: v[None].repeat((cfg.units,) + (1,) * v.ndim)
                for k, v in one.items()}

    units = {f"b{j}": stacked(kind) for j, kind in enumerate(cfg.block_pattern)}
    tail = [_block_cache(kind, cfg, batch, max_len, kv_quant, device)
            for kind in cfg.tail]
    return {"units": units, "tail": tail,
            "pos": torch.zeros((batch,), dtype=torch.int64, device=device)}


def _unit_view(cache: dict, i: int) -> dict:
    """Layer ``i``'s block caches of a stacked ``units`` subtree, as views."""
    return {bj: {k: v[i] for k, v in c.items()} for bj, c in cache.items()}


def _store(dst: dict, new: dict) -> None:
    """Write a block's new state into its cache tensors (views included)."""
    for key, value in new.items():
        if value is not dst[key]:
            dst[key].copy_(value)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _pack_ring(k: torch.Tensor, s_c: int) -> torch.Tensor:
    """(B, Hkv, S, Dh) keys or values -> a contiguous (B, Hkv, s_c, Dh)
    cache: zero-padded when S < s_c, else the last s_c tokens at their
    ring slots ``t % s_c``."""
    b, hkv, s, dh = k.shape
    out = k.new_zeros((b, hkv, s_c, dh))
    if s >= s_c:
        idx = torch.arange(s - s_c, s, device=k.device)  # tokens kept
        out[:, :, idx % s_c, :] = k[:, :, idx, :]
    else:
        out[:, :, :s, :] = k
    return out


def _prefill_block(kind, p, x, positions, cfg, ctx, max_len, dst):
    """One block over the prompt; writes its cache into ``dst``."""
    if kind == "attn":
        o, (k, v) = attention(
            p.attn, x, positions, cfg, ctx, window=cfg.window,
            use_kernel=True, return_kv=True,
        )
        x = x + o
        if p.moe is not None:
            y, _ = moe_ffn(p.moe, x, cfg, ctx)
            x = x + y
        elif p.ffn is not None:
            x = x + ffn(p.ffn, x, cfg, ctx)
        s_c = cache_len(cfg, max_len)
        k_cache, v_cache = _pack_ring(k, s_c), _pack_ring(v, s_c)
        if ctx.kv_quant:
            kq, ks = _quantize_kv(k_cache)
            vq, vs = _quantize_kv(v_cache)
            _store(dst, {"k": kq, "k_s": ks, "v": vq, "v_s": vs})
        else:
            _store(dst, {"k": k_cache, "v": v_cache})
        return x
    if kind == "rglru":
        o, st = rglru_block(p.rec, x, cfg, ctx, return_state=True)
        x = x + o
        x = x + ffn(p.ffn, x, cfg, ctx)
    elif kind == "mlstm":
        o, st = mlstm_block(p.rec, x, cfg, ctx, return_state=True)
        x = x + o
    elif kind == "slstm":
        o, st = slstm_block(p.rec, x, cfg, ctx, return_state=True)
        x = x + o
    else:
        raise ValueError(kind)
    _store(dst, st)
    return x


def prefill(model: LM, inputs: dict, cfg: ModelConfig, ctx: ParallelCtx,
            max_len: int):
    """Returns (last-token logits (B, V) fp32, a new cache).  Every
    attention block launches the flash-attention kernel once on a CUDA
    model."""
    rows = ctx.splits_batch(
        next(v for v in inputs.values() if v is not None).shape[0])
    inputs = local_batch(inputs, ctx)
    x = embed_inputs(model, inputs, cfg, ctx)
    b, s = x.shape[:2]
    positions = inputs.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cache = init_cache(cfg, b, max_len, kv_quant=ctx.kv_quant,
                       device=x.device)
    for i, unit in enumerate(model.units):
        view = _unit_view(cache["units"], i)
        for j, kind in enumerate(cfg.block_pattern):
            x = _prefill_block(kind, unit[f"b{j}"], x, positions, cfg, ctx,
                               max_len, view[f"b{j}"])
    for j, kind in enumerate(cfg.tail):
        x = _prefill_block(kind, model.tail[j], x, positions, cfg, ctx,
                           max_len, cache["tail"][j])
    last = L.rmsnorm(model.final_norm, x[:, -1, :], cfg.norm_eps)
    logits = whole_logits(model, head_logits(model, last, cfg, ctx), cfg,
                          ctx, rows)
    cache["pos"].fill_(s)
    return logits, _local_kv(cache, ctx, b)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _local_ring_update(buf, new_val, slot, offset) -> None:
    """Write ``new_val`` (B, Hkv, 1, Dh) into ``buf`` (B, Hkv, S_loc, Dh)
    at per-row positions ``slot`` (global, ``(B,)``) of a seq-shard
    covering [offset, offset + S_loc), in place.  Out-of-range rows
    (another shard owns the slot, or the slot is past capacity on a
    non-windowed arch) keep their current value — an overflowing write
    is *dropped*, never clamped onto the final slot."""
    b, _, s_loc, _ = buf.shape
    local = slot - offset  # (B,)
    in_range = (local >= 0) & (local < s_loc)
    lslot = torch.clamp(local, 0, s_loc - 1)
    rows = torch.arange(b, device=buf.device)
    # the indexed dims go first: (B, Hkv, Dh), as in numpy
    cur = buf[rows, :, lslot, :]
    upd = torch.where(in_range[:, None, None],
                      new_val[:, :, 0, :].to(buf.dtype), cur)
    buf[rows, :, lslot, :] = upd


def _inv_sqrt(dh: int) -> float:
    """1/sqrt(dh) in fp32, as the reference computes it, as a Python
    scalar: a scalar operand needs no copy to the device, and a copy from
    host memory would make the stream wait."""
    return float(np.float32(1) / np.sqrt(np.float32(dh)))


def _partial_attn(q, k, v, n_valid, offset, ks=None, vs=None):
    """Softmax pieces of ``q`` (B, H, Dh) over one S-shard of the cache:
    the row max ``m``, the sum ``l`` and the unnormalised output ``o``
    (fp32)."""
    b, h, dh = q.shape
    hkv, s_loc = k.shape[1], k.shape[2]
    g = h // hkv
    qg = (q.float() * _inv_sqrt(dh)).reshape(b, hkv, g, dh)
    kf, vf = k.float(), v.float()
    if ks is not None:
        kf = kf * ks
        vf = vf * vs
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, kf)
    live = ((offset + torch.arange(s_loc, device=q.device))[None, None, None]
            < n_valid[:, None, None, None])
    logits = torch.where(live, logits, torch.full((), -1e30,
                                                  device=q.device))
    m = logits.amax(dim=-1)  # (b, hkv, g)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, vf)
    return m, l, o


def decode_rows(b: int, ctx: ParallelCtx) -> bool:
    """Whether a decode batch of ``b`` rows runs split over dp (each rank
    its rows: ``b`` divides dp > 1).  A batch that does not divide a dp of
    more than one keeps every row's cache on every dp rank for the step,
    correct but costly: on a tensor-parallel grid that warns (callers size
    their slot pools to a dp multiple, as ``serve.scheduler`` does, or
    pad)."""
    if ctx.dp_size > 1 and b % ctx.dp_size and ctx.tp_size > 1:
        warnings.warn(
            f"decode batch {b} is not divisible by dp={ctx.dp_size}: "
            "KV cache DP sharding is dropped (replicated) for this step; "
            "pad the batch or use a slot count divisible by dp",
            RuntimeWarning,
            stacklevel=2,
        )
    return ctx.splits_batch(b)


def _decode_attention(q, k_new, v_new, k_cache, v_cache, slot, n_valid,
                      ctx: ParallelCtx, k_scale=None, v_scale=None):
    """One fused decode-attention step: write the new token's K/V into the
    ring caches (in place; on a grid, this rank's block only) and attend.

    q (B, H, Dh); k_new/v_new (B, Hkv, 1, Dh); caches (B, Hkv, S_c, Dh) —
    on a grid of more than one rank, the rows of the cache (this rank's
    rows where the batch is split over dp, ``decode_rows``) and, of the
    caches, this rank's S-shard of :func:`cache_shardings`.  ``slot`` /
    ``n_valid`` are per-row ``(B,)`` vectors (scalars are broadcast).
    With ``k_scale``/``v_scale`` the caches are int8 and dequantized
    in-shard.  Returns (attention output (B, H, Dh), the caches given...).
    """
    b, h, dh = q.shape
    dev = q.device
    slot = torch.as_tensor(slot, device=dev).expand(b)
    n_valid = torch.as_tensor(n_valid, device=dev).expand(b)
    quant = k_scale is not None
    if quant:
        kq_new, ks_new = _quantize_kv(k_new)
        vq_new, vs_new = _quantize_kv(v_new)
        news = ((k_cache, kq_new), (v_cache, vq_new), (k_scale, ks_new),
                (v_scale, vs_new))
        caches = (k_cache, v_cache, k_scale, v_scale)
    else:
        news = ((k_cache, k_new), (v_cache, v_new))
        caches = (k_cache, v_cache)
    # the per-rank program of the reference's shard_map: the rank's
    # S-shard starts at its tp index times the shard's length
    offset = (ctx.grid.axis_index(ctx.tp_axis) * k_cache.shape[2]
              if _sharded(ctx) and ctx.tp_axis is not None else 0)
    for buf, new in news:
        _local_ring_update(buf, new, slot, offset)
    m, l, o = _partial_attn(q, k_cache, v_cache, n_valid, offset, k_scale,
                            v_scale)
    if ctx.tp_size > 1:
        grid = ctx.grid
        m_g = grid.all_reduce(m, ctx.tp_axis, op="max")
        corr = torch.exp(m - m_g)
        l = grid.all_reduce(l * corr, ctx.tp_axis)
        o = grid.all_reduce(o * corr[..., None], ctx.tp_axis)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return (out.reshape(b, h, dh).to(q.dtype),) + caches


def _ring_attend(q_t, k_new, v_new, cache, pos, cfg, ctx):
    """An attn block's decode attention over its dense ring cache: write
    the new token's K/V (in place) and attend.  q_t (B, H, dh); k_new /
    v_new (B, Hkv, 1, dh); returns (B, H, dh).  Non-windowed archs write
    slot = pos *unclamped*: past capacity the ring update drops the write
    (see the module capacity contract and :class:`CacheCapacityError`)."""
    # global capacity: on a grid the cache holds this rank's S-shard
    s_c = cache["k"].shape[2] * (ctx.tp_size if _sharded(ctx) else 1)
    slot = pos % s_c if cfg.window is not None else pos
    n_valid = torch.clamp(pos + 1, max=s_c)
    scales = ((cache["k_s"], cache["v_s"]) if ctx.kv_quant else ())
    return _decode_attention(q_t, k_new, v_new, cache["k"], cache["v"],
                             slot, n_valid, ctx, *scales)[0]


def _decode_block(kind, p, x_t, positions, cache, pos, cfg, ctx,
                  attend=_ring_attend):
    """x_t (B, D) one token at per-row positions ``pos`` (B,); updates
    ``cache`` in place and returns x_t.  An attn block's attention is
    ``attend`` (the dense ring's unless told otherwise).  On a grid (x_t
    holds the cache's rows) the attention and recurrent weights are
    gathered whole, every tp rank repeating the projections around its
    sequence-sharded attention."""
    if kind == "attn":
        pa = ctx.whole(p.attn)
        h = L.rmsnorm(pa.norm, x_t, cfg.norm_eps)
        q, k, v = _project_qkv(pa, h[:, None, :], positions, cfg, ctx)
        q_t = q.reshape(q.shape[0], q.shape[2], q.shape[3])  # (B, H, dh)
        # k, v (B, 1, Hkv, dh) -> (B, Hkv, 1, dh)
        o = attend(q_t, k.transpose(1, 2), v.transpose(1, 2), cache, pos,
                   cfg, ctx)
        x_t = x_t + L.dense(pa.wo,
                            o.reshape(x_t.shape[0], -1).to(x_t.dtype))
        if p.moe is not None:
            y, _ = moe_ffn(p.moe, x_t[:, None, :], cfg, ctx)
            x_t = x_t + y[:, 0]
        elif p.ffn is not None:
            x_t = x_t + ffn(p.ffn, x_t[:, None, :], cfg, ctx)[:, 0]
        return x_t
    rec = ctx.whole(p.rec)
    if kind == "rglru":
        o, st = rglru_step(rec, x_t, cache, cfg)
        x_t = x_t + o
        x_t = x_t + ffn(p.ffn, x_t[:, None, :], cfg, ctx)[:, 0]
    elif kind == "mlstm":
        o, st = mlstm_step(rec, x_t, cache, cfg)
        x_t = x_t + o
    elif kind == "slstm":
        o, st = slstm_step(rec, x_t, cache, cfg)
        x_t = x_t + o
    else:
        raise ValueError(kind)
    _store(cache, st)
    return x_t


def decode_step(model: LM, cache, tokens, cfg: ModelConfig,
                ctx: ParallelCtx, *, active=None, attend=_ring_attend):
    """One decode step.  tokens (B,) int -> (logits (B, V) fp32, cache).

    Updates ``cache`` in place — its KV rings, recurrent states and
    ``pos`` — and returns it.  ``cache["pos"]`` is a per-row ``(B,)``
    position vector (a scalar is broadcast): rows decode at independent
    offsets, so a continuous-batching scheduler can hold requests at
    different depths in one batch.  ``active`` (optional ``(B,)``
    bool/int) advances only the marked rows' positions — inactive (free)
    slots keep ``pos`` untouched so an admitted request starts from a
    clean offset; their ride-along writes land in slots the next prefill
    overwrites anyway.  ``attend(q_t, k_new, v_new, cache, pos, cfg,
    ctx)`` is each attn block's attention over its cache, the dense
    ring's by default (``serve.pages`` passes its page-table twin).
    """
    rows = decode_rows(tokens.shape[0], ctx)
    if rows:  # this rank's rows, which its cache holds
        tokens = ctx.block(tokens, ctx.dp)
        if active is not None:
            active = ctx.block(torch.as_tensor(active, device=tokens.device),
                               ctx.dp)
    pos = cache["pos"]
    b = tokens.shape[0]
    if pos.ndim == 0:  # one position for the whole batch
        pos = pos.expand(b)
    x = _embed(model.embed, tokens, cfg, ctx) if cfg.embed_inputs else tokens
    if cfg.rope == "mrope":
        positions = pos[:, None, None].expand(b, 1, 3)
    else:
        positions = pos[:, None]
    for i, unit in enumerate(model.units):
        view = _unit_view(cache["units"], i)
        for j, kind in enumerate(cfg.block_pattern):
            x = _decode_block(kind, unit[f"b{j}"], x, positions,
                              view[f"b{j}"], pos, cfg, ctx, attend)
    for j, kind in enumerate(cfg.tail):
        x = _decode_block(kind, model.tail[j], x, positions,
                          cache["tail"][j], pos, cfg, ctx, attend)
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = whole_logits(model, head_logits(model, x, cfg, ctx), cfg, ctx,
                          rows)
    advance = 1 if active is None else torch.as_tensor(
        active, device=pos.device).to(pos.dtype)
    cache["pos"] = pos + advance
    return logits, cache

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

It runs the paper's SUMMA engine at the commodity-cluster size of
``configs/paper_mm.py`` (N = 32768, block 256) on the 1x1 grid of one
card, through the entry point a user calls (``DistributedMatmul``), and
checks every hand-written kernel against its plain PyTorch version.
Phases, in order — any failure raises, so the script exits non-zero:

1. device: the card's name and power limit; TF32 off;
2. build: both CUDA kernels from the checkout's sources (nvcc, sm_90a);
3. kernel vs plain version on the card, at the reference test shapes and
   at the shapes the main path gives each kernel, fp32 and bf16;
4. main path, dense: 128 K panels through the ``tiled_matmul`` kernel,
   checked against ``torch.matmul``;
5. main path, block-sparse at block fill 0.3: the ``bsmm`` kernel on the
   plan's CSR map, checked against ``reference_blocksparse_matmul`` and
   against ``torch.matmul`` of operands masked here, independently of the
   port's own masking;
6. times of each kernel at the main path's shapes beside its plain
   version, ``torch.matmul`` and the card's bound.

The line before the last is a JSON object listing every kernel; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import DistributedMatmul, Grid  # noqa: E402
from repro_torch.configs.paper_mm import (  # noqa: E402
    COMMODITY_BLOCK,
    COMMODITY_N,
    make_case,
)
from repro_torch.core.sparsity import (  # noqa: E402
    block_csr_from_mask,
    random_block_mask,
)
from repro_torch.core.summa import reference_blocksparse_matmul  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bsmm import bsmm_cuda, bsmm_plain  # noqa: E402
from repro_torch.kernels.tiled_matmul import (  # noqa: E402
    tiled_matmul_cuda,
    tiled_matmul_plain,
)

N, BLOCK = COMMODITY_N, COMMODITY_BLOCK
K_PANELS = N // BLOCK  # 128 K panels of width 256
SPARSE_FILL = 0.3
SEED = 0
#: published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
DTYPES = (torch.float32, torch.bfloat16)
DEVICE = "cuda"


def log(*args) -> None:
    print(*args, flush=True)


def tol(dtype) -> float:
    """The reference's kernel tolerance (tests/test_kernels.py::_tol)."""
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


def compare(got, want, k: int, dtype, what: str) -> float:
    """Largest |got - want|; raises unless every element is finite and
    within ``atol = tol*sqrt(k)``, ``rtol = tol`` of ``want``."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    t = tol(dtype)
    err, bad = 0.0, 0
    for r in range(0, got.shape[0], 4096):  # row chunks bound the temporaries
        g, w = got[r:r + 4096].float(), want[r:r + 4096].float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite values")
        diff = (g - w).abs()
        err = max(err, diff.max().item())
        bad += (diff > t * math.sqrt(k) + t * w.abs()).sum().item()
    log(f"  {what}: max_abs_err={err:.6g} (atol={t * math.sqrt(k):.4g}, "
        f"rtol={t}) -> {'ok' if not bad else f'{bad} elements out of tolerance'}")
    if bad:
        raise AssertionError(f"{what}: {bad} elements out of tolerance")
    return err


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms on the card, and what sets it."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kron_mask(x: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """``x`` with its dead blocks zeroed through an element mask made by
    repeating each entry of the block mask over its block (``np.kron`` of
    the mask with a block of ones, built on the card): a mapping of blocks
    to elements that shares no code with the port's."""
    rb, cb = x.shape[0] // mask.shape[0], x.shape[1] // mask.shape[1]
    keep = torch.as_tensor(np.asarray(mask, bool), device=x.device)
    keep = keep.repeat_interleave(rb, 0).repeat_interleave(cb, 1)
    return x * keep


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


# ---------------------------------------------------------------------------


def phase_device() -> tuple[str, int]:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); the port's kernels run only on a card")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] {kind} x{count}; torch {torch.__version__} "
        f"(CUDA {torch.version.cuda})")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return kind, count


def phase_build() -> None:
    t0 = time.perf_counter()
    path, out, compile_s = _build.build()
    _build.load()
    log(f"[2 build] {path}: nvcc {compile_s:.2f} s, load "
        f"{time.perf_counter() - t0:.2f} s")
    for line in out.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("  " + line.strip())


def phase_kernels(sparse_plan) -> dict:
    """Each kernel against its plain version; returns the main-shape fp32
    errors by kernel name."""
    log("[3 kernels vs plain versions]")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    errs = {}
    for dtype in DTYPES:
        for m, k, n in ((64, 64, 64), (128, 256, 64), (96, 160, 224),
                        (100, 60, 36)):
            a, b = randn((m, k), dtype, gen), randn((k, n), dtype, gen)
            got = tiled_matmul_cuda(a, b)
            torch.cuda.synchronize()
            compare(got, tiled_matmul_plain(a, b), k, dtype,
                    f"tiled_matmul {dtype} ({m},{k})x({k},{n})")
        # the main path's panel: a (N, 256) column slice of an (N, N) shard
        a_full = randn((N, N), dtype, gen)
        a, b = a_full[:, BLOCK:2 * BLOCK], randn((BLOCK, N), dtype, gen)
        got = tiled_matmul_cuda(a, b)
        torch.cuda.synchronize()
        err = compare(got, tiled_matmul_plain(a, b), BLOCK, dtype,
                      f"tiled_matmul {dtype} main panel ({N},{BLOCK}; "
                      f"lda={a.stride(0)})x({BLOCK},{N})")
        if dtype == torch.float32:
            errs["tiled_matmul"] = err
        del a_full, a, b, got

        for fill in (0.1, 0.4, 1.0):
            for mb, kb in ((4, 8), (2, 2), (8, 4)):
                m, k, n = mb * 32, kb * 32, 96
                a, b = randn((m, k), dtype, gen), randn((k, n), dtype, gen)
                mask = random_block_mask(mb, kb, fill, seed=int(fill * 10) + mb)
                cols = _cols(mask)
                got = bsmm_cuda(a, b, cols, bm=32, bk=32, bn=32)
                torch.cuda.synchronize()
                compare(got, bsmm_plain(a, b, cols, bm=32, bk=32, bn=32), k,
                        dtype, f"bsmm {dtype} fill={fill} blocks=({mb},{kb})")
        mask = np.zeros((4, 4), dtype=bool)
        mask[0, 0] = True  # only one live block: rows 32.. must be zero
        a, b = randn((128, 128), dtype, gen), randn((128, 64), dtype, gen)
        got = bsmm_cuda(a, b, _cols(mask), bm=32, bk=32, bn=32)
        torch.cuda.synchronize()
        if not (torch.all(got[32:] == 0) and torch.any(got[:32] != 0)):
            raise AssertionError("bsmm: empty block rows must give zero")
        compare(got, bsmm_plain(a, b, _cols(mask), bm=32, bk=32, bn=32), 128,
                dtype, f"bsmm {dtype} empty rows")
        # the main path's call: gathered live panels and the plan's CSR map
        a_g, b_g, cols, (bm, bk, bn) = _bsmm_operands(sparse_plan, dtype, gen)
        got = bsmm_cuda(a_g, b_g, cols, bm=bm, bk=bk, bn=bn)
        torch.cuda.synchronize()
        err = compare(got, bsmm_plain(a_g, b_g, cols, bm=bm, bk=bk, bn=bn),
                      a_g.shape[1], dtype,
                      f"bsmm {dtype} main ({N},{a_g.shape[1]}) blocks "
                      f"({bm},{bk}) S={cols.shape[1]}")
        if dtype == torch.float32:
            errs["bsmm"] = err
        del a_g, b_g, got
        torch.cuda.empty_cache()
    return errs


def _cols(mask: np.ndarray) -> torch.Tensor:
    csr = block_csr_from_mask(mask)
    return torch.as_tensor(csr.padded_cols(max(csr.max_row_nnz, 1)),
                           dtype=torch.int32, device=DEVICE)


def _bsmm_operands(plan, dtype, gen):
    """Random operands of the shapes ``_exec_sparse_bsmm`` hands the kernel
    for ``plan`` on the 1x1 grid."""
    width = len(plan.live_panels) * plan.kb_width
    a_g = randn((plan.m_pad, width), dtype, gen)
    b_g = randn((width, plan.n_pad), dtype, gen)
    cols = torch.as_tensor(plan.local_cols[0, 0], device=DEVICE)
    return a_g, b_g, cols, plan.local_block


def run_path(mm, a, b, kernel_of_path, **masks):
    """One product through ``mm`` with every launch count set to 0 just
    before and read just after; returns (C, wall seconds, counts)."""
    counters = {"tiled_matmul": tiled_matmul_cuda, "bsmm": bsmm_cuda}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = mm(a, b, **masks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches {counts}; wall {wall:.3f} s")
    if counts[kernel_of_path] == 0:
        raise AssertionError(f"the path never launched {kernel_of_path}")
    return c, wall, counts


def phase_dense(mm, a, b) -> tuple[int, float]:
    plan = mm.plan(N, N, N)
    log(f"[4 main path, dense] DistributedMatmul(taskbased, k_blocks="
        f"{K_PANELS}, local_matmul=pallas): k_steps={plan.k_steps}, "
        f"kb_width={plan.kb_width}, lookahead={plan.resolve_lookahead()}")
    c, wall, counts = run_path(mm, a, b, "tiled_matmul")
    if counts["tiled_matmul"] != plan.k_steps or plan.k_steps != K_PANELS:
        raise AssertionError(
            f"expected {K_PANELS} tiled_matmul launches, got {counts}"
        )
    if c.shape != (N, N) or c.dtype != torch.float32:
        raise AssertionError(f"dense C is {tuple(c.shape)} {c.dtype}")
    compare(c, torch.matmul(a, b), N, torch.float32,
            "dense C vs torch.matmul")
    return counts["tiled_matmul"], wall


def phase_sparse(mm, a, b, a_mask, b_mask) -> tuple[int, float]:
    plan = mm.plan(N, N, N, a_mask=a_mask, b_mask=b_mask)
    log(f"[5 main path, block-sparse fill {SPARSE_FILL}] local_impl="
        f"{plan.local_impl}, local_block={plan.local_block}, live panels "
        f"{len(plan.live_panels)}/{plan.k_steps}, fill_in="
        f"{plan.cost.fill_in:.4f}, S={plan.local_cols.shape[-1]}")
    if plan.local_impl != "bsmm":
        raise AssertionError(f"local_impl={plan.local_impl!r}, not 'bsmm'")
    c, wall, counts = run_path(mm, a, b, "bsmm", a_mask=a_mask, b_mask=b_mask)
    if counts["tiled_matmul"]:
        raise AssertionError("the bsmm route launched tiled_matmul")
    want = reference_blocksparse_matmul(a, b, a_mask, b_mask)
    compare(c, want, N, torch.float32,
            "block-sparse C vs reference_blocksparse_matmul")
    del want
    want = torch.matmul(kron_mask(a, a_mask), kron_mask(b, b_mask))
    compare(c, want, N, torch.float32,
            "block-sparse C vs torch.matmul of independently masked operands")
    return counts["bsmm"], wall


def phase_times(a, b, sparse_plan) -> dict:
    """Each kernel at the main path's shapes, on the main path's data."""
    log("[6 times] CUDA events, mean over repeated launches after a warm-up")
    out = {}
    a_panel, b_panel = a[:, :BLOCK], b[:BLOCK, :]
    flops = 2.0 * N * BLOCK * N
    nbytes = 4.0 * (N * BLOCK + BLOCK * N + N * N)
    ms = cuda_ms(lambda: tiled_matmul_cuda(a_panel, b_panel), 5)
    plain_ms = cuda_ms(lambda: tiled_matmul_plain(a_panel, b_panel), 5)
    lib_ms = cuda_ms(lambda: torch.matmul(a_panel, b_panel), 5)
    bound_ms, by = bound(flops, nbytes)
    out["tiled_matmul"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=by, flops=flops)
    log(f"  tiled_matmul ({N},{BLOCK})x({BLOCK},{N}) fp32: kernel {ms:.3f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.3f} ms, "
        f"torch.matmul {lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({by})")

    # the main path's bsmm call: the masked operands' live panels, gathered
    plan = sparse_plan
    w = plan.kb_width
    idx = torch.cat([torch.arange(kk * w, (kk + 1) * w, device=DEVICE)
                     for kk in plan.live_panels])
    a_g = kron_mask(a, plan.a_mask)[:, idx].contiguous()
    b_g = kron_mask(b, plan.b_mask)[idx].contiguous()
    cols = torch.as_tensor(plan.local_cols[0, 0], device=DEVICE)
    bm, bk, bn = plan.local_block
    live_blocks = int((plan.local_cols[0, 0] >= 0).sum())
    flops = 2.0 * live_blocks * bm * bk * N
    nbytes = 4.0 * (live_blocks * bm * bk + b_g.numel() + N * N) + cols.numel() * 4
    ms = cuda_ms(lambda: bsmm_cuda(a_g, b_g, cols, bm=bm, bk=bk, bn=bn), 3)
    plain_ms = cuda_ms(
        lambda: bsmm_plain(a_g, b_g, cols, bm=bm, bk=bk, bn=bn), 3
    )
    lib_ms = cuda_ms(lambda: torch.matmul(a_g, b_g), 3)
    bound_ms, by = bound(flops, nbytes)
    out["bsmm"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=by, flops=flops)
    log(f"  bsmm ({N},{a_g.shape[1]}) live blocks {live_blocks} "
        f"({live_blocks / cols.shape[0] / (a_g.shape[1] // bk):.4f} of A's): "
        f"kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
        f"{plain_ms:.3f} ms, torch.matmul (dense, masked operands) "
        f"{lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({by})")
    return out


def main() -> None:
    kind, count = phase_device()
    phase_build()
    t0 = time.perf_counter()
    # make_case's operands do not depend on the fill: one call gives the
    # dense instance (fill 1.0 masks are all-live and unused) and the masks
    # of the block-sparse one
    a_h, b_h, a_mask, b_mask = make_case(N, BLOCK, SPARSE_FILL, seed=SEED)
    log(f"[data] make_case({N}, {BLOCK}, fill={SPARSE_FILL}, seed={SEED}) "
        f"on the host: {time.perf_counter() - t0:.1f} s")
    mm = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                           k_blocks=K_PANELS, local_matmul="pallas")
    sparse_plan = mm.plan(N, N, N, a_mask=a_mask, b_mask=b_mask)
    errs = phase_kernels(sparse_plan)
    torch.cuda.reset_peak_memory_stats()
    a = torch.from_numpy(a_h).to(DEVICE)
    b = torch.from_numpy(b_h).to(DEVICE)
    del a_h, b_h
    dense_launches, dense_wall = phase_dense(mm, a, b)
    torch.cuda.empty_cache()
    sparse_launches, sparse_wall = phase_sparse(mm, a, b, a_mask, b_mask)
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    times = phase_times(a, b, sparse_plan)
    log(f"  whole products (host clock, ending in synchronize): dense "
        f"{dense_wall:.3f} s, block-sparse {sparse_wall:.3f} s; peak device "
        f"memory over the two products {peak / 2**30:.2f} GiB")
    launches = {"tiled_matmul": dense_launches, "bsmm": sparse_launches}
    sources = {"tiled_matmul": ("src/repro_torch/csrc/tiled_matmul.cu",
                                "src/repro/kernels/tiled_matmul.py:32"),
               "bsmm": ("src/repro_torch/csrc/bsmm.cu",
                        "src/repro/kernels/bsmm.py:30")}
    kernels = []
    for name, (source, replaces) in sources.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count,
    }}), flush=True)


if __name__ == "__main__":
    main()

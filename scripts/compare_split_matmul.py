#!/usr/bin/env python3
"""The dense and block-sparse split-bf16 kernels against variants of their
own design, on one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/compare_split_matmul.py [VARIANT ...]

A variant is named ``tiled.<name>`` or ``bsmm.<name>``: the kernel's
source (``csrc/tiled_matmul.cu`` or ``csrc/bsmm.cu``, with
``csrc/block_rows.cuh`` and ``csrc/split_gemm.cuh``) with a few lines
replaced (``VARIANTS`` below; ``source`` is the files unchanged).  With no
argument all of them run.  The script compiles each variant into a
library of its own under ``build/split_variants/``, one ``nvcc`` process a
variant, all of a kernel's started together, and prints the kernel's
registers and spills.  It checks each variant against an fp64 product on
a few shapes (and ``source`` also at the main path's), printing the worst
element's share of the reference's hold (``chip_smoke.py``'s: rtol = tol,
atol = tol·√K, tol 1e-4 in fp32 and 2e-2 in bf16; over 1 fails), and
times the variants of each kernel in turns (forward, then backward order,
three rounds; the least time is kept) at the main path's launch, fp32:

- ``tiled``: one SUMMA panel product, A a (32768 x 256) column slice of
  a 32768² shard (row stride 32768) times B (256 x 32768);
- ``bsmm``: the block-sparse product with A and B at block fill 0.3 as
  the planner hands it over: A's 128 live K-panels gathered (32768 x
  32768), B's dead blocks zeroed (as the executor masks them), once
  with the plan's column map of A alone (4916 live 256 x 256 blocks,
  S = 52) and once with the map the executor walks, a list a block row
  and 256-column tile (``core.summa._bsmm_walk``: A's blocks whose block
  of B is live, 188,897 of them; ``tiles`` after the variant's name);

beside ``torch.matmul`` over the same operands (for ``bsmm`` the dense
product of the gathered operands) and, where ``source`` runs, beside the
repository's build through its wrapper (``wrapper``).  It exits non-zero
if a ``source`` fails a hold; a variant that fails one is reported, not
raised (the ``ablate_*`` variants are wrong on purpose: they show where
the time goes).
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kernel_variants import build, card, in_turns, ms  # noqa: E402
from repro_torch import DistributedMatmul, Grid  # noqa: E402
from repro_torch.configs.paper_mm import (  # noqa: E402
    COMMODITY_BLOCK,
    COMMODITY_N,
)
from repro_torch.core.sparsity import (  # noqa: E402
    block_csr_from_mask,
    random_block_mask,
)
from repro_torch.core import summa  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bsmm import bsmm_cuda  # noqa: E402
from repro_torch.kernels.tiled_matmul import tiled_matmul_cuda  # noqa: E402

OUT = ROOT / "build" / "split_variants"
N, BLOCK = COMMODITY_N, COMMODITY_BLOCK
BR, SG = "block_rows.cuh", "split_gemm.cuh"
MAIN = {"tiled": "tiled_matmul.cu", "bsmm": "bsmm.cu"}
KERNEL = {"tiled": "tiled_matmul_kernel", "bsmm": "bsmm_kernel"}
SYMBOL = {"tiled": "tiled_matmul_launch", "bsmm": "bsmm_launch"}


def _col_group(kernel: str, now: int, to: int):
    return [(MAIN[kernel], f"constexpr int kColGroup = {now};",
             f"constexpr int kColGroup = {to};")]


#: variants shared by both kernels (edits of the engine and the body)
COMMON = {
    "source": [],
    # one staging slot: a slab's copies fly only while the one before it
    # is split
    "staging1": [(SG, "constexpr int kStaging = 2;",
                  "constexpr int kStaging = 1;")],
    # three slabs in flight
    "staging3": [(SG, "constexpr int kStaging = 2;",
                  "constexpr int kStaging = 3;")],
    # a ring of three stages of split slabs, not four
    "stages3": [(SG, "constexpr int kStages = 4;",
                 "constexpr int kStages = 3;")],
    # every 64-row unit in an item of its own (the second consumer idles)
    "unpaired": [
        (BR, "p.pairs_per_row = (bm + 2 * sg::kRows - 1) / (2 * sg::kRows);",
         "p.pairs_per_row = (bm + sg::kRows - 1) / sg::kRows;"),
        (BR, "const int64_t first = 2 * sg::kRows * (pair % p.pairs_per_row);",
         "const int64_t first = sg::kRows * (pair % p.pairs_per_row);"),
        (BR, "const int64_t left_b = left_a - sg::kRows;",
         "const int64_t left_b = 0;"),
    ],
    # ablations, wrong by design (they fail the holds): where the time goes
    # no products at all
    "ablate_no_products": [
        (SG, "      hopper::wgmma_rs_mn<kCols>(acc, hi[s], d_hi);\n", ""),
        (SG, "        hopper::wgmma_rs_mn<kCols>(acc, hi[s], d_lo);\n"
             "        hopper::wgmma_rs_mn<kCols>(acc, lo[s], d_hi);\n", ""),
    ],
    # no stores of C
    "ablate_no_store": [
        (SG, "    if (!(h ? at.live1 : at.live0)) continue;",
         "    if (ldc >= 0 || !(h ? at.live1 : at.live0)) continue;"),
    ],
    # the whole of a row's sum in the wgmma accumulator, and parts of
    # 16, 32 and 128 slabs (K = 512, 1024, 4096) added into an fp32 C
    **{f"sum_{n}": [(BR, "constexpr int kSumSlabs = 64;",
                     f"constexpr int kSumSlabs = {n};")]
       for n in (16, 32, 128)},
    "one_sum": [(BR, "constexpr int kSumSlabs = 64;",
                 "constexpr int kSumSlabs = 1 << 30;")],
    # a part's sum added into C with 1, 4 or 16 column pairs' reads in
    # flight at once, not 8
    **{f"add_batch_{n}": [(SG, "constexpr int kAddBatch = 8;",
                           f"constexpr int kAddBatch = {n};")]
       for n in (1, 4, 16)},
}
VARIANTS = {
    "tiled": {**COMMON, **{f"colgroup_{g}": _col_group("tiled", 16, g)
                           for g in (4, 12, 32, 128)}},
    "bsmm": {**COMMON, **{f"colgroup_{g}": _col_group("bsmm", 2, g)
                          for g in (1, 3, 4, 6, 16)}},
}
#: small checks: tiled (m, k, n, lda); bsmm (block rows, block columns,
#: bm, bk, n, fill)
CHECKS = {
    "tiled": ((200, 256, 300, 256), (130, 100, 520, 101), (70, 33, 260, 33),
              (1, 256, 700, 256), (256, 13312, 512, 13312),
              (192, 32768, 300, 32768)),
    "bsmm": ((4, 6, 96, 8, 300, 0.5), (3, 5, 256, 256, 512, 0.6),
             (2, 52, 256, 256, 512, 1.0), (4, 6, 32, 32, 260, 0.5)),
}


def _label(kernel: str):
    def label(entry: str) -> str:
        types = re.search(rf"{KERNEL[kernel]}I(\w+?)EEv", entry)
        return types.group(1) if types else entry
    return label


def _cols(mask: np.ndarray) -> torch.Tensor:
    csr = block_csr_from_mask(mask)
    return torch.as_tensor(csr.padded_cols(max(csr.max_row_nnz, 1)),
                           dtype=torch.int32, device="cuda")


def run_tiled(lib, a, b) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device="cuda")
    err = lib.tiled_matmul_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.stride(0),
        b.stride(0), _build.dtype_code(a.dtype),
        _build.dtype_code(torch.float32), _build.stream_handle(a.device))
    if err:
        raise RuntimeError(f"tiled_matmul_launch: CUDA error {err}")
    return c


def run_bsmm(lib, a, b, cols, bm, bk) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device="cuda")
    err = lib.bsmm_launch(
        a.data_ptr(), b.data_ptr(), cols.data_ptr(), c.data_ptr(), m, n,
        a.stride(0), b.stride(0), cols.shape[-1], k // bk, bm, bk,
        int(cols.dim() == 3), _build.dtype_code(a.dtype),
        _build.dtype_code(torch.float32),
        _build.stream_handle(a.device))
    if err:
        raise RuntimeError(f"bsmm_launch: CUDA error {err}")
    return c


def _masked(a, mask, bm, bk):
    keep = torch.as_tensor(mask, device="cuda")
    return a * keep.repeat_interleave(bm, 0).repeat_interleave(bk, 1)


def worst_share(got, want, k, tol) -> float:
    """The worst element's |got - want| over the hold tol·√k + tol·|want|,
    by row chunks (want is fp64)."""
    worst = 0.0
    for r in range(0, got.shape[0], 2048):
        g, w = got[r:r + 2048].double(), want[r:r + 2048]
        worst = max(worst, ((g - w).abs()
                            / (tol * k ** 0.5 + tol * w.abs())).max().item())
    return worst


def check(kernel, libs, gen) -> list:
    """Every variant at the small shapes; returns the holds ``source``
    failed."""
    failed = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for shape in CHECKS[kernel]:
            line = f"  {kernel} {dtype} {shape}:"
            if kernel == "tiled":
                m, k, n, lda = shape
                a = torch.randn((m, lda), generator=gen, device="cuda")
                a = a.to(dtype)[:, lda - k:]
                b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
                want = a.double() @ b.double()
                call = lambda lib: run_tiled(lib, a, b)  # noqa: E731
            else:
                mb, kb, bm, bk, n, fill = shape
                mask = random_block_mask(mb, kb, fill, seed=bm + kb)
                a = torch.randn((mb * bm, kb * bk), generator=gen,
                                device="cuda").to(dtype)
                b = torch.randn((kb * bk, n), generator=gen,
                                device="cuda").to(dtype)
                cols = _cols(mask)
                want = _masked(a, mask, bm, bk).double() @ b.double()
                k = kb * bk
                call = lambda lib: run_bsmm(lib, a, b, cols, bm, bk)  # noqa: E731
            for name, lib in libs.items():
                ratio = worst_share(call(lib), want, k, tol)
                line += f" {name} {ratio:.4f}"
                if name == "source" and not ratio <= 1.0:
                    failed.append((kernel, dtype, shape))
            print(line, flush=True)
    return failed


def main_sparse_case():
    """The planner's call at block fill 0.3 on the 1x1 grid: the live
    panels' width and the column map (as ``chip_smoke.py`` phase 5)."""
    nb = N // BLOCK
    a_mask = random_block_mask(nb, nb, 0.3, seed=1)  # make_case(seed=0)'s
    b_mask = random_block_mask(nb, nb, 0.3, seed=2)
    mm = DistributedMatmul(Grid.local("cuda"), strategy="taskbased",
                           k_blocks=nb, local_matmul="pallas")
    plan = mm.plan(N, N, N, a_mask=a_mask, b_mask=b_mask)
    return plan


def time_tiled(libs, gen, failed) -> None:
    shard = torch.randn((N, N), generator=gen, device="cuda")
    a = shard[:, BLOCK:2 * BLOCK]  # a panel of the shard, row stride N
    b = torch.randn((BLOCK, N), generator=gen, device="cuda")
    if "source" in libs:
        want = a.double() @ b.double()
        ratio = worst_share(run_tiled(libs["source"], a, b), want, BLOCK,
                            1e-4)
        print(f"  tiled source at the main panel: worst element {ratio:.4f} "
              f"of the fp32 hold", flush=True)
        if not ratio <= 1.0:
            failed.append(("tiled", "main"))
        del want
    fns = {name: (lambda lib=lib: run_tiled(lib, a, b))
           for name, lib in libs.items()}
    if "source" in libs:
        fns["wrapper"] = lambda: tiled_matmul_cuda(a, b)
    times = in_turns(fns, 5)
    lib_ms = ms(lambda: torch.matmul(a, b), 5)
    flop = 2.0 * N * BLOCK * N
    print(f"tiled ms a launch (least of 6 in turns), fp32 ({N},{BLOCK}; "
          f"lda={a.stride(0)})x({BLOCK},{N}): " + ", ".join(
              f"{name} {v:.4f} ms ({flop / v / 1e9:.1f} TFLOP/s)"
              for name, v in times.items())
          + f", torch.matmul {lib_ms:.4f} ms", flush=True)


def time_bsmm(libs, gen, failed) -> None:
    plan = main_sparse_case()
    bm, bk, _ = plan.local_block
    width = len(plan.live_panels) * plan.kb_width
    cols_np = plan.local_cols[0, 0]
    cols = torch.as_tensor(cols_np, device="cuda")
    tiles_np, (_, useful) = summa._bsmm_walk(plan, 0, 0, plan.n_pad)
    tiles = torch.as_tensor(tiles_np, device="cuda")
    a = torch.randn((plan.m_pad, width), generator=gen, device="cuda")
    b = torch.randn((width, plan.n_pad), generator=gen, device="cuda")
    b_keep = torch.as_tensor(plan.b_mask[list(plan.live_panels)],
                             device="cuda")
    b *= b_keep.repeat_interleave(bk, 0).repeat_interleave(
        plan.n_pad // plan.b_mask.shape[1], 1)
    del b_keep
    live = int((cols_np >= 0).sum())
    print(f"bsmm main: A ({plan.m_pad},{width}), blocks ({bm},{bk}), "
          f"S={cols_np.shape[1]}, {live} live blocks; tile map "
          f"{tuple(tiles_np.shape)}, {useful} useful block products",
          flush=True)
    maps = {"": cols, "tiles": tiles}
    if "source" in libs:
        mask = np.zeros((plan.m_pad // bm, width // bk), bool)
        rows = np.repeat(np.arange(mask.shape[0]), cols_np.shape[1])
        flat = cols_np.reshape(-1)
        mask[rows[flat >= 0], flat[flat >= 0]] = True
        want = _masked(a, mask, bm, bk).double() @ b.double()
        for label, m in maps.items():
            ratio = worst_share(run_bsmm(libs["source"], a, b, m, bm, bk),
                                want, width, 1e-4)
            print(f"  bsmm source {label or 'A map'} at the main call: worst "
                  f"element {ratio:.4f} of the fp32 hold", flush=True)
            if not ratio <= 1.0:
                failed.append(("bsmm", "main", label))
        del want
        torch.cuda.empty_cache()
    fns = {}
    for name, lib in libs.items():
        for label, m in maps.items():
            fns[f"{name} {label}".strip()] = (
                lambda lib=lib, m=m: run_bsmm(lib, a, b, m, bm, bk))
    if "source" in libs:
        for label, m in maps.items():
            fns[f"wrapper {label}".strip()] = (
                lambda m=m: bsmm_cuda(a, b, m, bm=bm, bk=bk, bn=bk))
    times = in_turns(fns, 2)
    lib_ms = ms(lambda: torch.matmul(a, b), 1)
    flop = {"": 2.0 * live * bm * bk * plan.n_pad,
            "tiles": 2.0 * useful * bm * bk * 256}
    print("bsmm ms a launch (least of 6 in turns), fp32; TFLOP/s of the "
          "products each map lists: " + ", ".join(
              f"{name} {v:.4f} ms "
              f"({flop['tiles' if name.endswith('tiles') else ''] / v / 1e9:.1f}"
              " TFLOP/s)"
              for name, v in times.items())
          + f", torch.matmul (dense, gathered operands) {lib_ms:.4f} ms",
          flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("compare_split_matmul: no CUDA device")
    known = [f"{k}.{v}" for k in VARIANTS for v in VARIANTS[k]]
    names = sys.argv[1:] or known
    unknown = sorted(set(names) - set(known))
    if unknown:
        sys.exit(f"compare_split_matmul: unknown variants {unknown}; "
                 f"known: {known}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    failed = []
    for kernel in VARIANTS:
        chosen = [n.split(".", 1)[1] for n in names
                  if n.split(".", 1)[0] == kernel]
        if not chosen:
            continue
        print(f"build ({KERNEL[kernel]}, ptxas):", flush=True)
        libs = build({v: VARIANTS[kernel][v] for v in chosen},
                     main=MAIN[kernel], kernel=KERNEL[kernel],
                     symbol=SYMBOL[kernel], out=OUT / kernel,
                     label=_label(kernel))
        print("worst element / the reference's hold:", flush=True)
        failed += check(kernel, libs, gen)
        (time_tiled if kernel == "tiled" else time_bsmm)(libs, gen, failed)
        torch.cuda.empty_cache()
    if failed:
        sys.exit(f"compare_split_matmul: a source fails the hold at {failed}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The grouped-GEMM kernel against variants of its own design, on one
CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/compare_grouped_gemm.py [VARIANT ...]

Each variant is ``csrc/grouped_gemm.cu`` and ``csrc/split_gemm.cuh``
with a few lines replaced (``VARIANTS`` below; ``source`` is the files
unchanged), or the source with another work list (``unpaired``: every
64-row unit alone, as if no two shared a block).  With no argument all of
them run.  The script compiles each variant into a library of its own
under ``build/gg_variants/``, all ``nvcc`` processes started together,
and prints the kernel's registers and spills.  It checks each variant
against an fp64 product on a few shapes, printing the worst element's
share of the reference's hold (``chip_smoke.py``'s: rtol = tol, atol =
tol·√D, tol 1e-4 in fp32 and 2e-2 in bf16; over 1 fails), and times every
variant in turns (forward, then backward order, three rounds; the least
time is kept) at the rank-sparse main path's launch (T = 65536, D = 256,
F = 32768, 128 experts read in place from one row-major B, 8 tiles of 64
rows each), beside ``torch.bmm`` over the same work grouped by expert
and, where ``source`` runs, beside ``grouped_gemm_cuda`` (``wrapper``:
the repository's build of the source through its wrapper, which builds
the work list on the host at every launch, where the variants take a
list built once).  It exits non-zero if ``source`` fails a hold; a variant that fails one is
reported, not raised.
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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.grouped_gemm import (  # noqa: E402
    grouped_gemm_cuda,
    tile_pairs,
)

OUT = ROOT / "build" / "gg_variants"
KERNEL = "grouped_gemm_kernel"
GG, SG = "grouped_gemm.cu", "split_gemm.cuh"
VARIANTS = {
    "source": [],
    # the same kernel with one block per work item, not one persistent
    # block a multiprocessor
    "block_per_item": [
        (GG, "const int64_t blocks = items < sms ? items : sms;",
         "const int64_t blocks = items;"),
    ],
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
    # the consumers' loads of A issued after their products, not under them
    "a_after_wait": [
        (SG, "    if (n + 1 < n_slabs) load_slab(n + 1);\n"
             "    hopper::wgmma_wait<0>();\n",
         "    hopper::wgmma_wait<0>();\n"
         "    if (n + 1 < n_slabs) load_slab(n + 1);\n"),
    ],
    # ablations, wrong by design (they fail the holds): where the time goes
    # one product, hi.hi, for fp32 operands
    "ablate_one_product": [
        (SG, "        hopper::wgmma_rs_mn<kCols>(acc, hi[s], d_lo);\n"
             "        hopper::wgmma_rs_mn<kCols>(acc, lo[s], d_hi);\n", ""),
    ],
    # no products at all
    "ablate_no_products": [
        (SG, "      hopper::wgmma_rs_mn<kCols>(acc, hi[s], d_hi);\n", ""),
        (SG, "        hopper::wgmma_rs_mn<kCols>(acc, hi[s], d_lo);\n"
             "        hopper::wgmma_rs_mn<kCols>(acc, lo[s], d_hi);\n", ""),
    ],
    # no stores of y
    "ablate_no_store": [
        (GG, "        sg::store(y +", "        if (p.f < 0) sg::store(y +"),
    ],
    # work items in plain order: each column tile over all pairs
    "colgroup_1": [
        (GG, "constexpr int kColGroup = 16;", "constexpr int kColGroup = 1;"),
    ],
    # each pair over all 128 column tiles before the next pair
    "colgroup_128": [
        (GG, "constexpr int kColGroup = 16;",
         "constexpr int kColGroup = 128;"),
    ],
    # the source with every unit in a block of its own (run-time work list)
    "unpaired": None,
}
CHECKS = (  # t, d, f, e, bt
    (128, 256, 256, 1, 64),
    (1024, 256, 1000, 4, 64),
    (640, 256, 512, 3, 128),
    (96, 256, 300, 3, 8),
    (72, 48, 100, 5, 24),
)
MAIN = (65536, 256, 32768, 128, 64)


def _label(entry: str) -> str:
    types = re.search(rf"{KERNEL}I(\w+?)EEv", entry)
    return types.group(1) if types else entry


def work_lists(te: np.ndarray, bt: int) -> dict[str, torch.Tensor]:
    """The wrapper's work list, and every unit alone."""
    paired = tile_pairs(te, bt)
    units = np.sort(paired[paired >= 0])
    alone = np.stack([units, np.full_like(units, -1)], axis=1)
    # keep the units ordered by expert, as tile_pairs orders its pairs
    alone = alone[np.argsort(te[alone[:, 0] // bt], kind="stable")]
    return {"paired": torch.as_tensor(paired, device="cuda"),
            "alone": torch.as_tensor(alone.astype(np.int32), device="cuda")}


def run(lib, x, w, te, pairs, bt) -> torch.Tensor:
    t, d = x.shape
    e, _, f = w.shape
    y = torch.empty((t, f), dtype=torch.float32, device="cuda")
    err = lib.grouped_gemm_launch(
        x.data_ptr(), w.data_ptr(), te.data_ptr(), pairs.data_ptr(),
        y.data_ptr(), t, f, d, x.stride(0), w.stride(0), w.stride(1), bt, e,
        pairs.shape[0], _build.dtype_code(x.dtype),
        _build.dtype_code(torch.float32), _build.stream_handle(x.device))
    if err:
        raise RuntimeError(f"grouped_gemm_launch: CUDA error {err}")
    return y


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("compare_grouped_gemm: no CUDA device")
    names = sys.argv[1:] or list(VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        sys.exit(f"compare_grouped_gemm: unknown variants {unknown}; "
                 f"known: {list(VARIANTS)}")
    if "unpaired" in names and "source" not in names:
        names.append("source")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    print(f"build ({KERNEL}, ptxas):", flush=True)
    libs = build({name: VARIANTS[name] for name in names
                  if VARIANTS[name] is not None},
                 main=GG, kernel=KERNEL, symbol="grouped_gemm_launch",
                 out=OUT, label=_label)
    runs = {name: (libs["source" if VARIANTS[name] is None else name],
                   "alone" if name == "unpaired" else "paired")
            for name in names}

    gen = torch.Generator(device="cuda").manual_seed(5)
    print("worst element / the reference's hold:", flush=True)
    failed = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for t, d, f, e, bt in CHECKS:
            x = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
            w = torch.randn((e, d, f), generator=gen, device="cuda").to(dtype)
            te_np = np.random.default_rng(t + f).integers(
                0, e, size=t // bt).astype(np.int32)
            te = torch.as_tensor(te_np, device="cuda")
            lists = work_lists(te_np, bt)
            want = torch.einsum(
                "tbd,tdf->tbf", x.double().view(t // bt, bt, d),
                w.double()[te.long()]).reshape(t, f)
            limit = tol * d ** 0.5 + tol * want.abs()
            line = f"  {dtype} T={t} D={d} F={f} E={e} bt={bt}:"
            for name, (lib, which) in runs.items():
                got = run(lib, x, w, te, lists[which], bt).double()
                ratio = ((got - want).abs() / limit).max().item()
                line += f" {name} {ratio:.4f}"
                if name == "source" and not ratio <= 1.0:
                    failed.append((dtype, t, d, f, e, bt))
            print(line, flush=True)

    t, d, f, e, bt = MAIN
    x = torch.randn((t, d), generator=gen, device="cuda")
    b = torch.randn((e * d, f), generator=gen, device="cuda")
    w = b.view(e, d, f)  # the K-panels of one row-major B, in place
    te_np = np.tile(np.arange(e, dtype=np.int32), t // bt // e)
    te = torch.as_tensor(te_np, device="cuda")
    lists = work_lists(te_np, bt)
    fns = {name: (lambda lib=lib, which=which:
                  run(lib, x, w, te, lists[which], bt))
           for name, (lib, which) in runs.items()}
    if "source" in runs:
        fns["wrapper"] = lambda: grouped_gemm_cuda(x, w, te_np, bt=bt)
    times = in_turns(fns, 5)
    rows = t // bt // e
    x_by_expert = x.view(rows, e, bt, d).transpose(0, 1).reshape(e, -1, d)
    bmm = ms(lambda: torch.bmm(x_by_expert, w), 5)
    flop = 2.0 * t * d * f
    print(f"ms a launch (least of 6 in turns), fp32, T={t} D={d} F={f} "
          f"experts {e} bt={bt}: " + ", ".join(
              f"{name} {v:.4f} ms ({flop / v / 1e9:.1f} TFLOP/s)"
              for name, v in times.items())
          + f", torch.bmm {bmm:.4f} ms", flush=True)
    if failed:
        sys.exit(f"compare_grouped_gemm: the source fails the hold at "
                 f"{failed}")


if __name__ == "__main__":
    main()

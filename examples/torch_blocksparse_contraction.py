r"""Block-sparse tensor computing, the paper's target workload, on the
PyTorch port.

    PYTHONPATH=src python examples/torch_blocksparse_contraction.py
    PYTHONPATH=src python examples/torch_blocksparse_contraction.py \
        --device cpu [--ranks 8]

1. Block-sparse C = A.B with distance-decay structure: dead panels are
   skipped (communication AND compute scale with fill), as
   ``analysis.cost`` counts them.
2. Nonuniformly blocked matrices (physics-driven blocking) through the
   bucketed uniform-tile engine.
3. A block-sparse *tensor* contraction T[abd] = sum_c X[abc] Y[cd]
   through the einsum front-end (``core.contract``).
4. A chained contraction D = (A.B).C scheduled *jointly*: the tuner
   picks per-step windows over the union task graph, and the inferred
   intermediate mask propagates through the chain.

By default on the 1x1 grid of one card (the block-sparse products on the
hand-written ``bsmm`` kernel, the dense ones on ``tiled_matmul``; on the
CPU their plain versions), where
no panel travels, so the count shows the FLOP that dead panels save;
``--ranks 8`` runs a 2x4 grid of eight gloo processes on the CPU, where
the JAX version (``examples/blocksparse_contraction.py``) emulates a 2x4
mesh, and the collective bytes shrink too.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis.cost import analyze_step  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BlockSparseTensor,
    DistributedMatmul,
    Grid,
    NonuniformMatmul,
    decay_block_mask,
    nonuniform_tiling,
    reference_blocksparse_matmul,
    reference_matmul,
)
from repro_torch.core.summa import (  # noqa: E402
    SummaConfig,
    summa_blocksparse_matmul,
    summa_matmul,
)
from repro_torch.launch.mesh import spawn_gloo_ranks  # noqa: E402

#: a result's largest error, as a share of the oracle's largest entry
HOLD = 1e-4


def _check(name: str, got, want) -> float:
    got = got.detach().double().cpu() if torch.is_tensor(got) else \
        torch.as_tensor(np.asarray(got, np.float64))
    want = want.detach().double().cpu() if torch.is_tensor(want) else \
        torch.as_tensor(np.asarray(want, np.float64))
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= HOLD:
        raise AssertionError(f"{name}: {err} > {HOLD}")
    return err


def run(grid: Grid, say=print) -> dict:
    """The four parts on ``grid``; returns each result's largest error as
    a share of the oracle's largest entry (raising past ``HOLD``) and the
    counts of part 1."""
    dev = grid.device
    rng = np.random.default_rng(0)
    out = {}

    def tensor(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev)

    # --- 1. block-sparse with distance decay --------------------------------
    n, kb = 1024, 16
    a, b = tensor(n, n), tensor(n, n)
    am = decay_block_mask(kb, kb, decay=0.5, threshold=5e-2)
    bm = decay_block_mask(kb, kb, decay=0.5, threshold=5e-2)
    # compact operator support: the last quarter of the inner dimension is
    # screened out entirely -> those SUMMA panels are dead (never
    # broadcast, never multiplied)
    am[:, 3 * kb // 4:] = False
    bm[3 * kb // 4:, :] = False
    cfg = SummaConfig(grid=grid, strategy="taskbased", k_blocks=kb,
                      local_matmul="pallas")
    got, sparse, _ = analyze_step(summa_blocksparse_matmul, a, b, am, bm,
                                  cfg)
    want = reference_blocksparse_matmul(a, b, am, bm)
    out["blocksparse"] = _check("block-sparse", got, want)
    _, dense, _ = analyze_step(summa_matmul, a, b, cfg)
    say(f"decay mask fill={am.mean():.2f}  max|err|/max|C|="
        f"{out['blocksparse']:.2e}")
    # the panels' broadcasts (the final gather of C to every rank aside)
    panels = [c.coll_bytes_by_op["broadcast"] for c in (dense, sparse)]
    say(f"per rank: FLOP dense {dense.flops:.3g} -> sparse {sparse.flops:.3g}"
        f" ({sparse.flops / max(dense.flops, 1):.0%}); panel broadcast bytes "
        f"dense {panels[0]:.3g} -> sparse {panels[1]:.3g}")
    out["flops"] = (dense.flops, sparse.flops)
    out["panel_bytes"] = tuple(panels)

    # --- 2. nonuniform (physics-driven) blocking -----------------------------
    rt = nonuniform_tiling(1000, 12, seed=1)
    it = nonuniform_tiling(1200, 10, seed=2)
    ct = nonuniform_tiling(900, 9, seed=3)
    a2, b2 = tensor(1000, 1200), tensor(1200, 900)
    mm = DistributedMatmul(grid, strategy="taskbased", local_matmul="pallas")
    nmm = NonuniformMatmul(mm, rt, it, ct, tile=64)
    out["nonuniform"] = _check("nonuniform", nmm(a2, b2),
                               reference_matmul(a2, b2))
    say(f"nonuniform blocks {rt.sizes[:4]}...  padding waste "
        f"{nmm.padding_waste}  max|err|/max|C|={out['nonuniform']:.2e}")

    # --- 3. block-sparse tensor contraction T[abd] = sum_c X[abc] Y[cd] ------
    x3 = BlockSparseTensor.from_dense(tensor(8, 64, 512),
                                      block_shape=(4, 16, 32),
                                      mask=rng.random((2, 4, 16)) < 0.5)
    y3 = BlockSparseTensor.from_dense(
        tensor(512, 384), block_shape=(32, 32),
        mask=decay_block_mask(16, 12, decay=0.4, threshold=5e-2))
    t3 = mm.contract("abc,cd->abd", x3, y3)
    ref3 = np.einsum("abc,cd->abd", x3.to_dense().astype(np.float64),
                     y3.to_dense().astype(np.float64))
    out["contraction"] = _check("contraction", t3.data, ref3)
    say(f"tensor contraction abc,cd->abd  operand fills {x3.fill():.2f}/"
        f"{y3.fill():.2f} -> out fill {t3.fill():.2f}  max|err|/max|T|="
        f"{out['contraction']:.2e}")

    # --- 4. chained contraction D = (A.B).C, jointly scheduled ---------------
    am2 = decay_block_mask(kb, kb, decay=0.5, threshold=5e-2)
    xc = BlockSparseTensor.from_dense(a, block_shape=(n // kb, n // kb),
                                      mask=am2)
    yc = BlockSparseTensor.from_dense(b, block_shape=(n // kb, n // kb),
                                      mask=am2)
    zc = BlockSparseTensor.from_dense(tensor(n, n),
                                      block_shape=(n // kb, n // kb))
    d, report = mm.contract_chain(
        [("ab,bc->ac", xc, yc), ("ab,bc->ac", zc)], tune=True)
    want4 = (xc.to_dense().astype(np.float64)
             @ yc.to_dense().astype(np.float64)) @ zc.to_dense().astype(
        np.float64)
    out["chain"] = _check("chain", d.data, want4)
    say(f"chained contraction (A.B).C  max|err|/max|D|={out['chain']:.2e}")
    say(f"  joint schedule {report['joint_makespan_s'] * 1e6:.1f}us vs "
        f"sequential {report['sequential_makespan_s'] * 1e6:.1f}us "
        f"(x{report['speedup_vs_sequential']:.2f}, per-step "
        f"I={report['lookaheads']}); intermediate mask propagated, "
        f"D fill {d.fill():.2f}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=1, choices=[1, 8],
                    help="8: a 2x4 grid of gloo processes on the CPU")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ranks == 1:
        return run(Grid.local(args.device))
    if args.device != "cpu":
        raise SystemExit("--ranks 8 runs gloo processes on the CPU: "
                         "add --device cpu")
    if args.rank is None:
        outs = spawn_gloo_ranks(os.path.abspath(__file__),
                                ["--device", "cpu", "--ranks", "8"], 8)
        print(outs[0], end="")
        return {}
    torch.distributed.init_process_group(
        "gloo", init_method=args.init_method, rank=args.rank, world_size=8)
    try:
        torch.set_num_threads(1)
        grid = Grid.from_process_group(2, 4, device="cpu")
        return run(grid, say=print if args.rank == 0 else lambda *a: None)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch in float64 on the operands' device.  It imports nothing of
the program: it takes the inputs that the program was handed (drawn again
here from the seed by ``cases``), works out again what the program derives
from them (the masking, through the route's ``reference_a`` and
``reference_b_rows``), and replays each timed product's fresh band.

Every timed product is judged twice, by numbers relative to the size of
the reference's answer:

* ``rows_err``: the widest gap over a sample of whole rows of C, drawn
  from the seed for each product, as a share of the rms of those rows;
* ``proj_err``: the widest gap of ``C @ x`` (x drawn from the seed, the
  product taken in the window on the card in fp32) as a share of its rms.
  Every element of C enters it, so a stale, partial or altered C shows.

The control is the reference put in the program's place in the precision
below the configuration's: TF32 for float32 with TF32 off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from mmbench import cases

#: whole rows of each product's C compared element by element
ROWS_PER_PRODUCT = 16


@dataclasses.dataclass
class Product:
    """What the window kept of one timed product."""

    band: tuple[int, int]  # B's rows redrawn before it
    rows: np.ndarray  # the rows of C kept in full
    c_rows: torch.Tensor | None  # those rows of C (host); None: malformed
    c_proj: torch.Tensor | None  # C @ x (host); None: malformed


def mask_rows_(x: torch.Tensor, mask: np.ndarray, block: int, lo: int,
               hi: int) -> None:
    """Zero, in place, the dead blocks of rows ``lo:hi`` of ``x``, a matrix
    blocked ``block`` by ``block`` under the block mask ``mask``; ``lo``
    and ``hi`` fall on block edges."""
    if lo % block or hi % block:
        raise ValueError(f"rows {lo}:{hi} are not on {block}-row edges")
    keep = torch.as_tensor(np.asarray(mask, bool)[lo // block:hi // block],
                           device=x.device).to(x.dtype)
    x[lo:hi].view(keep.shape[0], block, keep.shape[1], block).mul_(
        keep[:, None, :, None]
    )


def _rms(x: torch.Tensor) -> float:
    return math.sqrt(float(x.pow(2).mean()))


def check(products: list[Product], *, n: int, seed: int, device,
          band_rows: int, reference_a, reference_b_rows,
          limits: dict[str, float]) -> dict:
    """Judge every timed product against the float64 reference.

    ``reference_a()`` returns the reference's dense A (the operand as the
    program was handed it, with the route's derivations worked out again);
    ``reference_b_rows(b, lo, hi)`` does the same in place to rows
    ``lo:hi`` of B.  Returns the worst reading of each number, the count
    of products that missed a limit, and the readings of each product.
    """
    a64 = reference_a().double()
    b = cases.operand(n, seed, cases.B_VALUES, device)
    reference_b_rows(b, 0, n)
    b64 = b.double()
    x64 = cases.projection(n, seed, device).double()
    y = b64 @ x64
    bands = cases.BandStream(n, band_rows, seed, device)
    worst = {"rows_err": 0.0, "proj_err": 0.0}
    failed = 0
    for p in products:
        lo, hi = bands.redraw(b)
        if (lo, hi) != tuple(p.band):
            raise RuntimeError(f"band replay {lo}:{hi} != window's {p.band}")
        reference_b_rows(b, lo, hi)
        b64[lo:hi] = b[lo:hi].double()
        y[lo:hi] = b64[lo:hi] @ x64
        if p.c_rows is None or p.c_proj is None:
            failed += 1
            worst = {k: math.inf for k in worst}
            continue
        rows = torch.as_tensor(p.rows, device=device)
        want_rows = a64.index_select(0, rows) @ b64
        want_proj = a64 @ y
        got = {
            "rows_err": float((p.c_rows.to(device).double() - want_rows)
                              .abs().max()) / _rms(want_rows),
            "proj_err": float((p.c_proj.to(device).double() - want_proj)
                              .abs().max()) / _rms(want_proj),
        }
        for k, v in got.items():
            if not v <= worst[k]:  # NaN too
                worst[k] = v
        if any(not got[k] <= limits[k] for k in got):
            failed += 1
    return {"worst": worst, "failed": failed, "compared": len(products)}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _tf32_on():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def control_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in TF32: the card's TF32 tensor-core route, or on the CPU
    the same rounding of the operands before a float32 product."""
    if a.is_cuda:
        with _tf32_on():
            return a @ b
    return round_tf32(a) @ round_tf32(b)


def control(program, ctx):
    """The reference in the program's place, in TF32: a callable ``(a, b)
    -> C`` that masks B again on each call, as the program must."""
    del program
    route, cfg, traffic, st = ctx["route"], ctx["cfg"], ctx["traffic"], ctx["st"]
    a_ref = route.reference_a(cfg, traffic, st, ctx["seed"],
                              ctx["device"]).float()

    def call(a, b):
        del a
        b_ref = b.clone()
        route.reference_b_rows(b_ref, 0, b_ref.shape[0], cfg, traffic, st)
        return control_product(a_ref, b_ref)

    return call

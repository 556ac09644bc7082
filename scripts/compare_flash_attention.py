#!/usr/bin/env python3
"""The bf16 flash-attention kernel against variants of its own design, on
one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/compare_flash_attention.py [VARIANT ...]

Each variant is ``csrc/flash_attention.cu`` with a few lines replaced
(``VARIANTS`` below; ``source`` is the file unchanged).  With no
argument all of them run.  The script compiles each variant into a
library of its own under ``build/fa_variants/``, all ``nvcc`` processes
started together, and prints ``fa_wgmma_kernel``'s registers and spills
per head dim.  It then checks each variant against
``flash_attention_plain`` on a few shapes, printing the worst element's
share of ``chip_smoke.py``'s bf16 hold (2^-7 |want| + 2e-2 rms(want); over
1 fails), and times every variant in turns (forward, then backward order,
three rounds; the least time is kept) at the LM's shapes, beside
``scaled_dot_product_attention``.  It exits non-zero if ``source`` fails
the hold; a variant that fails it is reported, not raised.
"""
from __future__ import annotations

import math
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from kernel_variants import build, card, in_turns, ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain,
)

OUT = ROOT / "build" / "fa_variants"
KERNEL = "fa_wgmma_kernel"
FA = "flash_attention.cu"
VARIANTS = {
    "source": [],
    # one bf16 P enters P V, and l sums that rounded P
    "one_bf16_p": [
        (FA, "    hopper::wgmma_rs_mn<DH>(o, lo[kk], dv);\n", ""),
        (FA, "  sum += x0 + x1;",
         "  sum += __low2float(h) + __high2float(h);"),
    ],
    # l sums the two bf16 parts instead of the fp32 P
    "l_from_hi_lo": [
        (FA, "  sum += x0 + x1;",
         "  sum += __low2float(h) + __high2float(h) + __low2float(l) +\n"
         "         __high2float(l);"),
    ],
    # three K/V stages at Dh 64 instead of four
    "stages3_dh64": [(FA, "kStages = DH == 64 ? 4 :",
                      "kStages = DH == 64 ? 3 :")],
    # O rescaled on every tile, not only when some row's max moved
    "rescale_always": [
        (FA, "if (__any_sync(0xffffffffu, alpha[0] != 1.f || "
             "alpha[1] != 1.f)) {", "{"),
    ],
}
CHECKS = (  # b, h, hkv, sq, sk, dh, causal, window
    (2, 4, 2, 1000, 1000, 64, True, None),
    (1, 2, 2, 256, 64, 64, False, 64),
    (2, 10, 2, 129, 129, 64, True, None),
    (1, 4, 1, 700, 700, 128, True, 200),
    (1, 4, 1, 700, 700, 256, True, 8),
    (4, 32, 8, 4096, 4096, 64, True, None),
)
TIMES = ((4, 32, 8, 4096, 64), (1, 32, 8, 32768, 64), (4, 16, 4, 4096, 128),
         (2, 8, 1, 4096, 256))


def _label(entry: str) -> str:
    return "Dh=" + re.search(r"ILi(\d+)EE", entry).group(1)


def run(lib, q, k, v, causal=True, window=None) -> torch.Tensor:
    o = torch.empty_like(q)
    b, h, sq, dh = q.shape
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
        k.shape[1], sq, k.shape[2], dh, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *o.stride()[:3], 1.0 / math.sqrt(dh), int(causal),
        int(window is not None), window or 0,
        _build.dtype_code(torch.bfloat16), _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_attention_launch: CUDA error {err}")
    return o


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("compare_flash_attention: no CUDA device")
    names = sys.argv[1:] or list(VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        sys.exit(f"compare_flash_attention: unknown variants {unknown}; "
                 f"known: {list(VARIANTS)}")
    print(card(), flush=True)
    print(f"build ({KERNEL}, ptxas):", flush=True)
    libs = build({name: VARIANTS[name] for name in names}, main=FA,
                 kernel=KERNEL, symbol="flash_attention_launch", out=OUT,
                 label=_label)

    gen = torch.Generator(device="cuda").manual_seed(3)

    def heads(b, s, h, dh):  # a (b, h, s, dh) view of (b, s, h, dh)
        return torch.randn((b, s, h, dh), generator=gen,
                           device="cuda").bfloat16().transpose(1, 2)

    print("worst element / chip_smoke's bf16 hold:", flush=True)
    failed = []
    for b, h, hkv, sq, sk, dh, causal, window in CHECKS:
        q, k, v = heads(b, sq, h, dh), heads(b, sk, hkv, dh), heads(b, sk,
                                                                    hkv, dh)
        want = flash_attention_plain(q, k, v, causal=causal,
                                     window=window).float()
        limit = 2**-7 * want.abs() + 2e-2 * want.square().mean().sqrt()
        line = (f"  B={b} H={h}/{hkv} Sq={sq} Sk={sk} Dh={dh} "
                f"causal={causal} window={window}:")
        for name, lib in libs.items():
            got = run(lib, q, k, v, causal, window).float()
            ratio = ((got - want).abs() / limit).max().item()
            line += f" {name} {ratio:.3f}"
            if name == "source" and not ratio <= 1.0:
                failed.append((b, h, hkv, sq, sk, dh, causal, window))
        print(line, flush=True)
        del q, k, v, want, limit

    print("ms a launch (least of 6 in turns), bf16 causal:", flush=True)
    for b, h, hkv, s, dh in TIMES:
        q, k, v = heads(b, s, h, dh), heads(b, s, hkv, dh), heads(b, s, hkv,
                                                                  dh)
        flop = 4.0 * b * h * dh * s * (s + 1) / 2
        iters = 5 if s > 8192 else 20
        times = in_turns({name: (lambda lib=lib: run(lib, q, k, v))
                          for name, lib in libs.items()}, iters)
        sdpa = ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters)
        print(f"  B={b} H={h}/{hkv} S={s} Dh={dh}: " + ", ".join(
            f"{name} {t:.4f} ms ({flop / t / 1e9:.1f} TFLOP/s)"
            for name, t in times.items())
            + f", scaled_dot_product_attention {sdpa:.4f} ms", flush=True)
        del q, k, v
    if failed:
        sys.exit(f"compare_flash_attention: the source fails the bf16 hold "
                 f"at {failed}")


if __name__ == "__main__":
    main()

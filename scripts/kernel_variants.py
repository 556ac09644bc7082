"""What the scripts that set a CUDA kernel against variants of its own
design share: the card's line, building each variant into a library of
its own, and timing calls in turns.

A variant is a list of ``(file, old, new)`` replacements in files of
``src/repro_torch/csrc``; ``old`` must occur in its file exactly once.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable

import torch

from repro_torch.kernels import _build


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def build(variants: dict[str, list[tuple[str, str, str]]], *, main: str,
          kernel: str, symbol: str, out: Path,
          label: Callable[[str], str]) -> dict[str, ctypes.CDLL]:
    """Compile ``main`` with each variant's replacements into
    ``out/<name>/lib.so``, all ``nvcc`` processes started together, print
    ``kernel``'s registers and spills per instance (``label`` names an
    instance from its mangled entry), and bind ``symbol`` with its
    signature from ``_build``."""
    procs = {}
    for name, edits in variants.items():
        # main and every header are copied: a file's own directory comes
        # first for its quoted includes, so a header that includes an
        # edited one must sit beside it too
        text = {f: (_build.CSRC / f).read_text()
                for f in (main, *_build.HEADERS)}
        for f, old, new in edits:
            body = text[f]
            if body.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {f} once")
            text[f] = body.replace(old, new)
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f, body in text.items():
            (d / f).write_text(body)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(d),
             "-o", str(d / "lib.so"), str(d / main)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif entry and kernel in entry and ("Used" in line
                                                or "spill" in line):
                print(f"  {name} {label(entry)}: "
                      f"{line.replace('ptxas info    :', '').strip()}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        fn = getattr(lib, symbol)
        fn.argtypes = _build._SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def ms(fn: Callable[[], object], iters: int) -> float:
    """Mean ms of ``iters`` calls after one warm call, by CUDA events."""
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


def in_turns(fns: dict[str, Callable[[], object]], iters: int,
             rounds: int = 3) -> dict[str, float]:
    """The least of ``2 * rounds`` timings of each call, taken in turns:
    forward, then backward order, ``rounds`` times."""
    order = list(fns)
    times = {name: [] for name in order}
    for name in (order + order[::-1]) * rounds:
        times[name].append(ms(fns[name], iters))
    return {name: min(t) for name, t in times.items()}

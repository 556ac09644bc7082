"""Grid construction for the launchers.

The port of ``repro.launch.mesh``: where the reference builds a
``jax.sharding.Mesh``, the port builds a ``core.grid.Grid``.  A grid of
one rank is ``Grid.local``; a larger one runs one process per rank under
an initialised ``torch.distributed`` (``init_process_group`` with the
address, world size and rank given by the caller).  The production grids
(``make_production_grid``) are planning-only: they need no processes.

``spawn_gloo_ranks`` runs a script once per rank of a gloo world on the
CPU, each process joining it at the address it is given: the examples'
stand-in for the reference's emulated host devices.
"""
from __future__ import annotations

import math
import os
import socket
import subprocess
import sys

import torch

from repro_torch.core.grid import Grid

__all__ = ["make_grid", "make_host_grid", "make_production_grid",
           "spawn_gloo_ranks"]


def make_production_grid(*, multi_pod: bool = False,
                         device="cuda") -> Grid:
    """The planning-only 16x16 single-pod grid (256 cards) or the 2x16x16
    two-pod one (512), the reference's ``make_production_mesh``: plans,
    specs and per-rank sizes for them need no processes, and
    ``Grid.check_world`` refuses to execute on them.  On ``meta`` it is a
    counting grid: rank (0, ..., 0)'s program runs on it with shapes
    only."""
    if multi_pod:
        return Grid(sizes=(2, 16, 16), axis_names=("pod", "data", "model"),
                    device=torch.device(device))
    return Grid(sizes=(16, 16), axis_names=("data", "model"),
                device=torch.device(device))


def make_grid(shape: tuple[int, ...], axes: tuple[str, ...],
              device="cuda") -> Grid:
    """A grid of ``shape`` with ``axes``: ``Grid.local`` for one rank,
    else one over the initialised ``torch.distributed`` world."""
    if math.prod(shape) == 1:
        return Grid.local(device, axis_names=axes)
    return Grid.from_process_group(*shape, device=device, axis_names=axes)


def make_host_grid(data: int = 1, model: int = 1, device="cuda") -> Grid:
    """The ``("data", "model")`` grid of ``data x model`` ranks."""
    return make_grid((data, model), ("data", "model"), device)


def spawn_gloo_ranks(script: str, argv: list[str], world: int, *,
                     timeout: float = 600.0) -> list[str]:
    """Run ``python script *argv --rank r --init-method tcp://localhost:P``
    for every rank r of a ``world`` of processes on one free port P; each
    joins the gloo world there (``init_process_group("gloo", ...)``).
    Returns each rank's
    output (stdout and stderr); raises ``RuntimeError`` with the output
    of the ranks that failed.  Every process is stopped before it
    returns."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, script, *argv, "--rank", str(rank),
         "--init-method", f"tcp://localhost:{port}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError("ranks {} failed:\n{}".format(
            failed, "\n".join(outs[r][-3000:] for r in failed)))
    return outs

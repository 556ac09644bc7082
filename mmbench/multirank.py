"""One run of a cell whose ``chips`` is more than 1: one rank process per
card, joined in one ``torch.distributed`` world.

``python3 -m mmbench.run --workload <name> ...`` comes here for such a
cell (``main``).  The launcher touches no card: torch's own launcher
(``torch.distributed.run``, standalone, on a free localhost port) starts
one rank a card and ends the others when one fails; a rank that hangs
fails its next collective after ``COLLECTIVE_TIMEOUT_S``.  Rank 0 writes
its check lines and result line to standard output, which the launcher
keeps in a file and prints once every rank has ended.  Each rank binds
``cuda:<rank>``, joins the NCCL world and runs ``run_rank``: the set-up,
warm-up, window and check of ``run.run_cell``, with these differences:

* every rank draws the same global inputs from the seed and replays the
  same bands of B; set-up compares checksums of A and B over the world
  and fails the run where one rank drew others;
* rank 0 alone decides when the window ends: after each product a
  one-element broadcast tells every rank whether to go on, so all ranks
  time the same products;
* every rank sums the C it was returned after each product; once the
  window has closed, rank 0 counts the products in which another rank's
  sums differ from its own (``ranks_differ``, limit 0);
* rank 0 alone keeps what the check compares and judges the C it was
  returned once the other ranks have freed their memory and left;
* with ``--trace 1`` rank 0 profiles a stretch of ``TRACE_PRODUCTS``
  products after ``TRACE_SKIP`` (the profiler halves the pace of the host
  that paces the product, so a short stretch keeps the window's own pace);
* the memory peaks are the largest over the ranks, and the window, the
  rates and ``setup_s`` are rank 0's host clock, the last counted from the
  launcher's start;
* the hosts are steadied for the window (``RANK_ENV``; Python's collector
  frozen over what set-up made).

For the harness's own tests and for the readings that set a cell's
limits::

    python3 -m mmbench.multirank launch --workload <name> --seed <n> \\
        --seconds <s> [--trace 1] [--wrap control --wrap-ranks 0,1,2,3]

puts the control or a planted fault (``faults``, or ``no_exchange``) in the
program's place on the listed ranks.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # a rank's set-up parts are counted from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import datetime  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from mmbench import faults, reference, run  # noqa: E402
from mmbench import trace as traces  # noqa: E402

#: how long a collective may wait for a peer before its rank fails
COLLECTIVE_TIMEOUT_S = 300
#: the products a traced run skips, then profiles, on rank 0
TRACE_SKIP, TRACE_PRODUCTS = 10, 40
#: each rank's environment: c10d's flight recorder (under its names old and
#: new) and heartbeat monitor off, a collective's tensors held by its work
#: rather than recorded on the allocator's streams, one thread for the
#: host's own kernels
RANK_ENV = {"TORCH_FR_BUFFER_SIZE": "0", "TORCH_NCCL_TRACE_BUFFER_SIZE": "0",
            "TORCH_NCCL_ENABLE_MONITORING": "0",
            "TORCH_NCCL_AVOID_RECORD_STREAMS": "1",
            "OMP_NUM_THREADS": "1"}


def no_exchange(program, ctx):
    """The exchange between cards left out: every rank takes its own panel
    where it should receive the owner's (the grid's broadcast sends
    nothing)."""
    del ctx
    grid = program.mm.grid
    object.__setattr__(grid, "broadcast", lambda x, owner, axis, async_op=False:
                       (x.contiguous(), None))
    return program


#: what ``--wrap`` may put in the program's place
WRAPS = {"control": reference.control, "no_exchange": no_exchange,
         **faults.FAULTS}


# -- the launcher ------------------------------------------------------------


def launch(cell: run.Cell, *, seed: int, seconds: float, trace: bool,
           t0: float, device: str = "cuda", wrap: str | None = None,
           wrap_ranks=(), perturb_rank: int | None = None
           ) -> tuple[int, list[str]]:
    """Run ``cell`` once on ``cell.chips`` rank processes (on ``cuda`` one
    card each, on ``cpu`` a gloo world for the tests).  Returns the exit
    code and rank 0's standard output: its check lines, then its result
    line.  ``t0`` is the launcher's start on its ``time.perf_counter``."""
    from torch.distributed import run as torchrun
    from torch.distributed.elastic.multiprocessing.errors import \
        ChildFailedError

    wall0 = time.time() - (time.perf_counter() - t0)
    spec = json.dumps({k: getattr(cell, k) for k in (
        "name", "chips", "config", "traffic", "limits", "end_to_end",
        "per_layer")})
    args = ["--cell", spec, "--seed", str(seed), "--seconds", repr(seconds),
            "--trace", str(int(trace)), "--wall0", repr(wall0),
            "--device", device]
    if wrap is not None:
        args += ["--wrap", wrap, "--wrap-ranks", ",".join(map(str, wrap_ranks))]
    if perturb_rank is not None:
        args += ["--perturb-rank", str(perturb_rank)]
    logs = tempfile.mkdtemp(prefix="mmbench-ranks-")
    saved = dict(os.environ)
    os.environ.update(RANK_ENV)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(run.ROOT)] + [p for p in [saved.get("PYTHONPATH")] if p])
    try:
        torchrun.run(torchrun.parse_args([
            "--standalone", "--nproc-per-node", str(cell.chips),
            "--max-restarts", "0", "--monitor-interval", "0.1",
            "--redirects", "1", "--log-dir", logs,
            "-m", "mmbench.multirank", "rank", *args]))
        rc = 0
    except ChildFailedError as e:
        run.log(f"a rank failed; the others were ended:\n{e}")
        rc = 1
    finally:
        os.environ.clear()
        os.environ.update(saved)
        found = sorted(Path(logs).glob("**/0/stdout.log"))
        out = found[0].read_text().splitlines() if found else []
        shutil.rmtree(logs, ignore_errors=True)
    return (rc, out) if rc or out else (1, out)


def main(cell: run.Cell, args, t0: float) -> int:
    """``run.main`` for a cell on more than one card, started at ``t0``."""
    rc, lines = launch(cell, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), t0=t0,
                       wrap=getattr(args, "wrap", None),
                       wrap_ranks=getattr(args, "wrap_ranks", ()))
    found = run.forbidden_modules()
    if found:
        run.log(f"forbidden modules loaded in the launcher: {found}")
        return 3
    if rc:
        for line in lines:
            run.log("[rank 0] " + line)
        return rc
    *checks, result = lines
    for line in checks:
        run.log(line)
    print(result, flush=True)
    return 0


# -- one rank ----------------------------------------------------------------


def _checksums(*xs):
    """Two weighted sums of each matrix or vector: equal values give equal
    bits, and any changed element changes them."""
    import torch

    sums = []
    for x in xs:
        x = x.reshape(x.shape[0], -1)
        cols = torch.linspace(1.0, 2.0, x.shape[1], device=x.device)
        rows = torch.linspace(2.0, 1.0, x.shape[0], device=x.device)
        r = torch.mv(x, cols)
        sums += [r.sum(), r.dot(rows)]
    return torch.stack(sums).double()


def _check_draws(a, b, world: int) -> None:
    """Raise on every rank unless every rank drew the same A and B."""
    import torch
    import torch.distributed as dist

    mine = _checksums(a, b)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    other = [r for r, s in enumerate(every) if not torch.equal(s, every[0])]
    if other:
        raise RuntimeError(
            f"ranks {other} drew other inputs than rank 0: checksums of A "
            f"and B {[s.tolist() for s in every]}")


def _ranks_differ(sums, world: int, lead: bool) -> int | None:
    """On rank 0, the count of products in which another rank's sums of
    its C differ from rank 0's (``sums``: one row a product, as many rows
    on every rank)."""
    import torch
    import torch.distributed as dist

    every = [torch.empty_like(sums) for _ in range(world)]
    dist.all_gather(every, sums.contiguous())
    if not lead:
        return None
    same = torch.stack([(s == every[0]).all(dim=1) for s in every])
    return int((~same.all(dim=0)).sum())


def run_rank(cell: run.Cell, *, rank: int, seed: int, seconds: float,
             trace: bool, t0: float, device, wrap=None,
             perturb: bool = False) -> dict | None:
    """This rank's part of one run, in the world that ``torch.distributed
    .run`` set up in the environment; rank 0 returns what ``run.run_cell``
    returns, the others None."""
    import torch
    import torch.distributed as dist

    from mmbench import cases, count

    marks = {"spawn": T_START}
    run.use_program()
    marks["imports"] = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    on_card = device.type == "cuda"
    world, lead = cell.chips, rank == 0
    if int(os.environ.get("WORLD_SIZE", world)) != world:
        raise RuntimeError(f"{cell.name} takes {world} ranks, the launcher "
                           f"started {os.environ['WORLD_SIZE']}")
    if on_card:
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if on_card else "gloo", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
        **({"device_id": device} if on_card else {}))
    marks["world"] = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg, traffic, route = cell.config, cell.traffic, cell.route
    n = cfg["n"]
    st = route.structure(cfg, traffic, seed)
    a = route.operand_a(cfg, traffic, st, seed, device)
    b = cases.operand(n, seed, cases.B_VALUES, device)
    if perturb:
        a.view(-1)[0] += 1.0
    _check_draws(a, b, world)
    x = cases.projection(n, seed, device)
    sync()
    marks["inputs"] = time.perf_counter()
    program = route.Program(cfg, traffic, st, device)
    ctx = dict(cfg=cfg, traffic=traffic, st=st, seed=seed, device=device,
               route=route)
    call = WRAPS[wrap](program, ctx) if wrap is not None else program
    bands = cases.BandStream(n, traffic["band_rows"], seed, device)
    row_stream = cases.RowStream(n, reference.ROWS_PER_PRODUCT, seed)
    flag = torch.ones(1, dtype=torch.int32, device=device)

    # warm-up: two products on the first inputs (the first also makes the
    # grid's communicators), and the window's own ops; the second's time
    # sizes the buffers
    warm_stash = run._Stash(2, row_stream.count, n, device) if lead else None
    for _ in range(2):
        t_warm = time.perf_counter()
        c = call(a, b)
        if lead:
            warm_stash.keep(c, torch.arange(row_stream.count, device=device),
                            x)
        _checksums(c)
        del c
        dist.broadcast(flag, src=0)
        sync()
        t_warm = time.perf_counter() - t_warm
    cases.normal((traffic["band_rows"], n), torch.Generator(device=device),
                 device)
    capacity = int(seconds / max(t_warm, 1e-3) * 4) + 16
    sums = torch.zeros((capacity, 2), dtype=torch.float64, device=device)
    sync()
    marks["warm-up"] = time.perf_counter()
    stash = run._Stash(capacity, row_stream.count, n, device) if lead \
        else None
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0

    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    prof = profile(activities=acts) if trace and lead else None
    skip, stretch = TRACE_SKIP, TRACE_PRODUCTS
    in_stretch = contextlib.ExitStack()
    products, call_host, ends = [], [], []
    gc.collect()
    gc.freeze()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    before = run.launch_counts()
    start = time.perf_counter()
    while True:
        i = len(ends)
        if prof is not None and i == skip:
            prof.start()
            in_stretch.enter_context(record_function(traces.WINDOW_RANGE))
        band = bands.redraw(b)
        t_call = time.perf_counter()
        with record_function(traces.CALL_RANGE):
            c = call(a, b)
        call_host.append(time.perf_counter() - t_call)
        if i >= sums.shape[0]:
            sums = torch.cat([sums, torch.zeros_like(sums)])
        sums[i] = _checksums(c)
        if lead:
            rows = row_stream.next()
            c_rows, c_proj = stash.keep(
                c, torch.as_tensor(rows, device=device), x)
            products.append(reference.Product(band, rows, c_rows, c_proj))
        del c
        sync()
        done = time.perf_counter()
        ends.append(done - start)
        if lead:
            profiling = prof is not None and i < skip + stretch - 1
            go = done - start < seconds or profiling
            flag.fill_(int(go))
        dist.broadcast(flag, src=0)
        if prof is not None and i == skip + stretch - 1:
            in_stretch.close()
            prof.stop()
        if not (go if lead else flag.item()):
            break
    window_s = done - start
    gc.unfreeze()
    setup_s = start - t0
    marks["window"] = start
    setup_parts, last = {}, t0
    for k, t in marks.items():
        setup_parts[k], last = t - last, t
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    peaks = torch.tensor([max(peak_setup, window_peak), window_peak],
                         dtype=torch.int64, device=device)
    dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
    differ = _ranks_differ(sums[:len(ends)], world, lead)
    after = run.launch_counts()
    host_ms = sorted(1e3 * t for t in call_host)
    run.log(f"[rank {rank}] host ms a call: median "
            f"{statistics.median(host_ms)!r}, p90 "
            f"{host_ms[int(0.9 * (len(host_ms) - 1))]!r}")
    tr = None
    if prof is not None:
        run.OUT.mkdir(parents=True, exist_ok=True)
        path = run.OUT / f"{cell.name}.trace.json"
        prof.export_chrome_trace(str(path))
        tr = traces.load(path)
    del prof
    launches = {k: (after[k] - before[k]) / len(ends) for k in after}
    counters = program.counters() if lead else None
    del program, call, a, b, x
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    if not lead:
        return None

    checked = reference.check(
        products, n=n, seed=seed, device=device,
        band_rows=traffic["band_rows"],
        reference_a=lambda: route.reference_a(cfg, traffic, st, seed, device),
        reference_b_rows=lambda bb, lo, hi: route.reference_b_rows(
            bb, lo, hi, cfg, traffic, st),
        limits=cell.limits,
    )
    checked["worst"]["ranks_differ"] = differ
    checked["failed"] = min(checked["compared"], checked["failed"] + differ)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    ps = [e - s for s, e in zip([0.0] + ends[:-1], ends)]
    run.log(f"[{cell.name}] products a 5-s stretch of the window: "
            f"{[sum(1 for e in ends if k * 5 <= e < k * 5 + 5) for k in range(int(window_s // 5) + 1)]}")
    view = run.View(
        products=len(products), window_s=window_s, setup_s=setup_s,
        peak_bytes=int(peaks[1]),
        useful_flop=route.useful_flop(cfg, traffic, st) * len(products),
        call_host_s=call_host, product_s=ps,
        counters=counters, launches=launches,
        kernel_work=route.kernel_work(cfg, traffic, st, counters, launches),
        peak=count.PEAKS.get(kind), trace=tr, cards=world,
    )
    return dict(view=view, checked=checked, kind=kind, peak=int(peaks[0]),
                on_card=on_card, t_warm=t_warm, setup_parts=setup_parts)


def result_line(cell: run.Cell, result: dict, trace: bool):
    """``run.result_line`` for the grid: the cards counted, and a traced
    run said to trace a stretch of rank 0's window."""
    out, lines = run.result_line(cell, result, trace)
    out["device"]["count"] = cell.chips
    if trace:
        check = out.pop("check")
        calls = result["view"].trace.calls if result["view"].trace else []
        out["traced"] = f"rank 0 of {cell.chips}: {len(calls)} products " \
                        f"of its window, their spans and device trace"
        out["check"] = check
    return out, lines


def _cell_of(spec: str) -> run.Cell:
    import importlib

    d = json.loads(spec)
    route = importlib.import_module(f"mmbench.routes.{d['traffic']['route']}")
    return run.Cell(d["name"], int(d["chips"]), d["config"], d["traffic"],
                    route, d["limits"], d["end_to_end"], d["per_layer"])


def _rank_main(args) -> int:
    rank = int(os.environ["RANK"])
    t0 = time.perf_counter() - (time.time() - args.wall0)
    cell = _cell_of(args.cell)
    device = f"cuda:{int(os.environ['LOCAL_RANK'])}" \
        if args.device == "cuda" else args.device
    wrap = args.wrap if rank in args.wrap_ranks else None
    if wrap is not None and wrap not in WRAPS:
        raise SystemExit(f"rank {rank}: no wrap {wrap!r} (have {sorted(WRAPS)})")
    result = run_rank(cell, rank=rank, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t0=t0, device=device,
                      wrap=wrap, perturb=rank == args.perturb_rank)
    found = run.forbidden_modules()
    if found:
        run.log(f"forbidden modules loaded in rank {rank}: {found}")
        return 3
    if result is None:
        return 0
    out, lines = result_line(cell, result, bool(args.trace))
    run.info(cell, result)
    for line in lines:
        print(line)
    print(json.dumps(out), flush=True)
    return 0


def _ints(text: str) -> list[int]:
    return [int(r) for r in text.split(",") if r]


def _main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="mode", required=True)
    for mode in ("launch", "rank"):
        s = sub.add_parser(mode)
        s.add_argument("--seed", type=int, required=True)
        s.add_argument("--seconds", type=float, required=True)
        s.add_argument("--trace", type=int, choices=(0, 1), default=0)
        s.add_argument("--wrap")
        s.add_argument("--wrap-ranks", default="0", type=_ints)
    s = sub.choices["launch"]
    s.add_argument("--workload", required=True)
    s = sub.choices["rank"]
    s.add_argument("--cell", required=True)
    s.add_argument("--wall0", type=float, required=True)
    s.add_argument("--device", default="cuda")
    s.add_argument("--perturb-rank", type=int,
                   help="the rank that changes one element of A after "
                        "drawing it")
    args = p.parse_args(argv)
    if args.mode == "rank":
        return _rank_main(args)
    if args.wrap is not None and args.wrap not in WRAPS:
        p.error(f"--wrap: choose from {sorted(WRAPS)}")
    return main(run.resolve(run.load_benchmark(), args.workload), args,
                run.T0)


if __name__ == "__main__":
    sys.exit(_main())

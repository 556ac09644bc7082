"""Run one cell of the benchmark once and print its result line.

    python3 -m mmbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic mix,
route, limits and metrics are found by name from ``BENCHMARK.json``.  Set-up
draws the inputs from the seed on the card, builds the program's plan and
runs one warm-up product; then the window issues products back to back,
one caller waiting on each, with one band of B redrawn before each, until
the first product that ends at or after ``--seconds``.  ``--trace 1`` runs
the window under ``torch.profiler`` and reports the per-layer metrics.
After the window, with the program freed, every timed product is judged
against the plain reference (``reference``).

The last line of standard output is one JSON object; the numbers compared
are the last lines of standard error.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from mmbench import trace as traces  # noqa: E402
from mmbench.metrics import reader as metric_reader  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
OUT = HERE / "out"
#: top-level modules that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the program's four hand-written kernels, by the name each launches
KERNELS = {"tiled_matmul": ("tiled_matmul_kernel",), "bsmm": ("bsmm_kernel",),
           "grouped_gemm": ("grouped_gemm_kernel",),
           "flash_attention": ("fa_wgmma_kernel", "fa_fma_kernel")}


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


# -- discovery ---------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    route: object  # the route module
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _for_cell(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(bench: dict, workload: str) -> Cell:
    """The cell ``workload`` of ``bench`` with everything it names."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / config["file"]) as f:
        cfg = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "workloads" / f"{workload}.json") as f:
        limits = json.load(f)["limits"]
    route = importlib.import_module(f"mmbench.routes.{traffic['route']}")
    return Cell(workload, int(w["chips"]), cfg, traffic, route, limits,
                _for_cell(bench["end_to_end"], workload),
                _for_cell(bench["per_layer"], workload))


def use_program() -> None:
    """Import ``repro_torch`` from this checkout's ``src`` and nowhere else."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch

    where = Path(repro_torch.__file__).resolve()
    if Path(src).resolve() not in where.parents:
        raise SystemExit(f"repro_torch came from {where}, not from {src}")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# -- what the metrics read ---------------------------------------------------


@dataclasses.dataclass
class View:
    """Everything a metric's reader may read of one run."""

    products: int
    window_s: float
    setup_s: float
    peak_bytes: int
    useful_flop: float  # over the window
    call_host_s: list[float]
    product_s: list[float]  # each product's time, end to end, in turn
    counters: dict  # what the program counts
    launches: dict  # each kernel's launches per product (program counters)
    kernel_work: dict  # kernel -> (FLOP, bytes) per product, by ``count``
    peak: dict | None  # the card's peaks, ``count.PEAKS``
    trace: object = None  # ``trace.Trace`` of the window, with --trace 1
    cards: int = 1  # the cards the run spans (``multirank``)

    def program_device_s(self, names=None, exclude=()) -> float | None:
        """Device seconds the program's calls spent in intervals whose
        name holds one of ``names`` (all, if None) and none of
        ``exclude``."""
        if self.trace is None or not self.trace.intervals:
            return None
        total = 0.0
        for i in self.trace.intervals:
            if not i.program or any(x in i.name for x in exclude):
                continue
            if names is None or any(x in i.name for x in names):
                total += i.end_us - i.start_us
        return total / 1e6

    def roofline(self, kernel: str) -> float | None:
        """The kernel's share (%) of its least time at this work."""
        from mmbench import count

        work = self.kernel_work.get(kernel)
        t = self.program_device_s(KERNELS[kernel])
        if not work or not self.peak or not t:
            return None
        return 100.0 * count.least_seconds(*work, self.peak) * self.products / t

    def busy_s(self) -> float | None:
        if self.trace is None or not self.trace.intervals:
            return None
        return self.trace.busy_us(*self.trace.window) / 1e6

    def traced_window_s(self) -> float | None:
        if self.trace is None:
            return None
        return (self.trace.window[1] - self.trace.window[0]) / 1e6


# -- one run -----------------------------------------------------------------


def launch_counts() -> dict:
    from repro_torch.kernels.bsmm import bsmm_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.grouped_gemm import grouped_gemm_cuda
    from repro_torch.kernels.tiled_matmul import tiled_matmul_cuda

    return {"tiled_matmul": tiled_matmul_cuda.launches,
            "bsmm": bsmm_cuda.launches,
            "grouped_gemm": grouped_gemm_cuda.launches,
            "flash_attention": flash_attention_cuda.launches}


class _Stash:
    """Host buffers for what the check keeps of each product, filled by
    copies that do not stop the host (pinned memory on the card)."""

    def __init__(self, capacity: int, rows: int, n: int, device):
        import torch

        self.pin = torch.device(device).type == "cuda"
        self.rows, self.n = rows, n
        self.c_rows = torch.empty((capacity, rows, n), pin_memory=self.pin)
        self.c_proj = torch.empty((capacity, n), pin_memory=self.pin)
        self.used = 0

    def keep(self, c, rows_dev, x):
        import torch

        if tuple(c.shape) != (self.n, self.n) or c.dtype != torch.float32 \
                or c.device != x.device:
            return None, None
        if self.used < self.c_rows.shape[0]:
            r_buf, p_buf = self.c_rows[self.used], self.c_proj[self.used]
        else:  # more products than set-up foresaw
            r_buf = torch.empty((self.rows, self.n), pin_memory=self.pin)
            p_buf = torch.empty((self.n,), pin_memory=self.pin)
        self.used += 1
        r_buf.copy_(c.index_select(0, rows_dev), non_blocking=self.pin)
        p_buf.copy_(torch.mv(c, x), non_blocking=self.pin)
        return r_buf, p_buf


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
             t0: float, wrap=None) -> dict:
    """One run of ``cell``: set-up, the window, the check, the metrics.

    ``wrap(program, ctx)``, for the control and the fault tests only,
    puts another callable in the program's place.
    """
    import torch

    from mmbench import cases, count, reference

    use_program()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    marks = {"imports": time.perf_counter()}
    cfg, traffic, route = cell.config, cell.traffic, cell.route
    n = cfg["n"]
    st = route.structure(cfg, traffic, seed)
    a = route.operand_a(cfg, traffic, st, seed, device)
    b = cases.operand(n, seed, cases.B_VALUES, device)
    x = cases.projection(n, seed, device)
    sync()
    marks["inputs"] = time.perf_counter()
    program = route.Program(cfg, traffic, st, device)
    ctx = dict(cfg=cfg, traffic=traffic, st=st, seed=seed, device=device,
               route=route)
    call = wrap(program, ctx) if wrap is not None else program
    bands = cases.BandStream(n, traffic["band_rows"], seed, device)
    row_stream = cases.RowStream(n, reference.ROWS_PER_PRODUCT, seed)

    # warm-up: one product on the first inputs, and the window's own ops
    t_warm = time.perf_counter()
    c = call(a, b)
    warm_stash = _Stash(1, row_stream.count, n, device)
    warm_stash.keep(c, torch.arange(row_stream.count, device=device), x)
    cases.normal((traffic["band_rows"], n), torch.Generator(device=device),
                 device)
    del c
    sync()
    marks["warm-up"] = time.perf_counter()
    t_warm = marks["warm-up"] - t_warm
    # room for four times the products the warm-up's pace gives (the
    # warm-up is the slowest product), so none is allocated in the window
    stash = _Stash(int(seconds / max(t_warm, 1e-3) * 4) + 16,
                   row_stream.count, n, device)
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0

    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    prof = profile(activities=acts) if trace else contextlib.nullcontext()
    products, call_host, ends = [], [], []
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    with prof, record_function(traces.WINDOW_RANGE):
        start = time.perf_counter()
        while True:
            band = bands.redraw(b)
            rows = row_stream.next()
            rows_dev = torch.as_tensor(rows, device=device)
            t_call = time.perf_counter()
            with record_function(traces.CALL_RANGE):
                c = call(a, b)
            call_host.append(time.perf_counter() - t_call)
            c_rows, c_proj = stash.keep(c, rows_dev, x)
            products.append(reference.Product(band, rows, c_rows, c_proj))
            del c
            sync()
            done = time.perf_counter()
            ends.append(done - start)
            if done - start >= seconds:
                break
    window_s = done - start
    setup_s = start - t0
    marks["window"] = start
    setup_parts = {}
    last = t0
    for k, t in marks.items():
        setup_parts[k], last = t - last, t
    peak = max(peak_setup, torch.cuda.max_memory_allocated()) if on_card \
        else 0
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    after = launch_counts()
    tr = None
    if trace:
        OUT.mkdir(parents=True, exist_ok=True)
        path = OUT / f"{cell.name}.trace.json"
        prof.export_chrome_trace(str(path))
        tr = traces.load(path)
    del prof
    launches = {k: (after[k] - before[k]) / len(products) for k in after}
    counters = program.counters()
    del program, call, a, b, x
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checked = reference.check(
        products, n=n, seed=seed, device=device,
        band_rows=traffic["band_rows"],
        reference_a=lambda: route.reference_a(cfg, traffic, st, seed, device),
        reference_b_rows=lambda bb, lo, hi: route.reference_b_rows(
            bb, lo, hi, cfg, traffic, st),
        limits=cell.limits,
    )
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    view = View(
        products=len(products), window_s=window_s, setup_s=setup_s,
        peak_bytes=window_peak,
        useful_flop=route.useful_flop(cfg, traffic, st) * len(products),
        call_host_s=call_host,
        product_s=[e - s for s, e in zip([0.0] + ends[:-1], ends)],
        counters=counters, launches=launches,
        kernel_work=route.kernel_work(cfg, traffic, st, counters, launches),
        peak=count.PEAKS.get(kind), trace=tr,
    )
    return dict(view=view, checked=checked, kind=kind, peak=peak,
                on_card=on_card, t_warm=t_warm, setup_parts=setup_parts)


def result_line(cell: Cell, run: dict, trace: bool) -> tuple[dict, list[str]]:
    """The result object and the check's lines for standard error."""
    view, checked = run["view"], run["checked"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(view)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    worst = checked["worst"]
    correct = (checked["failed"] == 0 and checked["compared"] > 0
               and all(worst[k] <= cell.limits[k] for k in worst))
    device = {"platform": "gpu" if run["on_card"] else "cpu",
              "kind": run["kind"], "count": 1,
              "memory_peak_bytes": int(run["peak"])}
    out = {"correct": bool(correct), "attempted": checked["compared"],
           "failed": checked["failed"], "metrics": metrics, "device": device}
    if trace and view.trace is not None:
        device["busy_s"] = view.busy_s() or 0.0
        device["window_s"] = view.traced_window_s()
        out["breakdown"] = breakdown(view)
    out["check"] = {k: {"value": worst[k], "limit": cell.limits[k]}
                    for k in worst}
    lines = [f"check {k} {worst[k]!r} limit {cell.limits[k]!r}" for k in worst]
    lines.append(f"check failed_products {checked['failed']} limit 0 "
                 f"(of {checked['compared']})")
    return out, lines


def breakdown(view: View) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the host was doing."""
    tr = view.trace
    by_name: dict[str, float] = {}
    for i in tr.intervals:  # the benchmark's own work is marked "bench:"
        name = (i.name if i.program else "bench: " + i.name)[:120]
        by_name[name] = by_name.get(name, 0.0) + (i.end_us - i.start_us) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.gaps(*tr.window), key=lambda g: g[0] - g[1])[:10]
    idle = [[tr.host_doing(s)[:120], (e - s) / 1e6] for s, e in gaps]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def info(cell: Cell, run: dict) -> None:
    """What the run learned beyond its metrics, on standard error."""
    view = run["view"]
    ps = sorted(view.product_s)
    log(f"[{cell.name}] products {view.products} in {view.window_s!r} s; "
        f"per product: median {statistics.median(ps)!r} s, max {ps[-1]!r} "
        f"s, min {ps[0]!r} s, in turn {[round(p, 4) for p in view.product_s[:200]]}; "
        f"warm-up product {run['t_warm']!r} s; per call on the host "
        f"{1e3 * sum(view.call_host_s) / view.products!r} ms")
    log(f"[{cell.name}] set-up {view.setup_s!r} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run["setup_parts"].items()))
    log(f"[{cell.name}] launches per product {view.launches}; program "
        f"counters {view.counters}")
    if view.trace is not None:
        log(f"[{cell.name}] host waits on the card inside calls: "
            f"{view.trace.syncs_in_calls / view.products!r} per call")
    if run["on_card"]:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False)
        log(f"[{cell.name}] nvidia-smi: {smi.stdout.strip()}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = resolve(load_benchmark(), args.workload)
    # kernel caches at fixed places inside the checkout, should a library
    # of the program compile one
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / "mmbench" / sub))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
            f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if cell.chips > 1:
        from mmbench import multirank

        return multirank.main(cell, args, T0)
    run = run_cell(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda", t0=T0)
    out, lines = result_line(cell, run, bool(args.trace))
    info(cell, run)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The reduction of a traced window to device intervals.

The window runs under ``torch.profiler`` and is exported as a Chrome
trace.  Each device interval (a kernel, a copy or a fill on the card) is
tied by its correlation id to the host's launch, and through the launch's
time to the range it ran in: ``mmbench.call`` (the program's call) or the
benchmark's own work between calls.  So the metrics can tell the program's
device time from the benchmark's.
"""
from __future__ import annotations

import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_RANGE = "mmbench.call"
WINDOW_RANGE = "mmbench.window"
#: host calls that wait for the card (a copy to or from pageable memory
#: ends in ``cudaStreamSynchronize``)
SYNC_NAMES = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuCtxSynchronize",
              "cuStreamSynchronize")


@dataclasses.dataclass(frozen=True)
class Interval:
    name: str
    start_us: float
    end_us: float
    program: bool  # launched inside a call of the program


@dataclasses.dataclass
class Trace:
    intervals: list[Interval]
    calls: list[tuple[float, float]]  # the program's call ranges (host us)
    host_ops: list[tuple[str, float, float, int]]  # name, start, end, depth
    syncs_in_calls: int  # host waits on the card inside the calls
    window: tuple[float, float] | None  # the timed window (host us)

    def busy_us(self, lo: float | None = None, hi: float | None = None) -> float:
        """The union of the device intervals' time, within [lo, hi]."""
        spans = sorted(
            (max(i.start_us, lo if lo is not None else i.start_us),
             min(i.end_us, hi if hi is not None else i.end_us))
            for i in self.intervals
        )
        total, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def gaps(self, lo: float, hi: float) -> list[tuple[float, float]]:
        """The idle stretches of the card within [lo, hi]."""
        out, cursor = [], lo
        for i in sorted(self.intervals, key=lambda i: i.start_us):
            if i.start_us > cursor:
                out.append((cursor, min(i.start_us, hi)))
            cursor = max(cursor, i.end_us)
            if cursor >= hi:
                break
        if cursor < hi:
            out.append((cursor, hi))
        return [(s, e) for s, e in out if e > s]

    def host_doing(self, t_us: float) -> str:
        """The innermost host range running at ``t_us``."""
        best, depth = "host idle", -1
        for name, s, e, d in self.host_ops:
            if s <= t_us < e and d > depth:
                best, depth = name, d
        return best


def _inside(t: float, ranges: list[tuple[float, float]]) -> bool:
    return any(s <= t <= e for s, e in ranges)


def load(path) -> Trace:
    """Read a Chrome trace that ``torch.profiler`` exported."""
    with open(path) as f:
        doc = json.load(f)
    return reduce(doc.get("traceEvents", doc if isinstance(doc, list) else []))


def reduce(events: list[dict]) -> Trace:
    """Device intervals, the program's call ranges and the host's ranges
    of one trace's events."""
    def host_ranges(name):  # not their "gpu_user_annotation" mirrors
        return sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name") == name
        )

    windows, calls = host_ranges(WINDOW_RANGE), host_ranges(CALL_RANGE)
    launch_ts = {}
    host = []
    syncs = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
            if e.get("name") in SYNC_NAMES and _inside(ts, calls):
                syncs += 1
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((e.get("name", "?"), ts, ts + dur))
    # nesting depth of host ranges: later-starting ranges inside earlier ones
    host.sort(key=lambda r: (r[1], -r[2]))
    stack: list[float] = []
    host_ops = []
    for name, s, e in host:
        while stack and stack[-1] <= s:
            stack.pop()
        host_ops.append((name, s, e, len(stack)))
        stack.append(e)
    intervals = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        corr = (e.get("args") or {}).get("correlation")
        launched = launch_ts.get(corr, ts)
        intervals.append(Interval(e.get("name", "?"), ts, ts + dur,
                                  _inside(launched, calls)))
    return Trace(intervals, calls, host_ops, syncs,
                 windows[0] if windows else None)

"""Spans and counters: where a call of the program spends its time.

One recorder for the whole package; every span is opened through
``span`` (or the ``spanned`` decorator over it), and nothing else times a
step of the program.

* ``span(name, device=None, **attrs)`` is a context manager around one
  step.  It records the name, the host start and end
  (``time.perf_counter_ns``), its own id, its parent's id and the id of
  its ``api.call`` root, which every span of one call of the entry point
  shares.  A span that names a ``cuda`` ``device`` also records a
  ``torch.cuda.Event`` on that device's current stream at entry and at
  exit; its device time is their ``elapsed_time``, read lazily (one
  ``synchronize`` in ``summary`` or ``records``).  Spans without a device
  (planning, a grid's collectives, whose NCCL work runs on a stream of
  its own) record host time only.  An ``api.call`` opened inside
  another is no second root: it opens nothing.
* ``count(name, n)`` adds ``n`` to a counter of the session and of the
  innermost open span.
* ``recording()`` opens a fresh session and records into it until it
  closes; ``summary()``, ``records()`` and ``clear()`` read or empty the
  innermost open one, or else the process's ambient session.

The recorder is on inside ``recording()``, or while a ``torch.profiler``
records (``torch.autograd.profiler._is_profiler_enabled``); in the second
case spans go to the ambient session.  While a profiler records, each
span also opens ``torch.profiler.record_function(name)``, so it shows in
the exported trace as a ``user_annotation`` on the kernels' timeline.
When it is off, ``span`` returns one shared null context: no span, no
event and no ``record_function`` (which costs ~13 us a call even with no
profiler).

Which metric reads each span and counter: PERF.md, section 3.  The
recorder is meant for one thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = [
    "ROOT",
    "Span",
    "clear",
    "count",
    "records",
    "recording",
    "span",
    "spanned",
    "summary",
]

#: the name of a call of the entry point: the root of the spans inside it
ROOT = "api.call"

#: what ``span`` returns while nothing records
_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    """One closed (or still open) span."""

    name: str
    id: int
    parent: int | None
    root: int | None  # the id of its ``api.call`` (None outside any)
    start_ns: int
    end_ns: int | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    #: counts made while this was the innermost open span
    counters: dict = dataclasses.field(default_factory=dict)
    #: device seconds between its entry and exit events (None: host only)
    device_s: float | None = None
    _events: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Session:
    def __init__(self):
        self.spans: list[Span] = []
        self.open: list[Span] = []
        self.counters: dict[str, float] = {}
        self.ids = itertools.count()

    def clear(self) -> None:
        self.spans.clear()
        self.counters.clear()


_AMBIENT = _Session()
_RECORDING: list[_Session] = []


def _active() -> _Session | None:
    """The session that records now, or None."""
    if _RECORDING:
        return _RECORDING[-1]
    if _profiler._is_profiler_enabled:
        return _AMBIENT
    return None


def _current() -> _Session:
    """The session ``summary``, ``records`` and ``clear`` act on."""
    return _RECORDING[-1] if _RECORDING else _AMBIENT


class _Open:
    """The context of one recorded span."""

    __slots__ = ("session", "span", "device", "stream", "annotation")

    def __init__(self, session: _Session, name: str, device, attrs: dict):
        self.session = session
        self.device = device
        self.span = Span(name, next(session.ids), None, None, 0, attrs=attrs)
        self.stream = self.annotation = None

    def __enter__(self) -> Span:
        s, sp = self.session, self.span
        parent = s.open[-1] if s.open else None
        if parent is not None:
            sp.parent, sp.root = parent.id, parent.root
        if sp.name == ROOT:
            sp.root = sp.id
        if _profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(sp.name)
            self.annotation.__enter__()
        s.open.append(sp)
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            sp._events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            sp._events[0].record(self.stream)
        sp.start_ns = time.perf_counter_ns()
        return sp

    def __exit__(self, *exc) -> None:
        sp = self.span
        if sp._events is not None:
            sp._events[1].record(self.stream)
        sp.end_ns = time.perf_counter_ns()
        self.session.open.pop()
        self.session.spans.append(sp)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)


def span(name: str, *, device=None, **attrs):
    """A context manager that records one span named ``name`` while a
    session records (see the module's docstring), with device time on a
    ``cuda`` ``device``; else the shared null context."""
    session = _active()
    if session is None:
        return _NULL
    if name == ROOT and session.open and session.open[-1].root is not None:
        return _NULL  # a call inside a call: not a second root
    if device is not None and (torch.device(device).type != "cuda"
                               or not torch.cuda.is_available()):
        device = None
    return _Open(session, name, device, attrs)


def spanned(name: str):
    """A decorator: each call of the function runs inside ``span(name)``
    (host time only)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _active() is None:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while a session records."""
    session = _active()
    if session is None:
        return
    session.counters[name] = session.counters.get(name, 0) + n
    if session.open:
        top = session.open[-1].counters
        top[name] = top.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record into a fresh session inside; yields nothing (read it with
    ``summary`` or ``records`` inside, before it closes)."""
    session = _Session()
    _RECORDING.append(session)
    try:
        yield
    finally:
        _RECORDING.remove(session)


def clear() -> None:
    """Empty the current session (the innermost open ``recording()``, or
    the ambient one)."""
    _current().clear()


def _resolve(spans: list[Span]) -> None:
    """Read the device time of every span whose events are still held."""
    pending = [sp for sp in spans if sp._events is not None]
    if not pending:
        return
    torch.cuda.synchronize()
    for sp in pending:
        start, end = sp._events
        sp.device_s = start.elapsed_time(end) / 1e3
        sp._events = None


def records() -> list[Span]:
    """The closed spans of the current session, in the order they closed,
    their device times read."""
    spans = _current().spans
    _resolve(spans)
    return list(spans)


def summary() -> dict:
    """The current session by span name: ``{"spans": {name: {"count",
    "host_s", "self_host_s", "device_s"}}, "counters": {name: total}}``.
    ``self_host_s`` is the host time less what the span's children cover;
    ``device_s`` is None where no span of the name recorded device time."""
    session = _current()
    spans = records()
    children: dict[int, float] = {}
    for sp in spans:
        if sp.parent is not None:
            children[sp.parent] = children.get(sp.parent, 0.0) + sp.host_s
    out: dict[str, dict] = {}
    for sp in spans:
        row = out.setdefault(sp.name, {"count": 0, "host_s": 0.0,
                                       "self_host_s": 0.0, "device_s": None})
        row["count"] += 1
        row["host_s"] += sp.host_s
        row["self_host_s"] += sp.host_s - children.get(sp.id, 0.0)
        if sp.device_s is not None:
            row["device_s"] = (row["device_s"] or 0.0) + sp.device_s
    return {"spans": out, "counters": dict(session.counters)}

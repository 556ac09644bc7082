"""Step cost analysis: FLOPs, bytes, collectives and memory of a call.

The port of ``repro/analysis/hlo.py``.  The reference parses a compiled
step's HLO text and weights each while body by its trip count; the port
has no HLO, so it counts the call itself as it runs:

* ``CostCounter``, a ``TorchDispatchMode``, sees every aten op the call
  dispatches (autograd's backward included).  For each op that is not a
  view or a metadata op it counts the bytes the op moves (the port runs
  eager and unfused, so each op is a kernel over HBM; there is no
  on-chip threshold): its tensor inputs read and its outputs written,
  except that a destination an op only overwrites (``copy_``,
  ``fill_``, ``zero_``, an ``out=`` tensor) is not read, and that
  indexed ops are charged as ``analyze_hlo`` charges them: a gather or
  slice copy (``index``, ``gather``, ``index_select``, ``embedding``,
  ...) twice its result, an indexed write (``index_put_``, the
  ``scatter`` family, ``index_add_``, ``slice_scatter``, ...) twice the
  values it writes, at most twice its result.  And for every matrix
  product (``mm``, ``addmm``, ``bmm``, ``baddbmm``, which ``matmul`` and
  ``einsum`` lower to, and ``addmm_``, ``baddbmm_``) 2·M·N·K FLOP — the
  reference's ``dot`` rule, with the formulas of
  ``torch.utils.flop_counter``.
* The four hand-written kernels are not torch ops: each wrapper of
  ``kernels/ops.py`` reports its function's work through
  ``kernel_call`` and suspends the counter inside, so the CUDA kernel,
  its plain version on the CPU and the shape-only route on ``meta``
  count the same.  ``kernel_call`` is also the span ``kernel.<name>``
  of ``analysis.spans``.
* ``core/grid.py``'s collectives report their result bytes
  (``report_collective``) under the reference's five kinds, with
  ``exchange`` as ``collective-permute``, plus ``broadcast``, and the
  recorder's counter ``grid.recv_bytes`` adds them up (``analysis.
  spans``); on an axis of one rank they are the identity and report
  nothing.
* Memory: the storages the call creates, and the frees of those it found,
  tracked with ``weakref.finalize``: the peak of live bytes, the
  counterpart of ``memory_analysis()``.

With a ``device`` the counter counts only the ops that touch a tensor on
that device, so host scratch (index maps built in numpy, scalar
constants) does not enter a count of the card's work.

Weighting, as ``analyze_hlo`` weights a loop body by its trip count:
``CostCounter.weighted(n)`` counts a block n times (one of n identical
microbatches), and ``extrapolate`` takes count(L) = count(1) + (L - 1) ·
(count(2) - count(1)) from models of one and two identical units.  A
Python loop of identical steps over a sequence (the sLSTM's) asks
``loop_steps`` how many to run: all of them, unless a counter on
``meta`` samples loops (``sample_loops=n``), when it runs n and the loop
repeats its last output for the rest, so that count(trips) =
count(1) + (trips - 1) · (count(2) - count(1)), forward and backward.

``roofline`` and ``wire_bytes`` are the reference's formulas;
``DEFAULT_HW`` holds the card's peaks, not a TPU's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Any

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis import spans

__all__ = [
    "COLLECTIVE_OPS",
    "CostCounter",
    "DEFAULT_HW",
    "HW",
    "MemoryCost",
    "RooflineReport",
    "WeightedCost",
    "active_counter",
    "analyze_step",
    "extrapolate",
    "kernel_call",
    "loop_steps",
    "report_collective",
    "roofline",
    "wire_bytes",
]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12  # bf16 dense FLOP/s per card
    hbm_bw: float = 3.35e12  # B/s per card
    ici_bw: float = 450e9  # B/s per direction between cards (NVLink)
    hbm_capacity: float = 80e9  # bytes of device memory
    peak_fp32_flops: float = 67e12  # fp32 FMA FLOP/s per card


#: NVIDIA H100 SXM5 80GB HBM3 at 700 W, from its data sheet: the peaks
#: ``chip_smoke.py`` bounds every kernel with
DEFAULT_HW = HW()

#: the reference's five collective kinds (``exchange`` is
#: ``collective-permute``), plus ``broadcast``
COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "broadcast",
)

_aten = torch.ops.aten

#: the reference's ``dot``: the matrix products ``matmul`` and ``einsum``
#: lower to, and the in-place updates of the engine's panels
_PRODUCTS = {p: flop_registry[p] for p in (_aten.mm, _aten.addmm, _aten.bmm,
                                           _aten.baddbmm)}
_PRODUCTS[_aten.addmm_] = _PRODUCTS[_aten.addmm]
_PRODUCTS[_aten.baddbmm_] = _PRODUCTS[_aten.baddbmm]

#: ops that alias their input without being marked views
_ALIASING = {_aten._unsafe_view, _aten._reshape_alias, _aten.alias,
             _aten.lift_fresh}

#: gathers and slice copies: they read what they return and write it, the
#: reference's ``gather`` and ``dynamic-slice`` (twice the result)
_GATHERS = {_aten.index, _aten.gather, _aten.index_select, _aten.embedding,
            _aten.take, _aten.narrow_copy, _aten.slice_copy,
            _aten.select_copy}

#: indexed writes, the reference's ``scatter`` and ``dynamic-update-slice``
#: (twice the values written, at most twice the result), by the argument
#: that says how many elements they write
_INDEX_PUTS = {_aten.index_put_, _aten.index_put, _aten._index_put_impl_}
_SCATTERS = {
    **dict.fromkeys((_aten.scatter, _aten.scatter_, _aten.scatter_add,
                     _aten.scatter_add_, _aten.scatter_reduce,
                     _aten.scatter_reduce_), "index"),
    **dict.fromkeys((_aten.index_add, _aten.index_add_, _aten.index_copy,
                     _aten.index_copy_), "source"),
    **dict.fromkeys((_aten.slice_scatter, _aten.select_scatter,
                     _aten.diagonal_scatter), "src"),
}

#: ops that overwrite their first argument without reading it
_OVERWRITES = {_aten.copy_, _aten.fill_, _aten.zero_}

#: ops that move no data: allocation and metadata (their new storages are
#: still tracked)
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided,
               _aten._local_scalar_dense, _aten.is_same_size,
               _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
               _aten.sym_storage_offset}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _arg(func, args, kwargs, name: str):
    """The argument ``name`` of a call of the aten op ``func``."""
    if name in kwargs:
        return kwargs[name]
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return args[i] if i < len(args) else a.default_value
    raise KeyError(name)


def _written_elements(func, args, kwargs) -> int:
    """How many elements an indexed write stores: an ``index_put``'s
    indexed positions (its long indices broadcast, times the dimensions
    they leave whole; a boolean index counts its values), a scatter's
    index, an ``index_add``'s source, a ``slice_scatter``'s source."""
    packet = func.overloadpacket
    if packet not in _INDEX_PUTS:
        return _arg(func, args, kwargs, _SCATTERS[packet]).numel()
    shape = _arg(func, args, kwargs, "self").shape
    indices = list(_arg(func, args, kwargs, "indices"))
    live = [i for i in indices if i is not None]
    if any(i.dtype == torch.bool for i in live):
        return _arg(func, args, kwargs, "values").numel()
    whole = [shape[d] for d, i in enumerate(indices) if i is None]
    return (math.prod(torch.broadcast_shapes(*(i.shape for i in live)))
            * math.prod(whole) * math.prod(shape[len(indices):]))


def _traffic(func, args, kwargs, outs) -> int:
    """The bytes an op moves (see the module's docstring)."""
    packet = func.overloadpacket
    written = sum(_nbytes(t) for t in outs)
    if packet in _GATHERS:
        return 2 * written
    if packet in _INDEX_PUTS or packet in _SCATTERS:
        item = _arg(func, args, kwargs, "self").element_size()
        return min(2 * _written_elements(func, args, kwargs) * item,
                   2 * written)
    reads = _tensors(args[1:] if packet in _OVERWRITES else args, [])
    reads = _tensors({k: v for k, v in kwargs.items() if k != "out"}, reads)
    return sum(_nbytes(t) for t in reads) + written


def _tensors(tree, out: list) -> list:
    """The tensors of ``tree`` (nested tuples, lists and dicts; a module's
    parameters and buffers), appended to ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, nn.Module):
        out.extend(tree.parameters())
        out.extend(tree.buffers())
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _storages(tensors) -> dict[int, int]:
    """The distinct storages behind ``tensors``: key -> bytes."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return seen


@dataclasses.dataclass
class WeightedCost:
    flops: float
    hbm_bytes: float
    coll_bytes_by_op: dict[str, float]
    coll_counts_by_op: dict[str, float]
    #: op name -> [calls, flops, bytes]; a kernel's name -> the same
    by_op: dict[str, list] = dataclasses.field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll_bytes_by_op.values())

    @property
    def wire_bytes(self) -> float:
        return wire_bytes(self.coll_bytes_by_op)

    def _combine(self, other: WeightedCost, s: float) -> WeightedCost:
        """``self + s * other``, term by term."""
        by_op = {k: list(v) for k, v in self.by_op.items()}
        for k, v in other.by_op.items():
            row = by_op.setdefault(k, [0.0, 0.0, 0.0])
            for i in range(3):
                row[i] += s * v[i]
        return WeightedCost(
            flops=self.flops + s * other.flops,
            hbm_bytes=self.hbm_bytes + s * other.hbm_bytes,
            coll_bytes_by_op={k: self.coll_bytes_by_op.get(k, 0.0)
                              + s * other.coll_bytes_by_op.get(k, 0.0)
                              for k in COLLECTIVE_OPS},
            coll_counts_by_op={k: self.coll_counts_by_op.get(k, 0.0)
                               + s * other.coll_counts_by_op.get(k, 0.0)
                               for k in COLLECTIVE_OPS},
            by_op=by_op,
        )


@dataclasses.dataclass
class MemoryCost:
    """The counterpart of ``compiled.memory_analysis()``: the bytes of the
    call's arguments and outputs (distinct storages), of the outputs that
    are argument storages (``alias_size_in_bytes``: updated in place, as
    a decode step's cache), and the most bytes live at once — the
    arguments (until freed) and what the call created (until freed).
    ``temp_size_in_bytes`` is that peak less the arguments and the
    outputs that are not among them, at least 0."""

    argument_size_in_bytes: float
    output_size_in_bytes: float
    peak_live_bytes: float
    alias_size_in_bytes: float = 0.0

    @property
    def temp_size_in_bytes(self) -> float:
        return max(0.0, self.peak_live_bytes - self.argument_size_in_bytes
                   - (self.output_size_in_bytes - self.alias_size_in_bytes))


def extrapolate(one, two, n: int):
    """count(n) = count(1) + (n - 1) · (count(2) - count(1)), for a
    ``WeightedCost`` or a ``MemoryCost`` of models of one and two
    identical units (for memory, a linear estimate)."""
    if isinstance(one, WeightedCost):
        return one._combine(two._combine(one, -1.0), float(n - 1))
    return MemoryCost(**{
        f.name: getattr(one, f.name) + (n - 1) * (
            getattr(two, f.name) - getattr(one, f.name))
        for f in dataclasses.fields(MemoryCost)})


def wire_bytes(bytes_by_op: dict[str, float], group: int = 16) -> float:
    """Per-device wire traffic from result-shape bytes.

    Ring-algorithm cost model per device (g = group size):
      all-gather:        result x (g-1)/g      (result is the gathered buf)
      all-reduce:        2 x result x (g-1)/g  (reduce-scatter + all-gather)
      reduce-scatter:    result x (g-1)        (result is the 1/g shard)
      all-to-all:        result x (g-1)/g
      collective-permute: result               (one hop)
      broadcast:         result                (one result per hop)
    """
    f = (group - 1) / group
    w = 0.0
    w += bytes_by_op.get("all-gather", 0.0) * f
    w += bytes_by_op.get("all-reduce", 0.0) * 2 * f
    w += bytes_by_op.get("reduce-scatter", 0.0) * (group - 1)
    w += bytes_by_op.get("all-to-all", 0.0) * f
    w += bytes_by_op.get("collective-permute", 0.0)
    w += bytes_by_op.get("broadcast", 0.0)
    return w


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_ACTIVE: list[CostCounter] = []


def active_counter() -> CostCounter | None:
    """The innermost counter counting now (None outside one, or while a
    kernel wrapper has suspended it)."""
    if not _ACTIVE or _ACTIVE[-1]._paused:
        return None
    return _ACTIVE[-1]


class _KernelCall:
    def __init__(self):
        self.work = None

    def report(self, flops: float, reads, writes, extra_bytes: int = 0
               ) -> None:
        """The kernel's function: its FLOP, the tensors it reads and the
        ones it writes (each read or written once), and ``extra_bytes``
        it reads from the host (an index map)."""
        self.work = (float(flops), list(reads), list(writes), extra_bytes)


@contextlib.contextmanager
def kernel_call(name: str, device=None):
    """Around a kernel wrapper's body: the span ``kernel.<name>`` (with
    device time on a ``cuda`` ``device``, ``analysis.spans``); suspends the
    active counter (the plain version's torch ops, the launch's host work
    and the shape-only route count nothing), then adds what the body
    ``report``-ed under ``name``."""
    counter = active_counter()
    call = _KernelCall()
    with spans.span("kernel." + name, device=device):
        if counter is None:
            yield call
            return
        counter._paused += 1
        try:
            yield call
        finally:
            counter._paused -= 1
    if call.work is not None:
        counter._add_kernel(name, *call.work)


@contextlib.contextmanager
def paused():
    """Count nothing inside (a collective's transfer: its bytes are
    reported as the collective's, by ``report_collective``)."""
    counter = active_counter()
    if counter is None:
        yield
        return
    counter._paused += 1
    try:
        yield
    finally:
        counter._paused -= 1


def loop_steps(trips: int) -> int:
    """How many of a loop's ``trips`` identical steps to run: all, unless
    the active counter samples loops (then its ``sample_loops``, and the
    loop fills the remaining steps' outputs with its last one)."""
    counter = active_counter()
    if counter is None or counter.sample_loops is None:
        return trips
    counter.loop_trips.add(trips)
    return min(trips, counter.sample_loops)


def report_collective(kind: str, result: torch.Tensor) -> None:
    """A collective of ``kind`` (one of ``COLLECTIVE_OPS``) whose result on
    this rank is ``result``; its bytes also go to the recorder's
    ``grid.recv_bytes`` (``analysis.spans``)."""
    spans.count("grid.recv_bytes", _nbytes(result))
    counter = active_counter()
    if counter is not None and counter._on_device((result,)):
        counter._add_collective(kind, _nbytes(result))


class CostCounter(TorchDispatchMode):
    """Counts what the ops dispatched inside it do (see the module's
    docstring); ``device`` (a device or its type) limits the count to ops
    that touch a tensor on it.  ``sample_loops=n`` (on ``meta`` only, where
    values do not matter) runs n steps of each loop that asks
    ``loop_steps``; ``loop_trips`` collects the trip counts they asked
    with.

    Read ``cost()`` for the ``WeightedCost`` and ``peak_delta`` for the
    most bytes live at once above those live on entry."""

    def __init__(self, device=None, *, sample_loops: int | None = None):
        super().__init__()
        self.device_type = (None if device is None
                            else torch.device(device).type)
        if sample_loops is not None and self.device_type != "meta":
            raise ValueError("sample_loops changes values: meta only")
        self.sample_loops = sample_loops
        self.loop_trips: set[int] = set()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes = dict.fromkeys(COLLECTIVE_OPS, 0.0)
        self.coll_counts = dict.fromkeys(COLLECTIVE_OPS, 0.0)
        self.by_op: dict[str, list] = {}
        self.live_bytes = 0
        self.peak_delta = 0
        self._weight = 1.0
        self._paused = 0
        self._known: dict[int, weakref.finalize] = {}

    # -- context -------------------------------------------------------------

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)
            for fin in self._known.values():
                fin.detach()
            self._known.clear()

    @contextlib.contextmanager
    def weighted(self, weight: float):
        """Count what runs inside ``weight`` times (one of ``weight``
        identical repeats); memory is not weighted."""
        outer = self._weight
        self._weight = outer * weight
        try:
            yield self
        finally:
            self._weight = outer

    def cost(self) -> WeightedCost:
        return WeightedCost(
            flops=self.flops, hbm_bytes=self.hbm_bytes,
            coll_bytes_by_op=dict(self.coll_bytes),
            coll_counts_by_op=dict(self.coll_counts),
            by_op={k: list(v) for k, v in self.by_op.items()},
        )

    # -- memory --------------------------------------------------------------

    def _on_device(self, tensors) -> bool:
        return self.device_type is None or any(
            t.device.type == self.device_type for t in tensors)

    def _free(self, key: int, nbytes: int) -> None:
        self._known.pop(key, None)
        self.live_bytes -= nbytes

    def track(self, tensors, *, created: bool) -> None:
        """Follow the storages of ``tensors`` not seen yet: ``created`` by
        the call (their bytes go live), or live on entry (their free takes
        bytes off)."""
        for t in tensors:
            if self.device_type is not None and \
                    t.device.type != self.device_type:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            nbytes = st.nbytes()
            self._known[key] = weakref.finalize(st, self._free, key, nbytes)
            if created:
                self.live_bytes += nbytes
        self.peak_delta = max(self.peak_delta, self.live_bytes)

    # -- counting ------------------------------------------------------------

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        w = self._weight
        self.flops += w * flops
        self.hbm_bytes += w * nbytes
        row = self.by_op.setdefault(name, [0.0, 0.0, 0.0])
        row[0] += w
        row[1] += w * flops
        row[2] += w * nbytes

    def _add_kernel(self, name, flops, reads, writes, extra_bytes) -> None:
        if not self._on_device(reads + writes):
            return
        self.track(reads, created=False)
        self.track(writes, created=True)
        self._add(name, flops,
                  sum(_nbytes(t) for t in reads + writes) + extra_bytes)

    def _add_collective(self, kind: str, nbytes: int) -> None:
        if kind not in self.coll_bytes:
            raise ValueError(f"collective {kind!r}; known: {COLLECTIVE_OPS}")
        self.coll_bytes[kind] += self._weight * nbytes
        self.coll_counts[kind] += self._weight

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or func.is_view or func.overloadpacket in _ALIASING:
            return out
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        if not self._on_device(ins + outs):
            return out
        self.track(ins, created=False)
        self.track(outs, created=True)
        packet = func.overloadpacket
        if packet in _NO_TRAFFIC:
            return out
        product = _PRODUCTS.get(packet)
        flops = product(*args, **kwargs, out_val=out) if product else 0
        self._add(str(packet), flops, _traffic(func, args, kwargs, outs))
        return out


def analyze_step(fn, *args, device=None, counter=None, **kw):
    """``fn(*args, **kw)`` under a ``CostCounter``: returns ``(out,
    WeightedCost, MemoryCost)``.  The count is limited to ``device``
    (default: that of the first tensor in ``args``, a module's parameters
    included), or runs under ``counter`` if one is given; the arguments'
    storages are those live on entry."""
    arg_tensors = _tensors(args, _tensors(kw, []))
    if device is None and arg_tensors:
        device = arg_tensors[0].device
    counter = counter if counter is not None else CostCounter(device)
    dev = [t for t in arg_tensors if counter._on_device((t,))]
    arg_storages = _storages(dev)
    argument = sum(arg_storages.values())
    with counter:
        counter.track(dev, created=False)
        out = fn(*args, **kw)
    outs = _storages(t for t in _tensors(out, []) if counter._on_device((t,)))
    mem = MemoryCost(
        argument_size_in_bytes=float(argument),
        output_size_in_bytes=float(sum(outs.values())),
        peak_live_bytes=float(argument + counter.peak_delta),
        alias_size_in_bytes=float(sum(b for k, b in outs.items()
                                      if k in arg_storages)))
    return out, counter.cost(), mem


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RooflineReport:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    bound_s: float

    def row(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def roofline(
    flops: float,
    hbm_bytes: float,
    coll_bytes: float,
    chips: int,
    model_flops: float = 0.0,
    hw: HW = DEFAULT_HW,
) -> RooflineReport:
    """Three-term roofline from *per-device* quantities."""
    compute_s = flops / hw.peak_flops
    memory_s = hbm_bytes / hw.hbm_bw
    collective_s = coll_bytes / hw.ici_bw
    terms = {
        "compute": compute_s,
        "memory": memory_s,
        "collective": collective_s,
    }
    dominant = max(terms, key=terms.get)
    useful = model_flops / (flops * chips) if flops else 0.0
    return RooflineReport(
        flops=flops,
        hbm_bytes=hbm_bytes,
        coll_bytes=coll_bytes,
        chips=chips,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=useful,
        bound_s=max(terms.values()),
    )

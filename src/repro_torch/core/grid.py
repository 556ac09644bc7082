"""The device grid SUMMA runs on: the port's counterpart of
``jax.sharding.Mesh`` and of ``repro.launch.mesh.make_mesh`` /
``make_host_mesh``.

The reference expresses every executor as one ``shard_map`` program over
a mesh.  Here each rank runs its own program on its own shards, and a
``Grid`` tells it where it sits: the axis names and their sizes, this
rank's coordinates, its device, and one ``torch.distributed`` process
group per set of axes — the ranks that differ from this one only along
those axes.  A grid has any number of axes (two, ``("data", "model")``,
unless its caller names others) laid out row-major like a mesh's device
array: the last axis varies fastest, so on a 2-axis grid rank ``r`` sits
at ``divmod(r, p_col)``.

An axis argument is one name or a tuple of names.  A tuple axis is the
product of its axes, ordered as a mesh orders one in a ``PartitionSpec``:
the first name is the most significant, so on ``("pod", "data",
"model")`` the index along ``("pod", "data")`` is ``pod * |data| +
data``.  ``axis_index``, the owner ranks of ``broadcast`` and the chunk
order of ``all_gather`` and ``reduce_scatter`` all follow that order.

Three ways to build one:

* ``Grid.local(device)`` — the 1x1 grid on one device (1x1x1 with three
  axis names).  It has no process group and its collectives are the
  identity.
* ``Grid.from_process_group(*sizes, device=..., axis_names=...)`` — a
  grid over an initialised ``torch.distributed`` world (gloo in the
  tests, NCCL on a multi-card host).
* ``Grid(sizes=...)`` — a planning-only grid: the planner reads only
  ``shape``, so plans for any grid can be built (and compared with the
  reference's) without processes; ``check_world`` refuses it at
  execution, and a collective over an axis with peers raises.

Every grid is on ``cuda`` unless its caller names another device: a grid
built without one never runs on the CPU.

A planning-only grid on ``meta`` is a *counting* grid: it stands for the
rank at its ``coords`` (the origin unless given) in a count of that
rank's program (``launch.dryrun``), so its collectives over an axis with
peers return ``meta`` results of the right shape (values do not exist on
``meta``) and report their bytes like any other.  A grid with processes
never counts.

A gloo group runs the collectives on ``cuda`` tensors too (two ranks on
one card, where NCCL refuses): gloo implements few of them for device
memory, so on a gloo group every collective copies its ``cuda`` buffers
to the host, runs there and copies the result back.  An NCCL group never
copies through the host.

Each collective over an axis with peers reports its result bytes on this
rank to the active ``analysis.cost.CostCounter`` (``exchange`` and
``ring_shift`` as a ``collective-permute`` per buffer received) and to
the recorder's ``grid.recv_bytes``, and runs in a span of the recorder
(``analysis.spans``): ``grid.<collective>`` around the call and
``grid.wait`` around each wait for its completion, host time only.  The
identity on an axis of one rank reports nothing and opens no span.

The collectives are not autograd-aware.  Five that are, each the
other's transpose in the backward:

* ``shard(x, axis, dim)`` — this rank's chunk of ``dim``; its gradient
  is gathered over ``axis``;
* ``gather(x, axis, dim)`` — ``all_gather``; its gradient is this rank's
  chunk of the whole one, which holds where every rank of ``axis`` sees
  the same cotangent (a computation the ranks repeat);
* ``fsdp_gather(x, axis, dim)`` — ``all_gather``; its gradient is the
  ``reduce_scatter`` of the cotangents, the sum over ``axis`` of each
  rank's part: a weight gathered for rows or heads that differ between
  the ranks (FSDP over the data axis);
* ``sum(x, axis)`` — ``all_reduce`` (the reference's ``psum``); its
  gradient is the whole one, on every rank;
* ``replicate(x, axis)`` — the identity; its gradient is summed over
  ``axis``: an input whose uses the ranks split among themselves.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch
import torch.distributed as dist

from repro_torch.analysis import spans
from repro_torch.analysis.cost import paused, report_collective

__all__ = ["Grid"]


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    sizes: tuple[int, ...] = (1, 1)
    axis_names: tuple[str, ...] = ("data", "model")
    #: this rank's coordinate along each axis (None: the origin)
    coords: tuple[int, ...] | None = None
    device: torch.device = torch.device("cuda")
    #: frozenset of axis names -> process group of the ranks along those
    #: axes (absent: none)
    groups: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        sizes = tuple(int(s) for s in self.sizes)
        names = tuple(self.axis_names)
        coords = (0,) * len(sizes) if self.coords is None else tuple(
            int(c) for c in self.coords)
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(
                f"axis names {names} must be distinct, one per size {sizes}"
            )
        if len(coords) != len(sizes) or not all(
                0 <= c < s for c, s in zip(coords, sizes)):
            raise ValueError(f"coordinates {coords} outside grid {sizes}")
        object.__setattr__(self, "device", torch.device(self.device))
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "coords", coords)

    @classmethod
    def local(cls, device="cuda", axis_names=("data", "model")) -> Grid:
        """The grid of one rank on one device (``"cuda"`` unless told
        otherwise), with one axis of size 1 per name."""
        names = tuple(axis_names)
        return cls(sizes=(1,) * len(names), axis_names=names,
                   device=torch.device(device))

    @classmethod
    def from_process_group(cls, *sizes: int, device="cuda",
                           axis_names=("data", "model")) -> Grid:
        """A grid of ``sizes`` (one per axis name) over the initialised
        default world, e.g. ``from_process_group(2, 4)`` or
        ``from_process_group(2, 2, 2, axis_names=("pod", "data",
        "model"))``.

        Every rank must call this, in the same order as its other
        ``new_group`` calls: the group of every set of axes is created on
        all ranks (a group of its own for the set of all axes too: the
        grid never holds the default group, whose object must not outlive
        ``destroy_process_group``).
        """
        if not dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is not initialised: call "
                "init_process_group(...) before Grid.from_process_group"
            )
        sizes = tuple(int(s) for s in sizes)
        names = tuple(axis_names)
        if len(names) != len(sizes):
            raise ValueError(f"grid {sizes} needs one axis name per size, "
                             f"got {names}")
        world = dist.get_world_size()
        if world != math.prod(sizes):
            raise ValueError(
                f"world size {world} != grid {'x'.join(map(str, sizes))}"
            )
        coords = _unravel(dist.get_rank(), sizes)
        groups = {}
        dims = range(len(sizes))
        for n in range(1, len(sizes) + 1):
            for subset in itertools.combinations(dims, n):
                if math.prod(sizes[d] for d in subset) == 1:
                    continue
                key = frozenset(names[d] for d in subset)
                rest = [d for d in dims if d not in subset]
                for fixed in itertools.product(*(range(sizes[d])
                                                 for d in rest)):
                    ranks = []
                    for moving in itertools.product(*(range(sizes[d])
                                                      for d in subset)):
                        at = dict(zip(rest, fixed)) | dict(zip(subset, moving))
                        ranks.append(_ravel([at[d] for d in dims], sizes))
                    group = dist.new_group(ranks)
                    if all(coords[d] == f for d, f in zip(rest, fixed)):
                        groups[key] = group
        return cls(sizes=sizes, axis_names=names, coords=coords,
                   device=torch.device(device), groups=groups)

    # -- geometry -------------------------------------------------------------

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``Mesh.shape`` (what the planner reads)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def rank(self) -> int:
        """This rank's place in the world (row-major over the axes)."""
        return _ravel(self.coords, self.sizes)

    def axis_size(self, axis) -> int:
        """The number of ranks along ``axis`` (a name or a tuple of names)."""
        return math.prod(self.sizes[d] for d in self._dims(axis))

    def axis_index(self, axis) -> int:
        """This rank's coordinate along ``axis``; along a tuple axis the
        first name is the most significant digit."""
        dims = self._dims(axis)
        return _ravel([self.coords[d] for d in dims],
                      [self.sizes[d] for d in dims])

    def rank_at(self, at: dict) -> int:
        """The world rank at this rank's coordinates with those along each
        axis of ``at`` (axis -> index along it) replaced."""
        coords = list(self.coords)
        for axis, index in at.items():
            dims = self._dims(axis)
            for d, c in zip(dims, _unravel(index, [self.sizes[d]
                                                   for d in dims])):
                coords[d] = c
        return _ravel(coords, self.sizes)

    def check_world(self) -> None:
        """Raise unless this grid can execute: a grid of more than one rank
        must span the initialised ``torch.distributed`` world exactly.  A
        planning-only grid (``Grid(sizes=...)`` with no world behind it)
        plans any grid but never runs a plan; a grid of one rank always
        runs; a counting grid counts one rank's program."""
        size = math.prod(self.sizes)
        if size == 1 or self.counting:
            return
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != size:
            raise ValueError(
                f"grid {'x'.join(map(str, self.sizes))} has {size} ranks but "
                f"the torch.distributed world has {world}: a planning-only "
                "grid cannot execute a plan"
            )

    def fingerprint(self) -> tuple:
        """What ``MatmulPlan.digest`` hashes in place of mesh devices."""
        return (self.axis_names, self.sizes, self.device.type)

    def _dims(self, axis) -> tuple[int, ...]:
        names = axis if isinstance(axis, tuple) else (axis,)
        for name in names:
            if name not in self.axis_names:
                raise ValueError(
                    f"axis {name!r} is not a grid axis {self.axis_names}"
                )
        return tuple(self.axis_names.index(name) for name in names)

    def _group(self, axis):
        group = self.groups.get(frozenset(self.axis_names[d]
                                          for d in self._dims(axis)))
        if group is None:
            raise RuntimeError(
                f"grid axis {axis!r} has {self.axis_size(axis)} ranks but no "
                "process group (planning-only grid): build the grid with "
                "Grid.from_process_group"
            )
        return group

    def _group_order(self, axis) -> list[int] | None:
        """The axis index of each member of ``axis``'s group in group-rank
        order (ascending world rank), or None where the two orders agree:
        a tuple axis whose names are not in the grid's order."""
        dims = self._dims(axis)
        if list(dims) == sorted(dims):
            return None
        return sorted(range(self.axis_size(axis)),
                      key=lambda i: self.rank_at({axis: i}))

    # -- collectives ----------------------------------------------------------

    @property
    def counting(self) -> bool:
        """Whether this is a counting grid (see the module's docstring): a
        planning-only grid on ``meta``."""
        return self.device.type == "meta" and not self.groups

    def _host(self, group, x: torch.Tensor) -> bool:
        """Whether a collective of ``group`` on ``x`` runs through host
        memory: a ``cuda`` tensor on a gloo group."""
        return x.device.type == "cuda" and dist.get_backend(group) == "gloo"

    def _transfer(self, axis, call, out: torch.Tensor, *ins) -> None:
        """``call(out, *ins, group=...)``, a ``torch.distributed``
        collective writing ``out``, on ``axis``'s group, counted as
        nothing (the collective reports its bytes itself): on a gloo group
        through host copies of ``cuda`` buffers, on a counting grid not at
        all (its ``out`` stays as allocated)."""
        if self.counting:
            return
        group = self._group(axis)
        with paused():
            if not self._host(group, out):
                call(out, *ins, group=group)
                return
            host = out.cpu()
            call(host, *(t.cpu() for t in ins), group=group)
            out.copy_(host)

    def broadcast(self, x: torch.Tensor, owner: int, axis, *,
                  async_op: bool = False):
        """``x`` as held by rank ``owner`` along ``axis``, on every rank of
        that axis.  Returns ``(tensor, work)``; with ``async_op`` the
        tensor is valid once ``work.wait()`` returned (``work`` is None
        when nothing was sent).  The owner's tensor is sent in place when
        it is contiguous (on a gloo group, a ``cuda`` buffer goes through
        a host copy)."""
        if self.axis_size(axis) == 1:
            return x, None
        with spans.span("grid.broadcast"):
            if self.axis_index(axis) == owner:
                buf = x.contiguous()
            else:
                buf = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            report_collective("broadcast", buf)
            if self.counting:
                return buf, None
            group = self._group(axis)
            with paused():
                host = buf.cpu() if self._host(group, buf) else buf
                work = dist.broadcast(
                    host, src=self.rank_at({axis: owner}), group=group,
                    async_op=async_op,
                )
            work = _Works([work] if work is not None else [], None,
                          (host, buf) if host is not buf else None)
            if async_op:
                return buf, work
            work.wait()
            return buf, None

    def all_gather(self, x: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim``, in axis order (the
        reference's ``all_gather(..., tiled=True)``); on a gloo group a
        ``cuda`` ``x`` goes through host copies (``_transfer``)."""
        size = self.axis_size(axis)
        if size == 1:
            return x
        with spans.span("grid.all_gather"):
            x0 = x.movedim(dim, 0).contiguous()
            out = torch.empty((size * x0.shape[0], *x0.shape[1:]),
                              dtype=x.dtype, device=x.device)
            self._transfer(axis, dist.all_gather_into_tensor, out, x0)
            order = self._group_order(axis)
            if order is not None:  # chunk g holds axis index order[g]
                chunks = out.view(size, *x0.shape)
                out = torch.empty_like(chunks)
                out[order] = chunks
                out = out.view(size * x0.shape[0], *x0.shape[1:])
            report_collective("all-gather", out)
            return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, x: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """Sum every rank's ``x`` and keep this rank's slice of ``dim``, in
        axis order (the reference's ``psum_scatter(..., tiled=True)``);
        ``x.shape[dim]`` must divide by the axis size.  The identity on an
        axis of one rank; on a gloo group a ``cuda`` ``x`` goes through
        host copies (``_transfer``)."""
        size = self.axis_size(axis)
        if size == 1:
            return x
        x0 = x.movedim(dim, 0).contiguous()
        if x0.shape[0] % size:
            raise ValueError(
                f"dim {dim} of {tuple(x.shape)} does not divide by the "
                f"{size} ranks of axis {axis!r}"
            )
        with spans.span("grid.reduce_scatter"):
            order = self._group_order(axis)
            if order is not None:  # group rank g receives index order[g]
                x0 = x0.view(size, -1, *x0.shape[1:])[order].flatten(0, 1)
            out = torch.empty(
                (x0.shape[0] // size, *x0.shape[1:]), dtype=x.dtype,
                device=x.device,
            )
            self._transfer(axis, dist.reduce_scatter_tensor, out, x0)
            report_collective("reduce-scatter", out)
            return out.movedim(0, dim).contiguous()

    def all_reduce(self, x: torch.Tensor, axis, op: str = "sum"
                   ) -> torch.Tensor:
        """The sum (``op="sum"``, the reference's ``psum``) or the
        elementwise maximum (``op="max"``, its ``pmax``) of every rank's
        ``x`` along ``axis``, as a new tensor; the identity on an axis of
        one rank.  On a gloo group a ``cuda`` ``x`` goes through a host
        copy (``_transfer``)."""
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        if op not in ops:
            raise ValueError(f"op={op!r}; known: {sorted(ops)}")
        if self.axis_size(axis) == 1:
            return x
        with spans.span("grid.all_reduce"):
            out = x.clone(memory_format=torch.contiguous_format)
            self._transfer(axis, lambda t, group: dist.all_reduce(
                t, op=ops[op], group=group), out)
            report_collective("all-reduce", out)
            return out

    def ring_shift(self, x: torch.Tensor, axis, *, async_op: bool = False):
        """The ``x`` of the previous rank along ``axis`` (index - 1, mod
        its size): every rank sends its ``x`` to the next one, the
        reference's ``ppermute`` with the permutation i -> i + 1.  Returns
        ``(buffer, work)``; with ``async_op`` the buffer is valid once
        ``work.wait()`` returned (``work`` is None when nothing was sent:
        on an axis of one rank the buffer is ``x``).  On a gloo group a
        ``cuda`` ``x`` travels through host copies."""
        size = self.axis_size(axis)
        if size == 1:
            return x, None
        with spans.span("grid.ring_shift"):
            send = x.contiguous()
            buf = torch.empty_like(send)
            report_collective("collective-permute", buf)
            if self.counting:
                return buf, None
            self.check_world()
            me = self.axis_index(axis)
            with paused():
                host = self._host(self._group(axis), send)
                h_send, h_buf = (send.cpu(), torch.empty(
                    send.shape, dtype=send.dtype)) if host else (send, buf)
                work = _Works([
                    dist.irecv(h_buf,
                               src=self.rank_at({axis: (me - 1) % size})),
                    dist.isend(h_send,
                               dst=self.rank_at({axis: (me + 1) % size})),
                ], h_send, (h_buf, buf) if host else None)
            if async_op:
                return buf, work
            work.wait()
            return buf, None

    # -- collectives that autograd sees (see the module's docstring) ----------

    def shard(self, x: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """This rank's chunk of ``x`` along ``dim``, in axis order; its
        gradient is gathered over ``axis``."""
        return _Transposed.apply(x, self, axis, dim, ("slice", "gather"))

    def gather(self, x: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """``all_gather(x, axis, dim)``; its gradient is this rank's
        chunk of the whole one."""
        return _Transposed.apply(x, self, axis, dim, ("gather", "slice"))

    def fsdp_gather(self, x: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """``all_gather(x, axis, dim)``; its gradient is the
        ``reduce_scatter`` of the cotangents over ``axis`` (every rank's
        contribution summed, this rank's chunk kept)."""
        return _Transposed.apply(x, self, axis, dim, ("gather", "scatter"))

    def sum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``all_reduce(x, axis)``; its gradient is the whole one."""
        return _Transposed.apply(x, self, axis, 0, ("sum", "identity"))

    def replicate(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``x``; its gradient is summed over ``axis``."""
        return _Transposed.apply(x, self, axis, 0, ("identity", "sum"))

    def _collective(self, kind: str, x: torch.Tensor, axis, dim: int
                    ) -> torch.Tensor:
        if kind == "identity":
            return x
        if kind == "sum":
            return self.all_reduce(x, axis)
        if kind == "gather":
            return self.all_gather(x, axis, dim)
        if kind == "scatter":
            return self.reduce_scatter(x, axis, dim)
        size = self.axis_size(axis)
        if size == 1:
            return x
        if x.shape[dim] % size:
            raise ValueError(
                f"dim {dim} of {tuple(x.shape)} does not divide by the "
                f"{size} ranks of axis {axis!r}"
            )
        n = x.shape[dim] // size
        # a copy of its own: a view would keep the whole tensor alive
        return x.narrow(dim, self.axis_index(axis) * n, n).clone(
            memory_format=torch.contiguous_format)

    def exchange(self, sends, recvs) -> int:
        """Point-to-point transfers between world ranks: every ``(rank,
        tensor)`` of ``sends`` goes to that rank, and every ``(rank,
        buffer)`` of ``recvs`` (contiguous) is filled from that rank; each
        pair of ranks exchanges at most one tensor each way.  All are
        posted before any is waited on (on a gloo world, ``cuda`` buffers
        travel through host copies).  Returns the bytes received."""
        self.check_world()

        def staged(t):
            return (t.cpu() if t.device.type == "cuda"
                    and dist.get_backend() == "gloo" else t)

        with spans.span("grid.exchange"):
            sends = [(peer, t.contiguous()) for peer, t in sends]
            with paused():
                sends = [(peer, staged(t)) for peer, t in sends]
                h_recvs = [(peer, staged(buf)) for peer, buf in recvs]
                works = [dist.irecv(buf, src=peer) for peer, buf in h_recvs]
                works += [dist.isend(t, dst=peer) for peer, t in sends]
                with spans.span("grid.wait"):
                    for work in works:
                        work.wait()
                for (_, buf), (_, h_buf) in zip(recvs, h_recvs):
                    if h_buf is not buf:
                        buf.copy_(h_buf)
            for _, buf in recvs:
                report_collective("collective-permute", buf)
            return sum(buf.numel() * buf.element_size() for _, buf in recvs)


class _Works:
    """Works waited on together; keeps the sent tensor alive until then
    and, for a collective through host memory, copies the host buffer
    into the device one (``copy``: ``(host, device)``) once they are
    done."""

    def __init__(self, works, keep, copy=None):
        self.works, self.keep, self.copy = works, keep, copy

    def wait(self) -> None:
        with spans.span("grid.wait"):
            for work in self.works:
                work.wait()
            if self.copy is not None:
                with paused():
                    self.copy[1].copy_(self.copy[0])
        self.keep = self.copy = None


class _Transposed(torch.autograd.Function):
    """A collective of ``kinds[0]`` whose backward is ``kinds[1]``."""

    @staticmethod
    def forward(ctx, x, grid, axis, dim, kinds):
        ctx.grid, ctx.axis, ctx.dim, ctx.kind = grid, axis, dim, kinds[1]
        out = grid._collective(kinds[0], x, axis, dim)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return (ctx.grid._collective(ctx.kind, g, ctx.axis, ctx.dim),
                None, None, None, None)


def _ravel(coords, sizes) -> int:
    """Row-major index of ``coords`` in a box of ``sizes``."""
    out = 0
    for c, s in zip(coords, sizes):
        out = out * s + c
    return out


def _unravel(index: int, sizes) -> tuple[int, ...]:
    """The inverse of ``_ravel``."""
    out = []
    for s in reversed(list(sizes)):
        index, c = divmod(index, s)
        out.append(c)
    return tuple(reversed(out))

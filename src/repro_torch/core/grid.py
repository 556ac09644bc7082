"""The 2-D device grid SUMMA runs on: the port's counterpart of
``jax.sharding.Mesh`` and of ``repro.launch.mesh.make_mesh`` /
``make_host_mesh``.

The reference expresses every executor as one ``shard_map`` program over
a mesh.  Here each rank runs its own program on its own shards, and a
``Grid`` tells it where it sits: the two axis names (row axis first) and
their sizes, this rank's (row, col) coordinates, its device, and one
``torch.distributed`` process group per axis — the ranks that differ from
this one only along that axis.  Ranks are laid out row-major, rank
``r`` at ``divmod(r, p_col)``, like a mesh's device array.

Three ways to build one:

* ``Grid.local(device)`` — the 1x1 grid on one device.  It has no process
  group and its collectives are the identity.
* ``Grid.from_process_group(p_row, p_col, device=...)`` — a p_row x p_col
  grid over an initialised ``torch.distributed`` world (gloo in the tests,
  NCCL on a multi-card host).
* ``Grid(sizes=(p_row, p_col))`` — a planning-only grid: the planner reads
  only ``shape``, so plans for any grid can be built (and compared with
  the reference's) without processes; ``check_world`` refuses it at
  execution, and a collective over an axis with peers raises.

Every grid is on ``cuda`` unless its caller names another device: a grid
built without one never runs on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

__all__ = ["Grid"]


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    sizes: tuple[int, int] = (1, 1)
    axis_names: tuple[str, str] = ("data", "model")
    coords: tuple[int, int] = (0, 0)
    device: torch.device = torch.device("cuda")
    #: axis name -> process group of the ranks along that axis (None: none)
    groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def local(cls, device="cuda", axis_names=("data", "model")) -> Grid:
        """The 1x1 grid on one device (``"cuda"`` unless told otherwise)."""
        return cls(axis_names=tuple(axis_names), device=torch.device(device))

    @classmethod
    def from_process_group(
        cls, p_row: int, p_col: int, *, device="cuda",
        axis_names=("data", "model"),
    ) -> Grid:
        """A ``p_row x p_col`` grid over the initialised default world.

        Every rank must call this, in the same order as its other
        ``new_group`` calls: each row group and each column group is
        created on all ranks.
        """
        if not dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is not initialised: call "
                "init_process_group(...) before Grid.from_process_group"
            )
        world = dist.get_world_size()
        if world != p_row * p_col:
            raise ValueError(
                f"world size {world} != grid {p_row}x{p_col}"
            )
        row, col = divmod(dist.get_rank(), p_col)
        along_col = along_row = None
        for i in range(p_row):  # ranks of grid row i vary along the col axis
            g = dist.new_group([i * p_col + j for j in range(p_col)])
            if i == row:
                along_col = g
        for j in range(p_col):  # ranks of grid column j vary along the row axis
            g = dist.new_group([i * p_col + j for i in range(p_row)])
            if j == col:
                along_row = g
        row_axis, col_axis = axis_names
        return cls(
            sizes=(p_row, p_col),
            axis_names=tuple(axis_names),
            coords=(row, col),
            device=torch.device(device),
            groups={row_axis: along_row, col_axis: along_col},
        )

    # -- geometry -------------------------------------------------------------

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``Mesh.shape`` (what the planner reads)."""
        return dict(zip(self.axis_names, self.sizes))

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self._dim(axis)]

    def check_world(self) -> None:
        """Raise unless this grid can execute: a grid of more than one rank
        must span the initialised ``torch.distributed`` world exactly.  A
        planning-only grid (``Grid(sizes=...)`` with no world behind it)
        plans any grid but never runs a plan; the 1x1 grid always runs."""
        size = self.sizes[0] * self.sizes[1]
        if size == 1:
            return
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != size:
            raise ValueError(
                f"grid {self.sizes[0]}x{self.sizes[1]} has {size} ranks but "
                f"the torch.distributed world has {world}: a planning-only "
                "grid cannot execute a plan"
            )

    def fingerprint(self) -> tuple:
        """What ``MatmulPlan.digest`` hashes in place of mesh devices."""
        return (self.axis_names, self.sizes, self.device.type)

    def _dim(self, axis) -> int:
        if axis not in self.axis_names:
            raise ValueError(
                f"axis {axis!r} is not a grid axis {self.axis_names}"
            )
        return self.axis_names.index(axis)

    def _group(self, axis: str):
        group = self.groups.get(axis)
        if group is None:
            raise RuntimeError(
                f"grid axis {axis!r} has {self.shape[axis]} ranks but no "
                "process group (planning-only grid): build the grid with "
                "Grid.from_process_group"
            )
        return group

    def _global_rank(self, axis: str, index: int) -> int:
        row, col = self.coords
        if self._dim(axis) == 0:
            row = index
        else:
            col = index
        return row * self.sizes[1] + col

    # -- collectives ----------------------------------------------------------

    def broadcast(self, x: torch.Tensor, owner: int, axis: str, *,
                  async_op: bool = False):
        """``x`` as held by rank ``owner`` along ``axis``, on every rank of
        that axis.  Returns ``(tensor, work)``; with ``async_op`` the
        tensor is valid once ``work.wait()`` returned (``work`` is None
        when nothing was sent).  The owner's tensor is sent in place when
        it is contiguous."""
        if self.shape[axis] == 1:
            return x, None
        group = self._group(axis)
        if self.axis_index(axis) == owner:
            buf = x.contiguous()
        else:
            buf = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        work = dist.broadcast(
            buf, src=self._global_rank(axis, owner), group=group,
            async_op=async_op,
        )
        return buf, work

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim``, in axis order (the
        reference's ``all_gather(..., tiled=True)``)."""
        size = self.shape[axis]
        if size == 1:
            return x
        group = self._group(axis)
        x0 = x.movedim(dim, 0).contiguous()
        out = torch.empty(
            (size * x0.shape[0], *x0.shape[1:]), dtype=x.dtype, device=x.device
        )
        dist.all_gather_into_tensor(out, x0, group=group)
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Sum every rank's ``x`` and keep this rank's slice of ``dim``, in
        axis order (the reference's ``psum_scatter(..., tiled=True)``);
        ``x.shape[dim]`` must divide by the axis size.  The identity on an
        axis of one rank."""
        size = self.shape[axis]
        if size == 1:
            return x
        group = self._group(axis)
        x0 = x.movedim(dim, 0).contiguous()
        if x0.shape[0] % size:
            raise ValueError(
                f"dim {dim} of {tuple(x.shape)} does not divide by the "
                f"{size} ranks of axis {axis!r}"
            )
        out = torch.empty(
            (x0.shape[0] // size, *x0.shape[1:]), dtype=x.dtype,
            device=x.device,
        )
        dist.reduce_scatter_tensor(out, x0, group=group)
        return out.movedim(0, dim).contiguous()

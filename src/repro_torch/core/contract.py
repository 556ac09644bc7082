"""Block-sparse tensor contractions lowered to the ``MatmulPlan`` engine.

The port of ``repro.core.contract``: the tensor front-end of the paper's
"step towards block-sparse **tensor** computing".  A binary einsum-style
contraction ``contract("abc,cd->abd", x, y)`` of :class:`BlockSparseTensor`
operands is executed by

1. parsing the spec into **batch / contracted / free** modes
   (:func:`parse_contraction`);
2. **matricizing** each operand on its device: modes merge in
   *block-lexicographic* order, so every tensor block maps to one
   contiguous matrix block and the merged dimension carries a real
   ``core.blocking.Tiling`` (the Kronecker product of the mode tilings).
   Where every merged mode is uniformly blocked the order is a
   permutation of the modes split into (block, offset) pairs, so
   matricization is one ``permute`` copy; otherwise it is a gather by the
   merged order's index.  Block masks and rank maps (numpy) matricize by
   the same reshape, exactly;
3. executing the matricized product through ``DistributedMatmul``:
   masked products through ``bsmm``, all-live ones through
   ``tiled_matmul``, ``RankCSR`` operands through the factor route
   (``grouped_gemm``), and nonuniform merged tilings through
   ``NonuniformMatmul``;
4. un-matricizing C and *inferring its block mask* (the boolean product
   of the operand masks), so results chain as block-sparse tensors.

:func:`contract_chain` plans every step of a chain, simulates the union
task graph of the consecutive products (``sched.taskgraph.
chain_graphs``), optionally tunes the per-step windows jointly
(``sched.tuner.tune_chain``) and executes the steps with them.

Step programs.  A contraction step, a batch group and a whole chain run
as cached programs in ``DistributedMatmul._contract_cache``, keyed by the
step's structure (spec, tilings, masks, ranks), the dtypes and the
kernel autotune cache's fingerprint.  Building one plans its products
once (the reference's trace); calling it runs matricization, the planned
products (with ``compiled=False``: inside a step the engine runs eagerly,
as the reference's ``execute_plan`` does under a trace) and
un-matricization, with no planning.  A program holds structure, never
data.  ``DistributedMatmul(compiled=False)`` runs every step eagerly;
both routes launch the same kernels on the same operands, so they agree
bitwise.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.core import blocking as bk
from repro_torch.core.plan import mask_key, rank_key
from repro_torch.core.sparsity import BlockRankMap, RankCSR

__all__ = [
    "ContractionSpec",
    "parse_contraction",
    "BlockSparseTensor",
    "expand_block_mask",
    "matricize_mask",
    "unmatricize_mask",
    "merge_tilings",
    "contract",
    "contract_chain",
]


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ContractionSpec:
    """A parsed binary contraction ``"<x>,<y>-><out>"``.

    * ``batch`` — modes in x, y AND the output (einsum batch dims);
    * ``contracted`` — modes in x and y but not the output (summed);
    * ``free_x`` / ``free_y`` — modes of one operand surviving to the
      output.  Orders are the appearance order in the owning operand
      (``contracted`` uses x's order; y is transposed to match).
    """

    x_modes: tuple[str, ...]
    y_modes: tuple[str, ...]
    out_modes: tuple[str, ...]
    batch: tuple[str, ...]
    contracted: tuple[str, ...]
    free_x: tuple[str, ...]
    free_y: tuple[str, ...]

    @property
    def spec(self) -> str:
        return (
            f"{''.join(self.x_modes)},{''.join(self.y_modes)}"
            f"->{''.join(self.out_modes)}"
        )


def parse_contraction(spec: str) -> ContractionSpec:
    """Parse ``"abc,cd->abd"`` into batch / contracted / free modes.

    Exactly two inputs and an explicit output are required; a mode may
    appear at most once per operand (no internal traces), and every
    output mode must come from an input.  Modes of one input absent from
    the output would need a sum-reduction and are rejected — this is a
    *contraction* front-end, not full einsum.
    """
    if "->" not in spec:
        raise ValueError(
            f"contraction spec {spec!r} needs an explicit output "
            "('ab,bc->ac'); implicit-output einsum is not supported"
        )
    inputs, out = spec.replace(" ", "").split("->")
    parts = inputs.split(",")
    if len(parts) != 2:
        raise ValueError(
            f"spec {spec!r} must contract exactly two operands, "
            f"got {len(parts)}"
        )
    xm, ym = tuple(parts[0]), tuple(parts[1])
    om = tuple(out)
    for name, modes in (("x", xm), ("y", ym), ("output", om)):
        if len(set(modes)) != len(modes):
            raise ValueError(
                f"repeated mode in {name} of {spec!r}: internal traces "
                "are not supported"
            )
        bad = [m for m in modes if not m.isalpha()]
        if bad:
            raise ValueError(f"non-letter modes {bad} in {spec!r}")
    xs, ys, os_ = set(xm), set(ym), set(om)
    if not os_ <= (xs | ys):
        raise ValueError(
            f"output modes {sorted(os_ - xs - ys)} of {spec!r} appear in "
            "no input"
        )
    dropped = sorted((xs ^ ys) - os_)
    if dropped:
        raise ValueError(
            f"modes {dropped} of {spec!r} appear in one input but not the "
            "output: sum-reductions are not supported"
        )
    batch = tuple(m for m in xm if m in ys and m in os_)
    contracted = tuple(m for m in xm if m in ys and m not in os_)
    free_x = tuple(m for m in xm if m not in ys)
    free_y = tuple(m for m in ym if m not in xs)
    if not contracted:
        raise ValueError(
            f"spec {spec!r} contracts no mode (outer products are not "
            "supported; use a contraction with at least one summed mode)"
        )
    return ContractionSpec(
        x_modes=xm, y_modes=ym, out_modes=om,
        batch=batch, contracted=contracted,
        free_x=free_x, free_y=free_y,
    )


# ---------------------------------------------------------------------------
# the tensor container
# ---------------------------------------------------------------------------


def _as_tiling(t) -> bk.Tiling:
    if isinstance(t, bk.Tiling):
        return t
    return bk.Tiling(tuple(int(s) for s in t))


def _block_sums(x: torch.Tensor, tilings) -> torch.Tensor:
    """``x`` summed over each block of ``tilings`` (one per dim), on its
    device, in a fixed order (no atomics)."""
    for axis, t in enumerate(tilings):
        x = torch.stack([
            x.narrow(axis, o, s).sum(axis)
            for o, s in zip(t.offsets, t.sizes)
        ], axis)
    return x


@dataclasses.dataclass
class BlockSparseTensor:
    """A dense-stored tensor with per-mode block tilings and block structure.

    * ``data`` — the dense ``torch.Tensor`` on any device (numpy arrays
      are wrapped; ``None`` only when ``rank_csr`` supplies a factor
      payload); ``contract`` moves it to the grid's device;
    * ``tilings`` — one :class:`core.blocking.Tiling` per mode, possibly
      nonuniform ("physics-driven" extents, paper §4.1);
    * ``mask`` — optional bool numpy array over the block grid
      (``tuple(t.num_blocks for t in tilings)``); ``None`` = all blocks
      present;
    * ``ranks`` — optional int array over the same grid refining the mask
      into per-block numerical ranks (0 = screened out); dense-stored, so
      it drives cost/pruning only;
    * ``rank_csr`` — optional factorized payload (2-D tensors only): the
      operand *is* the factorization, executed through
      ``execute_rank_plan``;
    * ``norms`` — optional float array over the block grid of per-block
      Frobenius norms (:meth:`block_norms` computes them from the data
      when absent).  Contraction results propagate *bounds* here
      (``||C_ij|| <= sum_k ||A_ik||.||B_kj||``), which is what lets
      ``filter_eps`` chains get progressively sparser.
    """

    data: torch.Tensor | None
    tilings: tuple[bk.Tiling, ...]
    mask: np.ndarray | None = None
    ranks: np.ndarray | None = None
    rank_csr: RankCSR | None = None
    norms: np.ndarray | None = None

    def __post_init__(self):
        self.tilings = tuple(_as_tiling(t) for t in self.tilings)
        if self.data is not None and not isinstance(self.data, torch.Tensor):
            data = np.asarray(self.data)
            # a read-only array (e.g. one exported by another framework)
            # is copied: torch tensors are writable
            self.data = torch.as_tensor(
                data if data.flags.writeable else data.copy()
            )
        if self.rank_csr is not None:
            if self.data is not None:
                raise ValueError(
                    "pass data=None with a rank_csr payload: the "
                    "factorization is the tensor (use rank_csr.to_dense())"
                )
            if len(self.tilings) != 2:
                raise ValueError(
                    "rank_csr payloads are 2-D (matricized) structures; "
                    f"got {len(self.tilings)} modes"
                )
            if self.mask is not None or self.ranks is not None:
                raise ValueError(
                    "rank_csr carries its own structure; do not also pass "
                    "mask/ranks"
                )
            want = (
                self.rank_csr.csr.m_blocks * self.rank_csr.bm,
                self.rank_csr.csr.n_blocks * self.rank_csr.bk,
            )
            if self.shape != want:
                raise ValueError(
                    f"tilings extent {self.shape} != rank_csr shape {want}"
                )
        elif self.data is None:
            raise ValueError("data=None requires a rank_csr payload")
        elif tuple(self.data.shape) != self.shape:
            raise ValueError(
                f"data shape {tuple(self.data.shape)} != tilings "
                f"extents {self.shape}"
            )
        if self.mask is not None and self.ranks is not None:
            raise ValueError("pass either mask or ranks, not both")
        dtypes = {"mask": bool, "ranks": np.int32, "norms": np.float64}
        for name, dt in dtypes.items():
            arr = getattr(self, name)
            if arr is None:
                continue
            arr = np.asarray(arr)
            if arr.shape != self.block_grid:
                raise ValueError(
                    f"{name} shape {arr.shape} != block grid "
                    f"{self.block_grid}"
                )
            setattr(self, name, arr.astype(dt))

    # -- geometry ------------------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.tilings)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(t.extent for t in self.tilings)

    @property
    def block_grid(self) -> tuple[int, ...]:
        return tuple(t.num_blocks for t in self.tilings)

    @property
    def block_mask(self) -> np.ndarray:
        """The effective present/absent block mask (all-True if none)."""
        if self.rank_csr is not None:
            return self.rank_csr.rank_map().mask
        if self.ranks is not None:
            return self.ranks > 0
        if self.mask is not None:
            return self.mask
        return np.ones(self.block_grid, dtype=bool)

    def fill(self) -> float:
        """Live fraction of *elements* (block areas weighted — on
        nonuniform tilings this differs from the live-block count)."""
        if not self.tilings:  # 0-D result of a full contraction
            return 1.0
        mask = self.block_mask
        area = np.asarray(self.tilings[0].sizes, dtype=np.float64)
        for t in self.tilings[1:]:
            area = np.multiply.outer(area, np.asarray(t.sizes, np.float64))
        total = float(area.sum())
        return float((area * mask).sum() / total) if total else 0.0

    def block_norms(self) -> np.ndarray:
        """Per-block Frobenius norms over the block grid (numpy float64).

        Precomputed ``norms`` pass through; ``rank_csr`` payloads give
        theirs from the factors without densifying; dense data is reduced
        block by block in float64 on its own device, and only the norm
        grid comes to the host.  Dead blocks (mask / rank screened) report
        0, so norms agree with the effective structure.
        """
        if self.norms is not None:
            return self.norms
        if self.rank_csr is not None:
            from repro_torch.core.sparsity import rank_csr_norms

            return rank_csr_norms(self.rank_csr)
        if self.data is None:
            raise ValueError("block_norms needs data or precomputed norms")
        sq = _block_sums(self.data.to(torch.float64) ** 2, self.tilings)
        out = sq.sqrt().cpu().numpy()
        if self.mask is not None or self.ranks is not None:
            out = np.where(self.block_mask, out, 0.0)
        return out

    def to_dense(self) -> np.ndarray:
        """Dense numpy storage with masked blocks zeroed (the oracle view;
        bfloat16 data comes back as float32, which holds it exactly)."""
        if self.rank_csr is not None:
            return self.rank_csr.to_dense()
        data = self.data.detach()
        if data.dtype == torch.bfloat16:
            data = data.float()
        data = data.cpu().numpy()
        if self.mask is None and self.ranks is None:
            return data
        fine = expand_block_mask(self.block_mask, self.tilings)
        return np.where(fine, data, np.zeros((), data.dtype))

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_dense(
        cls,
        data,
        tilings=None,
        *,
        block_shape: tuple[int, ...] | None = None,
        mask: np.ndarray | None = None,
        ranks: np.ndarray | None = None,
    ) -> "BlockSparseTensor":
        """Wrap a dense tensor or array; ``block_shape`` builds uniform
        tilings."""
        if tilings is None:
            if block_shape is None:
                tilings = [bk.Tiling((d,)) for d in data.shape]
            else:
                tilings = [
                    bk.uniform_tiling(d, b)
                    for d, b in zip(data.shape, block_shape)
                ]
        return cls(
            data=data, tilings=tuple(tilings), mask=mask, ranks=ranks
        )

    @classmethod
    def from_rank_csr(cls, rank_csr: RankCSR) -> "BlockSparseTensor":
        """A 2-D tensor whose payload is the factorization itself."""
        tilings = (
            bk.uniform_tiling(
                rank_csr.csr.m_blocks * rank_csr.bm, rank_csr.bm
            ),
            bk.uniform_tiling(
                rank_csr.csr.n_blocks * rank_csr.bk, rank_csr.bk
            ),
        )
        return cls(data=None, tilings=tilings, rank_csr=rank_csr)


def _wrap(x) -> BlockSparseTensor:
    if isinstance(x, BlockSparseTensor):
        return x
    if isinstance(x, RankCSR):
        return BlockSparseTensor.from_rank_csr(x)
    return BlockSparseTensor.from_dense(torch.as_tensor(x))


def _on_device(t: BlockSparseTensor, device) -> BlockSparseTensor:
    """``t`` with its data on ``device`` (``t`` itself if it is there)."""
    if t.data is None or t.data.device == torch.device(device):
        return t
    return _with_data(t, t.data.to(device))


def expand_block_mask(
    mask: np.ndarray, tilings: tuple[bk.Tiling, ...]
) -> np.ndarray:
    """Element-resolution expansion of a block mask (nonuniform-aware)."""
    out = np.asarray(mask, dtype=bool)
    for axis, t in enumerate(tilings):
        out = np.repeat(out, t.sizes, axis=axis)
    return out


def _expand_block_mask_on(mask: np.ndarray, tilings, device) -> torch.Tensor:
    """:func:`expand_block_mask` built on ``device``."""
    out = torch.as_tensor(np.asarray(mask, bool), device=device)
    for axis, t in enumerate(tilings):
        sizes = torch.as_tensor(t.sizes, device=device)
        out = out.repeat_interleave(sizes, dim=axis)
    return out


# ---------------------------------------------------------------------------
# matricization: block-lexicographic mode merging
# ---------------------------------------------------------------------------


def merge_tilings(
    tilings: tuple[bk.Tiling, ...],
) -> tuple[bk.Tiling, np.ndarray | None]:
    """Merge mode tilings into one block-contiguous dimension.

    The natural row-major flatten of merged modes interleaves blocks
    (element ``(i1, i2)`` ↦ ``i1·E2 + i2`` scatters block ``(b1, b2)``
    into strided segments).  We instead order the merged dimension
    *block-lexicographically* — sort key ``(blk_1, …, blk_n, off_1, …,
    off_n)`` — so every tensor block occupies one contiguous range and
    the merged dimension is a genuine :class:`Tiling` whose sizes are
    the products of the per-mode block sizes in lexicographic block
    order (matching ``mask.reshape(-1)`` on the block grid).

    Returns ``(merged_tiling, perm)`` with ``perm[new] = old_flat_index``
    into the row-major flatten, or ``perm=None`` when the orders
    coincide (single mode, or any prefix of modes with one block each).
    """
    tilings = tuple(tilings)
    if not tilings:
        return bk.Tiling((1,)), None
    sizes = np.asarray(tilings[0].sizes, dtype=np.int64)
    for t in tilings[1:]:
        sizes = np.multiply.outer(sizes, np.asarray(t.sizes, np.int64))
    merged = bk.Tiling(tuple(int(s) for s in sizes.ravel()))
    if len(tilings) == 1 or all(
        t.num_blocks == 1 for t in tilings[1:]
    ):
        # trailing modes contribute a single block each, so every merged
        # block is already a contiguous row-major range
        return merged, None
    shape = tuple(t.extent for t in tilings)
    blk, off = [], []
    for axis, t in enumerate(tilings):
        ids = np.repeat(
            np.arange(t.num_blocks, dtype=np.int64), t.sizes
        )
        offs = (
            np.arange(t.extent, dtype=np.int64)
            - np.asarray(t.offsets, dtype=np.int64)[ids]
        )
        view = [1] * len(shape)
        view[axis] = -1
        blk.append(np.broadcast_to(ids.reshape(view), shape).ravel())
        off.append(np.broadcast_to(offs.reshape(view), shape).ravel())
    # lexsort: last key is primary -> (blk_1 … blk_n, off_1 … off_n)
    perm = np.lexsort(tuple(off[::-1]) + tuple(blk[::-1]))
    if np.array_equal(perm, np.arange(perm.size)):
        return merged, None
    return merged, perm


def matricize_mask(
    mask: np.ndarray,
    modes: tuple[str, ...],
    row_modes: tuple[str, ...],
    col_modes: tuple[str, ...],
) -> np.ndarray:
    """Reshape a block-grid array to the matricized 2-D block grid.

    Exact by construction: merged tilings order blocks
    lexicographically, which is precisely the row-major reshape of the
    transposed block grid.  Works for bool masks and int rank maps.
    """
    mask = np.asarray(mask)
    axes = [modes.index(m) for m in row_modes + col_modes]
    mt = np.transpose(mask, axes)
    rows = int(np.prod(mt.shape[: len(row_modes)], dtype=np.int64))
    return mt.reshape(max(rows, 1), -1)


def unmatricize_mask(
    mask2d: np.ndarray,
    row_modes: tuple[str, ...],
    col_modes: tuple[str, ...],
    grids: dict[str, int],
    out_modes: tuple[str, ...],
) -> np.ndarray:
    """Inverse of :func:`matricize_mask` onto ``out_modes`` order."""
    shape = tuple(grids[m] for m in row_modes) + tuple(
        grids[m] for m in col_modes
    )
    nd = np.asarray(mask2d).reshape(shape or (1,))
    if not shape:
        return nd
    cur = row_modes + col_modes
    return np.transpose(nd, [cur.index(m) for m in out_modes])


def _invert(perm: np.ndarray | None) -> np.ndarray | None:
    if perm is None:
        return None
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


def _take(x: torch.Tensor, idx: np.ndarray | None, axis: int):
    if idx is None:
        return x
    return x.index_select(axis, torch.as_tensor(idx, device=x.device))


@dataclasses.dataclass(frozen=True, eq=False)
class _Merge:
    """How the modes of one side merge into a matrix dimension.

    Where every mode is uniformly blocked and the block-lexicographic
    order differs from the row-major one, the merged order is the modes
    split into (blocks, block) pairs with the block indices first:
    ``split`` holds those pairs, and matricization is a ``permute``
    instead of a gather by ``perm``.
    """

    tiling: bk.Tiling
    perm: np.ndarray | None
    extents: tuple[int, ...]
    split: tuple[tuple[int, int], ...] | None

    @classmethod
    def of(cls, tilings: tuple[bk.Tiling, ...]) -> "_Merge":
        tiling, perm = merge_tilings(tilings)
        split = None
        if perm is not None and all(t.is_uniform for t in tilings):
            split = tuple((t.num_blocks, t.sizes[0]) for t in tilings)
        return cls(tiling, perm, tuple(t.extent for t in tilings), split)

    @property
    def dims(self) -> list[int]:
        """This side's dims in the split view (its extents if unsplit)."""
        if self.split is None:
            return list(self.extents)
        return [d for pair in self.split for d in pair]

    def order(self, base: int) -> list[int]:
        """Axes of the split view, from ``base``, in the merged order."""
        n = len(self.dims)
        if self.split is None:
            return list(range(base, base + n))
        return list(range(base, base + n, 2)) + list(range(base + 1,
                                                           base + n, 2))

    @property
    def gather(self) -> np.ndarray | None:
        return self.perm if self.split is None else None


def _to_matrix(x: torch.Tensor, rows: _Merge, cols: _Merge) -> torch.Tensor:
    """``x`` (row modes, then column modes) as the block-contiguous
    ``(R, C)`` matrix: at most one copy, then a gather where a side is
    nonuniform."""
    if rows.split is not None or cols.split is not None:
        x = x.reshape(rows.dims + cols.dims)
        x = x.permute(rows.order(0) + cols.order(len(rows.dims)))
    x = x.reshape(rows.tiling.extent, cols.tiling.extent)
    return _take(_take(x, rows.gather, 0), cols.gather, 1)


def _from_matrix(c2: torch.Tensor, rows: _Merge, cols: _Merge,
                 shape: tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`_to_matrix`, reshaped to ``shape``."""
    c2 = _take(c2, _invert(rows.gather), 0)
    c2 = _take(c2, _invert(cols.gather), 1)
    if rows.split is not None or cols.split is not None:
        dims = rows.dims + cols.dims
        order = rows.order(0) + cols.order(len(rows.dims))
        c2 = c2.reshape([dims[a] for a in order])
        c2 = c2.permute(list(np.argsort(order)))
    return c2.reshape(shape)


@dataclasses.dataclass(frozen=True, eq=False)
class _OperandGeom:
    """How one operand matricizes: transpose order, merged tilings, perms."""

    axes: tuple[int, ...]  # transpose order: row modes then col modes
    row_modes: tuple[str, ...]
    col_modes: tuple[str, ...]
    rows: _Merge
    cols: _Merge

    @property
    def row_tiling(self) -> bk.Tiling:
        return self.rows.tiling

    @property
    def col_tiling(self) -> bk.Tiling:
        return self.cols.tiling

    @property
    def row_perm(self) -> np.ndarray | None:
        return self.rows.perm

    @property
    def col_perm(self) -> np.ndarray | None:
        return self.cols.perm

    def matricize(self, data: torch.Tensor) -> torch.Tensor:
        return _to_matrix(data.permute(self.axes), self.rows, self.cols)

    @property
    def identity(self) -> bool:
        """True when matricization is a pure reshape (no data movement)."""
        return (
            self.axes == tuple(range(len(self.axes)))
            and self.row_perm is None
            and self.col_perm is None
        )


def _operand_geom(
    modes: tuple[str, ...],
    tilings: tuple[bk.Tiling, ...],
    row_modes: tuple[str, ...],
    col_modes: tuple[str, ...],
) -> _OperandGeom:
    tmap = dict(zip(modes, tilings))
    return _OperandGeom(
        axes=tuple(modes.index(m) for m in row_modes + col_modes),
        row_modes=row_modes, col_modes=col_modes,
        rows=_Merge.of(tuple(tmap[m] for m in row_modes)),
        cols=_Merge.of(tuple(tmap[m] for m in col_modes)),
    )


# ---------------------------------------------------------------------------
# one contraction step: geometry + planning + execution
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class _StepGeometry:
    """Everything static about one contraction: resolved once, cached."""

    spec: ContractionSpec
    x_geom: _OperandGeom
    y_geom: _OperandGeom
    a_mask2: np.ndarray | None  # matricized x mask (None = dense)
    b_mask2: np.ndarray | None
    a_ranks2: BlockRankMap | np.ndarray | None  # matricized rank map
    uniform: bool  # all three merged tilings uniform
    out_tilings: tuple[bk.Tiling, ...]
    out_mask: np.ndarray | None
    #: matricized inferred C mask (the spgemm symbolic pass), fed to the
    #: planner as ``c_mask`` on the uniform path; ``out_mask`` is its
    #: un-matricized twin
    c_mask2: np.ndarray | None
    out_row_perm_inv: np.ndarray | None
    out_col_perm_inv: np.ndarray | None
    tile: int
    #: the structural key this geometry is cached under; step programs
    #: key off it
    cache_key: tuple | None = None


def _uniform_block(t: bk.Tiling) -> int:
    return t.sizes[0]


def _step_geometry(
    spec: ContractionSpec,
    x: BlockSparseTensor,
    y: BlockSparseTensor,
    tile: int,
) -> _StepGeometry:
    if spec.batch:
        raise ValueError(
            "batch modes must be split before matricization "
            "(contract() handles this)"
        )
    if len(spec.x_modes) != x.ndim or len(spec.y_modes) != y.ndim:
        raise ValueError(
            f"spec {spec.spec!r} expects {len(spec.x_modes)}-D x / "
            f"{len(spec.y_modes)}-D y, got {x.ndim}-D / {y.ndim}-D"
        )
    xt = dict(zip(spec.x_modes, x.tilings))
    yt = dict(zip(spec.y_modes, y.tilings))
    # A structureless operand (no mask/ranks/factors — e.g. a raw array
    # wrapped with one block per mode) adopts its partner's blocking on
    # shared modes, so "masked tensor x raw array" just works.
    x_plain = x.mask is None and x.ranks is None and x.rank_csr is None
    y_plain = y.mask is None and y.ranks is None and y.rank_csr is None
    for m in spec.contracted:  # batch modes were split off in contract()
        if xt[m].sizes == yt[m].sizes:
            continue
        if x_plain and xt[m].num_blocks == 1:
            xt[m] = yt[m]
        elif y_plain and yt[m].num_blocks == 1:
            yt[m] = xt[m]
        else:
            raise ValueError(
                f"mode {m!r} tilings disagree between operands: "
                f"{xt[m].sizes} vs {yt[m].sizes}"
            )
    x_geom = _operand_geom(
        spec.x_modes, tuple(xt[m] for m in spec.x_modes),
        spec.free_x, spec.contracted,
    )
    y_geom = _operand_geom(
        spec.y_modes, tuple(yt[m] for m in spec.y_modes),
        spec.contracted, spec.free_y,
    )

    a_mask2 = b_mask2 = None
    a_ranks2 = None
    if x.rank_csr is None:
        if x.ranks is not None:
            r2 = matricize_mask(
                x.ranks, spec.x_modes, spec.free_x, spec.contracted
            ).astype(np.int32)
            if (
                x_geom.row_tiling.is_uniform
                and x_geom.col_tiling.is_uniform
            ):
                a_ranks2 = BlockRankMap(
                    ranks=r2,
                    bm=_uniform_block(x_geom.row_tiling),
                    bk=_uniform_block(x_geom.col_tiling),
                )
            else:
                # nonuniform merged tilings carry the rank map logically
                a_ranks2 = r2
        elif x.mask is not None:
            a_mask2 = matricize_mask(
                x.mask, spec.x_modes, spec.free_x, spec.contracted
            )
    if y.rank_csr is not None:
        raise NotImplementedError(
            "rank_csr payloads are supported on the first operand only "
            "(the planner factors A); densify y or swap the operands"
        )
    if y.ranks is not None:
        raise NotImplementedError(
            "per-block ranks on the second operand are not supported "
            "(the planner refines A only); pass a mask instead"
        )
    if y.mask is not None:
        b_mask2 = matricize_mask(
            y.mask, spec.y_modes, spec.contracted, spec.free_y
        )

    uniform = (
        x_geom.row_tiling.is_uniform
        and x_geom.col_tiling.is_uniform
        and y_geom.col_tiling.is_uniform
    )

    # -- output geometry + inferred mask -------------------------------------
    grids = {m: t.num_blocks for m, t in {**yt, **xt}.items()}
    out_tilings = tuple(
        {**yt, **xt}[m] for m in spec.out_modes
    )
    xmask = (
        np.ones(tuple(xt[m].num_blocks for m in spec.x_modes), bool)
        if x_plain else x.block_mask
    )
    ymask = (
        np.ones(tuple(yt[m].num_blocks for m in spec.y_modes), bool)
        if y_plain else y.block_mask
    )
    cm2 = None
    if x_plain and y_plain:
        out_mask = None
    else:
        # the symbolic pass is the single source of truth for the
        # inferred output structure; the planner's dead-output pruning
        # consumes the same boolean product (repro_torch.spgemm)
        from repro_torch.spgemm import output_mask as _output_mask

        am = matricize_mask(
            xmask, spec.x_modes, spec.free_x, spec.contracted
        )
        bm = matricize_mask(
            ymask, spec.y_modes, spec.contracted, spec.free_y
        )
        cm2 = _output_mask(am, bm)
        out_mask = unmatricize_mask(
            cm2, spec.free_x, spec.free_y, grids, spec.out_modes
        )
    return _StepGeometry(
        spec=spec,
        x_geom=x_geom,
        y_geom=y_geom,
        a_mask2=a_mask2,
        b_mask2=b_mask2,
        a_ranks2=a_ranks2,
        uniform=uniform,
        out_tilings=out_tilings,
        out_mask=out_mask,
        c_mask2=cm2,
        out_row_perm_inv=_invert(x_geom.row_perm),
        out_col_perm_inv=_invert(y_geom.col_perm),
        tile=tile,
    )


def _tensor_key(t: BlockSparseTensor) -> tuple:
    """Structural cache key: tilings + mask/rank content digests (the
    data itself never keys the geometry)."""
    return (
        tuple(tt.sizes for tt in t.tilings),
        mask_key(t.mask),
        None if t.ranks is None else (t.ranks.shape, t.ranks.tobytes()),
        rank_key(t.rank_csr),
    )


def _geometry_cached(mm, spec_str: str, x, y, tile: int) -> _StepGeometry:
    spec = parse_contraction(spec_str)
    stats = mm._cache_stats
    key = (spec.spec, _tensor_key(x), _tensor_key(y), tile)
    geom = mm._contract_cache.get(key)
    if geom is None:
        stats["geom_misses"] += 1
        geom = _step_geometry(spec, x, y, tile)
        geom.cache_key = key
        mm._contract_cache[key] = geom
    else:
        stats["geom_hits"] += 1
    return geom


def _nonuniform_front_end(mm, geom: _StepGeometry):
    """The bucketized adaptation for nonuniform merged tilings (cached)."""
    from repro_torch.core.api import NonuniformMatmul

    key = (
        "nmm",
        geom.x_geom.row_tiling.sizes,
        geom.x_geom.col_tiling.sizes,
        geom.y_geom.col_tiling.sizes,
        geom.tile,
    )
    nmm = mm._contract_cache.get(key)
    if nmm is None:
        nmm = NonuniformMatmul(
            mm,
            geom.x_geom.row_tiling,
            geom.x_geom.col_tiling,
            geom.y_geom.col_tiling,
            tile=geom.tile,
        )
        mm._contract_cache[key] = nmm
    return nmm


def _nonuniform_rank_map(geom: _StepGeometry, x: BlockSparseTensor):
    """Logical rank map feeding ``NonuniformMatmul`` pruning: explicit
    ranks pass through; a plain mask rides as full-rank-where-present
    (``physical_rank_map`` clamps to the tile extents)."""
    if geom.a_ranks2 is not None:
        r = geom.a_ranks2
        return np.asarray(r.ranks if isinstance(r, BlockRankMap) else r)
    if geom.a_mask2 is not None:
        return np.where(geom.a_mask2, np.int32(2**30), np.int32(0))
    if x.rank_csr is not None:
        raise NotImplementedError(
            "rank_csr payloads need uniform merged tilings; densify the "
            "operand for nonuniform mode extents"
        )
    return None


def _matricized_norms(
    t: BlockSparseTensor,
    modes: tuple[str, ...],
    rows: tuple[str, ...],
    cols: tuple[str, ...],
    og: _OperandGeom,
) -> np.ndarray:
    """Per-block Frobenius norms of one operand on its *matricized* block
    grid.

    Norms are data-dependent, so they are computed here at call time and
    never stored on the structurally-cached :class:`_StepGeometry`.
    Precomputed ``norms`` grids (chain intermediates, ``rank_csr``
    payloads) matricize by the exact block reshape; dense-stored data is
    matricized on its device and reduced block by block — this also
    covers plain operands whose blocking was adopted from the partner
    (their own one-block grid would not match the merged tilings).
    """
    want = (og.row_tiling.num_blocks, og.col_tiling.num_blocks)
    if t.norms is not None or t.rank_csr is not None or t.data is None:
        n2 = matricize_mask(t.block_norms(), modes, rows, cols)
        n2 = np.asarray(n2, dtype=np.float64)
        if n2.shape != want:
            raise ValueError(
                f"norm grid {n2.shape} mismatches the matricized block "
                f"grid {want}"
            )
        return n2
    sq = og.matricize(t.data).to(torch.float64) ** 2
    n2 = _block_sums(sq, (og.row_tiling, og.col_tiling)).sqrt().cpu().numpy()
    if t.mask is not None or t.ranks is not None:
        m2 = matricize_mask(t.block_mask, modes, rows, cols)
        if m2.shape == n2.shape:
            n2 = np.where(m2, n2, 0.0)
    return n2


def _step_norms(
    geom: _StepGeometry, x: BlockSparseTensor, y: BlockSparseTensor
) -> tuple[np.ndarray, np.ndarray]:
    """Matricized (A, B) norm grids for a ``filter_eps`` step."""
    spec = geom.spec
    an2 = _matricized_norms(
        x, spec.x_modes, spec.free_x, spec.contracted, geom.x_geom
    )
    bn2 = _matricized_norms(
        y, spec.y_modes, spec.contracted, spec.free_y, geom.y_geom
    )
    return an2, bn2


def _filtered_out_structure(
    geom: _StepGeometry,
    a_norms2: np.ndarray,
    b_norms2: np.ndarray,
    filter_eps: float,
) -> tuple[np.ndarray, np.ndarray]:
    """The *filtered* output structure of a ``filter_eps`` step.

    ``(out_mask, out_norms)`` on the output block grid: the mask keeps
    only C blocks with at least one surviving (i, k, j) addend —
    refining the symbolic ``geom.out_mask`` — and the norms are the
    propagated ``sum_k ||A_ik||.||B_kj||`` bounds over surviving
    addends.  This is what a chained step must see as its predecessor
    structure: the symbolic product alone would resurrect screened
    blocks.
    """
    from repro_torch.spgemm import filter_keep, output_norms

    keep, _bound = filter_keep(a_norms2, b_norms2, filter_eps)
    cn2 = output_norms(a_norms2, b_norms2, keep)
    ckeep2 = keep.any(axis=1)
    spec = geom.spec
    grids = {
        m: t.num_blocks for m, t in zip(spec.out_modes, geom.out_tilings)
    }
    out_norms = unmatricize_mask(
        cn2, spec.free_x, spec.free_y, grids, spec.out_modes
    )
    keep_mask = unmatricize_mask(
        ckeep2, spec.free_x, spec.free_y, grids, spec.out_modes
    ).astype(bool)
    out_mask = (
        keep_mask if geom.out_mask is None else (geom.out_mask & keep_mask)
    )
    return out_mask, np.where(out_mask, out_norms, 0.0)


def _step_c_mask(geom: _StepGeometry) -> np.ndarray | None:
    """The inferred output mask worth forwarding to the planner.

    An all-live product carries no pruning information — forwarding it
    would only perturb plan digests (and rebuild cached executables) for
    zero benefit, so only genuinely sparse outputs pass through."""
    cm = geom.c_mask2
    if cm is None or bool(cm.all()):
        return None
    return cm


def _plan_step(
    mm,
    geom: _StepGeometry,
    x: BlockSparseTensor,
    itemsize=4,
    *,
    a_norms2: np.ndarray | None = None,
    b_norms2: np.ndarray | None = None,
    filter_eps: float = 0.0,
):
    """The MatmulPlan this step will execute (for chain scheduling)."""
    m = geom.x_geom.row_tiling.extent
    k = geom.x_geom.col_tiling.extent
    n = geom.y_geom.col_tiling.extent
    if not geom.uniform:
        if filter_eps > 0.0:
            raise NotImplementedError(
                "filter_eps needs uniform merged tilings (the bucketized "
                "adaptation re-blocks norms ambiguously)"
            )
        nmm = _nonuniform_front_end(mm, geom)
        return nmm.plan(
            a_ranks=_nonuniform_rank_map(geom, x), itemsize=itemsize
        )
    if x.rank_csr is not None:
        return mm.plan(
            m, k, n, b_mask=geom.b_mask2, a_ranks=x.rank_csr,
            c_mask=_step_c_mask(geom), itemsize=itemsize,
            a_norms=a_norms2, b_norms=b_norms2, filter_eps=filter_eps,
        )
    a_ranks = geom.a_ranks2 if isinstance(
        geom.a_ranks2, BlockRankMap
    ) else None
    return mm.plan(
        m, k, n, a_mask=geom.a_mask2, b_mask=geom.b_mask2,
        a_ranks=a_ranks, c_mask=_step_c_mask(geom), itemsize=itemsize,
        a_norms=a_norms2, b_norms=b_norms2, filter_eps=filter_eps,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class _StepRun:
    """What one step executes: its route and the plan its product runs
    (and the nonuniform front-end on that route).  Structure only."""

    route: str  # "nonuniform" | "rank" | "matmul"
    plan: object
    nmm: object = None


def _resolve_step(
    mm,
    geom: _StepGeometry,
    x: BlockSparseTensor,
    dtypes: tuple[torch.dtype, torch.dtype],
    *,
    lookahead: int | None = None,
    tune: bool = False,
    a_norms2: np.ndarray | None = None,
    b_norms2: np.ndarray | None = None,
    filter_eps: float = 0.0,
) -> _StepRun:
    """Plan the step's product as ``DistributedMatmul.__call__`` (or
    ``NonuniformMatmul.__call__``) plans it for the matricized operands:
    the same refusals, the same planner call and so the same plan cache
    entry.  ``dtypes`` are x's and y's data types."""
    x_size, y_size = dtypes[0].itemsize, dtypes[1].itemsize
    if not geom.uniform:
        if filter_eps > 0.0:
            raise NotImplementedError(
                "filter_eps needs uniform merged tilings"
            )
        # Bucketized path: masks are applied elementwise (exact — pad and
        # dead blocks are zero) and x's structure rides as the logical
        # rank map so screened blocks still prune the physical plan.
        if x.rank_csr is not None:
            raise NotImplementedError(
                "rank_csr payloads need uniform merged tilings"
            )
        nmm = _nonuniform_front_end(mm, geom)
        plan = nmm.plan(
            a_ranks=_nonuniform_rank_map(geom, x), itemsize=x_size,
            lookahead=lookahead, tune=tune,
        )
        return _StepRun("nonuniform", plan, nmm)
    m = geom.x_geom.row_tiling.extent
    k = geom.x_geom.col_tiling.extent
    n = geom.y_geom.col_tiling.extent
    if x.rank_csr is not None:
        if not geom.x_geom.identity:
            raise NotImplementedError(
                f"spec {geom.spec.spec!r} transposes/permutes the "
                "rank_csr operand; factors cannot be re-laid-out — "
                "densify with rank_csr.to_dense() first"
            )
        if filter_eps > 0.0 and a_norms2 is None:
            from repro_torch.core.sparsity import rank_csr_norms

            a_norms2 = rank_csr_norms(x.rank_csr)
        plan = mm.plan(
            m, k, n, b_mask=geom.b_mask2, a_ranks=x.rank_csr,
            c_mask=_step_c_mask(geom), itemsize=y_size, tune=tune,
            lookahead=lookahead, a_norms=a_norms2, b_norms=b_norms2,
            filter_eps=filter_eps,
        )
        return _StepRun("rank", plan)
    a_ranks = geom.a_ranks2 if isinstance(
        geom.a_ranks2, BlockRankMap
    ) else None
    plan = mm.plan(
        m, k, n, a_mask=geom.a_mask2 if a_ranks is None else None,
        b_mask=geom.b_mask2, a_ranks=a_ranks, c_mask=_step_c_mask(geom),
        itemsize=x_size, tune=tune, lookahead=lookahead,
        a_norms=a_norms2, b_norms=b_norms2, filter_eps=filter_eps,
    )
    return _StepRun("matmul", plan)


def _run_step(
    mm,
    geom: _StepGeometry,
    run: _StepRun,
    x: BlockSparseTensor,
    y: BlockSparseTensor,
    *,
    compiled: bool,
) -> torch.Tensor:
    """Matricize, multiply under the resolved plan, un-matricize."""
    b2 = geom.y_geom.matricize(y.data)
    if run.route == "nonuniform":
        a = x.data
        if x.mask is not None or x.ranks is not None:
            a = a * _expand_block_mask_on(
                x.block_mask, x.tilings, a.device).to(a.dtype)
        if y.mask is not None:
            y_fine = geom.y_geom.matricize(_expand_block_mask_on(
                y.block_mask, y.tilings, b2.device))
            b2 = b2 * y_fine.to(b2.dtype)
        c2 = run.nmm._run(geom.x_geom.matricize(a), b2, run.plan,
                          compiled=compiled)
    elif run.route == "rank":
        c2 = mm._run_rank(x.rank_csr, b2, run.plan, compiled=compiled)
    else:
        c2 = mm._run(geom.x_geom.matricize(x.data), b2, run.plan,
                     compiled=compiled)
    del b2
    fx_ext, fy_ext = _free_extents(geom, x, y)
    return _unmatricize_step(c2, geom, fx_ext, fy_ext)


def _execute_step(
    mm,
    geom: _StepGeometry,
    x: BlockSparseTensor,
    y: BlockSparseTensor,
    *,
    lookahead: int | None = None,
    tune: bool = False,
    a_norms2: np.ndarray | None = None,
    b_norms2: np.ndarray | None = None,
    filter_eps: float = 0.0,
) -> torch.Tensor:
    """One step, eagerly: plan (through the caches) and run."""
    run = _resolve_step(
        mm, geom, x, _dtypes(x, y), lookahead=lookahead, tune=tune,
        a_norms2=a_norms2, b_norms2=b_norms2, filter_eps=filter_eps,
    )
    return _run_step(mm, geom, run, x, y, compiled=mm.compiled)


def _dtypes(x: BlockSparseTensor, y: BlockSparseTensor) -> tuple:
    """x's and y's data types (a factor payload's is its factors')."""
    x_dtype = (x.data.dtype if x.data is not None
               else torch.from_numpy(x.rank_csr.u).dtype)
    return x_dtype, y.data.dtype


def _free_extents(
    geom: _StepGeometry, x: BlockSparseTensor, y: BlockSparseTensor
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    spec = geom.spec
    xt = dict(zip(spec.x_modes, x.tilings))
    yt = dict(zip(spec.y_modes, y.tilings))
    return (
        tuple(xt[m].extent for m in spec.free_x),
        tuple(yt[m].extent for m in spec.free_y),
    )


def _unmatricize_step(c2, geom: _StepGeometry, fx_ext, fy_ext):
    """Un-matricize: undo the block-lex order, split merged modes,
    reorder to the output's modes."""
    spec = geom.spec
    c_nd = _from_matrix(c2, geom.x_geom.rows, geom.y_geom.cols,
                        fx_ext + fy_ext or (1,))
    cur = spec.free_x + spec.free_y
    if cur:
        c_nd = c_nd.permute([cur.index(m) for m in spec.out_modes])
    return c_nd


# ---------------------------------------------------------------------------
# step programs: one cached program per geometry, dtypes and window
# ---------------------------------------------------------------------------


def _with_data(t: BlockSparseTensor, data) -> BlockSparseTensor:
    """Structural copy of ``t`` with ``data`` swapped in, no validation.

    Step programs keep a data-free twin and rebuild the operand from the
    data of each call, so a cached program never pins a caller's
    tensors."""
    s = BlockSparseTensor.__new__(BlockSparseTensor)
    s.data = data
    s.tilings = t.tilings
    s.mask = t.mask
    s.ranks = t.ranks
    s.rank_csr = t.rank_csr
    s.norms = t.norms
    return s


def _cached_step(mm, key: tuple, build):
    """Get-or-build a contraction program in ``_contract_cache``
    (hits/misses/builds surface through ``DistributedMatmul.cache_stats``;
    ``build`` counts its build with ``_count_retrace``)."""
    from repro_torch.core.summa import _autotune_key_suffix

    key = key + _autotune_key_suffix()
    stats = mm._cache_stats
    fn = mm._contract_cache.get(key)
    if fn is None:
        stats["step_misses"] += 1
        fn = build()
        mm._contract_cache[key] = fn
    else:
        stats["step_hits"] += 1
    return fn


def _count_retrace(mm) -> None:
    mm._cache_stats["step_retraces"] += 1


def _filter_key(
    filter_eps: float,
    a_norms2: np.ndarray | None,
    b_norms2: np.ndarray | None,
) -> tuple:
    """Cache-key suffix for an active norm filter.  Empty at
    ``filter_eps=0`` so unfiltered keys stay those of norm-free calls."""
    if filter_eps <= 0.0:
        return ()
    from repro_torch.core.sparsity import norms_key

    return (
        ("filter", float(filter_eps), norms_key(a_norms2),
         norms_key(b_norms2)),
    )


def _execute_step_compiled(
    mm,
    geom: _StepGeometry,
    x: BlockSparseTensor,
    y: BlockSparseTensor,
    *,
    lookahead: int | None = None,
    tune: bool = False,
    a_norms2: np.ndarray | None = None,
    b_norms2: np.ndarray | None = None,
    filter_eps: float = 0.0,
):
    """One cached program for the whole step.

    Matricize → planned product → un-matricize runs as one program keyed
    by the geometry's structural cache key, the dtypes and the window, so
    a repeated contraction of the same structure plans nothing.  A
    ``RankCSR`` operand is planned at every call (its factor layout is
    memoized on the payload) and its factors are operands of the
    program, never part of it.  ``mm.compiled=False`` runs eagerly.
    """
    if not mm.compiled:
        return _execute_step(
            mm, geom, x, y, lookahead=lookahead, tune=tune,
            a_norms2=a_norms2, b_norms2=b_norms2, filter_eps=filter_eps,
        )
    fx_ext, fy_ext = _free_extents(geom, x, y)
    fkey = _filter_key(filter_eps, a_norms2, b_norms2)

    if x.rank_csr is not None:
        if not geom.x_geom.identity or not geom.uniform:
            # the eager path raises the informative NotImplementedError
            return _execute_step(
                mm, geom, x, y, lookahead=lookahead, tune=tune,
                a_norms2=a_norms2, b_norms2=b_norms2,
                filter_eps=filter_eps,
            )
        m = geom.x_geom.row_tiling.extent
        k = geom.x_geom.col_tiling.extent
        n = geom.y_geom.col_tiling.extent
        plan = mm.plan(
            m, k, n, b_mask=geom.b_mask2, a_ranks=x.rank_csr,
            c_mask=_step_c_mask(geom), itemsize=y.data.element_size(),
            tune=tune, lookahead=lookahead,
            a_norms=a_norms2, b_norms=b_norms2, filter_eps=filter_eps,
        )

        def build_rank(plan=plan):
            _count_retrace(mm)

            def program(rank_csr, yd):
                c2 = mm._run_rank(rank_csr, geom.y_geom.matricize(yd), plan,
                                  compiled=False)
                return _unmatricize_step(c2, geom, fx_ext, fy_ext)

            return program

        kind = ("exec_rank" if plan.local_impl == "ranksparse"
                else "exec_rankdense")
        key = (kind, geom.cache_key, str(y.data.dtype), lookahead,
               tune) + fkey
        return _cached_step(mm, key, build_rank)(x.rank_csr, y.data)

    x_sym = _with_data(x, None)
    y_sym = _with_data(y, None)
    dtypes = _dtypes(x, y)

    def build():
        _count_retrace(mm)
        run = _resolve_step(
            mm, geom, x_sym, dtypes, lookahead=lookahead, tune=tune,
            a_norms2=a_norms2, b_norms2=b_norms2, filter_eps=filter_eps,
        )

        def program(xd, yd):
            return _run_step(mm, geom, run, _with_data(x_sym, xd),
                             _with_data(y_sym, yd), compiled=False)

        return program

    key = (
        "exec_step", geom.cache_key, str(x.data.dtype), str(y.data.dtype),
        lookahead, tune,
    ) + fkey
    return _cached_step(mm, key, build)(x.data, y.data)


# ---------------------------------------------------------------------------
# the public entry points
# ---------------------------------------------------------------------------


def contract(
    spec: str,
    x,
    y,
    *,
    mm,
    tile: int = 64,
    lookahead: int | None = None,
    tune: bool = False,
    filter_eps: float = 0.0,
) -> BlockSparseTensor:
    """Binary block-sparse tensor contraction through the MatmulPlan engine.

    ``x``/``y`` are :class:`BlockSparseTensor` (plain tensors, arrays and
    ``RankCSR`` payloads are wrapped automatically); ``mm`` is the
    :class:`core.api.DistributedMatmul` supplying the grid, strategy and
    caches.  Operands move to ``mm.grid.device``.  Batch modes execute
    one matricized product per batch element (every slice shares one
    cached plan).  Returns a :class:`BlockSparseTensor` on the grid's
    device whose mask is *inferred* from the operand structure (exactly
    the reachable C blocks), ready to chain.

    ``filter_eps > 0`` screens (i, k, j) block products whose
    ``||X_ik||.||Y_kj||`` norm bound falls below the threshold (DBCSR's
    on-the-fly filtering): the result differs from the exact contraction
    by at most the dropped-product sum in Frobenius norm, and it carries
    the *filtered* output mask plus propagated per-block norm bounds.
    """
    dev = mm.grid.device
    x, y = _on_device(_wrap(x), dev), _on_device(_wrap(y), dev)
    pspec = parse_contraction(spec)
    if filter_eps > 0.0 and pspec.batch:
        raise NotImplementedError(
            "filter_eps with batch modes is not supported (filter the "
            "per-slice contractions instead)"
        )
    if not pspec.batch:
        geom = _geometry_cached(mm, spec, x, y, tile)
        a_norms2 = b_norms2 = None
        if filter_eps > 0.0:
            a_norms2, b_norms2 = _step_norms(geom, x, y)
        data = _execute_step_compiled(
            mm, geom, x, y, lookahead=lookahead, tune=tune,
            a_norms2=a_norms2, b_norms2=b_norms2, filter_eps=filter_eps,
        )
        if not pspec.out_modes:  # full contraction to a scalar
            return BlockSparseTensor(
                data=data.reshape(()), tilings=(), mask=None
            )
        if filter_eps > 0.0:
            out_mask, out_norms = _filtered_out_structure(
                geom, a_norms2, b_norms2, filter_eps
            )
            return BlockSparseTensor(
                data=data, tilings=geom.out_tilings, mask=out_mask,
                norms=out_norms,
            )
        return BlockSparseTensor(
            data=data, tilings=geom.out_tilings, mask=geom.out_mask
        )

    # -- batch modes: one matricized product per batch element ---------------
    if x.rank_csr is not None:
        raise NotImplementedError("batch modes with rank_csr payloads")
    sub_spec = (
        "".join(m for m in pspec.x_modes if m not in pspec.batch)
        + ","
        + "".join(m for m in pspec.y_modes if m not in pspec.batch)
        + "->"
        + "".join(m for m in pspec.out_modes if m not in pspec.batch)
    )
    bx = [pspec.x_modes.index(m) for m in pspec.batch]
    by = [pspec.y_modes.index(m) for m in pspec.batch]
    xt = dict(zip(pspec.x_modes, x.tilings))
    yt = dict(zip(pspec.y_modes, y.tilings))
    # Batch slices index elements, but masks/ranks slice by *block* —
    # block indices come from the resolved batch tilings, so the two
    # operands must agree on them wherever block-granular structure is
    # actually sliced; a plain side adopts the structured side's
    # blocking (only extents must always match).
    x_plain = x.mask is None and x.ranks is None
    y_plain = y.mask is None and y.ranks is None
    batch_tilings = []
    for m in pspec.batch:
        if xt[m].extent != yt[m].extent:
            raise ValueError(
                f"batch mode {m!r} extents disagree between operands: "
                f"{xt[m].extent} vs {yt[m].extent}"
            )
        if xt[m].sizes == yt[m].sizes or y_plain:
            batch_tilings.append(xt[m])
        elif x_plain:
            batch_tilings.append(yt[m])
        else:
            raise ValueError(
                f"batch mode {m!r} tilings disagree between operands "
                f"({xt[m].sizes} vs {yt[m].sizes}); masked/ranked "
                "operands must block batch modes identically"
            )
    extents = [t.extent for t in batch_tilings]
    # element -> owning block per batch mode (for mask slicing)
    blk_of = [
        np.repeat(np.arange(t.num_blocks), t.sizes) for t in batch_tilings
    ]

    def _slice(t: BlockSparseTensor, baxes, idx, bblk):
        other = [i for i in range(t.ndim) if i not in baxes]
        data = t.data
        for ax, i in sorted(zip(baxes, idx), reverse=True):
            data = data.select(ax, i)
        sub_mask = sub_ranks = None
        for name in ("mask", "ranks"):
            arr = getattr(t, name)
            if arr is None:
                continue
            sl = [slice(None)] * t.ndim
            for ax, b in zip(baxes, bblk):
                sl[ax] = b
            val = arr[tuple(sl)]
            if name == "mask":
                sub_mask = val
            else:
                sub_ranks = val
        return BlockSparseTensor(
            data=data,
            tilings=tuple(t.tilings[i] for i in other),
            mask=sub_mask,
            ranks=sub_ranks,
        )

    out_free = tuple(m for m in pspec.out_modes if m not in pspec.batch)
    all_idx = list(itertools.product(*[range(e) for e in extents]))
    bblk_of_idx = [
        tuple(int(blk_of[d][i]) for d, i in enumerate(idx))
        for idx in all_idx
    ]
    slices: list = [None] * len(all_idx)
    masks: dict[tuple, np.ndarray | None] = {}
    sub_tilings = None
    if mm.compiled:
        # Group batch elements by block signature: every group shares one
        # sub-geometry, so the whole group runs as a *single* program
        # (slicing + per-slice product + stack) planned once.
        groups: dict[tuple, list] = {}
        for pos, bblk in enumerate(bblk_of_idx):
            groups.setdefault(bblk, []).append(pos)
        x_sym = _with_data(x, None)
        y_sym = _with_data(y, None)
        dtypes = _dtypes(x, y)
        for bblk, positions in groups.items():
            idx0 = all_idx[positions[0]]
            xs0 = _slice(x, bx, idx0, bblk)
            sub_geom = _geometry_cached(
                mm, sub_spec, xs0, _slice(y, by, idx0, bblk), tile,
            )
            sub_tilings = sub_geom.out_tilings
            masks[bblk] = (
                sub_geom.out_mask if sub_geom.spec.out_modes else None
            )
            sub_shape = tuple(tt.extent for tt in sub_tilings)
            group_idx = tuple(all_idx[p] for p in positions)
            xs_sym = _with_data(xs0, None)

            def build(bblk=bblk, sub_geom=sub_geom, sub_shape=sub_shape,
                      group_idx=group_idx, xs_sym=xs_sym):
                _count_retrace(mm)
                runs = [
                    _resolve_step(mm, sub_geom, xs_sym, dtypes,
                                  lookahead=lookahead, tune=tune)
                    for _ in group_idx
                ]

                def program(xd, yd):
                    xf = _with_data(x_sym, xd)
                    yf = _with_data(y_sym, yd)
                    outs = []
                    for idx, run in zip(group_idx, runs):
                        d = _run_step(
                            mm, sub_geom, run,
                            _slice(xf, bx, idx, bblk),
                            _slice(yf, by, idx, bblk), compiled=False,
                        )
                        outs.append(d.reshape(sub_shape))
                    return torch.stack(outs)

                return program

            key = (
                "exec_batch", sub_geom.cache_key, bblk, group_idx,
                str(x.data.dtype), str(y.data.dtype), lookahead, tune,
            )
            group_out = _cached_step(mm, key, build)(x.data, y.data)
            for j, pos in enumerate(positions):
                slices[pos] = group_out[j]
    else:
        for pos, (idx, bblk) in enumerate(zip(all_idx, bblk_of_idx)):
            xs = _slice(x, bx, idx, bblk)
            ys = _slice(y, by, idx, bblk)
            out = contract(
                sub_spec, xs, ys, mm=mm, tile=tile,
                lookahead=lookahead, tune=tune,
            )
            slices[pos] = out.data
            sub_tilings = out.tilings
            if bblk not in masks:
                masks[bblk] = out.mask
    stacked = torch.stack(slices).reshape(
        tuple(extents) + tuple(tt.extent for tt in sub_tilings)
    )
    cur = pspec.batch + out_free
    c_nd = stacked.permute([cur.index(m) for m in pspec.out_modes])
    out_mask = None
    if any(v is not None for v in masks.values()):
        bgrids = tuple(t.num_blocks for t in batch_tilings)
        free_grid = tuple(
            dict(zip(out_free, sub_tilings))[m].num_blocks
            for m in out_free
        ) if out_free else ()
        full = np.zeros(bgrids + free_grid, dtype=bool)
        for bblk, msk in masks.items():
            full[bblk] = True if msk is None else msk
        full = np.transpose(
            full, [cur.index(m) for m in pspec.out_modes]
        )
        out_mask = full
    tmap = {**dict(zip(pspec.batch, batch_tilings)),
            **dict(zip(out_free, sub_tilings))}
    return BlockSparseTensor(
        data=c_nd,
        tilings=tuple(tmap[m] for m in pspec.out_modes),
        mask=out_mask,
    )


def contract_chain(
    steps,
    *,
    mm,
    tile: int = 64,
    tune: bool = False,
    machine=None,
    trace: bool = False,
    filter_eps: float = 0.0,
):
    """Execute consecutive contractions under one *jointly scheduled* plan.

    ``steps`` is ``[(spec0, x0, y0), (spec1, y1), (spec2, y2), …]`` —
    each later step contracts the previous result (as its first operand)
    with a fresh second operand.  Before executing anything the chain is
    planned end to end: per-step ``MatmulPlan``s (operand masks propagate
    through the inferred output masks), the **union task graph** of all
    steps (``sched.taskgraph.chain_graphs``: C tiles of step *i* gate
    only the A-panel broadcasts of step *i+1* that read them — B-side
    broadcasts and early panels overlap the previous multiplication),
    and a discrete-event simulation of it.  ``tune=True`` lets
    ``sched.tuner.tune_chain`` pick the per-step multiple-issue windows
    jointly by simulated makespan; execution then honors the chosen
    windows.

    Returns ``(result, report)``: the final :class:`BlockSparseTensor`
    and a dict with the joint / sequential simulated makespans, the
    speedup, per-step lookaheads and plan summaries (and the traced
    ``SimResult`` as ``report["sim"]`` when ``trace=True``).
    """
    from repro_torch.sched.simulator import DEFAULT_MACHINE, simulate
    from repro_torch.sched.taskgraph import chain_graphs, from_plan
    from repro_torch.sched.tuner import tune_chain

    machine = machine or DEFAULT_MACHINE
    if len(steps) < 2:
        raise ValueError("contract_chain needs at least two steps")
    dev = mm.grid.device
    spec0, x0, y0 = steps[0]
    norm = [(parse_contraction(spec0), _on_device(_wrap(x0), dev),
             _on_device(_wrap(y0), dev))]
    for item in steps[1:]:
        spec_i, y_i = item
        norm.append((parse_contraction(spec_i), None,
                     _on_device(_wrap(y_i), dev)))
    for spec, _x, _y in norm:
        if spec.batch:
            raise NotImplementedError(
                "joint chain scheduling supports non-batch specs only"
            )

    # -- phase 1: symbolic pass (geometry + plans, no data) -----------------
    # Under an active filter every step sees the *filtered* predecessor
    # structure: the symbolic intermediate carries the screened mask and
    # the propagated norm bounds, so step i+1's geometry / plan / norms
    # derive from what step i actually computed.
    geoms = []
    plans = []
    syms = []  # per-step symbolic outputs (filtered structure when active)
    norms_steps = []  # per-step matricized (A, B) norm grids (None pairs)
    x_cur = norm[0][1]
    for spec, _x, y in norm:
        geom = _geometry_cached(mm, spec.spec, x_cur, y, tile)
        geoms.append(geom)
        if filter_eps > 0.0:
            an2, bn2 = _step_norms(geom, x_cur, y)
            norms_steps.append((an2, bn2))
            plans.append(_plan_step(
                mm, geom, x_cur,
                a_norms2=an2, b_norms2=bn2, filter_eps=filter_eps,
            ))
            out_mask, out_norms = _filtered_out_structure(
                geom, an2, bn2, filter_eps
            )
            x_cur = _symbolic_out(geom)
            x_cur.mask = out_mask
            x_cur.norms = out_norms
        else:
            norms_steps.append((None, None))
            plans.append(_plan_step(mm, geom, x_cur))
            x_cur = _symbolic_out(geom)  # structure only; data in phase 3
        syms.append(x_cur)

    # -- phase 2: union graph, simulation, joint window tuning ---------------
    builders = [
        (lambda la, p=p: from_plan(p, lookahead=la)) for p in plans
    ]
    default_graphs = [b(None) for b in builders]
    seq_sims = [simulate(g, machine) for g in default_graphs]
    sequential = float(sum(s.makespan_s for s in seq_sims))
    tuned_record = None
    if tune:
        lookaheads, joint, tuned_record = tune_chain(
            builders, machine=machine, default_graphs=default_graphs
        )
        joint_default_s = tuned_record["default_makespan_s"]
        if trace:  # re-simulate the winner only to record spans
            joint = simulate(
                chain_graphs(
                    [b(la) for b, la in zip(builders, lookaheads)]
                ),
                machine, trace=True,
            )
    else:
        lookaheads = [g.lookahead for g in default_graphs]
        joint = simulate(chain_graphs(default_graphs), machine, trace=trace)
        joint_default_s = joint.makespan_s

    # -- phase 3: execute with the chosen per-step windows --------------------
    # The whole chain is ONE cached program: each intermediate is freed as
    # soon as the next step has consumed it.
    x0 = norm[0][1]
    ys = [y for _spec, _x, y in norm]
    las = tuple(int(la) for la in lookaheads)
    if mm.compiled and x0.rank_csr is None:
        x0_sym = _with_data(x0, None)
        y_syms = [_with_data(y, None) for y in ys]
        x_dtype = x0.data.dtype

        def build():
            _count_retrace(mm)
            runs, x_struct = [], x0_sym
            for geom, la, y, sym_out, (an2, bn2) in zip(
                geoms, las, ys, syms, norms_steps
            ):
                runs.append(_resolve_step(
                    mm, geom, x_struct, (x_dtype, y.data.dtype),
                    lookahead=la, a_norms2=an2, b_norms2=bn2,
                    filter_eps=filter_eps,
                ))
                x_struct = sym_out

            def program(x0d, *yds):
                x_cur = _with_data(x0_sym, x0d)
                for geom, run, y_sym, yd, sym_out in zip(
                    geoms, runs, y_syms, yds, syms
                ):
                    data = _run_step(mm, geom, run, x_cur,
                                     _with_data(y_sym, yd), compiled=False)
                    x_cur = _with_data(sym_out, data)
                return x_cur.data

            return program

        key = (
            "exec_chain", tuple(g.cache_key for g in geoms), las,
            str(x0.data.dtype), tuple(str(y.data.dtype) for y in ys),
        ) + tuple(
            k for an2, bn2 in norms_steps
            for k in _filter_key(filter_eps, an2, bn2)
        )
        data = _cached_step(mm, key, build)(
            x0.data, *[y.data for y in ys]
        )
        x_cur = BlockSparseTensor(
            data=data, tilings=geoms[-1].out_tilings,
            mask=syms[-1].mask, norms=syms[-1].norms,
        )
    else:
        x_cur = x0
        for y, geom, la, sym_out, (an2, bn2) in zip(
            ys, geoms, las, syms, norms_steps
        ):
            data = _execute_step_compiled(
                mm, geom, x_cur, y, lookahead=la,
                a_norms2=an2, b_norms2=bn2, filter_eps=filter_eps,
            )
            x_cur = BlockSparseTensor(
                data=data, tilings=geom.out_tilings,
                mask=sym_out.mask, norms=sym_out.norms,
            )

    report = {
        "steps": [g.spec.spec for g in geoms],
        "lookaheads": [int(la) for la in lookaheads],
        "joint_makespan_s": joint.makespan_s,
        "joint_default_makespan_s": joint_default_s,
        "sequential_makespan_s": sequential,
        "sequential_makespans_s": [s.makespan_s for s in seq_sims],
        "speedup_vs_sequential": (
            sequential / joint.makespan_s if joint.makespan_s > 0 else 1.0
        ),
        "plans": [p.summary() for p in plans],
        "tuned": tuned_record,
    }
    if filter_eps > 0.0:
        report["filter_eps"] = float(filter_eps)
        report["filter_bounds"] = [
            float(getattr(p, "filter_bound", 0.0)) for p in plans
        ]
    if trace:
        report["sim"] = joint
    return x_cur, report


def _symbolic_out(geom: _StepGeometry) -> BlockSparseTensor:
    """A data-free stand-in carrying the step's output structure (used by
    the chain's symbolic planning pass)."""
    t = BlockSparseTensor.__new__(BlockSparseTensor)
    t.data = None
    t.tilings = geom.out_tilings
    t.mask = geom.out_mask
    t.ranks = None
    t.rank_csr = None
    t.norms = None
    return t

"""Per-block-shape kernel autotune cache (the DBCSR ``libsmm_acc`` idea).

The port of ``repro.kernels.autotune``: the same bucket keys, the same
JSON file format and the same environment names, so one cache file
serves both packages.

Nonuniform tilings hand the local engines a zoo of block shapes, and one
generic kernel choice (``torch.matmul`` vs the tiled kernel vs the
block-sparse/grouped/factored routes) cannot win everywhere — DBCSR
(arXiv:1910.13555) ships a per-block-shape tuned kernel library for
exactly this reason.  This module is the runtime analogue:

* shapes are coarsened into **buckets** ``(bm, bk, bn, rank, dtype)``
  (power-of-two rounding, clamped to 4096), so one measurement covers a
  neighborhood; the dtype is the reference's name (``"float32"``,
  ``"bfloat16"``, ``"float16"``);
* :meth:`KernelAutotuner.tune` times every applicable route on a
  representative problem of the bucket shape and records the winner and
  the per-route times;
* winners persist to JSON (:meth:`save` / :meth:`load`), and the
  ``REPRO_AUTOTUNE_CACHE`` environment variable points the process
  singleton at a cache file;
* a table records the kind of device that measured it
  (``device_kind``: ``"cpu"`` or the card's name), and the file carries
  it as an extra top-level key that the reference's ``load`` does not
  read.  A consult that names its device (``_local_dot``,
  ``NonuniformMatmul``) refuses a non-empty table of another kind, or of
  no recorded kind (a file the reference saved, perhaps on a TPU, unless
  its loader vouches for the kind): winners measured elsewhere would
  decide which kernel this card runs;
* consumers (``core.summa._local_dot``, ``core.api.NonuniformMatmul``)
  only ever call :meth:`lookup` / :meth:`winner` — **lookup never
  times anything**, and an empty or disabled cache (``REPRO_AUTOTUNE=0``)
  leaves every execution path bitwise as it is without the cache
  (:func:`cache_fingerprint` returns ``""`` exactly then).

Routes timed per bucket:

``xla``
    ``torch.matmul`` — the generic baseline (the reference's
    ``jnp.matmul``); always a candidate, so a recorded winner is by
    construction never slower than the generic product on its own bucket
    (measured on the tuning machine).
``pallas``
    ``kernels.ops.tiled_matmul``, timed once.  The reference sweeps
    ``TILE_CANDIDATES`` and records the winning ``(bm, bk, bn)`` as
    ``tiles``; the card's kernel has one geometry, and the port's
    consumers read no tiles, so the port records the first candidate
    (clamped to the bucket) for the file format only.
``bsmm``
    the block-sparse kernel with an all-live mask — prices the CSR
    indirection so masked plans know when the structured kernel stops
    paying.
``grouped``
    the grouped GEMM with a single expert — the rank-sparse stage-1 shape
    (``kernels.ops.ranksparse_matmul``).
``factored``
    only when ``rank > 0``: the two-stage ``U @ (V @ B)`` pipeline at the
    bucket's rank.

On a CUDA device each timed call is bracketed by ``synchronize``: best of
``repeats`` after one warm call (which also builds the kernels).  A route
is skipped only where its wrapper refuses the shape before launching
(``ValueError``, ``NotImplementedError``); a failure to build or launch a
kernel propagates.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import torch

__all__ = [
    "KernelAutotuner",
    "bucket_key",
    "autotune_cache",
    "set_autotune_cache",
    "cache_fingerprint",
    "autotune_enabled",
    "device_kind",
    "preferred_tile",
]

#: every route the tuner knows; ``factored`` only applies at rank > 0.
ROUTES = ("xla", "pallas", "bsmm", "grouped", "factored")

#: the square tiles ``preferred_tile`` chooses among; the first, clamped
#: to the bucket, is what the ``pallas`` route records as ``tiles``.
TILE_CANDIDATES = (128, 256, 512)

#: the reference's dtype names (numpy's, with ml_dtypes' ``bfloat16``)
_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def _pow2_bucket(x: int, lo: int = 8, hi: int = 4096) -> int:
    """Round up to the next power of two, clamped to [lo, hi]."""
    x = int(max(x, 1))
    b = 1 << (x - 1).bit_length()
    return int(min(max(b, lo), hi))


def _dtype_name(dtype) -> str:
    """The reference's name of a dtype: a ``torch.dtype`` by its own name,
    anything else as numpy names it (``bfloat16`` needs no ml_dtypes)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if str(dtype) == "bfloat16":
        return "bfloat16"
    return str(np.dtype(dtype))


def bucket_key(
    m: int, k: int, n: int, *, rank: int = 0, dtype="float32"
) -> tuple:
    """Coarsen a local-gemm shape into its autotune bucket.

    ``rank=0`` means dense (no factored structure); positive ranks bucket
    to powers of two with a floor of 8 so nearby ranks share entries.
    """
    rb = _pow2_bucket(rank, lo=8, hi=1024) if rank > 0 else 0
    return (
        _pow2_bucket(m),
        _pow2_bucket(k),
        _pow2_bucket(n),
        rb,
        _dtype_name(dtype),
    )


def _key_str(key: tuple) -> str:
    m, k, n, r, dt = key
    return f"{m}x{k}x{n}xr{r}x{dt}"


def _key_parse(s: str) -> tuple:
    m, k, n, r, dt = s.split("x", 4)
    return (int(m), int(k), int(n), int(r[1:]), dt)


def device_kind(device) -> str:
    """What a table's timings were measured on: ``"cpu"``, or the card's
    name (``torch.cuda.get_device_name``)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def autotune_enabled() -> bool:
    """``REPRO_AUTOTUNE=0`` disables every consult (bitwise-off switch)."""
    return os.environ.get("REPRO_AUTOTUNE", "1") != "0"


def _time_call(fn, *args, repeats: int = 3) -> float:
    """Best-of-``repeats`` wall time of ``fn(*args)`` after one warm call;
    on a CUDA device the card is synchronized before and after each call."""
    on_card = any(isinstance(x, torch.Tensor) and x.is_cuda for x in args)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    fn(*args)  # builds and warms outside the timed region
    sync()
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


@dataclasses.dataclass
class KernelAutotuner:
    """Bucketed route winners; see the module docstring for semantics."""

    table: dict = dataclasses.field(default_factory=dict)
    #: the kind of device that measured ``table`` (:func:`device_kind`);
    #: ``None`` while empty, or for a file saved without one
    device_kind: str | None = None

    # -- consult (lookup-only) ------------------------------------------------

    def lookup(
        self, m: int, k: int, n: int, *, rank: int = 0, dtype="float32",
        device=None,
    ) -> dict | None:
        """The bucket's entry, or ``None`` (miss / disabled). Never tunes.

        With ``device`` (the device of the product that asks), a non-empty
        table measured on another kind of device raises ``ValueError``.
        """
        if not autotune_enabled():
            return None
        if device is not None and self.table:
            here = device_kind(device)
            if self.device_kind != here:
                raise ValueError(
                    f"the autotune cache was measured on "
                    f"{self.device_kind or 'an unrecorded device'}, not on "
                    f"{here}: tune it here, or load its file with "
                    f"device_kind= if it was measured on this kind"
                )
        return self.table.get(bucket_key(m, k, n, rank=rank, dtype=dtype))

    def winner(
        self, m: int, k: int, n: int, *, rank: int = 0, dtype="float32",
        device=None,
    ) -> str | None:
        entry = self.lookup(m, k, n, rank=rank, dtype=dtype, device=device)
        return entry["winner"] if entry else None

    def _adopt_kind(self, kind: str | None) -> None:
        """Take ``kind`` as the table's, refusing to mix two kinds."""
        if self.table and self.device_kind != kind:
            raise ValueError(
                f"the autotune table holds timings from "
                f"{self.device_kind or 'an unrecorded device'}; timings "
                f"from {kind or 'an unrecorded device'} do not mix with them"
            )
        self.device_kind = kind

    def fingerprint(self) -> str:
        """Content digest of the table; ``""`` when empty or disabled.

        Consumers append a non-empty fingerprint to their cache keys, so
        flipping the cache never aliases two different programs — and an
        empty/disabled cache leaves the keys bitwise unchanged.
        """
        if not autotune_enabled() or not self.table:
            return ""
        h = hashlib.sha1()
        for k in sorted(self.table, key=_key_str):
            e = self.table[k]
            h.update(_key_str(k).encode())
            h.update(str(e.get("winner")).encode())
            h.update(str(e.get("tiles")).encode())
        return h.hexdigest()[:16]

    # -- tuning (times the routes) ------------------------------------------

    def _routes(self, key: tuple, device: torch.device):
        """``{route: (callable, args)}`` for a bucket, operands on ``device``."""
        from repro_torch.kernels import ops as kops

        bm, bk, bn, rb, dt = key
        dtype = _TORCH_DTYPES[dt]
        rng = np.random.default_rng(0)

        def draw(shape):
            return torch.as_tensor(rng.standard_normal(shape)).to(
                device=device, dtype=dtype
            )

        a = draw((bm, bk))
        b = draw((bk, bn))
        routes = {
            "xla": (torch.matmul, (a, b)),
            "pallas": (kops.tiled_matmul, (a, b)),
        }

        blk = min(bm, bk, 128)
        mask = np.ones((bm // blk, bk // blk), dtype=bool)
        routes["bsmm"] = (lambda x, y: kops.bsmm(x, y, mask), (a, b))

        bt = min(bm, 256)  # bm is a power of two, so bt divides it
        te = np.zeros((bm // bt,), np.int32)
        routes["grouped"] = (
            lambda x, y: kops.grouped_gemm(x, y[None], te, bt=bt), (a, b)
        )

        if rb > 0:
            u = draw((bm, rb))
            v = draw((rb, bk))
            routes["factored"] = (lambda uu, vv, y: uu @ (vv @ y), (u, v, b))
        return routes

    def tune(
        self,
        m: int,
        k: int,
        n: int,
        *,
        rank: int = 0,
        dtype="float32",
        repeats: int = 3,
        routes: tuple[str, ...] | None = None,
        device="cuda",
    ) -> dict:
        """Time the routes on this shape's bucket and record the winner.

        Idempotent per bucket (re-tuning overwrites).  ``routes`` limits
        the sweep; ``device`` is where the operands live (``"cuda"`` unless
        the caller asks for the CPU, whose routes are the kernels' plain
        versions).  Returns the entry: ``{"winner", "times_s", "tiles"}``.
        Timings of another kind of device than the table's raise.
        """
        device = torch.device(device)
        kind = device_kind(device)
        self._adopt_kind(kind)
        key = bucket_key(m, k, n, rank=rank, dtype=dtype)
        built = self._routes(key, device)
        times: dict[str, float] = {}
        for name, (fn, args) in built.items():
            if routes is not None and name not in routes:
                continue
            try:
                times[name] = _time_call(fn, *args, repeats=repeats)
            except (ValueError, NotImplementedError):
                # the wrapper refused this shape before any launch
                continue
        if not times:
            raise ValueError(f"no route could be timed for bucket {key}")
        winner = min(times, key=times.get)
        first = TILE_CANDIDATES[0]
        entry = {
            "winner": winner,
            "times_s": {r: float(t) for r, t in times.items()},
            "tiles": ([min(first, d) for d in key[:3]]
                      if "pallas" in times else None),
        }
        self.table[key] = entry
        self.device_kind = kind
        return entry

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        data = {
            "version": 1,
            "entries": {_key_str(k): v for k, v in self.table.items()},
        }
        if self.device_kind is not None:
            data["device_kind"] = self.device_kind
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)

    def load(
        self, path: str, *, merge: bool = True, device_kind: str | None = None
    ) -> int:
        """Load entries from ``path``; returns how many were installed.

        ``merge=True`` (default) keeps existing in-memory entries on key
        collisions losing to the file — the file is the persisted truth.
        The file's ``device_kind`` becomes the table's; ``device_kind``
        vouches for the kind of a file that records none (the reference's)
        and must agree with one that does.  Merging two kinds raises.
        """
        with open(path) as f:
            data = json.load(f)
        entries = data.get("entries", {})
        kind = data.get("device_kind")
        if kind is not None and device_kind is not None and kind != device_kind:
            raise ValueError(
                f"{path} was measured on {kind}, not on {device_kind}"
            )
        kind = kind or device_kind
        if not merge:
            self.table.clear()
        self._adopt_kind(kind)
        for ks, e in entries.items():
            self.table[_key_parse(ks)] = e
        return len(entries)


_CACHE: KernelAutotuner | None = None


def autotune_cache() -> KernelAutotuner:
    """The process singleton, created on first use and seeded from
    ``REPRO_AUTOTUNE_CACHE`` if the variable names an existing JSON file."""
    global _CACHE
    if _CACHE is None:
        _CACHE = KernelAutotuner()
        path = os.environ.get("REPRO_AUTOTUNE_CACHE", "")
        if path and os.path.exists(path):
            _CACHE.load(path)
    return _CACHE


def set_autotune_cache(cache: KernelAutotuner | None) -> None:
    """Swap the process singleton (``None`` resets it to empty-lazy)."""
    global _CACHE
    _CACHE = cache


def cache_fingerprint() -> str:
    """The singleton's fingerprint; ``""`` when it is empty or disabled."""
    return autotune_cache().fingerprint()


def preferred_tile(
    max_block: int, *, dtype="float32", candidates=TILE_CANDIDATES,
    device=None,
) -> int | None:
    """Physical tile choice for ``NonuniformMatmul`` bucketing.

    Scans square ``(c, c, c)`` buckets the cache has measured and returns
    the candidate whose winning route is fastest per FLOP, ``None`` on a
    cold cache (the caller falls back to its static default).
    ``max_block`` caps the tile at the largest logical block so
    bucketization stays exact.  ``device`` is where the product will run
    (see :meth:`KernelAutotuner.lookup`).
    """
    cache = autotune_cache()
    best_c, best_t = None, float("inf")
    for c in candidates:
        if c > _pow2_bucket(max_block, lo=8):
            continue
        entry = cache.lookup(c, c, c, dtype=dtype, device=device)
        if not entry:
            continue
        t = entry["times_s"][entry["winner"]]
        # normalize by the bucket's flops so sizes are comparable
        t_norm = t / float(c) ** 3
        if t_norm < best_t:
            best_c, best_t = c, t_norm
    return best_c

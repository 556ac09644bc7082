"""Build and load the package's CUDA kernels.

The ``.cu`` sources under ``repro_torch/csrc`` have a plain C interface.
They are compiled with ``nvcc`` for Hopper (``sm_90a``), one process per
source, all started together, linked into one shared library, and loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds.  The
library lands in ``build/repro_torch/<hash>/`` at the repository root,
keyed by a hash of the sources and flags, at first use; a later call with
unchanged sources loads it without compiling.

Nothing here runs at import time: the CPU-only tests import every module
of the package on a machine with neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["build", "load", "check", "dtype_code", "stream_handle"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("tiled_matmul.cu", "bsmm.cu", "grouped_gemm.cu",
           "flash_attention.cu")
HEADERS = ("dtypes.cuh", "hopper.cuh", "split_gemm.cuh", "block_rows.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/dtypes.cuh
_i64, _int, _ptr = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
_f32 = ctypes.c_float
_SIGNATURES = {
    "tiled_matmul_launch": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _i64, _i64,
                            _int, _int, _ptr],
    # a, b, cols, c; M, N, lda, ldb; S, K/bk, bm, bk, tile lists; in and
    # out dtype, stream
    "bsmm_launch": [_ptr, _ptr, _ptr, _ptr, _i64, _i64, _i64, _i64, _int,
                    _int, _int, _int, _int, _int, _int, _ptr],
    # x, w, tile_expert, pairs, y; T, F, D, ldx, expert stride, ldw; bt,
    # E; pairs; in and out dtype, stream
    "grouped_gemm_launch": [_ptr] * 5 + [_i64] * 6 + [_int, _int, _i64,
                                                       _int, _int, _ptr],
    # q, k, v, o; B, H, Hkv, Sq, Sk, Dh; (batch, head, seq) strides of q,
    # k, v, o; scale, causal, has_window, window, dtype, stream
    "flash_attention_launch": [_ptr] * 4 + [_i64] * 18 + [_f32, _int, _int,
                                                          _i64, _int, _ptr],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or shutil.which(
        "nvcc", path=os.path.join(cuda_home, "bin")
    )
    if found is None:
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
            "kernels of repro_torch are built from source at first use"
        )
    return found


def _source_hash() -> str:
    h = hashlib.sha1(repr(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str, float]:
    """Compile the library unless this source hash is built already.

    Returns ``(library path, compiler output, seconds spent compiling)``;
    the output includes what ``-Xptxas -v`` reports per kernel.  Raises
    ``RuntimeError`` with nvcc's output when nvcc is missing or fails.
    """
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path, (out_dir / "build.log").read_text(), 0.0
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".tmp-"))
    t0 = time.perf_counter()
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src),
                 "-o", str(tmp / f"{src}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src in SOURCES
        ]
        logs = []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            logs.append(f"== nvcc {src} (rc={proc.returncode})\n{out}")
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / LIB_NAME),
             *(str(tmp / f"{src}.o") for src in SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        log = "\n".join(logs)
        (tmp / "build.log").write_text(log)
        try:
            tmp.rename(out_dir)  # publish atomically
        except OSError:  # built concurrently by another process
            shutil.rmtree(tmp, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return lib_path, log, time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib_path, _, _ = build()
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = load().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODES:
        raise TypeError(
            f"the CUDA kernels take float32 or bfloat16, not {dtype}"
        )
    return _DTYPE_CODES[dtype]


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, for a launch."""
    return torch.cuda.current_stream(device).cuda_stream

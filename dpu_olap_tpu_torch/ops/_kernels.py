"""Build and load the port's CUDA kernels (``dpu_olap_tpu_torch/csrc/*.cu``).

All sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes: one nvcc per source, all started together,
then one link. The build happens at first use, never at import, and is keyed
on a hash of the sources, their headers and the flags: the library lands in
``dpu_olap_tpu_torch/_build/`` (git-ignored) and is reused while the sources
are unchanged. A failed build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    # (in_planes, n_planes, n, out, work, stream)
    "dpu_sort_u32": [ctypes.POINTER(_P), ctypes.c_int, _LL, _P, _P, _P],
    # (in_planes, out_planes, n_planes, n, npow, stream)
    "dpu_sort_tiles_u32": [ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.c_int, _LL, _LL, _P],
    # (x, idx, out, nblk, op, reps, stream)
    "dpu_block_op_i32": [_P, _P, _P, _LL, ctypes.c_int, _LL, _P],
    # (x, idx, out, rows, w_values, w_idx, kernel, grid, rows_per_block, stream)
    "dpu_lane_gather_u32": [_P, _P, _P, _LL, _LL, _LL, ctypes.c_int, _LL, ctypes.c_int, _P],
    # (in, out, rows, cols, stream)
    "dpu_transpose_u32": [_P, _P, _LL, _LL, _P],
    # (a, b, out, k, m, n, stream)
    "dpu_onehot_matmul_bf16": [_P, _P, _P, _LL, _LL, _LL, _P],
    # (x, row, out, rows, w, stream)
    "dpu_dyn_row_u32": [_P, _P, _P, _LL, _LL, _P],
    # (stream)
    "dpu_noop": [_P],
    # (data, n, sidx, out, k, flag, stream)
    "dpu_gather_sorted_u32": [_P, _LL, _P, _P, _LL, _P, _P],
    # (x, n, threshold, fill, out, sel or NULL, work, count, stream)
    "dpu_filter_u32": [_P, _LL, ctypes.c_uint, ctypes.c_uint, _P, _P, _P, _P, _P],
    # the same, with the ENABLE_TRACE printf a tile
    "dpu_filter_trace_u32": [_P, _LL, ctypes.c_uint, ctypes.c_uint, _P, _P, _P, _P, _P],
    # (x, n, threshold, fill, out, sel or NULL, work, count, stream): the
    # filter alternates v2, v3 and v4 (work: filter_plan's tile words + ticket)
    "dpu_filter2_u32": [_P, _LL, ctypes.c_uint, ctypes.c_uint, _P, _P, _P, _P, _P],
    "dpu_filter3_u32": [_P, _LL, ctypes.c_uint, ctypes.c_uint, _P, _P, _P, _P, _P],
    "dpu_filter4_u32": [_P, _LL, ctypes.c_uint, ctypes.c_uint, _P, _P, _P, _P, _P],
    # (x, n, stage, out, tile_offs, work, count, stream)
    "dpu_filter_stage_u32": [_P, _LL, ctypes.c_int, _P, _P, _P, _P, _P],
    # (x, n, out_u64, stream)
    "dpu_sum_u32": [_P, _LL, _P, _P],
    # (in_planes, out_planes, n_planes, n, sentinel, alive or NULL, has or NULL, work, stream)
    "dpu_fill_u32": [
        ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.c_int, _LL, ctypes.c_uint, _P, _P, _P, _P,
    ],
    # (in_planes, out_planes, n_planes, n, block, stream)
    "dpu_merge_blocks_u32": [ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.c_int, _LL, _LL, _P],
    # (keys, payloads, n_pay, n, parts, cell, cells_k, cells_pay, cells_sel or NULL,
    #  counts, overflow, work, stream)
    "dpu_partition_u32": [
        _P, ctypes.POINTER(_P), ctypes.c_int, _LL, ctypes.c_int, _LL, _P, ctypes.POINTER(_P), _P,
        _P, _P, _P, _P,
    ],
    # (left, nl, right, nr, payloads, n_pay, has, pkey, out_pays, stream)
    "dpu_merge_probe_u32": [
        _P, _LL, _P, _LL, ctypes.POINTER(_P), ctypes.c_int, _P, _P, ctypes.POINTER(_P), _P,
    ],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last nvcc run


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and headers lives (built or
    not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *SRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdpu_olap_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it already exists."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    srcs = _sources()
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            list(pool.map(
                _run,
                [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(srcs, objs)],
            ))
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        build_seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.dpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dpu_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().dpu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch ({msg})")


def stream_handle(device) -> ctypes.c_void_p:
    """The current PyTorch CUDA stream of ``device``, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

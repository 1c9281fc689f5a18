"""ctypes binding of the port's native host runtime (``runtime.cpp``, the
port's own copy of the JAX package's; counterpart of
``dpu_olap_tpu/native/__init__.py``).

  parallel_memcpy   - threaded blocked memcpy (host/memory_utils/memcpy.h)
  parallel_stack    - np.stack through one process-wide OrderedExecutor
  PartitionSlab     - atomic-cursor columnar output buffer (host/partition)
  NativeTimers      - named per-rank ns timers (host/timer)
  OrderedExecutor   - per-queue FIFO async staging engine (DpuSetAsync analog)

The library builds at first use, never at import, with g++ and the JAX
package's ``native/Makefile`` flags into ``dpu_olap_tpu_torch/_build/``
(git-ignored), named by a hash of the source and the flags, so an edited
source is rebuilt and nothing is written beside it. A failed build raises
with the compiler's output; nothing falls back to a Python version (the
plain versions, ``np.copyto``, ``np.stack`` and list concatenation, live only
in the tests).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .. import config

SOURCE = Path(__file__).resolve().parent / "runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_stack_lock = threading.Lock()
_stacker: "OrderedExecutor | None" = None  # parallel_stack's queues
_stacker_pid = 0


def library_path() -> Path:
    """Where the library for the current source and flags lives (built or
    not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libueruntime_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile runtime.cpp unless the library for it already exists; raise
    with the compiler's output if g++ is missing or fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native runtime needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.ue_parallel_memcpy.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t, c.c_int, c.c_size_t]
    lib.ue_parallel_memcpy.restype = None
    lib.ue_partition_new.restype = c.c_void_p
    lib.ue_partition_new.argtypes = [c.c_int, c.POINTER(c.c_size_t), c.c_size_t]
    lib.ue_partition_reserve.restype = c.c_size_t
    lib.ue_partition_reserve.argtypes = [c.c_void_p, c.c_size_t]
    lib.ue_partition_write.argtypes = [c.c_void_p, c.c_int, c.c_size_t, c.c_void_p, c.c_size_t]
    lib.ue_partition_write.restype = None
    lib.ue_partition_data.restype = c.c_void_p
    lib.ue_partition_data.argtypes = [c.c_void_p, c.c_int]
    lib.ue_partition_rows.restype = c.c_size_t
    lib.ue_partition_rows.argtypes = [c.c_void_p]
    lib.ue_partition_free.argtypes = [c.c_void_p]
    lib.ue_partition_free.restype = None
    lib.ue_timers_new.restype = c.c_void_p
    lib.ue_timers_new.argtypes = []
    lib.ue_timers_free.argtypes = [c.c_void_p]
    lib.ue_timers_free.restype = None
    lib.ue_timer_start.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.ue_timer_start.restype = None
    lib.ue_timer_stop.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.ue_timer_stop.restype = None
    lib.ue_timer_sum_ns.restype = c.c_uint64
    lib.ue_timer_sum_ns.argtypes = [c.c_void_p, c.c_char_p]
    lib.ue_timer_rank_count.restype = c.c_int
    lib.ue_timer_rank_count.argtypes = [c.c_void_p, c.c_char_p]
    lib.ue_executor_new.restype = c.c_void_p
    lib.ue_executor_new.argtypes = [c.c_int]
    lib.ue_executor_free.argtypes = [c.c_void_p]
    lib.ue_executor_free.restype = None
    lib.ue_executor_submit_memcpy.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_size_t]
    lib.ue_executor_submit_memcpy.restype = None
    lib.ue_executor_submit_partition_write.argtypes = [
        c.c_void_p, c.c_int, c.c_void_p, c.c_int, c.c_void_p, c.c_size_t, c.c_size_t,
    ]
    lib.ue_executor_submit_partition_write.restype = None
    lib.ue_executor_sync.argtypes = [c.c_void_p]
    lib.ue_executor_sync.restype = None


def library() -> ctypes.CDLL:
    """The loaded runtime, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def available() -> bool:
    """True once the runtime is built and loaded (raises if it cannot be)."""
    return library() is not None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def parallel_memcpy(dst: np.ndarray, src: np.ndarray, nthreads: int | None = None,
                    block_size: int = 1 << 20) -> None:
    """Threaded memcpy between contiguous numpy buffers (below two blocks,
    2 MB by default, one thread copies: the reference's kMemcopyThreshold,
    memcpy.h:24-26)."""
    if dst.nbytes != src.nbytes:
        raise ValueError(f"parallel_memcpy: {dst.nbytes} bytes into {src.nbytes}")
    if not (dst.flags.c_contiguous and src.flags.c_contiguous):
        raise ValueError("parallel_memcpy needs contiguous buffers")
    lib = library()
    if nthreads is None:
        nthreads = config.max_threads()
    lib.ue_parallel_memcpy(_ptr(dst), _ptr(src), dst.nbytes, nthreads, block_size)


def parallel_stack(arrays, out: np.ndarray | None = None) -> np.ndarray:
    """np.stack with the native threaded memcpy: copies each source array
    into one row of a preallocated (len(arrays), *shape) buffer through the
    queues of one OrderedExecutor that the process keeps (at most 8 queues,
    made at the first call; a call uses no more queues than it has rows,
    round-robin). The round-staging analog of the reference's
    BackgroundProcessBuffers parallel_memcopy dispatch
    (host/partition/partitioner.cc:249-278). Calls from several threads take
    the executor in turns."""
    global _stacker, _stacker_pid
    rows = [np.ascontiguousarray(a) for a in arrays]
    first = rows[0]
    for i, a in enumerate(rows):
        if a.shape != first.shape or a.dtype != first.dtype:
            raise ValueError(f"parallel_stack: row {i} is {a.dtype}{a.shape}, "
                             f"row 0 {first.dtype}{first.shape}")
    if out is None:
        out = np.empty((len(rows),) + first.shape, dtype=first.dtype)
    with _stack_lock:
        if _stacker is None or _stacker_pid != os.getpid():  # a forked child has no workers
            _stacker = OrderedExecutor(max(1, min(config.max_threads(), 8)))
            _stacker_pid = os.getpid()
        nq = min(_stacker.nqueues, len(rows))
        for i, a in enumerate(rows):
            _stacker.submit_memcpy(i % nq, out[i], a)
        _stacker.sync()
    return out


class PartitionSlab:
    """Columnar output buffer with an atomic row cursor (Partition analog)."""

    def __init__(self, dtypes, capacity_rows: int):
        self._lib = library()
        self.dtypes = [np.dtype(d) for d in dtypes]
        self.capacity_rows = capacity_rows
        sizes = (ctypes.c_size_t * len(self.dtypes))(*[d.itemsize for d in self.dtypes])
        self._h = self._lib.ue_partition_new(len(self.dtypes), sizes, capacity_rows)

    def reserve(self, nrows: int) -> int:
        start = self._lib.ue_partition_reserve(self._h, nrows)
        if start == ctypes.c_size_t(-1).value:
            raise OverflowError("partition slab overflow")  # partition.cc:19-26
        return start

    def write(self, col: int, start_row: int, src: np.ndarray) -> None:
        if src.dtype != self.dtypes[col] or not src.flags.c_contiguous:
            raise ValueError(f"slab column {col} takes contiguous {self.dtypes[col]}")
        self._lib.ue_partition_write(self._h, col, start_row, _ptr(src), len(src))

    def append(self, *cols: np.ndarray) -> int:
        start = self.reserve(len(cols[0]))
        for i, c in enumerate(cols):
            self.write(i, start, c)
        return start

    @property
    def rows(self) -> int:
        return self._lib.ue_partition_rows(self._h)

    def column(self, col: int) -> np.ndarray:
        """Zero-copy view of the written prefix of a column. The view is
        valid only while this slab is alive (keep a reference)."""
        n = self.rows
        buf_t = ctypes.c_char * (n * self.dtypes[col].itemsize)
        buf = buf_t.from_address(self._lib.ue_partition_data(self._h, col))
        return np.frombuffer(buf, dtype=self.dtypes[col], count=n)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ue_partition_free(self._h)
            self._h = None


class NativeTimers:
    """Named per-rank nanosecond timers (host/timer/timer.{h,cc} analog)."""

    def __init__(self):
        self._lib = library()
        self._h = self._lib.ue_timers_new()

    def start(self, name: str, rank: int = 0):
        self._lib.ue_timer_start(self._h, name.encode(), rank)

    def stop(self, name: str, rank: int = 0):
        self._lib.ue_timer_stop(self._h, name.encode(), rank)

    def sum_ns(self, name: str) -> int:
        return int(self._lib.ue_timer_sum_ns(self._h, name.encode()))

    def sum_ms(self, name: str) -> float:
        return self.sum_ns(name) / 1e6

    def rank_count(self, name: str) -> int:
        return int(self._lib.ue_timer_rank_count(self._h, name.encode()))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ue_timers_free(self._h)
            self._h = None


class OrderedExecutor:
    """Per-queue FIFO async executor (DpuSetAsync rank-queue analog). Every
    buffer handed to a job is kept alive until ``sync``."""

    def __init__(self, nqueues: int):
        self._lib = library()
        self.nqueues = nqueues
        self._h = self._lib.ue_executor_new(nqueues)
        self._keepalive = []

    def submit_memcpy(self, queue: int, dst: np.ndarray, src: np.ndarray):
        if dst.nbytes != src.nbytes or not (dst.flags.c_contiguous and src.flags.c_contiguous):
            raise ValueError("submit_memcpy needs contiguous buffers of one size")
        self._keepalive.append((dst, src))
        self._lib.ue_executor_submit_memcpy(self._h, queue, _ptr(dst), _ptr(src), dst.nbytes)

    def submit_partition_write(self, queue: int, slab: PartitionSlab, col: int,
                               src: np.ndarray, start_row: int):
        if src.dtype != slab.dtypes[col] or not src.flags.c_contiguous:
            raise ValueError(f"slab column {col} takes contiguous {slab.dtypes[col]}")
        self._keepalive.append((slab, src))
        self._lib.ue_executor_submit_partition_write(
            self._h, queue, slab._h, col, _ptr(src), len(src), start_row
        )

    def sync(self):
        self._lib.ue_executor_sync(self._h)
        self._keepalive.clear()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ue_executor_free(self._h)
            self._h = None

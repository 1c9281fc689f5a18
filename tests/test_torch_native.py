"""The port's native host runtime (dpu_olap_tpu_torch.native), twin of
tests/test_native.py: the seven tests against the port's binding, one
parity case a function against its plain version (np.copyto, np.stack, list
concatenation, the Python timers), and the build: a failing g++ raises with
the compiler's output, and the source lies inside the port's package. All
comparisons are exact (byte copies and integer counts); the timers' sums are
held to the slept time less a 10% margin, as tests/test_native.py does."""

import os
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import dpu_olap_tpu_torch
from dpu_olap_tpu_torch import native
from dpu_olap_tpu_torch.timer import Timers, _PyTimers


def test_parallel_memcpy_exact(rng):
    src = rng.integers(0, 2**32, size=1 << 21, dtype=np.uint32)
    dst = np.zeros_like(src)
    native.parallel_memcpy(dst, src, nthreads=8)
    np.testing.assert_array_equal(dst, src)


def test_parallel_memcpy_small_and_odd(rng):
    for n in [1, 63, 64, 65, 4097]:
        src = rng.integers(0, 256, size=n, dtype=np.uint8)
        dst = np.zeros_like(src)
        native.parallel_memcpy(dst, src, nthreads=4)
        np.testing.assert_array_equal(dst, src)


def test_partition_slab_append_and_views(rng):
    slab = native.PartitionSlab([np.uint32, np.uint32], capacity_rows=1024)
    a = rng.integers(0, 2**32, size=300, dtype=np.uint32)
    b = rng.integers(0, 2**32, size=300, dtype=np.uint32)
    assert slab.append(a, b) == 0
    c = rng.integers(0, 2**32, size=200, dtype=np.uint32)
    d = rng.integers(0, 2**32, size=200, dtype=np.uint32)
    slab.append(c, d)
    assert slab.rows == 500
    np.testing.assert_array_equal(slab.column(0), np.concatenate([a, c]))
    np.testing.assert_array_equal(slab.column(1), np.concatenate([b, d]))


def test_partition_slab_overflow():
    slab = native.PartitionSlab([np.uint32], capacity_rows=10)
    slab.reserve(8)
    with pytest.raises(OverflowError):  # partition.cc:19-26 throw analog
        slab.reserve(8)
    # a failed reservation rolls back: the remaining capacity stays usable
    assert slab.reserve(2) == 8


def test_timers_accumulate():
    t = native.NativeTimers()
    for rank in range(3):
        t.start("phase", rank)
    time.sleep(0.01)
    for rank in range(3):
        t.stop("phase", rank)
    assert t.rank_count("phase") == 3
    assert t.sum_ms("phase") >= 3 * 10 * 0.9  # summed across ranks
    assert t.sum_ns("missing") == 0


def test_executor_ordering_and_sync():
    # FIFO within a queue: later writes to the same dst win
    ex = native.OrderedExecutor(4)
    dst = np.zeros(1 << 16, dtype=np.uint32)
    first = np.full(1 << 16, 1, dtype=np.uint32)
    second = np.full(1 << 16, 2, dtype=np.uint32)
    for _ in range(50):
        ex.submit_memcpy(0, dst, first)
        ex.submit_memcpy(0, dst, second)
    ex.sync()
    np.testing.assert_array_equal(dst, second)


def test_executor_partition_write(rng):
    ex = native.OrderedExecutor(2)
    slab = native.PartitionSlab([np.uint32], capacity_rows=4096)
    chunks = [rng.integers(0, 2**32, size=512, dtype=np.uint32) for _ in range(8)]
    starts = [slab.reserve(512) for _ in range(8)]
    for q, (s, c) in enumerate(zip(starts, chunks)):
        ex.submit_partition_write(q % 2, slab, 0, c, s)
    ex.sync()
    got = slab.column(0)
    for s, c in zip(starts, chunks):
        np.testing.assert_array_equal(got[s : s + 512], c)


# ---- each function against its plain version ------------------------------


@pytest.mark.parametrize("nbytes, nthreads", [(3 << 20, 1), (3 << 20, 8), ((8 << 20) + 13, 3)])
def test_parallel_memcpy_matches_copyto(rng, nbytes, nthreads):
    src = rng.integers(0, 256, size=nbytes, dtype=np.uint8)
    dst, ref = np.zeros_like(src), np.zeros_like(src)
    native.parallel_memcpy(dst, src, nthreads=nthreads)
    np.copyto(ref, src)
    np.testing.assert_array_equal(dst, ref)


@pytest.mark.parametrize("rows, shape, dtype", [
    (1, (5,), np.uint32), (37, (1 << 12,), np.uint32), (9, (3, 5), np.float64),
    (1024, (1 << 10,), np.uint8),
])
def test_parallel_stack_matches_np_stack(rng, rows, shape, dtype):
    arrays = [rng.integers(0, 200, size=shape).astype(dtype) for _ in range(rows)]
    got = native.parallel_stack(arrays)
    ref = np.stack(arrays)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_parallel_stack_keeps_one_executor_across_calls_and_threads(rng):
    # the staging threads of several operators stack at once through the
    # one executor the process keeps; each gets np.stack's rows
    from concurrent.futures import ThreadPoolExecutor

    native.parallel_stack([np.zeros(3, np.uint32)])
    ex = native._stacker
    jobs = [[rng.integers(0, 2**32, 1 << 10, dtype=np.uint32) for _ in range(n)]
            for n in (1, 5, 8, 13, 32, 64)]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(native.parallel_stack, jobs * 3))
    for g, arrays in zip(got, jobs * 3):
        np.testing.assert_array_equal(g, np.stack(arrays))
    assert native._stacker is ex


def test_parallel_stack_rejects_ragged_rows():
    with pytest.raises(ValueError, match="row 1"):
        native.parallel_stack([np.zeros(4, np.uint32), np.zeros(5, np.uint32)])


def test_slab_through_executor_matches_concatenation(rng):
    # the Partitioner's flow: reserve, write every column through the
    # executor's queues, sync; the plain version concatenates
    ex = native.OrderedExecutor(3)
    slab = native.PartitionSlab([np.uint32, np.uint32], capacity_rows=1 << 14)
    plain = [[], []]
    for q in range(12):
        n = int(rng.integers(0, 900))
        cols = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(2)]
        if n:
            start = slab.reserve(n)
            for ci, c in enumerate(cols):
                ex.submit_partition_write(q % 3, slab, ci, c, start)
        for dst, c in zip(plain, cols):
            dst.append(c)
    ex.sync()
    for ci in range(2):
        np.testing.assert_array_equal(slab.column(ci), np.concatenate(plain[ci]))


def test_native_timers_match_python_timers():
    nt, pt = Timers(), _PyTimers()
    assert isinstance(nt, native.NativeTimers)
    for rank in range(4):
        for t in (nt, pt):
            t.start("phase", rank)
    time.sleep(0.005)
    for rank in range(4):
        for t in (nt, pt):
            t.stop("phase", rank)
    assert nt.rank_count("phase") == pt.rank_count("phase") == 4
    assert nt.sum_ns("missing") == pt.sum_ns("missing") == 0
    assert nt.sum_ms("phase") >= 4 * 5 * 0.9 and pt.sum_ms("phase") >= 4 * 5 * 0.9


# ---- the build -------------------------------------------------------------


def test_runtime_source_is_the_ports_own():
    pkg = Path(dpu_olap_tpu_torch.__file__).resolve().parent
    assert native.SOURCE.is_file() and pkg in native.SOURCE.parents
    assert native.BUILD_DIR == pkg / "_build"
    assert native.library_path().parent == native.BUILD_DIR
    assert "g++" not in native.library_path().name
    head = native.SOURCE.read_text().splitlines()[0]
    assert "copy of dpu_olap_tpu/native/runtime.cpp" in head


FAKE_GXX = textwrap.dedent(
    """\
    import sys
    print("runtime.cpp:1:1: error: stand-in failure", file=sys.stderr)
    sys.exit(1)
    """
)


def test_failing_gxx_raises_with_compiler_output(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    gxx = bindir / "g++"
    gxx.write_text(f"#!{sys.executable}\n" + FAKE_GXX)
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_stacker", None)  # parallel_stack's executor, made anew
    with pytest.raises(RuntimeError, match="stand-in failure") as err:
        native.library()
    assert str(gxx) in str(err.value)
    assert list((tmp_path / "_build").iterdir()) == []  # nothing left behind
    with pytest.raises(RuntimeError, match="stand-in failure"):
        native.parallel_stack([np.zeros(4, np.uint32)])  # no fallback to np.stack

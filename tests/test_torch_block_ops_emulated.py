"""The in-block primitive ops' CUDA source (dpu_olap_tpu_torch/csrc/
block_ops.cu) run on the CPU, against the plain version ``block_op_ref``.

The kernels are compiled with the host C++ compiler against
tests/block_ops_emu.h, which runs each CUDA thread of a block as a
std::thread and gives __syncthreads, __syncwarp, __shfl_sync and
__reduce_add_sync their meaning with barriers; the launches run one block
at a time. count_matmul's kernel (inline PTX for the tensor cores) is left
out (BLOCK_OPS_WITHOUT_COUNT_MATMUL). This checks the kernels' index
arithmetic, their use of shared memory (filled with 0xCD before each
block) and their barriers' placement, bit for bit, before any build for
the card. It says nothing about speed, and a race
that the barriers miss need not show here.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dpu_olap_tpu_torch.ops import block_ops_cuda as bo

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "dpu_olap_tpu_torch" / "csrc" / "block_ops.cu"
HEADER = Path(__file__).resolve().parent / "block_ops_emu.h"
OPS = [op for op in bo.OPS + bo.COPS if op != "count_matmul"]
EDGE = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1, 127, 128, 255, 256,
                 2**30, -129], np.int32)


def _host_source(src: str) -> str:
    """block_ops.cu as host C++ without count_matmul: the CUDA runtime, the
    dynamic shared memory and the launches replaced by the stand-in's."""
    src = src.replace("#include <cuda_runtime.h>",
                      f'#define BLOCK_OPS_WITHOUT_COUNT_MATMUL\n#include "{HEADER}"')
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu::smem;")
    src, n = re.subn(r"KERNEL<<<\(unsigned\)p\.grid, p\.threads, p\.smem, s>>>\(([^)]*)\);",
                     r"emu::run(KERNEL, p.grid, p.threads, p.smem, \1);", src)
    assert n == 1
    return src


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++ or clang++) with C++20's <barrier>")
    d = tmp_path_factory.mktemp("block_ops_emu")
    cpp = d / "block_ops_emu.cpp"
    cpp.write_text(_host_source(SOURCE.read_text()))
    so = d / "libblock_ops_emu.so"
    res = subprocess.run([cxx, "-std=c++20", "-O1", "-Wall", "-Wno-unknown-pragmas", "-shared",
                          "-fPIC", "-pthread", "-o", str(so), str(cpp)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    out = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    out.dpu_block_op_i32.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, p]
    return out


def _inputs(op, nblk, seed):
    rng = np.random.default_rng(seed)
    shape = (nblk * bo.ROWS[op], 128)
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    x.flat[: len(EDGE)] = EDGE
    idx = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    near = (x.astype(np.int64) >> 7) + rng.integers(-2, 3, shape)
    idx = np.where(rng.random(shape) < 1 / 3, near, idx).astype(np.int32)
    idx.flat[-len(EDGE):] = EDGE
    return x, idx


def _aligned(shape):
    """A zeroed int32 array of shape whose data starts 16-byte aligned."""
    n = int(np.prod(shape))
    buf = np.zeros(n + 4, np.int32)
    off = (-buf.ctypes.data % 16) // 4
    return buf[off: off + n].reshape(shape)


@pytest.mark.parametrize("nblk, reps", [(1, 0), (1, 1), (2, 2), (3, 17), (1, 16), (2, 5)])
@pytest.mark.parametrize("op", OPS)
def test_kernel_source_matches_plain(lib, op, nblk, reps):
    x0, i0 = _inputs(op, nblk, nblk * 100 + reps)
    x, idx, out = _aligned(x0.shape), _aligned(x0.shape), _aligned(x0.shape)
    x[...], idx[...] = x0, i0
    out[...] = 0x5A5A5A5A
    rc = lib.dpu_block_op_i32(x.ctypes.data, idx.ctypes.data, out.ctypes.data, nblk,
                              bo.CODES[op], reps, None)
    assert rc == 0
    ref = bo.block_op_ref(torch.from_numpy(x0), torch.from_numpy(i0), op, reps)
    np.testing.assert_array_equal(out, ref.numpy())


@pytest.mark.parametrize("op", OPS)
def test_kernel_source_refuses_a_misaligned_plane(lib, op):
    """The C entry refuses x, out, and idx where the op reads it, that do not
    start 16-byte aligned (cudaErrorInvalidValue, 1, before any launch)."""
    x = _aligned((bo.ROWS[op] * 128 + 4,))
    view = x[1: 1 + bo.ROWS[op] * 128]  # 4 bytes past a 16-byte boundary
    good = x[4:]
    call = lib.dpu_block_op_i32
    code = bo.CODES[op]
    assert call(view.ctypes.data, good.ctypes.data, good.ctypes.data, 1, code, 1, None) == 1
    assert call(good.ctypes.data, good.ctypes.data, view.ctypes.data, 1, code, 1, None) == 1
    rc = call(good.ctypes.data, view.ctypes.data, good.ctypes.data, 1, code, 1, None)
    assert rc == (0 if op in bo.IDX_FREE else 1)

"""The probe primitives' CUDA source (dpu_olap_tpu_torch/csrc/probes.cu)
run on the CPU, against the plain versions in ops/probes_cuda.py.

The kernels are compiled with the host C++ compiler against
tests/block_ops_emu.h, which runs each CUDA thread of a block as a
std::thread and gives __syncthreads and __syncwarp their meaning with
barriers; every launch ``K<<<grid, block, smem, stream>>>(args)`` becomes
the stand-in's ``emu::Launch(grid, block, smem, stream).run(K)(args)``, one
block at a time. The one-hot product (inline PTX for the tensor cores) is
left out (PROBES_WITHOUT_ONEHOT). This checks both gathers at gather_plan's
launches (the warp-a-row kernel up to 128 values a row, the block-staged
kernel from 129 to 2048, on aligned and misaligned views, with out-of-range
indices), the transpose and the dyn row bit for bit before any build for
the card. It says nothing about speed.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dpu_olap_tpu_torch.ops import probes_cuda as pc

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "dpu_olap_tpu_torch" / "csrc" / "probes.cu"
HEADER = Path(__file__).resolve().parent / "block_ops_emu.h"


def _host_source(src: str) -> str:
    """probes.cu as host C++ without the one-hot product: the CUDA runtime,
    the dynamic shared memory and the launches replaced by the stand-in's."""
    src = src.replace("#include <cuda_runtime.h>",
                      f'#define PROBES_WITHOUT_ONEHOT\n#include "{HEADER}"')
    src = src.replace("extern __shared__ uint32_t srow[];",
                      "uint32_t* srow = reinterpret_cast<uint32_t*>(emu::smem);")
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\(", r"emu::Launch(\2).run(\1)(", src, flags=re.S)
    # the two gathers, the transpose, the dyn row, the noop, and the one-hot
    # product's, which PROBES_WITHOUT_ONEHOT leaves out of the build
    assert n == 6
    return src


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++ or clang++) with C++20's <barrier>")
    d = tmp_path_factory.mktemp("probes_emu")
    cpp = d / "probes_emu.cpp"
    cpp.write_text(_host_source(SOURCE.read_text()))
    so = d / "libprobes_emu.so"
    res = subprocess.run([cxx, "-std=c++20", "-O1", "-Wall", "-Wno-unknown-pragmas",
                          "-Wno-sign-compare", "-shared", "-fPIC", "-pthread", "-o", str(so),
                          str(cpp)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    out = ctypes.CDLL(str(so))
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    out.dpu_lane_gather_u32.argtypes = [p, p, p, ll, ll, ll, ctypes.c_int, ll, ctypes.c_int, p]
    out.dpu_transpose_u32.argtypes = [p, p, ll, ll, p]
    out.dpu_dyn_row_u32.argtypes = [p, p, p, ll, ll, p]
    out.dpu_noop.argtypes = [p]
    return out


def _buffer(n, dtype, offset_words=0):
    """n zeroed words whose data starts offset_words 4-byte words past a
    16-byte boundary."""
    buf = np.zeros(n + 8, dtype)
    start = (-buf.ctypes.data % 16) // 4 + offset_words
    return buf[start: start + n]


def _gather_inputs(rows, wv, wi, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, (rows, wv), dtype=np.uint32)
    i = rng.integers(0, wv, (rows, wi), dtype=np.int32)
    i[0, : min(3, wi)] = [-1, wv, 2**31 - 1][: min(3, wi)]  # out of range: 0
    i[-1, -min(3, wi):] = [wv, -1, -2**31][: min(3, wi)]
    return x, i


def _gather(lib, x0, i0, x_off=0, i_off=0, o_off=0):
    """The gather at gather_plan's launch, on views at the offsets given."""
    rows, wv = x0.shape
    wi = i0.shape[1]
    x = _buffer(x0.size, np.uint32, x_off)
    i = _buffer(i0.size, np.int32, i_off)
    out = _buffer(rows * wi, np.uint32, o_off)
    x[:], i[:] = x0.reshape(-1), i0.reshape(-1)
    out[:] = 0x5A5A5A5A
    plan = pc.gather_plan(rows, wv, wi)
    rc = lib.dpu_lane_gather_u32(x.ctypes.data, i.ctypes.data, out.ctypes.data, rows, wv, wi,
                                 pc.GATHER_KERNELS.index(plan.kernel), plan.grid,
                                 plan.rows_per_block, None)
    return rc, out.reshape(rows, wi)


def _gather_ref(x, i):
    return pc.lane_gather_ref(torch.from_numpy(x), torch.from_numpy(i)).numpy()


# the warp-a-row kernel's widest rows and the staged kernel's: both kernels
GATHER_WV = [pc.ROW_WORDS, 2 * pc.ROW_WORDS]


@pytest.mark.parametrize("wv", GATHER_WV)
@pytest.mark.parametrize("rows", [1, 31, 32, 33, 128])
@pytest.mark.parametrize("wi", [128, 256])
def test_gather_matches_plain(lib, wv, rows, wi):
    x, i = _gather_inputs(rows, wv, wi, rows + wi)
    rc, got = _gather(lib, x, i)
    assert rc == 0
    np.testing.assert_array_equal(got, _gather_ref(x, i))


@pytest.mark.parametrize("wv", GATHER_WV)
@pytest.mark.parametrize("which", ["x", "idx", "out", "all"])
@pytest.mark.parametrize("wi", [128, 256])
def test_gather_misaligned_views(lib, wv, which, wi):
    """Planes 4 bytes past a 16-byte boundary take the kernels' 4-byte loads
    and stores, inside the kernel, and give the same values."""
    x, i = _gather_inputs(33, wv, wi, 7)
    offs = {k: int(which in (k, "all")) for k in ("x", "idx", "out")}
    rc, got = _gather(lib, x, i, offs["x"], offs["idx"], offs["out"])
    assert rc == 0
    np.testing.assert_array_equal(got, _gather_ref(x, i))


@pytest.mark.parametrize("rows, wv, wi", [
    (9, 96, 40), (5, 7, 5), (3, 128, 300), (6, 1, 1), (4, 128, 2048), (2, 126, 131),
    (9, 129, 40), (5, 131, 5), (3, 200, 300), (6, 2047, 1), (4, 1000, 2048), (2, 2048, 131)])
def test_gather_ragged_widths(lib, rows, wv, wi):
    """Widths that are not multiples of 4 (rows then start off 16 bytes),
    index rows of several passes of the warp-a-row kernel, and the staged
    kernel at 1 to 15 rows a block."""
    x, i = _gather_inputs(rows, wv, wi, rows * wv + wi)
    rc, got = _gather(lib, x, i)
    assert rc == 0
    np.testing.assert_array_equal(got, _gather_ref(x, i))


@pytest.mark.parametrize("wv", [pc.ROW_WORDS, pc.ROW_WORDS + 1])
@pytest.mark.parametrize("rows", [300, 4224])
def test_gather_plan_kernel_either_side_of_its_width(lib, wv, rows):
    """The plan's kernel, the warp-a-row kernel up to 128 values a row and
    the staged kernel past it, at 4224 rows (two staged blocks an SM)."""
    x, i = _gather_inputs(rows, wv, 128, rows + wv)
    assert pc.gather_plan(rows, wv, 128).kernel == (
        "warp_rows" if wv <= pc.ROW_WORDS else "staged")
    rc, got = _gather(lib, x, i)
    assert rc == 0
    np.testing.assert_array_equal(got, _gather_ref(x, i))


def test_gather_refuses_a_launch_its_kernel_does_not_take(lib):
    """cudaErrorInvalidValue (1), before any launch: a row of more values
    than the warp-a-row kernel holds, another count of rows a warp-a-row
    block, more staged rows than a block holds, a grid short of the rows,
    and a kernel code of no kernel; gather_plan's launch goes."""
    x, i = _gather_inputs(40, 129, 8, 0)
    out = np.zeros(40 * 8, np.uint32)
    args = (x.ctypes.data, i.ctypes.data, out.ctypes.data, 40, 129, 8)
    warp, staged = pc.GATHER_KERNELS.index("warp_rows"), pc.GATHER_KERNELS.index("staged")
    assert lib.dpu_lane_gather_u32(*args, staged, 3, 15, None) == 0
    for launch in ((warp, 10, 4), (staged, 3, 16), (staged, 2, 15), (staged, 0, 15),
                   (2, 40, 1)):
        assert lib.dpu_lane_gather_u32(*args, *launch, None) == 1, launch
    x, i = _gather_inputs(40, 128, 8, 0)
    args = (x.ctypes.data, i.ctypes.data, out.ctypes.data, 40, 128, 8)
    assert lib.dpu_lane_gather_u32(*args, warp, 10, 4, None) == 0
    assert lib.dpu_lane_gather_u32(*args, warp, 10, 8, None) == 1


@pytest.mark.parametrize("shape", [(128, 128), (512, 128), (1, 1), (33, 70), (40, 31)])
def test_transpose_matches_plain(lib, shape):
    x = np.random.default_rng(shape[0]).integers(0, 2**32, shape, dtype=np.uint32)
    out = np.full(shape[::-1], 0x5A5A5A5A, np.uint32)
    assert lib.dpu_transpose_u32(x.ctypes.data, out.ctypes.data, *shape, None) == 0
    np.testing.assert_array_equal(out, pc.transpose_ref(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("row", [0, 317, 511, -1, 512, -2**31])
def test_dyn_row_matches_plain(lib, row):
    x = np.random.default_rng(2).integers(0, 2**32, (512, 128), dtype=np.uint32)
    r = np.array([row], np.int32)
    out = np.full(128, 0x5A5A5A5A, np.uint32)
    assert lib.dpu_dyn_row_u32(x.ctypes.data, r.ctypes.data, out.ctypes.data, 512, 128, None) == 0
    want = pc.dyn_row_ref(torch.from_numpy(x), torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(out, want.reshape(-1))


def test_noop_launches_and_returns_0(lib):
    assert lib.dpu_noop(None) == 0

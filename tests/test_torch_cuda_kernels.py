"""The port's CUDA kernels against their plain versions on the card, bit for
bit on every lane: the partition kernel (csrc/partition.cu: tile edges,
one bucket with and without overflow, P = 16 with two payload groups), the
merge-probe kernel (csrc/merge_probe.cu: empty and one-key sides, sparse
and dense probes, keys outside the build range, a run over tile edges, an
unsorted and a misaligned probe), the filter alternates
(csrc/filter2.cu, filter3.cu, filter4.cu; each at its one-sweep edges,
with indices at 8Mi and 64Mi, replayed from a graph, and refusing an
output that is not 16-byte aligned) and the five
stages of the filter stage ablation (csrc/filter.cu; lookback on
[:count]), the in-block primitive ops (csrc/block_ops.cu: every op on 1,
3, 64 and 264 blocks at reps 0, 1, 2, 16 and 17, indices over the whole
int32 range, misaligned views refused), the
probe primitives (csrc/probes.cu), the sort's tile stage (csrc/sort.cu),
the radix sort (csrc/radix_sort.cu) and the sorted gather (csrc/gather.cu),
count_matmul on the tensor cores (csrc/block_ops.cu: reps 0, 1, 2, 16, 17
on 1, 5, 128 and 264 tiles, products not all 0, a misaligned view
refused), the lane gather (csrc/probes.cu: W_i = 128 and 256 at 1 to 32768
rows, either side of gather_plan's threshold, on each kernel, out-of-range
indices, misaligned views), the one-hot product (K of 16 to 4096, M and N of
16 to 256, misaligned planes refused) and the noop,
the block merge (csrc/sort.cu: every pass structure of merge_plan, ties,
the top-bit edges, misaligned views, in == out, the sorted-build join's
call) and the tile stage at its geometry's edges,
the forward fill in both modes (csrc/scan.cu), the co-sort joins' fill
and match (csrc/scan.cu fill_match_kernel: 0 to 3 payloads a side, masked,
pad and unsorted lanes, and 2^29 lanes) and its compacting form (the same
edges, a capacity below the count, 2^29 lanes against the padded form's
matched rows) and filter v1
(csrc/filter.cu) at their one-sweep edges (lengths around a tile and not a
multiple of 4, misaligned views, dead stretches over many tiles, one kept
value in the last tile; v1's ENABLE_TRACE sweep against the untraced one
and its printf lines against the plain version's), and the graph-captured
chain timing, a captured
sort and gather, a captured merge-probe and partition, a captured fill
and filter and a captured block merge and tile stage. A CUDA
kernel has no CPU mode, so
every test here is marked ``cuda`` and skips without a device. This file
imports no jax (the machine with the card has none) and takes no fixture of
tests/conftest.py, which imports jax; on that machine run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import ctypes

import numpy as np
import pytest
import torch

from dpu_olap_tpu_torch.bench import device_time
from dpu_olap_tpu_torch.ops import (
    _kernels,
    bitonic_cuda,
    block_ops_cuda,
    filter_alt_cuda,
    fill_match_compact_cuda,
    fill_match_cuda,
    filter_cuda,
    filter_stages,
    merge,
    merge_cuda,
    partition_cuda,
    probes_cuda,
    scan_cuda,
    sort_cuda,
    take_cuda,
)
from fill_match_cases import KINDS, k2_case

EMPTY = np.uint32(0xFFFFFFFF)
EDGE_KEYS = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.array_equal(g.cpu().numpy(), r.cpu().numpy())


TILE = partition_cuda.TILE


@pytest.mark.cuda
@pytest.mark.parametrize("p, n, cell, n_pay", [
    (2, 1 << 16, 1 << 16, 1),
    (8, 3 * 4096 + 17, 2048, 3),
    (16, 1 << 16, 1 << 13, 0),
    (8, 1 << 14, 1024, 9),  # two launches; every bucket overflows
    (4, 1, 1, 1),
    (8, TILE - 1, TILE, 1),  # a ragged only tile, a whole one, one row past it
    (8, TILE, TILE, 1),
    (8, TILE + 1, TILE, 2),
    (16, 5 * TILE + 3, TILE, 9),  # P = 16, two payload groups
    (2, 1 << 20, 1 << 20, 1),  # the SF=64 side's P and cell, cut down
])
@pytest.mark.parametrize("with_sel", [True, False])  # False: the operators' call
def test_partition_kernel_matches_plain(cuda_device, p, n, cell, n_pay, with_sel):
    rng = np.random.default_rng(5)
    k = rng.integers(0, 2**32, n, dtype=np.uint32)
    k[: min(n, len(EDGE_KEYS))] = EDGE_KEYS[:n]
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay)]
    _partition_same(cuda_device, k, pays, p, cell, with_sel)


@pytest.mark.cuda
@pytest.mark.parametrize("n, cell", [
    (3 * TILE + 5, 3 * TILE + 5),  # every row in one bucket: tiles of one bucket
    (3 * TILE + 5, TILE + 100),  # and the cut-off falls inside a tile
    (3 * TILE + 5, 1),
])
@pytest.mark.parametrize("key", [12345, 0xFFFFFFFF])
def test_partition_kernel_one_bucket(cuda_device, n, cell, key):
    pays = [np.arange(n, dtype=np.uint32)]
    _partition_same(cuda_device, np.full(n, key, np.uint32), pays, 8, cell, True)


def _partition_same(cuda_device, k, pays, p, cell, with_sel):
    n = len(k)
    n_pay = len(pays)
    dev = [torch.from_numpy(a).to(cuda_device) for a in (k, *pays)]
    before = partition_cuda.LAUNCHES
    got = partition_cuda.partition_cells(dev[0], tuple(dev[1:]), p, cell, with_sel=with_sel)
    assert partition_cuda.LAUNCHES == before + max(1, -(-n_pay // partition_cuda.MAX_PAYLOADS))
    ref = partition_cuda.partition_cells_ref(dev[0], tuple(dev[1:]), p, cell, with_sel=with_sel)
    assert (got[2] is None) == (ref[2] is None) == (not with_sel)
    sel = (got[2],) if with_sel else ()
    ref_sel = (ref[2],) if with_sel else ()
    _same((got[0], *got[1], *sel, got[3], got[4]), (ref[0], *ref[1], *ref_sel, ref[3], ref[4]))


@pytest.mark.cuda
@pytest.mark.parametrize("nl, nr, n_pay", [
    (1 << 16, 1 << 16, 1), (3 * 1000 + 7, 1 << 15, 3), (5000, 0, 1), (1 << 14, 1000, 8),
    (5000, 1, 1), (5000, 0, 0), (1, 1 << 16, 2),  # nr = 0 and 1; one probe key
    (1 << 18, 100, 1), (1000, 1 << 20, 1),  # nl >> nr; nl << nr (ranges past STAGE)
    (merge_cuda.TILE + 1, 1 << 12, 0), (merge_cuda.TILE - 1, 7, 5),
])
def test_merge_probe_kernel_matches_plain(cuda_device, nl, nr, n_pay):
    rng = np.random.default_rng(9)
    right = np.sort(rng.choice(2**31, size=nr, replace=False).astype(np.uint32))
    pays = [rng.integers(0, 2**32, nr, dtype=np.uint32) for _ in range(n_pay)]
    left = np.sort(rng.integers(0, 2**31, nl).astype(np.uint32))
    if nl > 64:  # EMPTY tails on both sides
        left[-7:] = EMPTY
        right[-min(nr, 3):] = EMPTY
    _merge_probe_same(cuda_device, left, right, pays)


def _merge_probe_same(cuda_device, left, right, pays, offset=0):
    dev = [torch.from_numpy(a).to(cuda_device) for a in (left, right, *pays)]
    dev[0] = dev[0][offset:]  # a slice: not 16-byte aligned for an odd offset
    before = merge_cuda.LAUNCHES
    got = merge_cuda.merge_probe(dev[0], dev[1], tuple(dev[2:]))
    assert merge_cuda.LAUNCHES == before + 1
    ref = merge_cuda.merge_probe_ref(dev[0], dev[1], tuple(dev[2:]))
    _same((got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["below", "above", "run_over_edges", "unsorted", "offset"])
def test_merge_probe_kernel_edges(cuda_device, case):
    """Probe keys all below or all above every build key; a run of equal
    keys over tile edges; an unsorted probe (each key still gets its own
    answer); a probe slice at an odd offset."""
    rng = np.random.default_rng(13)
    nr, t = 1 << 14, merge_cuda.TILE
    right = np.sort(rng.choice(2**30, size=nr, replace=False).astype(np.uint32)) + np.uint32(1000)
    pays = [rng.integers(0, 2**32, nr, dtype=np.uint32) for _ in range(2)]
    left = np.sort(rng.integers(1000, 2**30, 3 * t + 5).astype(np.uint32))
    if case == "below":
        left = np.sort(rng.integers(0, 1000, 3 * t + 5)).astype(np.uint32)
    elif case == "above":
        left = np.sort(rng.integers(2**31, 2**32, 3 * t + 5)).astype(np.uint32)
    elif case == "run_over_edges":
        left[t - 50: 3 * t + 2] = right[nr // 2]
        left = np.sort(left)
    elif case == "unsorted":
        left = rng.permutation(left)
    _merge_probe_same(cuda_device, left, right, pays, offset=1 if case == "offset" else 0)


@pytest.mark.cuda
def test_merge_probe_and_partition_replay_in_a_graph(cuda_device):
    rng = np.random.default_rng(17)
    nr, nl, n = 1 << 16, (1 << 16) + 5, 3 * TILE + 9
    right = torch.from_numpy(np.sort(rng.choice(2**31, nr, replace=False).astype(np.uint32)))
    left = torch.from_numpy(np.sort(rng.integers(0, 2**31, nl).astype(np.uint32)))
    right_pay = torch.from_numpy(rng.integers(0, 2**32, nr, dtype=np.uint32))
    keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32))
    pay = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32))
    right, right_pay, left, keys, pay = (t.to(cuda_device)
                                         for t in (right, right_pay, left, keys, pay))

    def step():
        probe = merge_cuda.merge_probe(left, right, (right_pay,))
        cells = partition_cuda.partition_cells(keys, (pay,), 8, TILE)
        return (*probe[:2], *probe[2], cells[0], *cells[1], cells[2], cells[3], cells[4])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    left.copy_(torch.sort(left.view(torch.int32) ^ 0x5555).values.view(torch.uint32))
    keys.copy_(torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda_device))
    graph.replay()
    graph.replay()  # the second replay clears and reuses the work memory
    torch.cuda.synchronize()
    probe = merge_cuda.merge_probe_ref(left, right, (right_pay,))
    cells = partition_cuda.partition_cells_ref(keys, (pay,), 8, TILE)
    _same(outs, (*probe[:2], *probe[2], cells[0], *cells[1], cells[2], cells[3], cells[4]))


@pytest.mark.cuda
@pytest.mark.parametrize("version", filter_alt_cuda.VERSIONS)
@pytest.mark.parametrize("n", [1, 4096, 100_003, 1 << 20, 8 << 20])
@pytest.mark.parametrize("threshold", [0, 1 << 30, 1 << 31, 0xFFFFFFFF])
def test_filter_alternate_matches_plain(cuda_device, version, n, threshold):
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2**32, n, dtype=np.uint32)
    v[: min(n, len(EDGE_KEYS))] = EDGE_KEYS[:n]
    x = torch.from_numpy(v).to(cuda_device)
    before = filter_alt_cuda.LAUNCHES[version]
    got = filter_alt_cuda.filter_compact(x, version, threshold, fill=7)
    got_i = filter_alt_cuda.filter_with_indices(x, version, threshold)
    assert filter_alt_cuda.LAUNCHES[version] == before + 2
    _same(got, filter_alt_cuda.filter_compact_ref(x, version, threshold, fill=7))
    _same(got_i, filter_alt_cuda.filter_with_indices_ref(x, version, threshold))
    keep = v < threshold
    assert int(got[1]) == keep.sum()
    assert np.array_equal(got_i[1].cpu().numpy()[: keep.sum()], np.flatnonzero(keep))
    if threshold == filter_cuda.THRESHOLD:  # v1's kernel computes the same function
        _same(got_i, filter_cuda.filter_with_indices(x))
        _same(filter_alt_cuda.filter_padded(x, version, 7), filter_cuda.filter_compact(x, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", filter_stages.STAGES)
@pytest.mark.parametrize("n", [1, 3 * 4096 + 17, 1 << 20, 8 << 20])
def test_filter_stage_matches_plain(cuda_device, stage, n):
    v = np.random.default_rng(3).integers(0, 2**32, n, dtype=np.uint32)
    x = torch.from_numpy(v).to(cuda_device)
    before = filter_stages.LAUNCHES
    got = filter_stages.filter_stage(x, stage)
    assert filter_stages.LAUNCHES == before + 1
    ref = filter_stages.filter_stage_ref(x, stage)
    assert [g is None for g in got] == [r is None for r in ref]
    if stage == "lookback":  # the stage leaves out[count:] unwritten
        c = int(ref[2])
        got, ref = (got[0][:c], *got[1:]), (ref[0][:c], *ref[1:])
    _same([g for g in got if g is not None], [r for r in ref if r is not None])


EDGE_I32 = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1, 127, 128, 2**30], np.int32)


def _block_inputs(rows, nblk, seed):
    """int32 values over the whole range (edge values first, so the wrapping
    adds run) and indices over the whole int32 range, negative values and
    the +-2^31 edges included, a third of them near x >> 7 so that cprep's
    compare counts both ways."""
    rng = np.random.default_rng(seed)
    shape = (nblk * rows, 128)
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    x.flat[: len(EDGE_I32)] = EDGE_I32
    x[-1, -len(EDGE_I32):] = EDGE_I32
    idx = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    near = (x.astype(np.int64) >> 7) + rng.integers(-2, 3, shape)
    idx = np.where(rng.random(shape) < 1 / 3, near, idx).astype(np.int32)
    idx.flat[: len(EDGE_I32)] = EDGE_I32[::-1]
    idx[-1, -len(EDGE_I32):] = EDGE_I32
    return x, idx


@pytest.mark.cuda
@pytest.mark.parametrize("op", block_ops_cuda.OPS + block_ops_cuda.COPS)
@pytest.mark.parametrize("nblk", [1, 3, 64, 264])  # 264: more blocks than SMs, a partial wave
@pytest.mark.parametrize("reps", [0, 1, 2, 16, 17])  # 17: the roll's shift cycles past 4
def test_block_op_matches_plain(cuda_device, op, nblk, reps):
    rows = block_ops_cuda.ROWS[op]
    x, idx = (torch.from_numpy(a).to(cuda_device)
              for a in _block_inputs(rows, nblk, rows + 10 * nblk + reps))
    before = block_ops_cuda.LAUNCHES[op]
    got = block_ops_cuda.block_op(x, idx, op, reps)
    assert block_ops_cuda.LAUNCHES[op] == before + 1
    _same([got], [block_ops_cuda.block_op_ref(x, idx, op, reps)])


@pytest.mark.cuda
@pytest.mark.parametrize("op", block_ops_cuda.OPS + block_ops_cuda.COPS)
def test_block_op_refuses_misaligned_views(cuda_device, op):
    """Every block-op kernel reads with 16-byte loads: x, and idx where the
    op reads it, 4 bytes past a 16-byte boundary are refused before any
    launch."""
    rows = block_ops_cuda.ROWS[op]
    flat = torch.zeros(rows * 128 + 4, dtype=torch.int32, device=cuda_device)
    view = flat[1: 1 + rows * 128].view(rows, 128)
    good = flat[4:].view(rows, 128)
    before = block_ops_cuda.LAUNCHES[op]
    with pytest.raises(ValueError, match="16-byte aligned"):
        block_ops_cuda.block_op(view, good, op, 1)
    if op in block_ops_cuda.IDX_FREE:
        _same([block_ops_cuda.block_op(good, view, op, 1)],
              [block_ops_cuda.block_op_ref(good, view, op, 1)])
        assert block_ops_cuda.LAUNCHES[op] == before + 1
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            block_ops_cuda.block_op(good, view, op, 1)
        assert block_ops_cuda.LAUNCHES[op] == before


def _count_matmul_inputs(nblk, seed):
    """Tiles whose products are not all 0: v in [-2^14, 2^14) with the edge
    values (negative v, where v >> 7 is negative), half the indices equal
    to (v >> 7) & 127, the others any int32 (only idx & 127 counts); from 2
    tiles on, the second is all 0, where every sum of the first rep is 128."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**14, 2**14, (nblk * 128, 128), dtype=np.int64).astype(np.int32)
    x.flat[: len(EDGE_I32)] = EDGE_I32
    x[-1, -len(EDGE_I32):] = EDGE_I32
    idx = np.where(rng.random(x.shape) < 0.5, (x >> 7) & 127,
                   rng.integers(-2**31, 2**31, x.shape, dtype=np.int64)).astype(np.int32)
    idx.flat[: len(EDGE_I32)] = EDGE_I32
    if nblk > 1:
        x[128:256] = 0
        idx[128:256] = 0
    return x, idx


@pytest.mark.cuda
@pytest.mark.parametrize("nblk", [1, 5, 128, 264])  # 264: two waves on 132 SMs
@pytest.mark.parametrize("reps", [0, 1, 2, 16, 17])
def test_count_matmul_matches_plain(cuda_device, nblk, reps):
    x, idx = (torch.from_numpy(a).to(cuda_device) for a in _count_matmul_inputs(nblk, nblk + reps))
    before = block_ops_cuda.LAUNCHES["count_matmul"]
    got = block_ops_cuda.block_op(x, idx, "count_matmul", reps)
    assert block_ops_cuda.LAUNCHES["count_matmul"] == before + 1
    _same([got], [block_ops_cuda.block_op_ref(x, idx, "count_matmul", reps)])


@pytest.mark.cuda
def test_count_matmul_refuses_a_misaligned_view(cuda_device):
    flat = torch.zeros(128 * 128 + 1, dtype=torch.int32, device=cuda_device)
    x = flat[1:].view(128, 128)  # contiguous, 4 bytes past a 16-byte boundary
    before = block_ops_cuda.LAUNCHES["count_matmul"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        block_ops_cuda.block_op(x, x, "count_matmul", 1)
    assert block_ops_cuda.LAUNCHES["count_matmul"] == before


def _lane_gather_same(x, i):
    before = probes_cuda.LAUNCHES["lane_gather"]
    got = probes_cuda.lane_gather(x, i)
    assert probes_cuda.LAUNCHES["lane_gather"] == before + 1
    _same([got], [probes_cuda.lane_gather_ref(x, i)])


def _lane_gather_inputs(rows, wv, wi, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, (rows, wv), dtype=np.uint32)
    i = rng.integers(0, wv, (rows, wi), dtype=np.int32)
    i[0, :3] = [-1, wv, 2**31 - 1]  # out of range: 0 in both versions
    i[-1, -3:] = [wv, -1, -2**31]
    return x, i


@pytest.mark.cuda
@pytest.mark.parametrize("rows, wv, wi", [(8192, 128, 128), (32768, 128, 128), (128, 128, 256),
                                          (1000, 96, 40), (3, 2048, 7)])
def test_lane_gather_matches_plain(cuda_device, rows, wv, wi):
    _lane_gather_same(*(torch.from_numpy(a).to(cuda_device)
                        for a in _lane_gather_inputs(rows, wv, wi, rows)))


_GATHER_EDGE_ROWS = [1, 31, 32, 33, 128, 4223, 4224, 8192, 32768]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", _GATHER_EDGE_ROWS)
@pytest.mark.parametrize("wi", [128, 256])
@pytest.mark.parametrize("wv", [128, 129, 2048])
def test_lane_gather_row_edges(cuda_device, rows, wi, wv):
    """W_v = 128 and W_i = 128 or 256 (every shape gk and the wide lowering
    probe launch, on the warp-a-row kernel) at row counts around a warp's
    32, around the staged kernel's two blocks an SM (4224 rows) and at gk's
    shapes; the same on the staged kernel, at 15 rows and 1 row a block."""
    _lane_gather_same(*(torch.from_numpy(a).to(cuda_device)
                        for a in _lane_gather_inputs(rows, wv, wi, rows + wi)))


@pytest.mark.cuda
@pytest.mark.parametrize("wv", [probes_cuda.ROW_WORDS, probes_cuda.ROW_WORDS + 1])
@pytest.mark.parametrize("rows", [33, 4224])
def test_lane_gather_plan_either_side_of_its_width(cuda_device, wv, rows):
    """gather_plan takes the warp-a-row kernel up to 128 values a row and the
    staged kernel past it."""
    assert probes_cuda.gather_plan(rows, wv, 256).kernel == (
        "warp_rows" if wv <= probes_cuda.ROW_WORDS else "staged")
    _lane_gather_same(*(torch.from_numpy(a).to(cuda_device)
                        for a in _lane_gather_inputs(rows, wv, 256, rows + wv)))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["x", "idx"])
@pytest.mark.parametrize("rows", [33, 128, 4223, 4224])
@pytest.mark.parametrize("wi", [128, 256])
@pytest.mark.parametrize("wv", [128, 129])
def test_lane_gather_misaligned_view(cuda_device, which, rows, wi, wv):
    """A contiguous view that does not start 16-byte aligned: the kernels
    take 4-byte loads for it, so they take any 4-byte aligned view and give
    the plain version's values."""
    x, i = (torch.from_numpy(a).to(cuda_device)
            for a in _lane_gather_inputs(rows, wv, wi, rows + 5))
    t = x if which == "x" else i
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 and view.is_contiguous()
    _lane_gather_same(*((view, i) if which == "x" else (x, view)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 128), (512, 128), (1, 1), (33, 1000), (4096, 31),
                                   (4, 4), (12, 8), (4096, 32)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32])
def test_transpose_matches_plain(cuda_device, shape, dtype):
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 2**32, shape, dtype=np.uint32))
    x = x.view(dtype).to(cuda_device)
    got = probes_cuda.transpose(x)
    assert got.dtype == dtype
    _same([got], [probes_cuda.transpose_ref(x)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 128), (8, 12)])
def test_transpose_on_a_misaligned_view(cuda_device, shape):
    # a view 4 bytes past 16-byte alignment
    n = shape[0] * shape[1]
    flat = torch.from_numpy(np.random.default_rng(2).integers(0, 2**32, n + 1, dtype=np.uint32))
    x = flat.to(cuda_device)[1:].view(shape)
    assert x.data_ptr() % 16 and x.is_contiguous()
    _same([probes_cuda.transpose(x)], [probes_cuda.transpose_ref(x)])


def _onehot_planes(k, m, n, device):
    rng = np.random.default_rng(k + m + n)
    return (torch.from_numpy(rng.integers(0, 2, s).astype(np.float32)).to(device)
            .to(torch.bfloat16) for s in ((k, m), (k, n)))


@pytest.mark.cuda
@pytest.mark.parametrize("k, m, n", [(256, 64, 48)] + [
    (k, m, n) for k in (16, 128, 144, 4096) for m in (16, 48, 128, 256) for n in (16, 48, 128, 256)])
def test_onehot_matmul_matches_plain(cuda_device, k, m, n):
    """Bit for bit at K of one k-chunk, one and a part (144) and 32 chunks,
    and M and N of whole, ragged (48) and single tiles."""
    a, b = _onehot_planes(k, m, n, cuda_device)
    before = probes_cuda.LAUNCHES["onehot_matmul"]
    got = probes_cuda.onehot_matmul(a, b)
    assert probes_cuda.LAUNCHES["onehot_matmul"] == before + 1
    _same([got], [probes_cuda.onehot_matmul_ref(a, b)])


@pytest.mark.cuda
def test_onehot_matmul_refuses_a_misaligned_plane(cuda_device):
    flat = torch.zeros(16 * 16 + 8, dtype=torch.bfloat16, device=cuda_device)
    view = flat[4: 4 + 256].view(16, 16)  # 8 bytes past a 16-byte boundary
    good = flat[8: 8 + 256].view(16, 16)
    assert view.data_ptr() % 16 == 8 and good.data_ptr() % 16 == 0
    before = probes_cuda.LAUNCHES["onehot_matmul"]
    for args in ((view, good), (good, view)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            probes_cuda.onehot_matmul(*args)
    assert probes_cuda.LAUNCHES["onehot_matmul"] == before


@pytest.mark.cuda
def test_noop_launches(cuda_device):
    before = probes_cuda.LAUNCHES["noop"]
    probes_cuda.noop(cuda_device)
    torch.cuda.synchronize()
    assert probes_cuda.LAUNCHES["noop"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("row", [0, 317, 511, -1, 512])
def test_dyn_row_matches_plain(cuda_device, row):
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 2**32, (512, 128), dtype=np.uint32))
    x = x.to(cuda_device)
    r = torch.tensor([row], dtype=torch.int32, device=cuda_device)
    _same([probes_cuda.dyn_row(x, r)], [probes_cuda.dyn_row_ref(x, r)])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 100, 4096, 4097, 3 * 4096 + 5, 2 << 20])
@pytest.mark.parametrize("n_pay", [0, 1, 3])
def test_sort_tiles_matches_plain(cuda_device, n, n_pay):
    rng = np.random.default_rng(n + n_pay)
    keys = rng.integers(0, 2**31, n, dtype=np.uint32)
    keys[: len(EDGE_KEYS) - 1] = EDGE_KEYS[:-1][:n]
    keys[-min(n, 50):] = keys[0]  # ties: the tile sort may permute their payloads
    planes = [torch.from_numpy(a).to(cuda_device) for a in
              (keys, *(rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay)))]
    before = sort_cuda.TILE_LAUNCHES
    got = sort_cuda.sort_tiles(planes)
    assert sort_cuda.TILE_LAUNCHES == before + 1
    ref = sort_cuda.sort_tiles_ref(planes)
    _same([got[0]], [ref[0]])  # keys agree as they are; payloads after a canonical order
    _same(sort_cuda.canonical_tiles(got), sort_cuda.canonical_tiles(ref))


@pytest.mark.cuda
def test_chain_timing_captures_a_graph(cuda_device):
    x = torch.from_numpy(np.arange(1 << 16, dtype=np.uint32)).to(cuda_device)

    def step(c):
        out, cnt = filter_alt_cuda.filter_compact(c, "v3")
        return (c.view(torch.int32) ^ (out.view(torch.int32) & 1) ^ cnt.view(torch.int32)).view(torch.uint32)

    before = filter_alt_cuda.LAUNCHES["v3"]
    assert device_time.time_chained(step, x, k=4, reps=3) > 0
    assert filter_alt_cuda.LAUNCHES["v3"] == before + 2 + 4 + 8  # a warm step, then one capture, per chain

    def syncs(c):
        return c + 0 if int(c[0]) >= 0 else c  # a readback: cannot be captured

    with pytest.raises(RuntimeError):
        device_time.time_chained(syncs, x.view(torch.int32), k=2, reps=1)


def _radix_keys(kind, n, rng):
    """Keys for the radix sort: random over the whole range with the edges,
    or with only one digit varying, or all equal (constant digits: the
    passes that copy)."""
    if kind == "random":
        k = rng.integers(0, 2**32, n, dtype=np.uint32)
        k[: min(n, len(EDGE_KEYS))] = EDGE_KEYS[:n]
        k[-min(n, 50):] = k[0]  # ties: the sort is stable
        return k
    if kind == "low8":
        return rng.integers(0, 256, n, dtype=np.uint32)
    if kind == "high8":
        return rng.integers(0, 256, n, dtype=np.uint32) << np.uint32(24)
    return np.full(n, 0xFFFFFFFF if kind == "all_max" else 12345, np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 100, 4095, 4096, 4097, 3 * 4096 + 5, (1 << 20) + 3])
@pytest.mark.parametrize("n_pay", [0, 1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["random", "low8", "high8", "all_equal", "all_max"])
def test_radix_sort_matches_plain(cuda_device, n, n_pay, kind):
    rng = np.random.default_rng(n + n_pay)
    planes = [torch.from_numpy(a).to(cuda_device) for a in
              (_radix_keys(kind, n, rng), *(rng.integers(0, 2**32, n, dtype=np.uint32)
                                            for _ in range(n_pay)))]
    ref = sort_cuda.sort_bitonic_ref(planes)
    before = sort_cuda.LAUNCHES
    got = sort_cuda.sort_bitonic(planes)
    assert sort_cuda.LAUNCHES == before + 1
    _same(got, ref)  # stable: every plane bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [0, 1, 2, 3, 5, 4096 + 7, (1 << 20) + 1])
def test_gather_sorted_matches_plain(cuda_device, offset, k):
    rng = np.random.default_rng(k + offset)
    n = max(k, 64)
    data = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda_device)
    sidx = np.sort(rng.integers(0, n + n // 8, k + offset).astype(np.uint32))  # tail out of range
    sidx[len(sidx) - min(len(sidx), 3):] = 0xFFFFFFFF
    sidx = torch.from_numpy(sidx).to(cuda_device)[offset:]  # a slice: misaligned by offset
    before = take_cuda.LAUNCHES
    got = take_cuda.gather_sorted(data, sidx)
    assert take_cuda.LAUNCHES == before + 1
    _same(got, take_cuda.gather_sorted_ref(data, sidx))


@pytest.mark.cuda
def test_sort_and_gather_replay_in_a_graph(cuda_device):
    rng = np.random.default_rng(11)
    n = (1 << 18) + 9
    planes = [torch.from_numpy(rng.integers(0, 1 << 18, n, dtype=np.uint32)).to(cuda_device),
              torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda_device)]
    table = torch.from_numpy(rng.integers(0, 2**32, 1 << 18, dtype=np.uint32)).to(cuda_device)

    def step():
        key, pay = sort_cuda.sort_bitonic(planes)
        return key, pay, *take_cuda.gather_sorted(table, key)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    planes[0].copy_(torch.from_numpy(rng.integers(0, 1 << 18, n, dtype=np.uint32)).to(cuda_device))
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    ref = sort_cuda.sort_bitonic_ref(planes)
    _same(outs, (*ref, *take_cuda.gather_sorted_ref(table, ref[0])))


FILL_TILE = scan_cuda.TILE
FILL_LENGTHS = [1, 3, FILL_TILE - 1, FILL_TILE, FILL_TILE + 1, 3 * FILL_TILE + 5, (1 << 20) + 3]


def _fill_same(cuda_device, live, pays, offset=0):
    """propagate_fill (key + pays) and propagate_last (pays) kernels against
    their plain versions on planes that start `offset` elements into their
    storage (not 16-byte aligned for offset 1-3)."""
    n = len(live)
    rng = np.random.default_rng(n)
    key = np.where(live, rng.integers(0, 2**31, n), EMPTY).astype(np.uint32)

    def view(a):
        t = torch.from_numpy(np.concatenate([np.zeros(offset, a.dtype), a])).to(cuda_device)
        return t[offset:]

    planes = tuple(view(a) for a in (key, *pays))
    alive = view(live)
    before = scan_cuda.LAUNCHES
    got = scan_cuda.propagate_fill(planes)
    got_h, got_l = scan_cuda.propagate_last(alive, planes[1:])
    assert scan_cuda.LAUNCHES == before + 2
    _same(got, scan_cuda.propagate_fill_ref(planes))
    ref_h, ref_l = scan_cuda.propagate_last_ref(alive, planes[1:])
    _same((got_h, *got_l), (ref_h, *ref_l))


@pytest.mark.cuda
@pytest.mark.parametrize("n", FILL_LENGTHS)
@pytest.mark.parametrize("density", [0.0, 0.002, 0.5, 1.0])
@pytest.mark.parametrize("n_pay, offset", [(1, 0), (1, 1), (2, 2), (8, 3)])
def test_fill_kernel_matches_plain(cuda_device, n, density, n_pay, offset):
    rng = np.random.default_rng(n + n_pay)
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay)]
    _fill_same(cuda_device, rng.random(n) < density, pays, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, FILL_TILE - 2, FILL_TILE - 1, FILL_TILE, 40 * FILL_TILE - 1,
                                 64 * FILL_TILE + 1])
def test_fill_kernel_dead_stretch(cuda_device, pos):
    """One live lane, then a dead run of many tiles: every later lane takes
    it through the look-back; the lanes before it have none."""
    n = 64 * FILL_TILE + 9
    live = np.zeros(n, bool)
    live[pos] = True
    pays = [np.random.default_rng(pos).integers(0x80000000, 2**32, n, dtype=np.uint32)]
    _fill_same(cuda_device, live, pays)


def _join_flat(res):
    return [res[0], *res[1], *res[2], res[3]]


def _fill_match_same(planes, m_l, m_r):
    """fill_match_k2's kernel, one launch, against its plain version."""
    before = (fill_match_cuda.LAUNCHES, scan_cuda.LAUNCHES)
    got = fill_match_cuda.fill_match_k2(planes, m_l, m_r)
    torch.cuda.synchronize()
    assert (fill_match_cuda.LAUNCHES, scan_cuda.LAUNCHES) == (before[0] + 1, before[1])
    _same(_join_flat(got), _join_flat(fill_match_cuda.fill_match_k2_ref(planes, m_l, m_r)))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", FILL_LENGTHS)
@pytest.mark.parametrize("m_l, m_r, offset", [(1, 1, 0), (0, 0, 0), (2, 1, 1), (1, 3, 3),
                                              (3, 3, 0), (0, 2, 2)])
def test_fill_match_kernel_matches_plain(cuda_device, kind, n, m_l, m_r, offset):
    """The co-sort joins' fill and match at the CPU tests' edges: lengths
    around a tile, 0 to 3 payloads a side, masked and pad lanes, fks before
    any pk, a carry across tiles, unsorted keys, views at offsets 1-3."""
    rng = np.random.default_rng(n + 10 * m_l + m_r)
    arrays = [k2_case(kind, n, rng),
              *(rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(max(m_l, m_r)))]

    def view(a):
        t = torch.from_numpy(np.concatenate([np.zeros(offset, a.dtype), a])).to(cuda_device)
        return t[offset:]

    _fill_match_same(tuple(view(a) for a in arrays), m_l, m_r)


@pytest.mark.cuda
def test_fill_match_kernel_at_the_merge_length(cuda_device):
    """At bm_join_sf128's merge length, 2^29 lanes: a pk row and three fk
    rows a key, 1 in 20 pk rows masked out (0xFFFFFFFE, its fks unmatched)."""
    n = 1 << 29
    gen = torch.Generator(device=cuda_device).manual_seed(29)
    i = torch.arange(n, device=cuda_device)
    k2 = ((i >> 2) << 1) | ((i & 3) != 0).to(torch.int64)
    masked = ((i & 3) == 0) & (torch.rand(n, generator=gen, device=cuda_device) < 0.05)
    k2 = torch.where(masked, 0xFFFFFFFE, k2).to(torch.uint32)
    pay = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=cuda_device,
                        generator=gen).view(torch.uint32)
    del i
    got = _fill_match_same((k2, pay), 1, 1)
    assert int(got[3].sum()) == 3 * (n // 4 - int(masked.sum()))


def _compact_same(planes, m_l, m_r, cap):
    """fill_match_compact_k2's kernel, one launch of its own, against its
    plain version: the count, and the rows below it and below cap."""
    before = (fill_match_compact_cuda.LAUNCHES, fill_match_cuda.LAUNCHES, scan_cuda.LAUNCHES)
    got = fill_match_compact_cuda.fill_match_compact_k2(planes, m_l, m_r, cap)
    torch.cuda.synchronize()
    assert (fill_match_compact_cuda.LAUNCHES, fill_match_cuda.LAUNCHES,
            scan_cuda.LAUNCHES) == (before[0] + 1, *before[1:])
    want = fill_match_compact_cuda.fill_match_compact_k2_ref(tuple(p.cpu() for p in planes),
                                                             m_l, m_r, cap)
    assert int(got[3]) == int(want[3])
    kept = min(int(want[3]), cap)
    _same([p[:kept] for p in (got[0], *got[1], *got[2])],
          [p[:kept] for p in (want[0], *want[1], *want[2])])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", FILL_LENGTHS)
@pytest.mark.parametrize("m_l, m_r, offset", [(1, 1, 0), (0, 0, 0), (2, 1, 1), (1, 3, 3),
                                              (3, 3, 0), (0, 2, 2)])
def test_fill_match_compact_kernel_matches_plain(cuda_device, kind, n, m_l, m_r, offset):
    """The compacting form at the padded form's edges: every kind (no match,
    all matched, dead stretches among them), lengths around a tile, 0 to 3
    payloads a side, input views at offsets 1-3."""
    rng = np.random.default_rng(n + 10 * m_l + m_r)
    arrays = [k2_case(kind, n, rng),
              *(rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(max(m_l, m_r)))]

    def view(a):
        t = torch.from_numpy(np.concatenate([np.zeros(offset, a.dtype), a])).to(cuda_device)
        return t[offset:]

    _compact_same(tuple(view(a) for a in arrays), m_l, m_r, n)


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [1, 2, 3, 1000])
def test_fill_match_compact_kernel_below_the_count(cuda_device, cut):
    """A capacity below the count: the rows under it, the count whole."""
    rng = np.random.default_rng(cut)
    n = (1 << 20) + 3
    planes = (torch.from_numpy(k2_case("sorted", n, rng)).to(cuda_device),
              torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda_device))
    full = int(fill_match_compact_cuda.fill_match_compact_k2(planes, 1, 1, n)[3])
    _compact_same(planes, 1, 1, full - cut)


@pytest.mark.cuda
def test_fill_match_compact_kernel_at_the_merge_length(cuda_device):
    """At bm_join_sf128's merge length, 2^29 lanes, against the padded
    kernel and the matched rows selected: a pk row and three fk rows a key,
    1 in 20 pk rows masked out (0xFFFFFFFE, its fks unmatched)."""
    n = 1 << 29
    gen = torch.Generator(device=cuda_device).manual_seed(29)
    i = torch.arange(n, device=cuda_device)
    k2 = ((i >> 2) << 1) | ((i & 3) != 0).to(torch.int64)
    masked = ((i & 3) == 0) & (torch.rand(n, generator=gen, device=cuda_device) < 0.05)
    k2 = torch.where(masked, 0xFFFFFFFE, k2).to(torch.uint32)
    pay = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=cuda_device,
                        generator=gen).view(torch.uint32)
    del i
    want = 3 * (n // 4 - int(masked.sum()))
    del masked
    key, (out_l,), (out_r,), count = fill_match_compact_cuda.fill_match_compact_k2(
        (k2, pay), 1, 1, 3 * n // 4)
    assert int(count) == want
    pkey, (pl,), (pr,), matched = fill_match_cuda.fill_match_k2((k2, pay), 1, 1)
    for got, padded in ((key, pkey), (out_l, pl), (out_r, pr)):
        assert torch.equal(got[:want].view(torch.int32),
                           padded.view(torch.int32)[matched])


FILTER_TILE = filter_cuda.TILE


def _filter_values(kind, n, rng):
    t = filter_cuda.THRESHOLD
    if kind == "random":
        v = rng.integers(0, 2**32, n, dtype=np.uint32)
        v[: min(n, len(EDGE_KEYS))] = EDGE_KEYS[:n]
        return v
    if kind == "all_kept":
        return rng.integers(0, t, n, dtype=np.uint32)
    v = rng.integers(t, 2**32, n, dtype=np.uint32)
    if kind == "one_in_last_tile":
        v[-1] = 5
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, FILTER_TILE - 1, FILTER_TILE, FILTER_TILE + 1,
                               3 * FILTER_TILE + 17, (1 << 20) + 3])
@pytest.mark.parametrize("kind", ["random", "all_kept", "none_kept", "one_in_last_tile"])
@pytest.mark.parametrize("offset", [0, 1])
def test_filter_kernel_matches_plain(cuda_device, n, kind, offset):
    v = _filter_values(kind, n, np.random.default_rng(n))
    x = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint32), v])).to(cuda_device)[offset:]
    before = filter_cuda.LAUNCHES
    got = filter_cuda.filter_compact(x, 0xDEADBEEF)
    got_i = filter_cuda.filter_with_indices(x)
    assert filter_cuda.LAUNCHES == before + 2
    _same(got, filter_cuda.filter_compact_ref(x, 0xDEADBEEF))
    _same(got_i, filter_cuda.filter_with_indices_ref(x))
    keep = v < filter_cuda.THRESHOLD
    assert int(got[1]) == keep.sum()
    assert np.array_equal(got_i[1].cpu().numpy()[: keep.sum()], np.flatnonzero(keep))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, FILTER_TILE + 1, 3 * FILTER_TILE + 17])
@pytest.mark.parametrize("with_indices", [False, True])
def test_filter_trace_kernel_matches_untraced(cuda_device, capfd, n, with_indices):
    """The ENABLE_TRACE sweep (dpu_filter_trace_u32): the same outputs as
    the untraced kernel, and a printf line a tile equal to the plain
    version's lines (as a set: tiles print in the order they finish)."""
    v = _filter_values("random", n, np.random.default_rng(n + 7))
    x = torch.from_numpy(v).to(cuda_device)
    call = filter_cuda.filter_with_indices if with_indices else filter_cuda.filter_compact
    capfd.readouterr()
    got = call(x, trace=True)
    torch.cuda.synchronize()
    ctypes.CDLL(None).fflush(None)
    lines = [x for x in capfd.readouterr().out.splitlines() if x.startswith("filter block")]
    _same(got, call(x))
    assert sorted(lines) == sorted(filter_cuda.trace_lines(x.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, FILTER_TILE - 1, FILTER_TILE, FILTER_TILE + 1,
                               3 * FILTER_TILE + 17, (1 << 20) + 3])
@pytest.mark.parametrize("kind", ["random", "all_kept", "none_kept", "one_in_last_tile"])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_filter_v3_at_the_one_sweep_edges(cuda_device, n, kind, offset):
    """v3 against its plain version and v1's kernel, whole arrays with their
    tails: lengths around a tile, every value kept or none, one kept value
    in the last tile, and input views that are not 16-byte aligned."""
    v = _filter_values(kind, n, np.random.default_rng(n + 7))
    x = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint32), v])).to(cuda_device)[offset:]
    before = filter_alt_cuda.LAUNCHES["v3"]
    got = filter_alt_cuda.filter_compact(x, "v3", filter_cuda.THRESHOLD, 0xDEADBEEF)
    got_i = filter_alt_cuda.filter_with_indices(x, "v3")
    assert filter_alt_cuda.LAUNCHES["v3"] == before + 2
    _same(got, filter_alt_cuda.filter_compact_ref(x, "v3", filter_cuda.THRESHOLD, 0xDEADBEEF))
    _same(got_i, filter_alt_cuda.filter_with_indices_ref(x, "v3"))
    _same(got, filter_cuda.filter_compact(x, 0xDEADBEEF))
    _same(got_i, filter_cuda.filter_with_indices(x))
    keep = v < filter_cuda.THRESHOLD
    assert int(got[1]) == keep.sum()
    assert np.array_equal(got_i[1].cpu().numpy()[: keep.sum()], np.flatnonzero(keep))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8 << 20, 64 << 20])
def test_filter_v3_with_indices_at_scale(cuda_device, n):
    """v3 with indices at measure_filter's two sizes, against its plain
    version and v1's kernel, compared on the card."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=cuda_device,
                      generator=gen).view(torch.uint32)
    got = filter_alt_cuda.filter_with_indices(x, "v3")
    for ref in (filter_alt_cuda.filter_with_indices_ref(x, "v3"), filter_cuda.filter_with_indices(x)):
        assert all(torch.equal(g.view(torch.int32), r.view(torch.int32)) for g, r in zip(got, ref))


@pytest.mark.cuda
def test_filter_v3_back_to_back_and_replayed_in_a_graph(cuda_device):
    """v3 called twice in a row, then captured in a CUDA graph and replayed
    twice on new inputs: each call clears its own ticket and status words."""
    rng = np.random.default_rng(29)
    n = 9 * FILTER_TILE + 7
    key = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda_device)

    def step():
        return (*filter_alt_cuda.filter_with_indices(key, "v3"),
                *filter_alt_cuda.filter_compact(key, "v3", 1 << 31, 3))

    def ref():
        return (*filter_alt_cuda.filter_with_indices_ref(key, "v3"),
                *filter_alt_cuda.filter_compact_ref(key, "v3", 1 << 31, 3))

    first, second = step(), step()
    _same(first, second)
    _same(second, ref())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for _ in range(2):
        key.copy_(torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)))
        graph.replay()
        torch.cuda.synchronize()
        _same(outs, ref())


ONE_SWEEP_LENGTHS = [1, FILTER_TILE - 1, FILTER_TILE, FILTER_TILE + 1, 3 * (1 << 20) + 17]
THRESHOLDS = [0, 1 << 30, 1 << 31, 0xFFFFFFFF]


def _alternate_same(x, version, threshold, fill):
    """One version's kernel against its plain version and, at 2^30, v1's
    kernel: compact with ``fill`` and with indices, whole arrays with their
    tails. Each call launches the version's memset, sweep and tail once."""
    before = filter_alt_cuda.LAUNCHES[version]
    got = filter_alt_cuda.filter_compact(x, version, threshold, fill)
    got_i = filter_alt_cuda.filter_with_indices(x, version, threshold)
    assert filter_alt_cuda.LAUNCHES[version] == before + 2
    _same(got, filter_alt_cuda.filter_compact_ref(x, version, threshold, fill))
    _same(got_i, filter_alt_cuda.filter_with_indices_ref(x, version, threshold))
    if threshold == filter_cuda.THRESHOLD:
        _same(got, filter_cuda.filter_compact(x, fill))
        _same(got_i, filter_cuda.filter_with_indices(x))
    return got, got_i


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v2", "v4"])
@pytest.mark.parametrize("n", ONE_SWEEP_LENGTHS)
@pytest.mark.parametrize("kind", ["random", "all_kept", "none_kept", "one_in_last_tile"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_filter_v2_v4_at_the_one_sweep_edges(cuda_device, version, n, kind, offset):
    """v2 and v4 against their plain versions and v1's kernel: lengths around
    a tile, every value kept or none, one kept value at the end, and input
    views that are not 16-byte aligned."""
    v = _filter_values(kind, n, np.random.default_rng(n + 11))
    x = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint32), v])).to(cuda_device)[offset:]
    got, got_i = _alternate_same(x, version, filter_cuda.THRESHOLD, 0xDEADBEEF)
    keep = v < filter_cuda.THRESHOLD
    assert int(got[1]) == keep.sum()
    assert np.array_equal(got_i[1].cpu().numpy()[: keep.sum()], np.flatnonzero(keep))


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v2", "v4"])
@pytest.mark.parametrize("n", ONE_SWEEP_LENGTHS)
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_filter_v2_v4_thresholds(cuda_device, version, n, threshold):
    """v2 and v4 at the runtime thresholds 0 (none kept), 2^30, 2^31 and
    0xFFFFFFFF (all but 0xFFFFFFFF kept) against their plain versions, with
    the edge keys among the values."""
    v = _filter_values("random", n, np.random.default_rng(n + 13))
    _, got_i = _alternate_same(torch.from_numpy(v).to(cuda_device), version, threshold, 7)
    keep = v.astype(np.int64) < threshold
    assert np.array_equal(got_i[1].cpu().numpy()[: keep.sum()], np.flatnonzero(keep))


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v2", "v4"])
@pytest.mark.parametrize("n", [8 << 20, 64 << 20])
def test_filter_v2_v4_at_scale(cuda_device, version, n):
    """v2 and v4 at measure_filter's two sizes, compact and with indices,
    against their plain versions and v1's kernel, compared on the card."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + 1)
    x = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=cuda_device,
                      generator=gen).view(torch.uint32)

    def equal(got, ref):
        return all(torch.equal(g.view(torch.int32), r.view(torch.int32)) for g, r in zip(got, ref))

    got = filter_alt_cuda.filter_compact(x, version, fill=5)
    for ref in (filter_alt_cuda.filter_compact_ref(x, version, fill=5),
                filter_cuda.filter_compact(x, 5)):
        assert equal(got, ref)
    got = filter_alt_cuda.filter_with_indices(x, version)
    for ref in (filter_alt_cuda.filter_with_indices_ref(x, version),
                filter_cuda.filter_with_indices(x)):
        assert equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v2", "v4"])
def test_filter_v2_v4_back_to_back_and_replayed_in_a_graph(cuda_device, version):
    """v2 and v4 called twice in a row, then captured in a CUDA graph and
    replayed twice on new inputs: each call clears its own ticket and status
    words."""
    rng = np.random.default_rng(31)
    n = 9 * FILTER_TILE + 7
    key = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda_device)

    def step():
        return (*filter_alt_cuda.filter_with_indices(key, version),
                *filter_alt_cuda.filter_compact(key, version, 1 << 31, 3))

    def ref():
        return (*filter_alt_cuda.filter_with_indices_ref(key, version),
                *filter_alt_cuda.filter_compact_ref(key, version, 1 << 31, 3))

    first, second = step(), step()
    _same(first, second)
    _same(second, ref())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for _ in range(2):
        key.copy_(torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)))
        graph.replay()
        torch.cuda.synchronize()
        _same(outs, ref())


@pytest.mark.cuda
@pytest.mark.parametrize("version", filter_alt_cuda.VERSIONS)
@pytest.mark.parametrize("plane", ["out", "sel"])
def test_filter_alternate_rejects_a_misaligned_output(cuda_device, version, plane):
    """The entry points store 16-byte runs: an out or sel that is not 16-byte
    aligned is refused at launch (cudaErrorMisalignedAddress), and the
    wrappers' check raises on it."""
    n = 3 * FILTER_TILE + 5
    x = torch.zeros(n, dtype=torch.uint32, device=cuda_device)
    out = torch.empty(n + 1, dtype=torch.uint32, device=cuda_device)
    sel = torch.empty(n + 1, dtype=torch.uint32, device=cuda_device)
    count = torch.empty((), dtype=torch.uint32, device=cuda_device)
    work = torch.empty(filter_cuda.filter_plan(n).work_words, dtype=torch.int64,
                       device=cuda_device)
    ptrs = {"out": out.data_ptr(), "sel": sel.data_ptr()}
    ptrs[plane] += 4
    rc = getattr(_kernels.library(), f"dpu_filter{version[1]}_u32")(
        x.data_ptr(), n, 1 << 30, 0, ptrs["out"], ptrs["sel"], work.data_ptr(),
        count.data_ptr(), _kernels.stream_handle(cuda_device))
    assert rc == 716  # cudaErrorMisalignedAddress
    with pytest.raises(RuntimeError, match="misaligned"):
        _kernels.check(rc, f"filter {version}")


@pytest.mark.cuda
def test_fill_and_filter_back_to_back_and_replayed_in_a_graph(cuda_device):
    """Two calls in a row on one stream, then the same calls captured in a
    CUDA graph and replayed twice on new inputs: each call clears its own
    ticket and status words."""
    rng = np.random.default_rng(19)
    n = 9 * FILL_TILE + 7
    key = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda_device)
    pay = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda_device)
    alive = torch.from_numpy(rng.random(n) < 0.01).to(cuda_device)

    def step():
        fill = scan_cuda.propagate_fill((key, pay))
        has, (last,) = scan_cuda.propagate_last(alive, (pay,))
        out, sel, cnt = filter_cuda.filter_with_indices(key)
        out2, cnt2 = filter_cuda.filter_compact(key, 3)
        return (*fill, has, last, out, sel, cnt, out2, cnt2)

    def ref():
        fill = scan_cuda.propagate_fill_ref((key, pay))
        has, (last,) = scan_cuda.propagate_last_ref(alive, (pay,))
        return (*fill, has, last, *filter_cuda.filter_with_indices_ref(key),
                *filter_cuda.filter_compact_ref(key, 3))

    first, second = step(), step()
    _same(first, second)
    _same(second, ref())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for _ in range(2):  # each replay clears and reuses the work memory
        key.copy_(torch.from_numpy(
            np.where(rng.random(n) < 0.3, rng.integers(0, 2**31, n), EMPTY).astype(np.uint32)))
        alive.copy_(torch.from_numpy(rng.random(n) < 0.3))
        graph.replay()
        torch.cuda.synchronize()
        _same(outs, ref())


MERGE_TOP_BIT = np.array([0, 1, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _bitonic_keys(kind, n, block, rng):
    """n keys whose every block is an ascending run, then a descending one."""
    if kind == "random":
        k = rng.integers(0, 2**32, n, dtype=np.uint32)
    elif kind == "below16":
        k = rng.integers(0, 16, n, dtype=np.uint32)
    elif kind == "all_equal":
        k = np.full(n, 12345, np.uint32)
    elif kind == "all_max":
        k = np.full(n, EMPTY, np.uint32)
    else:  # the top-bit edges only
        k = MERGE_TOP_BIT[rng.integers(0, len(MERGE_TOP_BIT), n)]
    k = k.reshape(-1, 2, block // 2)
    k.sort(axis=2)
    k[:, 1] = k[:, 1, ::-1]
    return k.reshape(n)


def _card_same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.equal(g.view(torch.int32), r.view(torch.int32))


MERGE_KINDS = ["random", "below16", "all_equal", "all_max", "top_bit"]


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 4096, bitonic_cuda.SET, 1 << 16, 1 << 23])
@pytest.mark.parametrize("n_pay", [0, 1, 3, 8])
@pytest.mark.parametrize("kind", MERGE_KINDS)
def test_merge_blocks_kernel_matches_plain(cuda_device, block, n_pay, kind):
    rng = np.random.default_rng(block + n_pay)
    n = max(block, 1 << 16) if block < 1 << 16 else block * (2 if block < 1 << 23 else 1)
    n += block if block <= 4096 else 0  # n & -n below the tile: smaller tiles
    planes = [torch.from_numpy(_bitonic_keys(kind, n, block, rng)).to(cuda_device)] + [
        torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda_device)
        for _ in range(n_pay)]
    before = bitonic_cuda.LAUNCHES
    got = bitonic_cuda.bitonic_merge_blocks(planes, block // 128)
    assert bitonic_cuda.LAUNCHES == before + 1
    _card_same(got, bitonic_cuda.bitonic_merge_blocks_ref(planes, block // 128))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MERGE_KINDS)
def test_merge_blocks_kernel_two_strided_passes(cuda_device, kind):
    n = 1 << 24  # one 16Mi block: 10 stages d >= SET, so two strided passes
    assert len(bitonic_cuda.merge_plan(n, n, 0)) == 3
    planes = [torch.from_numpy(_bitonic_keys(kind, n, n, np.random.default_rng(24))).to(cuda_device)]
    _card_same(bitonic_cuda.bitonic_merge_blocks(planes, n // 128),
               bitonic_cuda.bitonic_merge_blocks_ref(planes, n // 128))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("block", [128, 1 << 16])
def test_merge_blocks_kernel_on_misaligned_views(cuda_device, offset, block):
    rng = np.random.default_rng(offset)
    n = 1 << 17
    keys = np.concatenate([np.zeros(offset, np.uint32), _bitonic_keys("below16", n, block, rng)])
    planes = [torch.from_numpy(keys).to(cuda_device)[offset:]] + [
        torch.from_numpy(rng.integers(0, 2**32, n + offset, dtype=np.uint32)).to(cuda_device)[offset:]
        for _ in range(2)]
    _card_same(bitonic_cuda.bitonic_merge_blocks(planes, block // 128),
               bitonic_cuda.bitonic_merge_blocks_ref(planes, block // 128))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [4096, 1 << 23])
def test_merge_blocks_kernel_in_place(cuda_device, block):
    # the C entry point takes in == out: every pass reads its whole set first
    rng = np.random.default_rng(block)
    n = 1 << 23
    planes = [torch.from_numpy(_bitonic_keys("below16", n, block, rng)).to(cuda_device),
              torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda_device)]
    ref = bitonic_cuda.bitonic_merge_blocks_ref(planes, block // 128)
    ptrs = (ctypes.c_void_p * 2)(*[p.data_ptr() for p in planes])
    rc = _kernels.library().dpu_merge_blocks_u32(ptrs, ptrs, 2, n, block,
                                                 _kernels.stream_handle(cuda_device))
    assert rc == 0
    _card_same(planes, ref)


@pytest.mark.cuda
def test_bitonic_merge_at_the_sorted_build_joins_call(cuda_device):
    # TPC-H SF=1: 1.5M sorted o_orderkey << 1, the pad, 5,996,462-ish
    # l_orderkey << 1 | 1 descending; one merged payload plane; 8Mi
    rng = np.random.default_rng(1)
    i = np.arange(1_500_000, dtype=np.uint32)
    okey = (i // 8) * 32 + i % 8 + 1
    lkey = np.repeat(okey, rng.integers(1, 8, okey.size))
    n = 1 << 23
    k2_l = np.sort((lkey << 1) | 1)[::-1]
    key = np.concatenate([okey << 1, np.full(n - okey.size - lkey.size, EMPTY), k2_l]).astype(np.uint32)
    pay = rng.integers(0, 2**32, n, dtype=np.uint32)
    planes = [torch.from_numpy(key).to(cuda_device), torch.from_numpy(pay).to(cuda_device)]
    got = merge.bitonic_merge(planes)
    _card_same(got, bitonic_cuda.bitonic_merge_blocks_ref(planes, n // 128))
    assert np.array_equal(got[0].cpu().numpy(), np.sort(key))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 128, 129, 1000, 4095, 8191, 8193, 3 * 4096 - 1, (2 << 20) - 1,
                               (2 << 20) + 1])
@pytest.mark.parametrize("n_pay, offset", [(0, 0), (8, 0), (1, 3)])
@pytest.mark.parametrize("kind", ["random", "all_max"])
def test_sort_tiles_at_the_tile_edges(cuda_device, n, n_pay, offset, kind):
    # all_max: real 0xFFFFFFFF keys beside the pad keep their payloads
    rng = np.random.default_rng(n + n_pay)
    keys = (rng.integers(0, 2**32, n + offset, dtype=np.uint32) if kind == "random"
            else np.full(n + offset, EMPTY, np.uint32))
    planes = [torch.from_numpy(a).to(cuda_device)[offset:] for a in
              (keys, *(rng.integers(0, 2**32, n + offset, dtype=np.uint32) for _ in range(n_pay)))]
    got = sort_cuda.sort_tiles(planes)
    ref = sort_cuda.sort_tiles_ref(planes)
    _card_same(got[:1], ref[:1])
    _card_same(sort_cuda.canonical_tiles(got), sort_cuda.canonical_tiles(ref))


@pytest.mark.cuda
def test_merge_and_sort_tiles_replay_in_a_graph(cuda_device):
    rng = np.random.default_rng(12)
    n = 1 << 20
    mplanes = [torch.from_numpy(_bitonic_keys("below16", n, n, rng)).to(cuda_device),
               torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda_device)]
    tplanes = [torch.from_numpy(rng.integers(0, 2**32, n - 5, dtype=np.uint32)).to(cuda_device)
               for _ in range(3)]

    def step():
        return (*bitonic_cuda.bitonic_merge_blocks(mplanes, n // 128), *sort_cuda.sort_tiles(tplanes))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for r in range(2):
        mplanes[0].copy_(torch.from_numpy(_bitonic_keys(MERGE_KINDS[r], n, n, rng)).to(cuda_device))
        tplanes[0].copy_(torch.from_numpy(rng.integers(0, 2**(16 * r + 4), n - 5, dtype=np.uint32)))
        graph.replay()
        torch.cuda.synchronize()
        _card_same(outs[:2], bitonic_cuda.bitonic_merge_blocks_ref(mplanes, n // 128))
        ref = sort_cuda.sort_tiles_ref(tplanes)
        _card_same(outs[2:3], ref[:1])
        _card_same(sort_cuda.canonical_tiles(outs[2:]), sort_cuda.canonical_tiles(ref))

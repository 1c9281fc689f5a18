"""The port's CUDA kernels against their plain versions on the card, bit for
bit on every lane: the partition kernel (csrc/partition.cu), the
merge-probe kernel (csrc/merge_probe.cu), the filter alternates
(csrc/filter2.cu, filter3.cu, filter4.cu) and the filter stage ablation
(csrc/filter.cu), and the graph-captured chain timing around them. A CUDA kernel has no CPU mode, so
every test here is marked ``cuda`` and skips without a device. This file
imports no jax (the machine with the card has none) and takes no fixture of
tests/conftest.py, which imports jax; on that machine run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from dpu_olap_tpu_torch.bench import device_time
from dpu_olap_tpu_torch.ops import filter_alt_cuda, filter_cuda, filter_stages, merge_cuda, partition_cuda

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


@pytest.mark.cuda
@pytest.mark.parametrize("p, n, cell, n_pay", [
    (2, 1 << 16, 1 << 16, 1),
    (8, 3 * 4096 + 17, 2048, 3),
    (16, 1 << 16, 1 << 13, 0),
    (8, 1 << 14, 1024, 9),  # two launches; every bucket overflows
    (4, 1, 1, 1),
])
@pytest.mark.parametrize("with_sel", [True, False])  # False: the operators' call
def test_partition_kernel_matches_plain(cuda_device, p, n, cell, n_pay, with_sel):
    rng = np.random.default_rng(5)
    k = rng.integers(0, 2**32, n, dtype=np.uint32)
    k[: min(n, len(EDGE_KEYS))] = EDGE_KEYS[:n]
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay)]
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
])
def test_merge_probe_kernel_matches_plain(cuda_device, nl, nr, n_pay):
    rng = np.random.default_rng(9)
    right = np.sort(rng.choice(2**31, size=nr, replace=False).astype(np.uint32))
    pays = [rng.integers(0, 2**32, nr, dtype=np.uint32) for _ in range(n_pay)]
    left = np.sort(rng.integers(0, 2**31, nl).astype(np.uint32))
    left[-7:] = EMPTY
    right[-3:] = EMPTY
    dev = [torch.from_numpy(a).to(cuda_device) for a in (left, right, *pays)]
    before = merge_cuda.LAUNCHES
    got = merge_cuda.merge_probe(dev[0], dev[1], tuple(dev[2:]))
    assert merge_cuda.LAUNCHES == before + 1
    ref = merge_cuda.merge_probe_ref(dev[0], dev[1], tuple(dev[2:]))
    _same((got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2]))


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
    _same([g for g in got if g is not None], [r for r in ref if r is not None])


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

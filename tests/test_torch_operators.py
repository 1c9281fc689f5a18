"""The slice as a whole: FilterGpu, SumGpu and TakeGpu
(dpu_olap_tpu_torch.operators, on an explicit CPU DeviceSet) against the JAX
package's FilterTpu, SumTpu and TakeTpu on one device and against the
pyarrow oracles, on the same seed-42 tables. Integer outputs compare
exactly; float sums within a relative 1e-5 (f32 block partials added in
another order than XLA's)."""

import numpy as np
import pytest
import torch

from dpu_olap_tpu.columnar import Batch as JaxBatch
from dpu_olap_tpu.columnar import Table as JaxTable
from dpu_olap_tpu.generator import make_filter_batches as jax_make_filter_batches
from dpu_olap_tpu.generator import make_take_batches as jax_make_take_batches
from dpu_olap_tpu.operators import FilterTpu, SumTpu, TakeTpu
from dpu_olap_tpu.parallel.mesh import DeviceSet as JaxDeviceSet
from dpu_olap_tpu_torch.columnar import Batch, Table
from dpu_olap_tpu_torch.config import FLAGS
from dpu_olap_tpu_torch.generator import make_filter_batches, make_take_batches
from dpu_olap_tpu_torch.operators.aggr_op import SumGpu, SumNative
from dpu_olap_tpu_torch.operators.filter_op import FilterGpu, FilterNative
from dpu_olap_tpu_torch.operators.take_op import TakeGpu, TakeNative
from dpu_olap_tpu_torch.ops import filter_cuda, sort_cuda, sum_cuda, take_cuda
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

CPU_SET = DeviceSet(torch.device("cpu"))
NB, ROWS = 8, 1 << 12


@pytest.fixture(scope="module")
def jax_ds():
    return JaxDeviceSet.allocate(1)


@pytest.fixture(params=[64 << 20, 2 * ROWS], ids=["one_round", "four_rounds"])
def round_rows(request, monkeypatch):
    monkeypatch.setattr(FLAGS, "stream_round_rows", request.param)
    return request.param


def _tables(cols):
    """The same columns as a port Table and a JAX-package Table."""
    return (Table([Batch.from_numpy({"a": c}) for c in cols]),
            JaxTable([JaxBatch.from_numpy({"a": c}) for c in cols]))


def _launches():
    return [m.LAUNCHES for m in (filter_cuda, sort_cuda, sum_cuda, take_cuda)]


def test_filter_gpu_matches_filter_tpu_and_pyarrow(jax_ds, round_rows):
    table = make_filter_batches(NB, ROWS)
    jtable = jax_make_filter_batches(NB, ROWS)
    before = _launches()
    op = FilterGpu(CPU_SET, table).Prepare()
    got = op.Run()
    assert _launches() == before  # CPU tensors take the plain versions
    assert op.n_rounds == (1 if round_rows > NB * ROWS else 4)
    jgot = FilterTpu(jax_ds, jtable).Prepare().Run()
    nat = FilterNative(table).Prepare().Run()
    assert len(got) == len(jgot) == len(nat) == NB
    for g, j, e in zip(got, jgot, nat):
        np.testing.assert_array_equal(g, np.asarray(j))
        np.testing.assert_array_equal(g, e)
    assert op.Timers().rank_count("dispatch") == op.n_rounds


def test_sum_gpu_matches_sum_tpu_and_pyarrow(jax_ds, round_rows):
    table = make_filter_batches(NB, ROWS)
    got = SumGpu(CPU_SET, table).Prepare().Run()
    assert isinstance(got, int)
    assert got == SumTpu(jax_ds, jax_make_filter_batches(NB, ROWS)).Prepare().Run()
    assert got == SumNative(table).Prepare().Run()


def test_sum_gpu_ragged_table(jax_ds):
    """Batches of different lengths (e.g. after a filter) take the single
    array path; an all-0xFFFFFFFF batch carries into the high word."""
    rng = np.random.default_rng(8)
    cols = [rng.integers(0, 2**32, n, dtype=np.uint32) for n in (1000, 4097, 1)]
    cols.append(np.full(3000, 0xFFFFFFFF, np.uint32))
    table, jtable = _tables(cols)
    op = SumGpu(CPU_SET, table).Prepare()
    got = op.Run()
    assert got == int(np.concatenate(cols).astype(np.uint64).sum())
    assert got == SumNative(table).Prepare().Run()
    assert got == SumTpu(jax_ds, jtable).Prepare().Run()
    assert op.Timers().rank_count("device-work") == 1


@pytest.mark.parametrize("ragged", [False, True], ids=["even", "ragged"])
def test_sum_gpu_float_column(jax_ds, ragged):
    rng = np.random.default_rng(9)
    sizes = (3000, 4096, 17) if ragged else (4096,) * 4
    cols = [(rng.random(n) * 100.0).astype(np.float32) for n in sizes]
    table, jtable = _tables(cols)
    got = SumGpu(CPU_SET, table).Prepare().Run()
    expect = SumNative(table).Prepare().Run()
    assert isinstance(got, float) and isinstance(expect, float)
    assert abs(got - expect) <= abs(expect) * 1e-5
    jgot = SumTpu(jax_ds, jtable).Prepare().Run()
    assert abs(got - jgot) <= abs(jgot) * 1e-5


def test_take_gpu_matches_take_tpu_and_pyarrow(jax_ds, round_rows):
    data, idx = make_take_batches(NB, ROWS, 1 << 9)
    jdata, jidx = jax_make_take_batches(NB, ROWS, 1 << 9)
    op = TakeGpu(CPU_SET, data, idx).Prepare()
    assert op._use_sorted
    got = op.Run()
    jgot = TakeTpu(jax_ds, jdata, jidx).Prepare().Run()
    nat = TakeNative(data, idx).Prepare().Run()
    assert len(got) == len(jgot) == len(nat) == NB
    for g, j, e in zip(got, jgot, nat):
        np.testing.assert_array_equal(g, np.asarray(j))
        np.testing.assert_array_equal(g, e)


def test_take_gpu_clips_out_of_range_indices_per_batch(jax_ds):
    """Each batch's indices clip to its own last row (n-1), not into the
    next batch of the round's concatenated table."""
    rng = np.random.default_rng(3)
    n, k = 500, 300
    datas = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(3)]
    idxs = [rng.integers(0, 2 * n, k, dtype=np.uint32) for _ in range(3)]
    idxs[1][:3] = [0xFFFFFFFF, 2**31, n]
    mk = lambda cols, name: Table([Batch.from_numpy({name: c}) for c in cols])  # noqa: E731
    got = TakeGpu(CPU_SET, mk(datas, "a"), mk(idxs, "i")).Prepare().Run()
    for g, d, i in zip(got, datas, idxs):
        np.testing.assert_array_equal(g, d[np.minimum(i, n - 1)])


def test_take_gpu_row_gather_for_wide_columns():
    rng = np.random.default_rng(4)
    datas = [rng.integers(0, 2**63, 256, dtype=np.uint64) for _ in range(2)]
    idxs = [rng.integers(0, 300, 100, dtype=np.uint32) for _ in range(2)]
    data = Table([Batch.from_numpy({"a": d}) for d in datas])
    idx = Table([Batch.from_numpy({"i": i}) for i in idxs])
    op = TakeGpu(CPU_SET, data, idx).Prepare()
    assert not op._use_sorted
    for g, d, i in zip(op.Run(), datas, idxs):
        np.testing.assert_array_equal(g, d[np.minimum(i, 255)])


def test_operators_reject_uneven_batches():
    rng = np.random.default_rng(5)
    table = Table([Batch.from_numpy({"a": rng.integers(0, 9, n, dtype=np.uint32)}) for n in (4, 5)])
    with pytest.raises(ValueError, match="one length"):
        FilterGpu(CPU_SET, table).Prepare()
    idx = Table([Batch.from_numpy({"i": np.zeros(2, np.uint32)}) for _ in range(2)])
    with pytest.raises(ValueError, match="one length"):
        TakeGpu(CPU_SET, table, idx).Prepare()

"""Parity of the port's partition engines and operator
(dpu_olap_tpu_torch.parallel.partitioner, operators.partition_op, CPU
paths) with the JAX package on a one-device mesh: tests/test_partition.py's
and tests/test_operators.py's cases at d = 1. Integer data: exact equality,
partition by partition and row by row (both engines keep input order within
a partition)."""

import numpy as np
import pytest
import torch

from dpu_olap_tpu.generator import make_filter_batches as jax_make_filter_batches
from dpu_olap_tpu.generator import make_join_tables as jax_make_join_tables
from dpu_olap_tpu.operators import PartitionTpu
from dpu_olap_tpu.parallel.mesh import DeviceSet as JaxDeviceSet
from dpu_olap_tpu.parallel.partitioner import Partitioner as JaxPartitioner
from dpu_olap_tpu.parallel.partitioner import ResidentPartitioner as JaxResidentPartitioner
from dpu_olap_tpu_torch.columnar import Batch, Table
from dpu_olap_tpu_torch.operators import PartitionGpu
from dpu_olap_tpu_torch.ops import partition_cuda
from dpu_olap_tpu_torch.ops.hashing import bucket_shift, wang_hash_np
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet
from dpu_olap_tpu_torch.parallel.partitioner import (
    DevicePartitions,
    Partitioner,
    ResidentPartitioner,
)

CPU_SET = DeviceSet(torch.device("cpu"))


def _same_parts(got, want, names):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == names
        for nm in names:
            assert g[nm].dtype == np.uint32
            np.testing.assert_array_equal(g[nm], np.asarray(w[nm]))


def _oracle(table, key, p):
    """Partition q: the rows whose Wang-hash top bits are q, in input order."""
    cols = {nm: np.concatenate([np.asarray(b[nm]) for b in table]) for nm in table.names}
    b = wang_hash_np(cols[key]) >> np.uint32(bucket_shift(p))
    return [{nm: c[b == q] for nm, c in cols.items()} for q in range(p)]


@pytest.mark.parametrize("p", [16, 8, 32])
def test_partitioners_match_jax(p):
    jtable = jax_make_filter_batches(num_batches=8, batch_size=1 << 12)
    table = Table.from_reference(jtable)
    jds = JaxDeviceSet.allocate(1)
    host = Partitioner(CPU_SET, p).partition_table(table, "a")
    dparts = ResidentPartitioner(CPU_SET, p).partition_table(table, "a")
    jhost = JaxPartitioner(jds, p).partition_table(jtable, "a")
    jdparts = JaxResidentPartitioner(jds, p).partition_table(jtable, "a")
    assert dparts.nr_partitions == p and dparts.rounds == p
    np.testing.assert_array_equal(dparts.partition_rows(), jdparts.partition_rows())
    res = dparts.to_host()
    _same_parts(res, jdparts.to_host(), ["a"])
    _same_parts(host, jhost, ["a"])
    _same_parts(res, _oracle(table, "a", p), ["a"])
    _same_parts(host, res, ["a"])


def test_resident_partitioner_payload_alignment_matches_jax():
    rng = np.random.default_rng(7)
    n = 1 << 15
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    pay = keys ^ np.uint32(0xA5A5A5A5)  # derivable from the key
    dparts = ResidentPartitioner(CPU_SET, 16).partition_arrays(keys, (pay,), ["k", "v"])
    jparts = JaxResidentPartitioner(JaxDeviceSet.allocate(1), 16).partition_arrays(
        keys, (pay,), ["k", "v"]
    )
    parts = dparts.to_host()
    _same_parts(parts, jparts.to_host(), ["k", "v"])
    for part in parts:
        np.testing.assert_array_equal(part["v"], part["k"] ^ np.uint32(0xA5A5A5A5))


def test_partitioner_carries_payloads_and_raises_on_overflow():
    jleft, _ = jax_make_join_tables(4, 1 << 11, 1 << 10)
    left = Table.from_reference(jleft)
    parts = Partitioner(CPU_SET, 4).partition_table(left, "fk", ["y"])
    jparts = JaxPartitioner(JaxDeviceSet.allocate(1), 4).partition_table(jleft, "fk", ["y"])
    _same_parts(parts, jparts, ["fk", "y"])
    _same_parts(parts, _oracle(left, "fk", 4), ["fk", "y"])
    same_key = Table([type(left[0])({"fk": np.zeros(4096, np.uint32)})])
    with pytest.raises(OverflowError, match="shuffle_slack"):
        Partitioner(CPU_SET, 8).partition_table(same_key, "fk")
    with pytest.raises(OverflowError, match="shuffle_slack"):
        ResidentPartitioner(CPU_SET, 8).partition_table(same_key, "fk")


@pytest.mark.parametrize("p, hot_share", [(16, 1.0), (16, 0.5), (4, 1.0)])
def test_partitioner_takes_a_hot_key_over_many_small_batches(p, hot_share):
    # 100 batches of 64 rows: each round fits its 128-row cell, while the hot
    # key's partition collects far more rows than the table's slack share
    rng = np.random.default_rng(11)
    n_hot = int(64 * hot_share)
    batches = []
    for _ in range(100):
        k = rng.integers(0, 2**32, 64, dtype=np.uint32)
        k[:n_hot] = 0xDEADBEEF
        batches.append(Batch({"k": k, "v": ~k}))
    table = Table(batches)
    parts = Partitioner(CPU_SET, p).partition_table(table, "k", ["v"])
    _same_parts(parts, _oracle(table, "k", p), ["k", "v"])
    assert max(len(part["k"]) for part in parts) >= 100 * n_hot


def test_device_partitions_rows_and_host_layout():
    counts = torch.tensor([3, 0, 2, 1], dtype=torch.uint32)
    keys = torch.arange(16, dtype=torch.int32).reshape(4, 4).view(torch.uint32)
    dp = DevicePartitions(keys=keys, payloads=(keys,), counts=counts, names=["k", "v"],
                          nr_partitions=4, rounds=4)
    dp.sync()
    np.testing.assert_array_equal(dp.partition_rows(), [3, 0, 2, 1])
    host = dp.to_host()
    assert [list(h["k"]) for h in host] == [[0, 1, 2], [], [8, 9], [12]]
    assert all(np.array_equal(h["k"], h["v"]) for h in host)


@pytest.mark.parametrize("resident", [None, False])
def test_partition_gpu_matches_partition_tpu(resident):
    # tests/test_operators.py:134-152 at d = 1
    jtable = jax_make_filter_batches(num_batches=8, batch_size=1 << 12)
    table = Table.from_reference(jtable)
    op = PartitionGpu(CPU_SET, table, "a", nr_partitions=16, resident=resident).Prepare()
    jop = PartitionTpu(JaxDeviceSet.allocate(1), jtable, "a", nr_partitions=16,
                       resident=resident).Prepare()
    assert op.resident == jop.resident == (resident is None)
    before = partition_cuda.LAUNCHES
    parts, jparts = op.Run(), jop.Run()
    assert partition_cuda.LAUNCHES == before  # the CPU path launches nothing
    if op.resident:
        assert isinstance(parts, DevicePartitions) and parts.nr_partitions == 16
        parts, jparts = parts.to_host(), jparts.to_host()
        assert op.Timers().sum_ns("partition-resident") > 0
    else:
        assert op.Timers().rank_count("dispatch") == len(table)
    _same_parts(parts, jparts, ["a"])
    allv = np.concatenate([q["a"] for q in parts])
    orig = np.concatenate([np.asarray(b["a"]) for b in table])
    np.testing.assert_array_equal(np.sort(allv), np.sort(orig))
    _same_parts(parts, _oracle(table, "a", 16), ["a"])


def test_partition_gpu_engine_choice_matches_partition_tpu():
    jtable = jax_make_filter_batches(num_batches=2, batch_size=1 << 10)
    table = Table.from_reference(jtable)
    for rows in (1 << 12, 1 << 10):
        op = PartitionGpu(CPU_SET, table, "a", 4)
        jop = PartitionTpu(JaxDeviceSet.allocate(1), jtable, "a", 4)
        op.MAX_RESIDENT_ROWS = jop.MAX_RESIDENT_ROWS = rows
        assert op.Prepare().resident == jop.Prepare().resident == (rows >= table.num_rows)
        assert isinstance(op._parter, ResidentPartitioner if op.resident else Partitioner)

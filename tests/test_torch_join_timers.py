"""The shuffle join's phase timers at one device: the port's
dist_join_phase_ms (parallel/dist_join.py) against the JAX package's
(dpu_olap_tpu/parallel/dist_join.py:182-292), JoinGpu.phase_ms under
FLAGS.join_timers on the shuffle route only, and the ACTIVATE_JOIN_TIMERS
flag, on the CPU."""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpu_olap_tpu.parallel.dist_join import dist_join_phase_ms as jax_dist_join_phase_ms
from dpu_olap_tpu.parallel.mesh import DeviceSet as JaxDeviceSet
from dpu_olap_tpu_torch.config import FLAGS
from dpu_olap_tpu_torch.generator import make_join_tables
from dpu_olap_tpu_torch.operators.join_op import JoinGpu, JoinNative
from dpu_olap_tpu_torch.ops.hashing import radix_bucket
from dpu_olap_tpu_torch.ops.partition import radix_partition
from dpu_olap_tpu_torch.parallel.dist_join import dist_join_phase_ms
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

REPO = Path(__file__).resolve().parents[1]
CPU_SET = DeviceSet(torch.device("cpu"))
PER = 1 << 12


@pytest.fixture(scope="module")
def tables():
    return make_join_tables(1, PER, PER)


@pytest.fixture
def join_timers():
    FLAGS.join_timers = True
    yield
    FLAGS.join_timers = False


@pytest.mark.parametrize("impl, rounds", [("cosort", 1), ("cosort", 2), ("sort", 1),
                                          ("sort", 2), ("cuckoo", 1)])
def test_phase_ms_has_the_jax_functions_keys(tables, impl, rounds):
    left, right = tables
    lf, rk = left.concat()["fk"], right.concat()["pk"]
    cell = 2 * PER // rounds
    got = dist_join_phase_ms(CPU_SET, lf, rk, 1, 1, cell, cell, impl=impl, keys31=True,
                             rounds=rounds, k=2)
    want = jax_dist_join_phase_ms(JaxDeviceSet.allocate(1), np.asarray(lf), np.asarray(rk),
                                  1, 1, cell, cell, impl=impl, keys31=True, rounds=rounds, k=2)
    assert list(got) == list(want) == ["fragments-ms", "exchange-ms", "local-join-ms"]
    assert all(isinstance(v, float) and math.isfinite(v) for v in got.values())
    # the prefixes nest: their sum is the whole chain's time a step
    assert sum(got.values()) > 0


def test_phase_ms_leaves_its_inputs_alone(tables):
    left, right = tables
    lf, rk = left.concat()["fk"], right.concat()["pk"]
    lf0, rk0 = lf.copy(), rk.copy()
    dist_join_phase_ms(CPU_SET, torch.from_numpy(lf), torch.from_numpy(rk), 2, 1,
                       2 * PER, 2 * PER, impl="sort", k=1)
    np.testing.assert_array_equal(lf, lf0)
    np.testing.assert_array_equal(rk, rk0)


def _rows(out):
    rows = np.stack([np.asarray(out[c]) for c in ("fk", "y", "x")])
    return rows[:, np.lexsort(rows[::-1])]


def test_join_gpu_shuffle_route_sets_phase_ms(tables, join_timers):
    left, right = tables
    op = JoinGpu(CPU_SET, left, right, impl="sort").Prepare()
    out = op.Run()
    assert list(op.phase_ms) == ["fragments-ms", "exchange-ms", "local-join-ms"]
    assert all(math.isfinite(v) for v in op.phase_ms.values())
    nat = JoinNative(left, right).Prepare().Run()
    np.testing.assert_array_equal(_rows(out),
                                  _rows({c: nat[c].to_numpy() for c in nat.column_names}))


@pytest.mark.parametrize("route", ["dense", "partitioned"])
def test_other_routes_leave_phase_ms_absent(tables, join_timers, route):
    left, right = tables
    op = JoinGpu(CPU_SET, left, right).Prepare()
    if route == "partitioned":
        op.MAX_RESIDENT_ROWS = PER // 2  # the host-staged path, as its tests shrink it
    op.Run()
    assert not hasattr(op, "phase_ms")


def test_shuffle_route_without_the_flag_sets_nothing(tables):
    left, right = tables
    assert not FLAGS.join_timers
    op = JoinGpu(CPU_SET, left, right, impl="sort").Prepare()
    op.Run()
    assert not hasattr(op, "phase_ms")


@pytest.mark.parametrize("env, want", [("", False), ("0", False), ("1", True)])
def test_activate_join_timers_env(env, want):
    code = "from dpu_olap_tpu_torch.config import FLAGS; print(FLAGS.join_timers)"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "ACTIVATE_JOIN_TIMERS": env})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(want)


@pytest.mark.parametrize("p", [1, 2, 16])
def test_radix_partition_counts_are_the_histogram(p):
    keys = torch.from_numpy(np.random.default_rng(p).integers(0, 2**32, 5000, dtype=np.uint32))
    res = radix_partition(keys, p)
    want = np.bincount(radix_bucket(keys, p).to(torch.int64).numpy(), minlength=p)
    np.testing.assert_array_equal(res.counts.to(torch.int64).numpy(), want)
    np.testing.assert_array_equal(res.offsets.to(torch.int64).numpy(), np.cumsum(want) - want)

"""SUM(x) over BM_JoinDpu's inner join, on tables held on one device.

The tables are made on the device from the seed by the data module the
configuration names (``data/<generator>.py``) and held there as the
program's device-resident ``Table``s, one ``Batch`` a ``batch_rows`` rows. Each query builds a fresh plan tree over them (a plan
node keeps its result for the set it ran on, so a reused tree would serve
that) and asks for the scalar:

    Aggregate(HashJoin(Source(left), Source(right)), "x").scalar(ds)

The plan's device-resident tier joins in place (``join_shard_auto``: the
radix sort of the probe side, the bitonic merge with the build side, the
forward fill), compacts the matched rows on the device and sums x there;
only scalars reach the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import spec
from ..reference import join as ref


class State(NamedTuple):
    fk: torch.Tensor  # the columns the benchmark made, which both sides read
    y: torch.Tensor
    pk: torch.Tensor
    x: torch.Tensor
    left: object  # the program's Table of (fk, y) batches
    right: object  # the program's Table of (pk, x) batches
    ds: object  # the program's DeviceSet


def setup(env) -> State:
    from dpu_olap_tpu_torch.columnar import Batch, Table
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    cfg = env.config
    data, batch = spec.data_module(cfg), cfg["batch_rows"]
    fk, y = data.probe_block(env.seed, 0, cfg, env.device)
    pk, x = data.build_block(env.seed, 0, cfg, env.device)

    def table(names, cols):
        return Table([Batch({n: c[i:i + batch] for n, c in zip(names, cols)})
                      for i in range(0, cols[0].shape[0], batch)])

    return State(fk, y, pk, x, table(("fk", "y"), (fk, y)), table(("pk", "x"), (pk, x)),
                 DeviceSet(env.device))


def _plan(state: State):
    from dpu_olap_tpu_torch import plan

    join = plan.HashJoin(plan.Source(state.left), plan.Source(state.right))
    return join, plan.Aggregate(join, "x")


def query(state: State, due: bool):
    _, agg = _plan(state)
    return agg.scalar(state.ds), due


def joined_rows(state: State):
    """A query once more; the rows its join handed the aggregate."""
    join, agg = _plan(state)
    agg.scalar(state.ds)
    out = join._run(state.ds)  # the node's kept result: the Table the sum read
    cols = [torch.cat([b[n] for b in out]) for n in ("fk", "y", "x")]
    del out, join, agg
    return tuple(ref.widen(c) for c in cols)


def expected(state: State, control: bool = False):
    rows = ref.join(state.fk, state.y, state.pk, state.x)
    return rows, (ref.sum_32 if control else ref.exact_sum)(rows[2])


def control_query(state: State, due: bool):
    _, total = expected(state, control=True)
    return total, due


def check(state: State, answers, control: bool = False) -> dict:
    """The window's answers against the reference's SUM(x), and the rows a
    query's join hands the sum against the reference's join (with control,
    the reference's rows stand in the program's place). The program's rows
    come first, its padded outputs freed before the reference runs."""
    got = expected(state, control=True)[0] if control else joined_rows(state)
    if got[0].is_cuda:
        torch.cuda.empty_cache()
    want, want_sum = expected(state)
    return ref.judge(got, answers, want, want_sum)


def least_bytes(env) -> int:
    """What SUM(x) over the join must read once: fk (4 bytes a probe row),
    pk and x (8 bytes a build row)."""
    probe, build = spec.data_module(env.config).rows(env.config)
    return 4 * probe + 8 * build


def probe_rows(env) -> int:
    return spec.data_module(env.config).rows(env.config)[0] * env.world

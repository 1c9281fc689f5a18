"""Faults planted in the program under the harness, for the tests: each is
called first in every process of a run (spawned ranks included, which find
it by module), and breaks one thing where it is produced."""

import torch

MASK32 = 0xFFFFFFFF


def _half(col):
    return col[: col.shape[0] // 2]


def half_the_probe_rows():
    """Half of the probe side left out of every join."""
    from dpu_olap_tpu_torch.ops import join
    from dpu_olap_tpu_torch.parallel import dist_join

    one, many = join.join_shard_auto, dist_join.dist_join

    def join_shard_auto(left_fk, left_payload, right_pk, right_payload, **kw):
        return one(_half(left_fk), tuple(_half(p) for p in left_payload), right_pk,
                   right_payload, **kw)

    def dist_join_half(ds, left_fk, left_payloads, right_pk, right_payloads, **kw):
        return many(ds, tuple(_half(s) for s in left_fk),
                    tuple(tuple(_half(s) for s in p) for p in left_payloads), right_pk,
                    right_payloads, **kw)

    join.join_shard_auto = join_shard_auto
    dist_join.dist_join = dist_join_half


def sum_off_by_one():
    """Every exact sum one too high where the kernel's wrapper returns it."""
    from dpu_olap_tpu_torch.ops import aggregate

    exact = aggregate.sum_u64_pair

    def sum_u64_pair(values):
        lo, hi = exact(values)
        return ((lo.view(torch.int32).to(torch.int64) + 1) & MASK32).to(torch.uint32), hi

    aggregate.sum_u64_pair = sum_u64_pair


def no_exchange():
    """The exchange between ranks left out: each rank keeps its own blocks."""
    from dpu_olap_tpu_torch.parallel.process_group import GroupSet

    GroupSet.exchange = lambda self, blocks, split_axis=0, concat_axis=0: tuple(blocks)

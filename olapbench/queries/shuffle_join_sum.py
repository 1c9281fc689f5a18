"""SUM(x) over BM_JoinDpu's inner join, with the tables spread over the ranks
of a process group, one rank a chip: the program's shuffle join.

Rank r holds block r of the probe side and block r + ``build_shift`` (mod
the ranks) of the build side (``data/<generator>.py``), made on its device
from the seed: the two tables lie apart, so a probe row's match lies on
another rank and only the shuffle brings them together. A query, on
every rank:

    out, _ = dist_join_retry(gs, (fk,), ((y,),), (pk,), ((x,),),
                             keys31=..., rounds=...)
    lo, hi = sum_u64_pair(x where matched)
    all_reduce([lo, hi, window over]) over the group

``dist_join_retry`` co-partitions both sides by key, exchanges the
partitions (one ``all_to_all_single`` a side over NCCL) and joins each
rank's partitions with the fused co-sort join, in the rounds JoinGpu would
take (``SINGLE_ROUND_ROWS`` a round and a rank), with the packed-key sort
where every key is below 2^31 - 1 (found once in set-up). The all-reduce
carries rank 0's word that the window is over, so every rank stops after
the same query.

The check routes each matched row to the rank that made its probe row
(the data module's ``probe_owner``: for BM_JoinDpu fk names its block) and
holds each rank's rows to the reference join of its own probe rows against
the whole build side, made again from the seed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import spec
from ..reference import join as ref


class State(NamedTuple):
    env: object
    fk: torch.Tensor  # this rank's probe block
    y: torch.Tensor
    pk: torch.Tensor  # this rank's build block
    x: torch.Tensor
    keys31: bool
    rounds: int


def setup(env) -> State:
    from dpu_olap_tpu_torch.operators.join_op import JoinGpu

    cfg = env.config
    data = spec.data_module(cfg)
    fk, y = data.probe_block(env.seed, env.rank, cfg, env.device)
    pk, x = data.build_block(env.seed, _held_build(env), cfg, env.device)
    # keys below 2^31 - 1 on every rank take the packed-key sort, as
    # JoinGpu.Prepare decides from its scans; here one all-reduce in set-up
    top = torch.stack([ref.widen(fk).max(), ref.widen(pk).max()]).max().reshape(1)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=env.gs.group)
    keys31 = int(top.item()) < 0x7FFFFFFF
    rounds = max(1, -(-max(data.rows(cfg)) // JoinGpu.SINGLE_ROUND_ROWS))  # _ici_rounds
    return State(env, fk, y, pk, x, keys31, rounds)


def _held_build(env) -> int:
    """The build block this rank holds."""
    return (env.rank + env.config["build_shift"]) % env.world


def _join(state: State):
    from dpu_olap_tpu_torch.parallel.dist_join import dist_join_retry

    s = state
    out, _ = dist_join_retry(s.env.gs, (s.fk,), ((s.y,),), (s.pk,), ((s.x,),),
                             keys31=state.keys31, rounds=state.rounds)
    # each output is a tuple of this rank's one shard (a column of them for y, x)
    return out[0][0], out[1][0][0], out[2][0][0], out[3][0]


def _reduce(state: State, lo, hi, due: bool):
    """All-reduce (lo, hi, window over) over the group: the sum, and stop."""
    env = state.env
    red = torch.stack([lo.reshape(()), hi.reshape(()),
                       torch.zeros((), dtype=torch.int64, device=env.device)])
    if due and env.rank == 0:
        red[2] = 1
    dist.all_reduce(red, group=env.gs.group)
    lo_sum, hi_sum, stop = red.tolist()
    return ((hi_sum << 32) + lo_sum) & ((1 << 64) - 1), stop > 0


def query(state: State, due: bool):
    from dpu_olap_tpu_torch.ops import aggregate

    fk, y, x, matched = _join(state)
    lo, hi = aggregate.sum_u64_pair(torch.where(matched, x.view(torch.int32), 0)
                                    .view(torch.uint32))
    return _reduce(state, ref.widen(lo), ref.widen(hi), due)


def _route(state: State, fk, y, x):
    """Send each row (int32 views) to the rank whose block holds its fk;
    returns this rank's rows (fk, y, x) as int64, and the rows no rank
    owns."""
    env = state.env
    owner = spec.data_module(env.config).probe_owner(ref.widen(fk), env.config)
    keep = (owner >= 0) & (owner < env.world)
    stray = int((~keep).sum())
    owner = owner[keep]
    order = torch.argsort(owner, stable=True)
    rows = torch.stack([fk[keep], y[keep], x[keep]], 1)[order].contiguous()
    send = torch.bincount(owner, minlength=env.world)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=env.gs.group)
    got = torch.empty((int(recv.sum()), 3), dtype=torch.int32, device=env.device)
    dist.all_to_all_single(got, rows, recv.tolist(), send.tolist(), group=env.gs.group)
    return tuple(ref.widen(got[:, i]) for i in range(3)), stray


def joined_rows(state: State):
    """A query's join once more; its matched rows, each on the rank that
    made its probe row. A row no rank owns comes back as a row of -1s, which
    no correct output holds."""
    fk, y, x, matched = _join(state)
    cols = [c.view(torch.int32)[matched] for c in (fk, y, x)]
    del fk, y, x, matched
    rows, stray = _route(state, *cols)
    if stray:
        pad = torch.full((stray,), -1, dtype=torch.int64, device=rows[0].device)
        rows = tuple(torch.cat([c, pad]) for c in rows)
    return rows


def _build_side(state: State):
    """The build side (pk, x) of every block: the one this rank holds, and
    the others made again from the seed."""
    env, cfg = state.env, state.env.config
    data = spec.data_module(cfg)
    blocks = [(state.pk, state.x) if blk == _held_build(env) else
              data.build_block(env.seed, blk, cfg, env.device) for blk in range(env.world)]
    return tuple(torch.cat(cols) for cols in zip(*blocks))


def expected(state: State, control: bool = False):
    """The reference: this rank's probe rows against the build side of every
    block; the sum over every rank's rows (with control, each rank's
    partial taken in 32 bits)."""
    rows = ref.join(state.fk, state.y, *_build_side(state))
    part = (ref.sum_32 if control else ref.exact_sum)(rows[2])
    total = torch.tensor([part], dtype=torch.int64, device=state.env.device)
    dist.all_reduce(total, group=state.env.gs.group)
    return rows, int(total.item()) & ((1 << 64) - 1)


def control_query(state: State, due: bool):
    """The reference in the program's place: this rank's rows joined by the
    reference, the partial sum in 32 bits, the same all-reduce."""
    rows = ref.join(state.fk, state.y, *_build_side(state))
    part = torch.tensor(ref.sum_32(rows[2]), dtype=torch.int64, device=state.env.device)
    return _reduce(state, part, torch.zeros_like(part), due)


def check(state: State, answers, control: bool = False) -> dict:
    """This rank's rows against the reference's (with control, the
    reference's rows in the program's place); the window's answers, the
    same on every rank after the all-reduce, counted on rank 0 alone."""
    got = expected(state, control=True)[0] if control else joined_rows(state)
    if got[0].is_cuda:
        torch.cuda.empty_cache()
    want, want_sum = expected(state)
    return ref.judge(got, answers if state.env.rank == 0 else [], want, want_sum)


def least_bytes(env) -> int:
    """What SUM(x) over the join must read once on a rank: its fk (4 bytes
    a probe row), its pk and x (8 bytes a build row)."""
    probe, build = spec.data_module(env.config).rows(env.config)
    return 4 * probe + 8 * build


def probe_rows(env) -> int:
    return spec.data_module(env.config).rows(env.config)[0] * env.world

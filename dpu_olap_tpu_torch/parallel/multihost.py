"""Two-level meshes and the hierarchical shuffle (counterpart of
``dpu_olap_tpu/parallel/multihost.py``).

Reference (SURVEY §2.7 item 5, §5.8): the UPMEM topology is a flat
set -> ranks -> dpus tree with one host; scaling beyond one host has no
reference implementation. As in the JAX package, a cluster is a 2-D mesh
(hosts x chips a host) and the shuffle a two-stage transpose, so the links
between hosts carry few large per-host messages instead of H*C small ones:

  stage 1 (within a host): each chip exchanges fragments with the chips of
                 its host, so chip c collects everything its host has for
                 chip c of any host;
  stage 2 (across hosts): chip (h, c) exchanges those host-batched
                 fragments with its peers (h', c).

After both stages device (h, c) holds one fragment from every source device
for its partition: the contract of the flat shuffle (parallel/shuffle.py),
so the same join consumes it.

In one process the host axis is a virtual split of a DeviceSet's devices,
as in the JAX package on one process (multihost.py:56-60). One process a
host, with a process group between them, is the counterpart of the JAX
package's ``process_index`` branch (multihost.py:46-55) and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .mesh import DeviceSet
from .shuffle import ShuffleResult, _stacked, _unstacked, exchange, local_fragments

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


@dataclasses.dataclass
class Mesh2D:
    """A (hosts, chips a host) grid over a DeviceSet's devices, row-major:
    device (h, c) is ``ds.devices[h * C + c]``."""

    ds: DeviceSet
    n_hosts: int
    chips_per_host: int

    @property
    def shape(self) -> dict:
        return {DCN_AXIS: self.n_hosts, ICI_AXIS: self.chips_per_host}


def make_mesh_2d(n_hosts: int | None = None, chips_per_host: int | None = None,
                 ds: DeviceSet | None = None) -> Mesh2D:
    """An (hosts, chips) mesh over ds's devices (DeviceSet.allocate() of
    n_hosts * chips_per_host devices by default, which raises without that
    many CUDA devices); the host axis is a virtual split. n_hosts defaults to
    2 and chips_per_host to the devices a host."""
    h = n_hosts or 2
    if ds is None:
        ds = DeviceSet.allocate(h * chips_per_host if chips_per_host else None)
    n = ds.nr_devices
    if n % h:
        raise ValueError(f"{n} devices not divisible into {h} hosts")
    c = chips_per_host or n // h
    if h * c > n:
        raise ValueError(f"a {h} x {c} mesh needs {h * c} devices, have {n}")
    return Mesh2D(DeviceSet(ds.devices[: h * c]), h, c)


def shuffle_partitions_2d(
    keys: tuple,
    payloads: tuple,
    n_hosts: int,
    chips_per_host: int,
    cell_size: int,
    rounds: int = 1,
) -> Tuple[ShuffleResult, ...]:
    """The hierarchical two-stage exchange over row-major shards (shard
    h*C + c on device (h, c); each payload a column of shards). Global
    partition p = (h*C + c)*rounds + r lives on device (h, c) as its
    resident round r, as in the flat shuffle with rounds > 1: received row
    s*rounds + r is source device s's fragment of my round-r partition
    (s = src_host*C + src_chip, host-major, the order the two stages give).
    Returns a ShuffleResult a device."""
    h, c = n_hosts, chips_per_host
    d = h * c
    if len(keys) != d:
        raise ValueError(f"a {h} x {c} mesh takes {d} shards, got {len(keys)}")
    p = d * rounds
    frags = [local_fragments(keys[s], tuple(col[s] for col in payloads), p, cell_size)
             for s in range(d)]

    def two_stage(blocks):
        # (P, ...) -> (H, C, R, ...): leading = (dest host, dest chip, local
        # round); rounds are the fastest bucket axis, so they ride untouched
        hc = [b.reshape((h, c, rounds) + b.shape[1:]) for b in blocks]
        # stage 1: within a host, the dest-chip axis becomes the source-chip axis
        s1 = [None] * d
        for host in range(h):
            ids = range(host * c, (host + 1) * c)
            for i, r in zip(ids, exchange([hc[i] for i in ids], split_axis=1, concat_axis=1)):
                s1[i] = r
        # stage 2: across hosts, the dest-host axis becomes the source-host axis
        s2 = [None] * d
        for chip in range(c):
            ids = range(chip, d, c)
            for i, r in zip(ids, exchange([s1[i] for i in ids])):
                s2[i] = r
        # leading axes now (src host, src chip, round): flatten host-major
        return [x.reshape((p,) + x.shape[3:]) for x in s2]

    # one stacked two-stage exchange for the key and payload planes; the
    # small counts vector goes through its own
    recv = two_stage([_stacked(ck, cp) for ck, cp, _, _ in frags])
    counts = two_stage([f[2].view(torch.int32).reshape(p, 1) for f in frags])
    return tuple(_unstacked(r, n[:, 0], f[3], rounds) for r, n, f in zip(recv, counts, frags))


def dist_join_2d_spmd(
    left_fk, left_payloads, right_pk, right_payloads,
    n_hosts: int, chips_per_host: int, cell_left: int, cell_right: int,
    rounds: int = 1,
):
    """The multi-host join over every shard: the hierarchical co-shuffle,
    then the fused local join on each device (rounds > 1: the resident
    rounds, see dist_join.join_shuffled). Returns (fk, left_cols,
    right_cols, matched, overflow), each a tuple of shards."""
    from .dist_join import _columns, join_shuffled

    right = shuffle_partitions_2d(right_pk, right_payloads, n_hosts, chips_per_host,
                                  cell_right, rounds=rounds)
    left = shuffle_partitions_2d(left_fk, left_payloads, n_hosts, chips_per_host,
                                 cell_left, rounds=rounds)
    return _columns([join_shuffled(lt, rt) for lt, rt in zip(left, right)])


def dist_join_2d(
    mesh: Mesh2D,
    left_fk, left_payloads: Tuple, right_pk, right_payloads: Tuple,
    cell_left: int | None = None, cell_right: int | None = None,
    slack: float | None = None, rounds: int = 1,
):
    """The multi-host join of host arrays or tensors, split over the mesh's
    devices in row-major order. Returns tuples of shards, as
    dist_join_2d_spmd."""
    from ..config import FLAGS
    from .shuffle import default_cell_size

    h, c = mesh.n_hosts, mesh.chips_per_host
    n_dev = h * c
    slack = slack or FLAGS.shuffle_slack
    cell_left = cell_left or default_cell_size(left_fk.shape[0] // n_dev, n_dev * rounds, slack)
    cell_right = cell_right or default_cell_size(right_pk.shape[0] // n_dev, n_dev * rounds,
                                                 slack)
    put = mesh.ds.split
    return dist_join_2d_spmd(
        put(left_fk), tuple(put(a) for a in left_payloads),
        put(right_pk), tuple(put(a) for a in right_payloads),
        h, c, cell_left, cell_right, rounds=rounds,
    )

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
as in the JAX package on one process (multihost.py:56-60). The JAX
package's ``process_index`` branch (multihost.py:46-55), one process a
device under ``jax.distributed``, is ported too: ``make_mesh_2d(group=...)``
over a process group (``parallel/process_group.py``) gives a
``ProcessMesh2D`` whose rows are hosts of ``chips_per_host`` ranks (rank
h*C + c is chip c of host h), each stage an ``all_to_all_single`` over a
subgroup: the ranks of a host in stage 1, the ranks of a chip index in
stage 2. Each mesh gives the two stages (``stage1``, ``stage2``), so the
shuffle and the join below are one code over both.
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

    def stage1(self, blocks) -> list:
        """Within each host: the exchange over its shards' axis 1."""
        h, c = self.n_hosts, self.chips_per_host
        out = [None] * (h * c)
        for host in range(h):
            ids = range(host * c, (host + 1) * c)
            for i, r in zip(ids, exchange([blocks[i] for i in ids], split_axis=1,
                                          concat_axis=1)):
                out[i] = r
        return out

    def stage2(self, blocks) -> list:
        """Across hosts: the exchange over each chip index's shards."""
        h, c = self.n_hosts, self.chips_per_host
        out = [None] * (h * c)
        for chip in range(c):
            ids = range(chip, h * c, c)
            for i, r in zip(ids, exchange([blocks[i] for i in ids])):
                out[i] = r
        return out


@dataclasses.dataclass
class ProcessMesh2D:
    """A (hosts, chips a host) grid over the ranks of a process group, one
    rank a device, row-major: this rank is chip ``chip`` of host ``host``;
    ``host_group`` holds the ranks of its host, ``chip_group`` the ranks of
    its chip index, one a host."""

    ds: object  # the GroupSet of every rank
    n_hosts: int
    chips_per_host: int
    host_group: object
    chip_group: object

    @property
    def shape(self) -> dict:
        return {DCN_AXIS: self.n_hosts, ICI_AXIS: self.chips_per_host}

    @property
    def host(self) -> int:
        return self.ds.rank // self.chips_per_host

    @property
    def chip(self) -> int:
        return self.ds.rank % self.chips_per_host

    def stage1(self, blocks) -> tuple:
        """Within the host: one collective over the host's ranks, axis 1."""
        return self.host_group.exchange(blocks, split_axis=1, concat_axis=1)

    def stage2(self, blocks) -> tuple:
        """Across hosts: one collective over the chip index's ranks."""
        return self.chip_group.exchange(blocks)


def make_mesh_2d(n_hosts: int | None = None, chips_per_host: int | None = None,
                 ds: DeviceSet | None = None, group=None):
    """An (hosts, chips) mesh over ds's devices (DeviceSet.allocate() of
    n_hosts * chips_per_host devices by default, which raises without that
    many CUDA devices); the host axis is a virtual split. n_hosts defaults to
    2 and chips_per_host to the devices a host.

    Over a process group of two or more ranks (``group``, the GroupSet of
    every rank) the grid's rows are hosts: chips_per_host defaults to the
    ranks a host (LOCAL_WORLD_SIZE) and n_hosts is the world over it. Every
    rank calls this alike: it creates each host's and each chip index's
    subgroup, in that order, and returns a ProcessMesh2D."""
    if group is not None:
        w = group.world_size
        c = chips_per_host or group.local_world_size
        if w < 2 or w % c:
            raise ValueError(f"a process mesh takes 2 or more ranks in hosts of {c}, got {w}")
        h = w // c
        if n_hosts not in (None, h):
            raise ValueError(f"{w} ranks in hosts of {c} make {h} hosts, not {n_hosts}")
        host_group = group.subgroups([range(i * c, (i + 1) * c) for i in range(h)])
        chip_group = group.subgroups([range(j, w, c) for j in range(c)])
        return ProcessMesh2D(group, h, c, host_group, chip_group)
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
    keys,
    payloads: tuple,
    n_hosts: int,
    chips_per_host: int,
    cell_size: int,
    rounds: int = 1,
    mesh=None,
):
    """The hierarchical two-stage exchange over row-major shards (shard
    h*C + c on device (h, c); each payload a column of shards). Global
    partition p = (h*C + c)*rounds + r lives on device (h, c) as its
    resident round r, as in the flat shuffle with rounds > 1: received row
    s*rounds + r is source device s's fragment of my round-r partition
    (s = src_host*C + src_chip, host-major, the order the two stages give).
    Returns a ShuffleResult for each shard this process holds.

    ``mesh`` gives the stages: by default a Mesh2D over the shards' devices;
    over a ProcessMesh2D keys and each payload column are the 1-tuple of
    this rank's shard."""
    h, c = n_hosts, chips_per_host
    d = h * c
    if mesh is None:
        if len(keys) != d:
            raise ValueError(f"a {h} x {c} mesh takes {d} shards, got {len(keys)}")
        mesh = Mesh2D(DeviceSet([k.device for k in keys]), h, c)
    elif (mesh.n_hosts, mesh.chips_per_host) != (h, c):
        raise ValueError(f"a {h} x {c} shuffle over a {mesh.n_hosts} x"
                         f" {mesh.chips_per_host} mesh")
    frags = [local_fragments(k, tuple(col[s] for col in payloads), d * rounds, cell_size)
             for s, k in enumerate(keys)]
    return move_fragments_2d(mesh, frags, rounds)


def move_fragments_2d(mesh, frags, rounds: int = 1) -> Tuple[ShuffleResult, ...]:
    """ShuffleResults from the fragments (``local_fragments``' outputs) of
    each shard this process holds, row-major, by the mesh's two stages."""
    h, c = mesh.n_hosts, mesh.chips_per_host
    p = h * c * rounds

    def two_stage(blocks):
        # (P, ...) -> (H, C, R, ...): leading = (dest host, dest chip, local
        # round); rounds are the fastest bucket axis, so they ride untouched.
        # Stage 1 turns the dest-chip axis into the source-chip axis, stage 2
        # the dest-host axis into the source-host axis; the leading axes are
        # then (src host, src chip, round): flatten host-major
        hc = [b.reshape((h, c, rounds) + b.shape[1:]) for b in blocks]
        return [x.reshape((p,) + x.shape[3:]) for x in mesh.stage2(mesh.stage1(hc))]

    # one stacked two-stage exchange for the key and payload planes; the
    # small counts vector goes through its own
    recv = two_stage([_stacked(ck, cp) for ck, cp, _, _ in frags])
    counts = two_stage([f[2].view(torch.int32).reshape(p, 1) for f in frags])
    return tuple(_unstacked(r, n[:, 0], f[3], rounds) for r, n, f in zip(recv, counts, frags))


def dist_join_2d_spmd(
    left_fk, left_payloads, right_pk, right_payloads,
    n_hosts: int, chips_per_host: int, cell_left: int, cell_right: int,
    rounds: int = 1, mesh=None,
):
    """The multi-host join over every shard this process holds: the
    hierarchical co-shuffle (over ``mesh``'s stages, as
    shuffle_partitions_2d), then the fused local join on each device
    (rounds > 1: the resident rounds, see dist_join.join_shuffled). Returns
    (fk, left_cols, right_cols, matched, overflow), each a tuple of shards
    (over a ProcessMesh2D, this rank's one)."""
    from .dist_join import _columns, join_shuffled

    right = shuffle_partitions_2d(right_pk, right_payloads, n_hosts, chips_per_host,
                                  cell_right, rounds=rounds, mesh=mesh)
    left = shuffle_partitions_2d(left_fk, left_payloads, n_hosts, chips_per_host,
                                 cell_left, rounds=rounds, mesh=mesh)
    return _columns([join_shuffled(lt, rt) for lt, rt in zip(left, right)])


def dist_join_2d(
    mesh,
    left_fk, left_payloads: Tuple, right_pk, right_payloads: Tuple,
    cell_left: int | None = None, cell_right: int | None = None,
    slack: float | None = None, rounds: int = 1,
):
    """The multi-host join of host arrays or tensors, split over the mesh's
    devices in row-major order (``mesh.ds.split``: over a ProcessMesh2D each
    rank takes its own rows); a tuple of the shards this process holds is
    taken as it is. Returns tuples of shards, as dist_join_2d_spmd."""
    from ..config import FLAGS
    from .dist_join import _shard_rows
    from .shuffle import default_cell_size

    h, c = mesh.n_hosts, mesh.chips_per_host
    n_dev = h * c
    slack = slack or FLAGS.shuffle_slack

    def put(a):
        return tuple(a) if isinstance(a, (tuple, list)) else mesh.ds.split(a)

    cell_left = cell_left or default_cell_size(_shard_rows(left_fk, n_dev), n_dev * rounds,
                                               slack)
    cell_right = cell_right or default_cell_size(_shard_rows(right_pk, n_dev), n_dev * rounds,
                                                 slack)
    left_fk, right_pk = put(left_fk), put(right_pk)
    return dist_join_2d_spmd(
        left_fk, tuple(put(a) for a in left_payloads),
        right_pk, tuple(put(a) for a in right_payloads),
        h, c, cell_left, cell_right, rounds=rounds, mesh=mesh,
    )

"""One process a device: the ranks of a ``torch.distributed`` process group
(counterpart of running the JAX package under ``jax.distributed``).

Under ``jax.distributed`` every process holds its own devices and runs the
same SPMD program on its shard; the shuffle's ``lax.all_to_all``
(shuffle.py:192-202) and the two stages of ``shuffle_partitions_2d``
(multihost.py:84-96) are then collectives between processes. Here each rank
of a process group holds one device and its shard of the data: the same
partition, sort and fill kernels run in every rank, and the exchange is one
``all_to_all_single`` over the group (``shuffle.exchange_group``). A
``GroupSet`` is one rank's view of the group, beside the one-controller
``DeviceSet``, and offers what the shuffle and the join ask of a set: the
group's size (``nr_devices``), ``split``, which gives the rank the rows that
``DeviceSet.split`` gives shard r, as the one shard it holds (a 1-tuple),
``exchange`` over those shards, and ``any`` of every rank's flags. So the
shuffle, the joins and the two-stage mesh run over a GroupSet unchanged;
``gather`` brings every rank's shard to rank 0, for the checks.

Backends: NCCL, the default on a card, takes one rank a GPU (two ranks on
one card fail with "Duplicate GPU detected"); gloo runs ranks on the CPU
(the tests) or several ranks on one card, and takes CUDA tensors, which it
stages through host memory inside itself. Neither
moves uint32 (NCCL: "Unconvertible NCCL type UInt32"; gloo: "Invalid scalar
type"), so the collectives here move int32 views or bytes.

``init_group`` takes the rank, the world size and the rendezvous from its
arguments or, under ``torchrun``, from RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT. ``spawn`` starts ranks
(``torch.multiprocessing``, spawn), each calling a function with its
group; a rank that raises, dies or outlasts the time limit fails the run,
and every rank is stopped.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..metrics import count
from .shuffle import exchange_group

TIMEOUT_S = 300  # a collective's and a spawn's time limit


@dataclasses.dataclass(eq=False)
class GroupSet:
    """One rank of a process group: its place in the group, the group's
    handle (None: the default group of every process) and its device."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    ranks: tuple  # the members' ranks in the default group, in group order
    group: object = None
    local_world_size: int = 1  # ranks a host (LOCAL_WORLD_SIZE)

    def __enter__(self) -> "GroupSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Tear the group down (the default group: every group)."""
        if self.group is None:
            dist.destroy_process_group()
        else:
            dist.destroy_process_group(self.group)

    @property
    def nr_devices(self) -> int:
        """The group's devices, one a rank (DeviceSet.nr_devices)."""
        return self.world_size

    def subgroups(self, members) -> "GroupSet | None":
        """A group for each list of member positions (ranks of this group),
        created in the order given; returns this rank's, or None. Creating a
        group is collective over every process: each one calls this with
        the same lists."""
        mine = None
        for pos in members:
            ranks = tuple(self.ranks[i] for i in pos)
            handle = dist.new_group(ranks=list(ranks))
            if self.ranks[self.rank] in ranks:
                mine = GroupSet(ranks.index(self.ranks[self.rank]), len(ranks), self.device,
                                self.backend, ranks, handle, self.local_world_size)
        return mine

    # ---- transfers ---------------------------------------------------------

    def put(self, a) -> torch.Tensor:
        """A host array or a tensor on this rank's device."""
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device)

    def split(self, a) -> tuple:
        """This rank's rows [r*k, (r+1)*k) of axis 0 of a host array or a
        tensor, on its device, as the one shard it holds: shard r of
        ``DeviceSet.split``."""
        k, rest = divmod(a.shape[0], self.world_size)
        if rest:
            raise ValueError(f"{a.shape[0]} rows do not split over {self.world_size} ranks")
        return (self.put(a[self.rank * k:(self.rank + 1) * k]),)

    def exchange(self, blocks, split_axis: int = 0, concat_axis: int = 0) -> tuple:
        """``shuffle.exchange`` over the group: this rank's one block
        (a 1-tuple) in, the block of shard rank out, by one collective."""
        (block,) = blocks
        if split_axis != concat_axis:
            raise ValueError("a group's exchange splits and concatenates one axis")
        return (exchange_group(block, self, split_axis),)

    def gather(self, x) -> np.ndarray | None:
        """Every rank's tensor (or its one shard, a 1-tuple) concatenated
        along axis 0 in rank order, as a host array on rank 0 (None on the
        others); the ranks' rows may differ in number. The bytes travel,
        padded to the longest."""
        if isinstance(x, (tuple, list)):
            (x,) = x
        x = x.contiguous()
        raw = x.reshape(-1).view(torch.uint8)
        n = torch.tensor([raw.numel()], dtype=torch.int64, device=self.device)
        sizes = [torch.empty_like(n) for _ in range(self.world_size)]
        dist.all_gather(sizes, n, group=self.group)
        sizes = [int(s) for s in sizes]
        top = max(sizes)
        send = torch.zeros(top, dtype=torch.uint8, device=self.device)
        send[:raw.numel()] = raw
        root = self.rank == 0
        recv = [torch.empty_like(send) for _ in sizes] if root else None
        dist.gather(send, recv, dst=self.ranks[0], group=self.group)
        if not root:
            return None
        dtype = np.dtype(str(x.dtype).removeprefix("torch."))
        data = np.concatenate([r[:s].cpu().numpy() for r, s in zip(recv, sizes)])
        return data.view(dtype).reshape((-1, *x.shape[1:]))

    def any(self, flags) -> bool:
        """Whether any element of any rank's flag (a tensor, or its one
        shard) is set: one decision that every rank takes alike."""
        if isinstance(flags, (tuple, list)):
            (flags,) = flags
        t = flags.reshape(-1).any().to(torch.int32).reshape(1).to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        count("readback.group.any")
        return bool(t.item())

    def barrier(self) -> None:
        """Wait for this rank's device work, then for every rank."""
        self.sync()
        dist.barrier(group=self.group)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _env_int(name: str, given: int | None) -> int | None:
    if given is not None:
        return given
    return int(os.environ[name]) if name in os.environ else None


def rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` by default (raises without
    that card), or the device named ("cpu", "cuda:0", ...)."""
    if device is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_rank >= cards:
            raise RuntimeError(f"local rank {local_rank} has no CUDA device ({cards} visible);"
                               " device='cpu' runs the rank on the CPU")
        return torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device}")
    return device


def init_group(backend: str | None = None, rank: int | None = None,
               world_size: int | None = None, init_method: str | None = None,
               device=None, timeout_s: float = TIMEOUT_S) -> GroupSet:
    """Join the default process group and return this rank's GroupSet.
    Arguments left None come from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE; MASTER_ADDR and MASTER_PORT give the
    rendezvous ``env://``). The backend is NCCL on a card and gloo on the
    CPU unless named; NCCL needs a CUDA device."""
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    if rank is None or world_size is None:
        raise ValueError("init_group needs rank and world_size (RANK and WORLD_SIZE under"
                         " torchrun)")
    if init_method is None:
        if not ("MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ):
            raise ValueError("init_group needs init_method (MASTER_ADDR and MASTER_PORT under"
                             " torchrun)")
        init_method = "env://"
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    device = rank_device(device, local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend is 'nccl' or 'gloo', got {backend!r}")
    extra = {}
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA devices, not {device}")
        extra["device_id"] = device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **extra)
    return GroupSet(rank, world_size, device, backend, tuple(range(world_size)), None,
                    local_world)


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for a ``tcp://`` rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, init_method, backend, device, timeout_s, args, results):
    try:
        with init_group(backend, rank, world, init_method, device, timeout_s) as gs:
            value = fn(gs, *args)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, value))


def spawn(fn, nproc: int, args: tuple = (), init_method: str | None = None,
          backend: str | None = None, device=None, timeout_s: float = TIMEOUT_S) -> list:
    """Run ``fn(gs, *args)`` in nproc spawned ranks, each in the group that
    ``init_group(backend, rank, nproc, init_method, device)`` joins (a
    ``tcp://127.0.0.1`` rendezvous on a free port by default); returns the
    ranks' results in rank order. fn and its results are pickled. Raises
    RuntimeError, after stopping every rank, when a rank raises or dies
    before returning, or when the ranks outlast timeout_s."""
    import torch.multiprocessing as mp

    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nproc, init_method, backend, device, timeout_s, args,
                               results))
             for r in range(nproc)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < nproc:
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in got]
            try:
                # a rank that died has put its traceback first: wait for it
                rank, ok, value = results.get(timeout=5.0 if dead else 1.0)
            except queue.Empty:
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with {dead[0][1]}"
                                       " before returning") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"no result within {timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nproc} failed:\n{value}")
            got[rank] = value
        for r, p in enumerate(procs):
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(nproc)]

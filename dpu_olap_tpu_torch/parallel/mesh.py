"""DeviceSet over explicit torch devices (counterpart of
``dpu_olap_tpu/parallel/mesh.py``).

Reference: dpu::DpuSet (host/dpuext/dpuext.hpp:664-929) — allocate devices,
scatter/gather buffers, sync. As in the JAX package, one controller (this
process) holds every device of the set: where the JAX package shards a
global array over its mesh, the port holds a tuple of shards, shard i on
``devices[i]``, and runs each device's part of a program in turn; the
launches are asynchronous, so work on different physical devices overlaps.

``allocate`` hands out the first n CUDA devices and raises when there are
fewer; it never repeats a device and never falls back to the CPU. The
default is one device (the JAX package's is every visible device): NR_DEVICES
chooses more. A set that repeats a device, or lies on the CPU, exists only
where a caller such as a test or chip_smoke.py constructs it: ``[cpu] * d``
is the counterpart of the JAX tests' virtual CPU mesh, ``[cuda:0] * d`` runs
every per-shard kernel and the exchange on one card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import config


class DeviceSet:
    """Torch devices (one or several, a device may repeat) with
    scatter/split/gather transfers and a sync barrier."""

    def __init__(self, devices):
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a DeviceSet needs at least one device")

    @staticmethod
    def allocate(nr_devices: int | None = None) -> "DeviceSet":
        """The first nr_devices CUDA devices (DpuSet::allocate; NR_DEVICES env
        analog in config.nr_devices, 1 by default). Raises when fewer CUDA
        devices exist."""
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("DeviceSet.allocate: no CUDA device available")
        avail = torch.cuda.device_count()
        n = config.nr_devices(default=1) if nr_devices is None else nr_devices
        if n < 1:
            raise ValueError(f"requested {n} devices")
        if n > avail:
            raise ValueError(f"requested {n} devices, have {avail}")
        return DeviceSet([torch.device("cuda", i) for i in range(n)])

    @property
    def nr_devices(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first device: where one-device work and host arrays go."""
        return self.devices[0]

    @property
    def physical(self) -> tuple:
        """The distinct devices of the set, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))

    # ---- transfers ---------------------------------------------------------

    def scatter(self, host_array: np.ndarray) -> torch.Tensor:
        """Copy a host array to the first device (push_xfer analog)."""
        return torch.from_numpy(np.ascontiguousarray(host_array)).to(self.device)

    def split(self, a) -> tuple:
        """Split axis 0 of a host array or a tensor into nr_devices equal
        shards, shard i on devices[i] (the JAX package's ``scatter`` with
        P(AXIS), per-DPU push_xfer scatter, dpuext.hpp:275-288). A shard that
        is already on its device is a view."""
        d = self.nr_devices
        if a.shape[0] % d:
            raise ValueError(f"{a.shape[0]} rows do not split over {d} devices")
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        k = a.shape[0] // d
        return tuple(a[i * k:(i + 1) * k].to(dev) for i, dev in enumerate(self.devices))

    @staticmethod
    def gather(x) -> np.ndarray:
        """Fetch to host numpy (copy_from gather): a tensor, or a tuple of
        shards concatenated along axis 0 in device order, in one readback
        (the shards meet on the first shard's device first)."""
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        if len(x) == 1:
            return x[0].cpu().numpy()
        dev = x[0].device
        return torch.cat([s.to(dev) for s in x]).cpu().numpy()

    def exchange(self, blocks, split_axis: int = 0, concat_axis: int = 0) -> tuple:
        """The tiled all-to-all over the set's shards (``shuffle.exchange``)."""
        from .shuffle import exchange

        return exchange(blocks, split_axis, concat_axis)

    def any(self, flags) -> bool:
        """Whether any element of the flags (a tensor or a tuple of shards)
        is set, in one readback."""
        return bool(self.gather(flags).any())

    def sync(self) -> None:
        """Barrier on outstanding device work (DpuSetAsync::sync), each
        distinct device once."""
        sync_devices(self.physical)


def sync_devices(devices: Sequence[torch.device]) -> None:
    """Synchronise each CUDA device among ``devices`` once."""
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

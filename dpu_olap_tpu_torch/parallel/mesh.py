"""DeviceSet over an explicit torch device (counterpart of
``dpu_olap_tpu/parallel/mesh.py``).

Reference: dpu::DpuSet (host/dpuext/dpuext.hpp:664-929) — allocate devices,
scatter/gather buffers, sync. This slice runs on one device: ``allocate``
hands out one CUDA device and raises when there is none; a CPU DeviceSet
exists only where a caller such as a test constructs it explicitly.
Multi-device sets (the JAX package's mesh, over a process group) arrive with
the shuffle join's exchange across devices (ROADMAP §1 item 10); the
one-device shuffle join (parallel/dist_join.py) runs on this set.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config


class DeviceSet:
    """One torch device with scatter/gather transfers and a sync barrier."""

    def __init__(self, device):
        self.device = torch.device(device)

    @staticmethod
    def allocate(nr_devices: int | None = None) -> "DeviceSet":
        """Allocate nr_devices CUDA devices (DpuSet::allocate; NR_DEVICES env
        analog in config.nr_devices). Raises when no CUDA device exists."""
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("DeviceSet.allocate: no CUDA device available")
        avail = torch.cuda.device_count()
        n = config.nr_devices(default=1) if nr_devices is None else nr_devices
        if n > avail:
            raise ValueError(f"requested {n} devices, have {avail}")
        if n != 1:
            raise NotImplementedError(
                "multi-device DeviceSet is not ported yet (ROADMAP §1 item 10)"
            )
        return DeviceSet(torch.device("cuda", torch.cuda.current_device()))

    @property
    def nr_devices(self) -> int:
        return 1

    # ---- transfers ---------------------------------------------------------

    def scatter(self, host_array: np.ndarray) -> torch.Tensor:
        """Copy a host array to the device (push_xfer analog)."""
        return torch.from_numpy(np.ascontiguousarray(host_array)).to(self.device)

    @staticmethod
    def gather(device_array: torch.Tensor) -> np.ndarray:
        """Fetch to host numpy (copy_from gather)."""
        return device_array.cpu().numpy()

    def sync(self) -> None:
        """Barrier on outstanding device work (DpuSetAsync::sync)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

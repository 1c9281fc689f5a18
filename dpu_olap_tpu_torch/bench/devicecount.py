"""Device inventory (counterpart of ``scripts/devicecount.py``, the
reference's scripts/dpucount.py: allocate all and report the count).

    python -m dpu_olap_tpu_torch.bench.devicecount

Prints ``N devices allocated (cuda)`` and a line per CUDA device with its
name, SM count, compute capability and total memory in GiB. With no CUDA
device it says so and exits 1.
"""

from __future__ import annotations

import sys

import torch


def main(argv=None) -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        print("devicecount: no CUDA device", file=sys.stderr)
        return 1
    n = torch.cuda.device_count()
    print(f"{n} devices allocated (cuda)")
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        print(f"  [{i}] {p.name} sms={p.multi_processor_count} capability={p.major}.{p.minor},"
              f" {p.total_memory / 2**30:.1f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())

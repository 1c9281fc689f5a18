"""The TPU lowering probes' counterpart: each primitive that
``measurements/_probe_v4_lowering.py``, ``_proto_lower.py`` and
``_proto_lower2.py`` export for the TPU (and never run) is built here at the
probe's shapes, run once on the card through ``ops/probes_cuda.py`` and
compared bit for bit with numpy.

    python -m dpu_olap_tpu_torch.bench.probe_lowering

It prints one ``OK`` or ``FAIL`` line per probe, under the probe's own
name, and exits 1 if any line is ``FAIL`` (or there is no CUDA device).
Inputs come from ``np.random.default_rng(0)``: random 32-bit words, lane
indices in [0, 128), random 0/1 bf16 planes. ``run(device="cpu")`` runs the
plain versions, for the tests.
"""

from __future__ import annotations

import sys

import numpy as np

LANES = 128


def _probes(rng):
    """(name, run(device) -> (got, want)) for every probe of the three
    scripts, in their order."""
    import torch

    from ..ops import probes_cuda as pc

    def dev(a, device):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def words(shape, dtype):
        return rng.integers(0, 2**32, shape, dtype=np.uint32).view(dtype)

    def transpose(shape, dtype):
        x = words(shape, dtype)
        return lambda d: (pc.transpose(dev(x, d)), x.T)

    def gather(wi):
        x = words((LANES, LANES), np.uint32)
        i = rng.integers(0, LANES, (LANES, wi), dtype=np.int32)
        return lambda d: (pc.lane_gather(dev(x, d), dev(i, d)), np.take_along_axis(x, i, axis=1))

    def onehot():
        a, b = (rng.integers(0, 2, (LANES, w)).astype(np.float32) for w in (LANES, 2 * LANES))
        def bf16(m, d):
            return dev(m, d).to(torch.bfloat16)
        return lambda d: (pc.onehot_matmul(bf16(a, d), bf16(b, d)), a.T @ b)

    def dynrow():
        x = words((4 * LANES, LANES), np.uint32)
        r = int(rng.integers(0, 4 * LANES))
        return lambda d: (pc.dyn_row(dev(x, d), dev(np.array([r], np.int32), d)), x[r:r + 1])

    return [
        # _probe_v4_lowering.py
        ("transpose u32 (128,128)", transpose((LANES, LANES), np.uint32)),
        ("transpose i32 (128,128)", transpose((LANES, LANES), np.int32)),
        ("gather axis=1 idx(128,256) over vals(128,128)", gather(2 * LANES)),
        ("gather axis=1 idx(128,128) over vals(128,128)", gather(LANES)),
        ("bf16 one-hot matmul (128,128)^T@(128,256) f32 acc", onehot()),
        # _proto_lower.py
        ("transpose_512x128_u32", transpose((4 * LANES, LANES), np.uint32)),
        ("transpose_128x128_i32", transpose((LANES, LANES), np.int32)),
        ("gather_wide_idx", gather(2 * LANES)),
        ("dynrow_read", dynrow()),
        # _proto_lower2.py
        ("gather_wide", gather(2 * LANES)),
    ]


def run(device: str = "cuda") -> dict:
    """Run every probe once on ``device``; print and return {name: ok}."""
    results = {}
    for name, probe in _probes(np.random.default_rng(0)):
        got, want = probe(device)
        got = got.cpu().numpy()
        ok = got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)
        results[name] = ok
        print(f"  {'OK  ' if ok else 'FAIL'} {name}"
              + ("" if ok else f": got {got.dtype} {got.shape}, want {want.dtype} {want.shape}"
                 " or other values"), flush=True)
    return results


def main(argv=None) -> int:
    import torch

    if argv:
        print(f"probe_lowering takes no arguments, got {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe_lowering needs a CUDA device", file=sys.stderr)
        return 1
    print(f"probe_lowering on {torch.cuda.get_device_name(0)}", flush=True)
    return 0 if all(run().values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The 95th percentile, by nearest rank, of every query's time in the window,
from submission to its result on the host (host clock, rank 0)."""

from olapbench.harness import p95


def read(run):
    lat = run.lead["latencies_s"]
    return p95(lat) * 1e3 if lat else None

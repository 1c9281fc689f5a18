"""The query's least time on the chip over the device's busy time in the
traced slice, every rank together. The least time is the bytes SUM(x) over
the join must read once (the query module's ``least_bytes``: fk, pk and x)
at the H100's 3.35 TB/s; busy time is the union of the device's
intervals, copies included."""

from olapbench.roofline import HBM_BYTES_PER_S


def read(run):
    traces = run.traces
    busy = sum(t.busy_us for t in traces)
    least = sum(t.least_bytes * t.queries for t in traces) / HBM_BYTES_PER_S * 1e6
    return 100.0 * least / busy if busy and least else None

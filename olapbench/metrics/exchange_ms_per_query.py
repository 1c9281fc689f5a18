"""Device time of the NCCL kernels a query in the traced slice, rank 0: the
shuffle's exchange, the retry's overflow vote and the query's all-reduce,
with the time a kernel waits there for the other ranks."""


def read(run):
    traces = run.traces
    if not traces or not traces[0].queries:
        return None
    t = traces[0]
    comm = t.kind_us("comm")
    return comm / 1e3 / t.queries if comm else None

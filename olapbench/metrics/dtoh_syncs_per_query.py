"""Device-to-host copies a query in the traced slice, rank 0: the plan's and
the join's scalar readbacks, each a wait of the host for the device."""


def read(run):
    traces = run.traces
    if not traces or not traces[0].queries:
        return None
    return traces[0].count("Memcpy DtoH") / traces[0].queries

"""One minus the device's busy time (the union of its kernel, copy and
memset intervals) over the traced slice's length, every rank together."""


def read(run):
    traces = run.traces
    span = sum(t.span_us for t in traces)
    if not span:
        return None
    return 100.0 * (1.0 - sum(t.busy_us for t in traces) / span)

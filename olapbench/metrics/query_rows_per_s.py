"""Probe-side input rows of every query the window completed, over the
window's seconds (host clock, rank 0, from the first query's submission to
the last one's result)."""


def read(run):
    lead = run.lead
    if not lead["latencies_s"] or lead["window_s"] <= 0:
        return None
    return len(lead["latencies_s"]) * run.probe_rows / lead["window_s"]

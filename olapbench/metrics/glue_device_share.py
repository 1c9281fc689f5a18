"""The share of compute-kernel time (NCCL kernels, copies and memsets left
out) in kernels that are not the program's own: torch's and cub's, named
under at::, cub:: and the like. Every rank's slice together."""


def read(run):
    traces = run.traces
    glue = sum(t.kind_us("glue") for t in traces)
    compute = glue + sum(t.kind_us("port") for t in traces)
    return 100.0 * glue / compute if compute else None

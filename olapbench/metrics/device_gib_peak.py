"""``torch.cuda.max_memory_allocated`` over the window (reset after the
warm-up), the resident tables and the working set, in GiB; the fullest
chip's."""


def read(run):
    peak = max(r["peak_bytes"] for r in run.ranks)
    return peak / 2**30 if peak else None

"""Runs of the cells through the harness as a run drives it, called as
functions: at a test size on the CPU (two gloo ranks for a four-chip cell),
or on the cards at the cell's own size (``rows=None``), where ``readings``
gives the numbers the check's limits are set from, seed by seed:

    python3 -c "from olapbench.tests.cells import readings; \\
        print(readings('<cell>', [1, 2, 3], control=True, device='cuda:0', rows=None, seconds=5))"
"""

import time

from olapbench import harness, spec

ROWS, BATCHES = 4096, 4  # a batch's rows and a chip's batches at the test size
SEED = 2**31 + 424242


def ctx_of(name, trace=False, control=False, hook=None, seed=SEED, seconds=0.3,
           device="cpu", rows=ROWS):
    """(cell, ctx) of a run of ``name``: at the test size, or with
    ``rows=None`` at the cell's own."""
    cell = spec.cell(name)
    cfg = cell.config if rows is None else dict(cell.config, batch_rows=rows,
                                                 batches_per_chip=BATCHES)
    chips = min(cell.chips, 2) if device == "cpu" else cell.chips
    return cell, harness.Ctx(seed, seconds, trace, chips, cfg, cell.traffic, device=device,
                             control=control, hook=hook, started=time.time())


def line_of(name, **kw):
    """The result line of one run of ``name``."""
    cell, ctx = ctx_of(name, **kw)
    return harness.result_line(cell, ctx, harness.execute(ctx))


def readings(name, seeds, **kw):
    """One run a seed: {seed: (correct, {number: value})}."""
    out = {}
    for seed in seeds:
        line = line_of(name, seed=seed, **kw)
        out[seed] = (line["correct"], {k: c["value"] for k, c in line["checks"].items()})
    return out

"""One reader a metric: ``<name>.py`` holds ``read(run) -> float | None``.

``run`` is ``harness.Run``: every rank's result of one seed (``ranks``,
rank 0 first, ``lead``), the set-up seconds and the probe rows a query;
in a traced run ``traces`` holds each rank's ``trace.Trace``. A reader
that finds nothing to read returns None and the metric is left out of
the line."""

"""The per-layer metrics, one reader each, found by the metric's name.

Each file has ``read(run) -> float | None``: ``run`` is what a driver's
``run`` returned (its ``window``, with the profiled ``slice`` in a traced
run, and its ``model``). A reader that finds nothing to read returns
None, and the harness leaves that metric out of the line."""

"""Per-layer metric readers, one module a metric, named as the metric in
``BENCHMARK.json``. Each has ``read(run) -> float | None``: ``run`` is the
harness's record of one run (``harness.measure``); a reader that finds
nothing to read returns None and the metric is left out of the line."""

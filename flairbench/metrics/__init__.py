"""Per-layer metric readers: ``<name>.py`` for the metric ``<name>`` of
``BENCHMARK.json``, each with ``read(summary) -> float | None`` over the
summary of a traced window (``harness.trace_summary``). A reader that
finds nothing to read returns None, and the harness leaves its metric
out."""

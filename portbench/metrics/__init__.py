"""One reader a metric, ``<metric>.py``, found by the metric's name in
``BENCHMARK.json``.  ``read(rec)`` takes the run's record (``window`` for
the end-to-end metrics; ``trace``, the traced slice, for the per-layer
ones) and returns the value, or None where it finds nothing to read:
the harness then leaves the metric out of the line."""

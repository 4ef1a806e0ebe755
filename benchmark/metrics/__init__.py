"""Per-layer metrics, one reader each: ``benchmark/metrics/<name>.py`` for
the metric ``<name>`` of BENCHMARK.json, whose ``read(ctx)`` returns the
number, or None where the run has nothing to read it from (the harness
then leaves the metric out of the line). ``ctx`` is ``harness.Context``."""

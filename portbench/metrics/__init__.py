"""One reader per metric, found by the metric's name in BENCHMARK.json.

``read(ctx)`` takes the run's ``harness.Context`` and returns the metric's
value, or None where the run holds nothing to read it from (the harness then
leaves the metric out of the result).
"""

"""Per-layer metric readers, one file per metric named as in
BENCHMARK.json: ``read(ctx)`` returns the value, or None where the traced
window has nothing to read."""

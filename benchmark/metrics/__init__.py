"""Metric readers: one module a metric of BENCHMARK.json, named after it,
with ``read(run) -> float | None`` (harness.Run).  End-to-end readers take
the benchmark's own host clock; per-layer readers take the summary of the
traced window (trace.summarize).  A reader that finds nothing to read
returns None, and the run leaves that metric out."""

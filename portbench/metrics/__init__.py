"""Per-layer metric readers, one a file: ``read(trace)`` returns the
metric's value from a traced run (``harness.Trace``), or None where the
run has nothing to read, and the harness then leaves it out."""

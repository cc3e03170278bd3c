"""Per-layer metric readers: ``readers/<name>.py`` has ``read(trace, spec)``,
which returns the metric from the traced run's spans or device intervals
(:class:`benchmark.run.Trace`), or None where it finds nothing to read;
``spec`` is the metric's file, ``metrics/<metric>.json``."""

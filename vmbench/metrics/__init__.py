"""One per-layer metric a module: ``read(reading) -> float | None``, where
``reading`` is ``vmbench.run.Reading`` (the traced morphs' spans and
counts, the device trace, the kernel-name lists). None leaves the metric
out of the result line: a reader that finds nothing to read never
returns 0."""

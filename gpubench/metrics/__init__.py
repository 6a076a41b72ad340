"""Per-layer metric readers: metrics/<name>.py (or metrics/<name up to its
first dot>.py, shared by a quantity's `.batch` and `.online` metrics) holds
`read(rec) -> float | None`, where `rec` is run.Record. A reader that finds
nothing to read returns None, and the run leaves the metric out of its
line; a share of a roofline is never made up as 0."""

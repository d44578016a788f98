"""Per-layer readers: `<name>.py` (or `<name before the first dot>.py`) has
`read(run) -> float | None`, `run` being `perfbench.result.RunData`. A
reader that finds nothing to read returns None, and the metric is left out
of the line."""

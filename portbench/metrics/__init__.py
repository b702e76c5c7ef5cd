"""One reader a metric: ``portbench/metrics/<name>.py`` defines
``read(run: record.Run) -> float | None``; None leaves the metric out
of the result line."""

"""One file per per-layer metric, named as the metric, each with
``read(run) -> float | None`` (``run``: ``core/cell.Run``). A reader that
finds nothing to read returns None and the metric is left out of the line.
"""

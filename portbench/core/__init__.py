"""The general harness: what every cell shares (spec lookup, the closed
loop, the trace reduction, the comparison with the reference)."""

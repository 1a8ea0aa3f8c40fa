"""The comparison that decides ``correct``.

Each configuration states, under ``limits.<task>``, a limit for each number
its driver's ``judge`` returns; a run is correct when every number is at
or under its limit (an exact comparison has the limit 0). ``PERF.md``
gives the readings each limit was set from.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _rows(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return x.reshape(-1, x.shape[-1])


def row_err(prog, ref) -> float:
    """The largest, over rows, of max|prog − ref| / max|ref| of the row."""
    p, r = _rows(prog), _rows(ref)
    if p.shape != r.shape:
        return float("inf")
    scale = np.abs(r).max(axis=1)
    err = np.abs(p - r).max(axis=1) / np.where(scale > 0, scale, 1.0)
    return float(np.nan_to_num(err, nan=np.inf).max())


def compared(numbers: Dict[str, float], limits: Dict[str, float]
             ) -> List[Dict]:
    """``[{name, value, limit}]``, one entry per limit (a number the run did
    not produce reads as infinite)."""
    return [{"name": k, "value": float(numbers.get(k, float("inf"))),
             "limit": float(v)} for k, v in limits.items()]


def correct(entries: List[Dict]) -> bool:
    return bool(entries) and all(e["value"] <= e["limit"] for e in entries)

"""Plain columns: what the generators make, what the references read, and
what `dfbench.port` hands to the program. NumPy only."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

class Col(NamedTuple):
    """One column. `data` holds the values; for a string column it holds
    int32 codes into `dictionary`, the sorted distinct strings. A decimal
    holds int64 units of 10**-scale."""

    kind: str  # int32, int64, float64, date32, decimal, string
    data: np.ndarray
    dictionary: Optional[np.ndarray] = None
    precision: int = 0
    scale: int = 0


def strings(values) -> Col:
    """A string column from an array of strings: sorted dictionary, codes."""
    uniq, inv = np.unique(np.asarray(values, dtype="U"), return_inverse=True)
    return Col("string", inv.astype(np.int32).reshape(-1), uniq.astype(object))


def bounded_unique(keys: np.ndarray, bound: int):
    """np.unique(keys, return_inverse=True) for non-negative integer keys
    below `bound`, by a presence table instead of a sort."""
    present = np.zeros(bound, dtype=bool)
    present[keys] = True
    uniq = np.flatnonzero(present)
    rank = np.cumsum(present, dtype=np.int64) - 1
    return uniq, rank[keys]

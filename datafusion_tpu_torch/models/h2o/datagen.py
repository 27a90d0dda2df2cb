# Verbatim copy of datafusion_tpu/models/h2o/datagen.py; host-only, kept in step with the original.
"""Synthetic data for the h2o.ai db-benchmark workloads (groupby + join).

Derived from the PUBLIC db-benchmark data spec (h2oai/db-benchmark; the
reference runs the same workload via benchmarks/src/h2o.rs): table x has
three low/medium/high-cardinality string ids, three int ids mirroring them,
and v1/v2 int, v3 float measures. Join tables small/medium/big share id
columns at matching cardinalities."""
from __future__ import annotations

import numpy as np

from ...data.table import Table


def generate_groupby(n: int, k: int = 100, nas: float = 0.0,
                     seed: int = 42) -> Table:
    """The G1 groupby table: n rows, K distinct id1/id2/id4/id5 values,
    n//k distinct id3/id6 values."""
    rng = np.random.default_rng(seed)
    hi = max(n // k, 1)
    id1 = rng.integers(1, k + 1, n)
    id2 = rng.integers(1, k + 1, n)
    id3 = rng.integers(1, hi + 1, n)
    cols = {
        "id1": np.array([f"id{v:03d}" for v in id1], dtype=object),
        "id2": np.array([f"id{v:03d}" for v in id2], dtype=object),
        "id3": np.array([f"id{v:010d}" for v in id3], dtype=object),
        "id4": rng.integers(1, k + 1, n).astype(np.int64),
        "id5": rng.integers(1, k + 1, n).astype(np.int64),
        "id6": rng.integers(1, hi + 1, n).astype(np.int64),
        "v1": rng.integers(1, 6, n).astype(np.int64),
        "v2": rng.integers(1, 16, n).astype(np.int64),
        "v3": np.round(rng.uniform(0, 100, n), 6),
    }
    return Table.from_pydict(cols)


def generate_join(n: int, seed: int = 7):
    """The join workload: fact table x (n rows) plus small (n/1e6-scaled),
    medium, and big dimension tables keyed id1/id2/id3."""
    rng = np.random.default_rng(seed)
    n_small = max(n // 1_000_000, 10)
    n_medium = max(n // 1_000, 10)
    n_big = n

    def keyed(m, upper, with_str=True):
        ids = rng.permutation(upper)[:m] + 1
        out = {"id": ids.astype(np.int64),
               "v": np.round(rng.uniform(0, 100, m), 6)}
        if with_str:
            out["s"] = np.array([f"id{v:07d}" for v in ids], dtype=object)
        return out

    x = Table.from_pydict({
        "id1": rng.integers(1, n_small + 1, n).astype(np.int64),
        "id2": rng.integers(1, n_medium + 1, n).astype(np.int64),
        "id3": rng.integers(1, n_big + 1, n).astype(np.int64),
        "v1": np.round(rng.uniform(0, 100, n), 6),
    })
    small = Table.from_pydict(keyed(n_small, n_small))
    medium = Table.from_pydict(keyed(n_medium, n_medium))
    big = Table.from_pydict(keyed(n_big, n_big))
    return {"x": x, "small": small, "medium": medium, "big": big}

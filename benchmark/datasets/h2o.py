# Frozen copy of generate_groupby in datafusion_tpu_torch/models/h2o/datagen.py
# (itself a copy of datafusion_tpu/models/h2o/datagen.py) and of the groupby
# queries of datafusion_tpu_torch/models/h2o/queries.py, kept with the
# benchmark so that no later change to the program changes them. The same
# seed gives the same values; what differs: the string ids are encoded from
# their distinct values (K, or N/K for id3) and codes, instead of formatting
# one Python string per row, and the columns are plain (dfbench.columns.Col).
"""The h2o.ai db-benchmark groupby table (h2oai/db-benchmark, G1: table x with
three string ids of K, K and N/K distinct values, three int ids mirroring
them, int measures v1, v2 and a float measure v3), and its ten questions."""
from __future__ import annotations

from typing import Dict

import numpy as np

from dfbench.columns import Col, bounded_unique

GROUPBY_QUERIES = [
    # q1: low-cardinality string key
    "SELECT id1, sum(v1) AS v1 FROM x GROUP BY id1",
    # q2: two low-cardinality keys
    "SELECT id1, id2, sum(v1) AS v1 FROM x GROUP BY id1, id2",
    # q3: high-cardinality key, two aggregates
    "SELECT id3, sum(v1) AS v1, avg(v3) AS v3 FROM x GROUP BY id3",
    # q4: int key, three means
    "SELECT id4, avg(v1) AS v1, avg(v2) AS v2, avg(v3) AS v3 FROM x GROUP BY id4",
    # q5: high-cardinality int key, three sums
    "SELECT id6, sum(v1) AS v1, sum(v2) AS v2, sum(v3) AS v3 FROM x GROUP BY id6",
    # q6: median + stddev
    "SELECT id4, id5, median(v3) AS median_v3, stddev(v3) AS sd_v3 "
    "FROM x GROUP BY id4, id5",
    # q7: range aggregate
    "SELECT id3, max(v1) - min(v2) AS range_v1_v2 FROM x GROUP BY id3",
    # q8: top 2 v3 per group (window)
    "SELECT id6, v3 AS largest2_v3 FROM ("
    "  SELECT id6, v3, row_number() OVER (PARTITION BY id6 ORDER BY v3 DESC) AS rn"
    "  FROM x) sub WHERE rn <= 2",
    # q9: r^2 per group
    "SELECT id2, id4, power(corr(v1, v2), 2) AS r2 FROM x GROUP BY id2, id4",
    # q10: all six keys
    "SELECT id1, id2, id3, id4, id5, id6, sum(v3) AS v3, count(*) AS cnt "
    "FROM x GROUP BY id1, id2, id3, id4, id5, id6",
]

STREAMS = {"default": [f"q{i}" for i in range(1, 11)]}


def _ids(values: np.ndarray, bound: int, width: int) -> Col:
    """The string column f"id{v:0{width}d}" of `values` (1..bound): the
    dictionary holds the distinct values only, sorted (zero padding makes
    the strings sort as the numbers do)."""
    uniq, inv = bounded_unique(values, bound + 1)
    d = np.array([f"id{v:0{width}d}" for v in uniq], dtype=object)
    return Col("string", inv.astype(np.int32), d)


def generate(config: dict, seed: int) -> Dict[str, Dict[str, Col]]:
    """Table x of config's rows (N), K and NA share (0 only), from `seed`."""
    n, k = int(config["rows"]), int(config["k"])
    if float(config.get("na_share", 0)) != 0 or config.get("sorted", False):
        raise ValueError("h2o: only the 0% NA, unsorted table is generated")
    rng = np.random.default_rng(seed)
    hi = max(n // k, 1)
    id1 = rng.integers(1, k + 1, n)
    id2 = rng.integers(1, k + 1, n)
    id3 = rng.integers(1, hi + 1, n)
    return {"x": {
        "id1": _ids(id1, k, 3),
        "id2": _ids(id2, k, 3),
        "id3": _ids(id3, hi, 10),
        "id4": Col("int64", rng.integers(1, k + 1, n).astype(np.int64)),
        "id5": Col("int64", rng.integers(1, k + 1, n).astype(np.int64)),
        "id6": Col("int64", rng.integers(1, hi + 1, n).astype(np.int64)),
        "v1": Col("int64", rng.integers(1, 6, n).astype(np.int64)),
        "v2": Col("int64", rng.integers(1, 16, n).astype(np.int64)),
        "v3": Col("float64", np.round(rng.uniform(0, 100, n), 6)),
    }}


def queries(config: dict) -> Dict[str, str]:
    return {f"q{i + 1}": q for i, q in enumerate(GROUPBY_QUERIES)}

# Verbatim copy of datafusion_tpu/models/h2o/queries.py; host-only, kept in step with the original.
"""The h2o.ai db-benchmark queries (PUBLIC workload; the reference's
benchmarks/src/h2o.rs + benchmarks/queries/h2o/ run the same set).

Groupby: ten aggregation shapes over table x.
Join: five joins of x against small/medium/big at increasing cardinality."""

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

JOIN_QUERIES = [
    # q1: small inner
    "SELECT x.id1, x.v1, small.v AS v2 FROM x JOIN small ON x.id1 = small.id",
    # q2: medium inner
    "SELECT x.id2, x.v1, medium.v AS v2 FROM x JOIN medium ON x.id2 = medium.id",
    # q3: medium left outer
    "SELECT x.id2, x.v1, medium.v AS v2 FROM x LEFT JOIN medium ON x.id2 = medium.id",
    # q4: medium inner on string key
    "SELECT x.id2, x.v1, medium.v AS v2 FROM x "
    "JOIN medium ON x.id2 = medium.id AND medium.s IS NOT NULL",
    # q5: big inner
    "SELECT x.id3, x.v1, big.v AS v2 FROM x JOIN big ON x.id3 = big.id",
]


def groupby_query(i: int) -> str:
    return GROUPBY_QUERIES[i]


def join_query(i: int) -> str:
    return JOIN_QUERIES[i]

"""The user-defined function case table: scalar, aggregate, window, table and
host (async) functions over small tables, shared by the differential tests
(tests/test_torch_udf.py, against the JAX package on the CPU) and
chip_smoke.py's udf phase (the card against the CPU); the Spark family
query; and the TPC-H queries the udf phase runs at scale (U1-U6), with Q1
and Q6 built through the DataFrame methods.

tables() are the tables every case reads (pydict columns). register(ctx)
registers the torch half of every user function on a session of this
package (tests/test_torch_udf.py writes the same functions with jax.numpy
for the JAX package). CASES maps a case name to one SQL query, ERRORS the
queries both packages reject, HOST_CASES the cases that call a host
function (their steady state runs eagerly on the card), FAMILIES one query
per kind of user function for a captured steady state, SYNCING a query
whose UDF reads a device value on the host (`.item()`: a CUDA graph
capture refuses it, as the JAX package's tracer does)."""
import asyncio

import numpy as np
import torch

from ..common import types as T


def tables(seed: int = 13) -> dict:
    """name -> pydict of columns; `r` is 400 seeded random rows (`i` a row
    id, `k` a group, `a` a float, `b` an int, `c` a small int with ties,
    `ds` a date string, `s` a string)."""
    rng = np.random.default_rng(seed)
    n = 400
    days = rng.integers(0, 3000, n)
    return {
        "t": {"g": [1, 1, 1, 2, 2, 3, 3, 3, 3],
              "x": [2.0, -3.0, 2.0, 5.0, 5.0, -1.0, 0.0, -1.0, 4.0],
              "y": [1, 2, 2, 3, 3, 3, 4, 4, 5],
              "z": [10, 10, 20, 20, 20, 30, 40, 40, 40]},
        "n": {"v": [1.0, None, 3.0]},
        "e": {"g": [1, 2], "v": [1.0, None]},
        "r": {"i": list(range(n)),
              "k": rng.integers(0, 10, n).tolist(),
              "a": rng.normal(0.0, 50.0, n).round(4).tolist(),
              "b": rng.integers(0, 1000, n).tolist(),
              "c": rng.integers(0, 20, n).tolist(),
              "ds": [str(np.datetime64("2015-01-01") + int(d)) for d in days],
              "s": [f"w{v}" for v in rng.integers(0, 30, n)]},
    }


def _geomean_state(x):
    return {"logsum": torch.log(torch.clamp(torch.abs(x.to(torch.float64)), min=1e-300)),
            "n": torch.ones_like(x, dtype=torch.float64)}


async def remote_score(xs):
    """A coroutine over the whole batch, fanning out per row."""
    async def one(v):
        await asyncio.sleep(0)
        return float(v) * 2 + 1

    return np.array(await asyncio.gather(*[one(v) for v in xs]))


def register(ctx) -> None:
    """The torch half of every user function, on `ctx`."""
    ctx.register_udf("plus_one", lambda a: a + 1.0, T.FLOAT64)
    ctx.register_udf("hyp", lambda a, b: torch.sqrt(a * a + b * b), T.FLOAT64)
    ctx.register_udf("safe_log", lambda a: (torch.log(torch.clamp(a, min=1e-300)), a > 0),
                     T.FLOAT64)
    ctx.register_udf("dbl", lambda a: a * 2.0, T.FLOAT64)
    ctx.register_udf("sq", lambda a: a * a, T.FLOAT64)
    ctx.register_udf("is_big", lambda a: a > 500, T.BOOL)
    ctx.register_udf("next_week", lambda d: d + 7, T.DATE32)
    ctx.register_udf("half", lambda a: a / 2.0, T.decimal(12, 3))
    ctx.register_udf("keep_row", lambda q: q > 0, T.BOOL)
    ctx.register_udf("scaled", lambda a: a / torch.abs(a).max().item(), T.FLOAT64)
    ctx.register_udaf(
        "geomean", state=_geomean_state,
        combine=lambda a, b: {"logsum": a["logsum"] + b["logsum"], "n": a["n"] + b["n"]},
        identity={"logsum": 0.0, "n": 0.0},
        finalize=lambda s: torch.exp(s["logsum"] / torch.clamp(s["n"], min=1.0)),
        return_type=T.FLOAT64)
    ctx.register_udaf(
        "bit_or_agg", state=lambda x: x.to(torch.int64), combine=lambda a, b: a | b,
        identity=0, finalize=lambda s: s, return_type=T.INT64, nullable=False)
    ctx.register_udaf(
        "spread", state=lambda x: (x.to(torch.float64), x.to(torch.float64)),
        combine=lambda a, b: (torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])),
        identity=(float("inf"), float("-inf")), finalize=lambda s: s[1] - s[0],
        return_type=T.FLOAT64)
    ctx.register_udwf(
        "run_prod", state=lambda x: x.to(torch.float64), combine=lambda a, b: a * b,
        identity=1.0, finalize=lambda s: s, return_type=T.FLOAT64)
    ctx.register_udwf(
        "run_sum", state=lambda x: x.to(torch.float64), combine=lambda a, b: a + b,
        identity=0.0, finalize=lambda s: s, return_type=T.FLOAT64)
    ctx.register_async_udf("remote_score", remote_score, T.FLOAT64)
    ctx.register_async_udf("twice", lambda xs: xs * 2, T.FLOAT64)
    ctx.register_udtf("fib", lambda n: {"f": [1, 1, 2, 3, 5, 8, 13][:int(n)]})


CASES = {
    # scalar UDFs
    "scalar": "SELECT plus_one(x) AS p FROM t ORDER BY y, x",
    "scalar_two_args": "SELECT g, sum(hyp(x, y)) AS s FROM t GROUP BY g ORDER BY g",
    "custom_validity": "SELECT safe_log(x) AS l FROM t ORDER BY y, x",
    "null_propagation": "SELECT dbl(v) AS d FROM n ORDER BY v NULLS LAST",
    "in_where": "SELECT k, count(*) AS n, sum(a) AS sa FROM r WHERE is_big(b) "
                "GROUP BY k ORDER BY k",
    "date_argument": "SELECT i, next_week(CAST(ds AS DATE)) AS w FROM r "
                     "WHERE i < 40 ORDER BY i",
    "decimal_argument": "SELECT i, half(CAST(a AS DECIMAL(12, 2))) AS h FROM r "
                        "WHERE i < 40 ORDER BY i",
    "nested_calls": "SELECT i, sq(plus_one(a)) + dbl(b) AS v FROM r "
                    "WHERE i < 40 ORDER BY i",
    # aggregate UDFs
    "udaf_grouped": "SELECT g, geomean(y) AS gm FROM t GROUP BY g ORDER BY g",
    "udaf_global": "SELECT geomean(y) AS gm FROM t",
    "udaf_empty_group": "SELECT g, geomean(v) AS gm FROM e GROUP BY g ORDER BY g",
    "udaf_integer_monoid": "SELECT g, bit_or_agg(z) AS b FROM t GROUP BY g ORDER BY g",
    "udaf_tuple_state": "SELECT k, spread(a) AS sp, geomean(b) AS gm FROM r "
                        "GROUP BY k ORDER BY k",
    "udaf_with_builtins": "SELECT k, geomean(a) AS gm, sum(b) AS sb, count(*) AS n "
                          "FROM r GROUP BY k ORDER BY k",
    "udaf_global_filtered": "SELECT bit_or_agg(b) AS b, spread(a) AS sp FROM r "
                            "WHERE c < 5",
    "udaf_string_key": "SELECT s, geomean(b) AS gm FROM r GROUP BY s ORDER BY s",
    # window UDFs and UDAFs over OVER
    "udaf_window": "SELECT g, y, geomean(y) OVER (PARTITION BY g ORDER BY y) AS gm "
                   "FROM t ORDER BY g, y",
    "udaf_window_whole_partition": "SELECT g, y, geomean(y) OVER (PARTITION BY g) AS gm "
                                   "FROM t ORDER BY g, y",
    "udwf": "SELECT g, y, run_prod(y) OVER (PARTITION BY g ORDER BY y, x) AS rp "
            "FROM t ORDER BY g, y, x",
    "udwf_peers": "SELECT i, run_sum(a) OVER (PARTITION BY k ORDER BY c) AS rs "
                  "FROM r ORDER BY i",
    "udwf_no_partition": "SELECT i, run_sum(b) OVER (ORDER BY c, i) AS rs "
                         "FROM r WHERE i < 60 ORDER BY i",
    # host functions
    "async_coroutine": "SELECT y, remote_score(x) AS s FROM t WHERE y > 1 ORDER BY y, x",
    "async_plain": "SELECT sum(twice(x)) AS s FROM t",
    # table functions
    "udtf": "SELECT * FROM fib(5)",
    "generate_series": "SELECT n * n AS sq FROM generate_series(10, 1, -3) AS t(n) "
                       "ORDER BY n",
    "range_aggregate": "SELECT sum(value) AS s FROM range(100)",
}

HOST_CASES = frozenset({"async_coroutine", "async_plain"})

ERRORS = {
    "string_argument": "SELECT plus_one(s) FROM r",
    "unknown_function": "SELECT nosuch(x) FROM t",
    "unknown_table_function": "SELECT * FROM nosuch(1)",
}

FAMILIES = {
    "scalar": "SELECT plus_one(x) AS p, safe_log(x) AS l, next_week(CAST('2020-01-01' "
              "AS DATE)) AS w FROM t",
    "udaf_grouped": "SELECT k, geomean(a) AS gm, spread(a) AS sp, bit_or_agg(b) AS bo "
                    "FROM r GROUP BY k",
    "udaf_global": "SELECT geomean(a) AS gm, spread(a) AS sp FROM r",
    "window": "SELECT i, run_sum(a) OVER (PARTITION BY k ORDER BY c) AS rs, "
              "geomean(b) OVER (PARTITION BY k ORDER BY c) AS gm FROM r",
}

SYNCING = "SELECT scaled(a) AS s FROM r"

# one query over every Spark family, in a session with the Spark library on
SPARK_FAMILY = ("SELECT i, sha2(s, 256) AS h, xxhash64(s) AS x, crc32(s) AS c32, "
                "bit_count(b) AS bc, pmod(b - 500, 7) AS pm, "
                "shiftrightunsigned(b - 500, 3) AS su, shiftleft(b, 40) AS sl, "
                "bit_get(b - 500, 63) AS bg, round(a, 1) AS r, bround(a, 1) AS br, "
                "hex(c) AS hx, substring(s, -2) AS sub, "
                "date_add(CAST(ds AS DATE), c) AS da, last_day(CAST(ds AS DATE)) AS ld "
                "FROM r")

# ---------------------------------------------------------------------------
# TPC-H at scale (chip_smoke.py's udf phase): U1-U6
# ---------------------------------------------------------------------------

Q1_CUTOFF = 10561  # date '1998-12-01' (days since 1970-01-01)


def q1_dataframe(ctx, E):
    """TPC-H Q1 built with the DataFrame methods over ctx's lineitem (E is
    the expr.nodes module of ctx's package): the same logical plan as the
    SQL text."""
    c = E.col
    disc = E.BinaryOp(E.Op.MUL, c("l_extendedprice"),
                      E.BinaryOp(E.Op.SUB, E.lit(1), c("l_discount")))
    charge = E.BinaryOp(E.Op.MUL, disc, E.BinaryOp(E.Op.ADD, E.lit(1), c("l_tax")))

    def agg(f, *args):
        return E.AggregateFunction(f, tuple(args))

    cutoff = E.BinaryOp(E.Op.SUB, E.Literal(Q1_CUTOFF, E.T.DATE32),
                        E.Literal(90, E.T.INTERVAL_DAYS))
    return (ctx.table("lineitem")
            .filter(E.BinaryOp(E.Op.LE, c("l_shipdate"), cutoff))
            .aggregate([c("l_returnflag"), c("l_linestatus")],
                       [agg("sum", c("l_quantity")).alias("sum_qty"),
                        agg("sum", c("l_extendedprice")).alias("sum_base_price"),
                        agg("sum", disc).alias("sum_disc_price"),
                        agg("sum", charge).alias("sum_charge"),
                        agg("avg", c("l_quantity")).alias("avg_qty"),
                        agg("avg", c("l_extendedprice")).alias("avg_price"),
                        agg("avg", c("l_discount")).alias("avg_disc"),
                        agg("count").alias("count_order")])
            .sort(c("l_returnflag"), c("l_linestatus")))


def q6_dataframe(ctx, E):
    """TPC-H Q6 built with the DataFrame methods (see q1_dataframe)."""
    c = E.col
    start = E.Literal(8766, E.T.DATE32)  # date '1994-01-01'

    def both(*preds):
        out = preds[0]
        for p in preds[1:]:
            out = E.BinaryOp(E.Op.AND, out, p)
        return out

    pred = both(
        E.BinaryOp(E.Op.GE, c("l_shipdate"), start),
        E.BinaryOp(E.Op.LT, c("l_shipdate"),
                   E.BinaryOp(E.Op.ADD, start, E.Literal(12, E.T.INTERVAL_MONTHS))),
        E.Between(c("l_discount"), E.BinaryOp(E.Op.SUB, E.lit(0.06), E.lit(0.01)),
                  E.BinaryOp(E.Op.ADD, E.lit(0.06), E.lit(0.01)), False),
        E.BinaryOp(E.Op.LT, c("l_quantity"), E.lit(24)))
    return (ctx.table("lineitem").filter(pred)
            .aggregate([], [E.AggregateFunction(
                "sum", (E.BinaryOp(E.Op.MUL, c("l_extendedprice"), c("l_discount")),)
            ).alias("revenue")]))


# U1: Q1 with a scalar UDF in its WHERE clause that keeps every row (each
# l_quantity is at least 1): Q1's answer, its groups and its kernel route
U1 = ("SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty, "
      "sum(l_extendedprice) AS sum_base_price, "
      "sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price, "
      "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge, "
      "avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price, "
      "avg(l_discount) AS avg_disc, count(*) AS count_order FROM lineitem "
      "WHERE l_shipdate <= date '1998-12-01' - interval '90' day AND keep_row(l_quantity) "
      "GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus")
# U3: a geometric-mean UDAF per order, beside the built-in aggregates
# computing the same function
U3 = "SELECT l_orderkey, geomean(l_extendedprice) AS gm FROM lineitem GROUP BY l_orderkey"
U3_BUILTIN = ("SELECT l_orderkey, exp(avg(ln(abs(l_extendedprice)))) AS gm FROM lineitem "
              "GROUP BY l_orderkey")
# U4: a running-sum UDWF per supplier
U4 = ("SELECT l_orderkey, l_linenumber, run_sum(l_quantity) OVER (PARTITION BY l_suppkey "
      "ORDER BY l_shipdate, l_orderkey, l_linenumber) AS rs FROM lineitem")
# U5: a host function over every row
U5 = "SELECT sum(twice(l_extendedprice)) AS s, count(*) AS n FROM lineitem"
# U6: Spark functions over lineitem, grouped by two Spark hashes of the
# ship mode
U6 = ("SELECT sha2(l_shipmode, 256) AS h, xxhash64(l_shipmode) AS x, count(*) AS n, "
      "sum(pmod(l_orderkey, 7)) AS pm, sum(bit_count(l_orderkey)) AS bc, "
      "sum(shiftrightunsigned(0 - l_orderkey, 40)) AS su, "
      "sum(round(l_extendedprice, 0)) AS r FROM lineitem "
      "GROUP BY sha2(l_shipmode, 256), xxhash64(l_shipmode)")

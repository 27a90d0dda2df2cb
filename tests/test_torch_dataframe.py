"""The DataFrame API of the port (context.py's builders and introspection,
explain_analyze) against the JAX package on the CPU: every case of
tests/test_dataframe_surface.py and tests/test_dataframe_e2e.py built the
same way on both packages (the expression nodes are a verbatim copy, so one
builder serves both), TPC-H Q1 and Q6 built with the builders at SF 0.01
equal to the SQL queries and to the JAX package, and EXPLAIN ANALYZE
naming the same operators and output rows. Floats to rtol 1e-12, the rest
exactly."""
import json
import math
import re

import jax
import pytest

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.expr import nodes as JE
from datafusion_tpu.models.tpch.datagen import generate_tpch as jax_generate
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.expr import nodes as PE
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch
from datafusion_tpu_torch.models.tpch.queries import query
from datafusion_tpu_torch.ops import dense_agg as DA
from datafusion_tpu_torch.testing import udf_cases as UC

RTOL = 1e-12
SF = 0.01


@pytest.fixture(scope="module", autouse=True)
def fast_reference():
    """The reference compiled with its optimizations off, for this module."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


def _tables(ctx):
    ctx.register_table("t", {"a": [1, 2, 3, 2], "b": [10.0, None, 30.0, 20.0],
                             "s": ["x", "y", "x", "y"]})
    ctx.register_table("u", {"a": [2, 3], "b": [20.0, 99.0], "s": ["y", "z"]})
    ctx.register_table("v", {"s": ["q"], "b": [1.0], "a": [9]})
    ctx.register_table("w", {"k": [1, 2], "lbl": ["one", "two"]})
    ctx.register_table("e", {"k": [1, 2, 1, 3, 2, 1],
                             "v": [10.0, 20.0, 30.0, 40.0, 50.0, 60.0],
                             "s": ["a", "b", "a", "c", "b", "a"]})
    ctx.register_table("d", {"k": [1, 2, 4], "name": ["one", "two", "four"]})
    return ctx


@pytest.fixture(scope="module")
def sessions():
    return _tables(JaxSession()), _tables(PortSession(device="cpu"))


def _agg(E, f, *args, distinct=False):
    return E.AggregateFunction(f, tuple(args), distinct)


# name -> build(ctx, E) -> DataFrame; each collected on both packages
CASES = {
    # tests/test_dataframe_surface.py
    "with_column_and_rename": lambda c, E: c.table("t").with_column(
        "a2", E.BinaryOp(E.Op.MUL, E.col("a"), E.lit(2))).with_column_renamed("a2", "double_a"),
    "with_column_replaces": lambda c, E: c.table("t").with_column("a", E.lit(0)),
    "drop_columns": lambda c, E: c.table("t").drop_columns("b"),
    "select_columns": lambda c, E: c.table("t").select_columns("s"),
    "intersect": lambda c, E: c.table("t").select("a").intersect(
        c.table("u").select("a")).sort(E.col("a")),
    "except_all": lambda c, E: c.table("t").select("a").except_all(c.table("u").select("a")),
    "union_distinct": lambda c, E: c.table("t").select("a").union_distinct(
        c.table("u").select("a")).sort(E.col("a")),
    "union_by_name": lambda c, E: c.table("t").union_by_name(c.table("v")).sort(
        E.col("a"), E.col("s")),
    "distinct_on": lambda c, E: c.table("t").distinct_on(
        [E.col("s")], [E.col("s"), E.col("a")],
        [E.SortSpec(E.col("a"), asc=True)]).sort(E.col("s")),
    "fill_null": lambda c, E: c.table("t").fill_null(0.0, ["b"]).sort(E.col("a"), E.col("b")),
    "join_on": lambda c, E: c.table("t").join_on(
        c.table("w"), "inner", E.BinaryOp(E.Op.EQ, E.col("a"), E.col("k"))).sort(E.col("a")),
    "unnest_columns": lambda c, E: c.sql(
        "SELECT 1 AS id, [10, 20] AS xs").unnest_columns("xs"),
    "window": lambda c, E: c.table("t").window([E.Alias(E.WindowFunction(
        "row_number", (), (E.col("s"),), (E.SortSpec(E.col("a")),), None), "rn")]).sort(
        E.col("s"), E.col("a")),
    "alias_and_limit": lambda c, E: c.table("t").alias("tt").select(
        E.col("tt.a")).sort(E.col("a")).limit(2, 1),
    "sort_by": lambda c, E: c.table("t").sort_by(E.col("b").sort(asc=False, nulls_first=True)),
    # tests/test_dataframe_e2e.py
    "filter_project": lambda c, E: c.table("e").filter(E.col("v") > 25).select(
        E.col("k"), (E.col("v") * 2).alias("vv")),
    "aggregate_grouped": lambda c, E: c.table("e").aggregate(
        [E.col("k")], [_agg(E, "sum", E.col("v")).alias("sv"),
                       _agg(E, "count", E.col("v")).alias("cv"),
                       _agg(E, "min", E.col("s")).alias("ms")]).sort(E.col("k")),
    "aggregate_global": lambda c, E: c.table("e").aggregate(
        [], [_agg(E, "sum", E.col("v")).alias("sv"), _agg(E, "count").alias("n"),
             _agg(E, "avg", E.col("v")).alias("av"),
             _agg(E, "count", E.col("k"), distinct=True).alias("dk")]),
    "join_inner": lambda c, E: c.table("e").join(
        c.table("d"), on=[("e.k", "d.k")], how="inner").select(
        E.col("e.k"), E.col("v"), E.col("name")).sort(E.col("v")),
    "join_left": lambda c, E: c.table("d").join(
        c.table("e"), on=[("d.k", "e.k")], how="left").select(
        E.col("d.k"), E.col("name"), E.col("v")).sort(E.col("d.k"), E.col("v")),
    "join_semi": lambda c, E: c.table("d").join(
        c.table("e"), on=[("d.k", "e.k")], how="semi").sort(E.col("d.k")),
    "join_anti": lambda c, E: c.table("d").join(c.table("e"), on=[("d.k", "e.k")], how="anti"),
    "join_on_names": lambda c, E: c.table("e").select("k", "v").join(
        c.table("d"), on=["k"]).sort(E.col("v")),
    "sort_desc_limit": lambda c, E: c.table("e").sort(E.col("v").sort(asc=False)).limit(2),
    "distinct": lambda c, E: c.table("e").select(E.col("s")).distinct().sort(E.col("s")),
    "union_all": lambda c, E: c.table("e").select(E.col("k")).union(
        c.table("d").select(E.col("k"))).sort(E.col("k")),
    "cross_join": lambda c, E: c.table("d").join(
        c.table("d").alias("d2"), on=[], how="cross").aggregate(
        [], [_agg(E, "count").alias("n")]),
    "having_style": lambda c, E: c.table("e").aggregate(
        [E.col("s")], [_agg(E, "count").alias("n")]).filter(E.col("n") > 1).sort(E.col("s")),
}


def _same(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(
            len(a[k]) == len(b[k]) and all(_same(x, y) for x, y in zip(a[k], b[k]))
            for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=RTOL, abs_tol=RTOL)
    return a == b


@pytest.mark.parametrize("name", sorted(CASES))
def test_builder_matches_jax(sessions, name):
    jctx, pctx = sessions
    df = CASES[name](pctx, PE)
    got = [df.collect().to_pydict() for _ in range(3)]  # discovery, build, steady
    assert got[0] == got[1] == got[2]
    want = CASES[name](jctx, JE).collect().to_pydict()
    assert _same(got[0], want), (got[0], want)


def test_describe_matches_jax(sessions):
    jctx, pctx = sessions
    got = pctx.table("t").describe().to_pydict()
    assert _same(got, jctx.table("t").describe().to_pydict())
    assert got["describe"] == ["count", "null_count", "mean", "std", "min", "max", "median"]
    assert got["a"][0] == 4.0 and got["b"][1] == 1.0 and math.isnan(got["s"][2])


def test_cache_into_view_and_count_match_jax():
    outs = []
    for ctx, E in ((_tables(PortSession(device="cpu")), PE), (_tables(JaxSession()), JE)):
        c = ctx.table("t").filter(E.BinaryOp(E.Op.GT, E.col("a"), E.lit(1))).cache()
        ctx.table("t").select("a").into_view("ta")
        outs.append((c.count(), ctx.sql("SELECT count(*) AS n FROM ta").to_pydict(),
                     c.to_pydict()))
    assert outs[0] == outs[1] and outs[0][0] == 3


def test_introspection_matches_jax(sessions):
    jctx, pctx = sessions
    pdf, jdf = CASES["aggregate_grouped"](pctx, PE), CASES["aggregate_grouped"](jctx, JE)
    assert [(f.name, repr(f.dtype)) for f in pdf.schema.fields] == \
        [(f.name, repr(f.dtype)) for f in jdf.schema.fields]
    assert pdf.logical_plan().display() == jdf.logical_plan().display()
    assert pdf.optimized_plan().display() == jdf.optimized_plan().display()


def test_show_prints_like_jax(sessions, capsys):
    jctx, pctx = sessions
    pctx.table("e").sort(PE.col("v")).show(3)
    got = capsys.readouterr().out
    jctx.table("e").sort(JE.col("v")).show(3)
    assert got == capsys.readouterr().out and len(got.splitlines()) == 4


@pytest.mark.parametrize("method", ["to_substrait", "to_proto"])
def test_interchange_still_names_its_item(sessions, method):
    """Named when the encoders raised NotImplementedError naming their
    ROADMAP item; now ported: a DataFrame built with the methods encodes to
    the JAX package's Substrait JSON or LogicalPlanNode bytes, and decodes
    back to the JAX package's answer."""
    jctx, pctx = sessions
    sql = "SELECT s, sum(v) AS sv FROM e WHERE k < 3 GROUP BY s ORDER BY s"
    got, want = getattr(pctx.sql(sql), method)(), getattr(jctx.sql(sql), method)()
    assert json.dumps(got) == json.dumps(want) if method == "to_substrait" else got == want
    decode = "from_substrait" if method == "to_substrait" else "from_proto"
    assert getattr(pctx, decode)(got).to_pydict() == jctx.sql(sql).to_pydict()


@pytest.mark.parametrize("method,arg", [("from_substrait", {}), ("from_proto", b"")])
def test_interchange_entry_points_name_their_item(sessions, method, arg):
    """Named when the decoders raised NotImplementedError naming their
    ROADMAP item; now ported: a plan the JAX package encoded decodes in the
    port to the JAX package's answer, and an empty plan (`arg`) is refused
    with the JAX package's error class."""
    jctx, pctx = sessions
    df = jctx.sql("SELECT k, count(*) AS n FROM e GROUP BY k ORDER BY k")
    plan = df.to_substrait() if method == "from_substrait" else df.to_proto()
    assert getattr(pctx, method)(plan).to_pydict() == df.to_pydict()
    raised = []
    for ctx in (pctx, jctx):
        with pytest.raises(Exception) as info:
            getattr(ctx, method)(arg).collect()
        raised.append(type(info.value).__name__)
    assert raised[0] == raised[1] == "PlanError"


def test_explain_analyze_names_the_same_operators_and_rows_as_jax(sessions):
    """The rendered metrics of one execution: the same operators, output
    rows and metric names (the times differ)."""
    jctx, pctx = sessions
    sql = ("SELECT s, count(*) AS n, sum(v) AS sv FROM e WHERE v > 15 GROUP BY s "
           "ORDER BY s")

    def lines(text):
        return [re.sub(r"[0-9.]+ ms", "<ms>", line) for line in text.splitlines()]

    got = lines(pctx.sql(sql).explain_analyze())
    assert got == lines(jctx.sql(sql).explain_analyze())
    assert "-- total: <ms>, output rows: 3" in got
    assert any("AggregateExec" in line for line in got)
    got = pctx.sql("EXPLAIN ANALYZE " + sql).to_pydict()["plan"]
    assert lines("\n".join(got)) == lines("\n".join(
        jctx.sql("EXPLAIN ANALYZE " + sql).to_pydict()["plan"]))


# ---------------------------------------------------------------------------
# TPC-H built with the builders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch():
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    for name, table in jax_generate(SF).items():
        if name == "lineitem":
            jctx.register_table(name, table)
    for name, table in generate_tpch(SF).items():
        if name == "lineitem":
            pctx.register_table(name, table)
    return jctx, pctx


@pytest.mark.parametrize("qid", [1, 6])
def test_tpch_built_equals_sql_and_jax(tpch, monkeypatch, qid):
    """The built query's answer equals the SQL query's exactly and the JAX
    package's (sums of decimals are exact), and it launches the dense
    kernel's plain version as the SQL query does."""
    jctx, pctx = tpch
    calls = []
    real = DA.dense_groupby_sums
    monkeypatch.setattr(DA, "dense_groupby_sums",
                        lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    build = UC.q1_dataframe if qid == 1 else UC.q6_dataframe
    df = build(pctx, PE)
    built = [df.collect().to_pydict() for _ in range(3)]
    built_calls, calls[:] = list(calls), []
    sql = pctx.sql(query(qid, SF)).collect().to_pydict()
    assert built[0] == built[1] == built[2] == sql
    assert built_calls and calls and set(built_calls) == set(calls)
    assert _same(built[0], build(jctx, JE).collect().to_pydict())


def test_u1_udf_filter_keeps_q1(tpch):
    """U1 of chip_smoke.py's udf phase: Q1 with a scalar UDF in its WHERE
    clause that keeps every row answers as Q1."""
    _, pctx = tpch
    UC.register(pctx)
    assert pctx.sql(UC.U1).collect().to_pydict() == \
        pctx.sql(query(1, SF)).collect().to_pydict()

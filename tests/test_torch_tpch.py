"""TPC-H Q1 and Q6 through the port's SessionContext(device="cpu") against the
JAX package's SessionContext at SF 0.01 (frames_diff: integers, decimals and
strings exact, floats to rtol 1e-6 / atol 1e-4 because summation order
differs), plus the operators and planner paths around them: dense, sorted
and global aggregates, DISTINCT (tests/test_torch_tpch22.py runs the other
twenty queries). A query the port
cannot run yet must raise NotImplementedError, never answer wrongly."""
import numpy as np
import pytest

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.models.tpch.datagen import generate_tpch as jax_generate
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.models.tpch.compare import frames_diff
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch as port_generate
from datafusion_tpu_torch.models.tpch.queries import query
from datafusion_tpu_torch.models.tpch.queries_ref import ref_query
from datafusion_tpu_torch.ops import dense_agg as DA

SF = 0.01


@pytest.fixture(scope="module")
def sessions():
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    for name, t in jax_generate(SF).items():
        jctx.register_table(name, t)
    port_tables = port_generate(SF)
    for name, t in port_tables.items():
        pctx.register_table(name, t)
    return jctx, pctx, port_tables


@pytest.mark.parametrize("qid", [1, 6])
def test_query_matches_jax_and_oracle(sessions, qid):
    jctx, pctx, tables = sessions
    sql = query(qid, SF)
    ours = pctx.sql(sql).to_pandas()
    assert frames_diff(ours, jctx.sql(sql).to_pandas(), ordered=True) is None
    ref = ref_query(qid, {"lineitem": tables["lineitem"].to_pandas()}, SF)
    assert frames_diff(ours, ref, ordered=True) is None


@pytest.mark.parametrize("qid", [1, 6])
def test_physical_plan_output_matches_jax_slot_by_slot(sessions, qid, monkeypatch):
    """The whole plan's output relation, slot by slot, against the JAX
    package running the same dense path through its Pallas kernel in
    interpret mode: sums and counts are exact int64, avg the same float64
    arithmetic, so every live slot must be bit-identical."""
    monkeypatch.setenv("DATAFUSION_TPU_FORCE_PALLAS", "interpret")
    jctx, pctx, _ = sessions
    sql = query(qid, SF)
    jrel = jctx.sql(sql).physical_plan().execute(jctx.exec_context())
    prel = pctx.sql(sql).physical_plan().execute(pctx.exec_context())
    assert prel.capacity == jrel.capacity
    sel = np.asarray(jrel.sel)
    assert np.array_equal(prel.sel.numpy(), sel)
    for p, j in zip(prel.columns, jrel.columns):
        assert repr(p.dtype) == repr(j.dtype)
        assert np.array_equal(p.data.numpy()[sel], np.asarray(j.data)[sel])
        if j.validity is not None:
            assert np.array_equal(p.validity.numpy()[sel], np.asarray(j.validity)[sel])


def test_main_path_goes_through_dense_groupby_sums(sessions, monkeypatch):
    """Q1 and Q6 each make one dense_groupby_sums call: G = 6 with 7 pairs,
    and G = 1 with one pair."""
    _, pctx, _ = sessions
    calls = []
    real = DA.dense_groupby_sums

    def spy(seg, mask, pairs, G):
        calls.append((G, len(pairs), sum(b is not None for _, b in pairs)))
        return real(seg, mask, pairs, G)

    monkeypatch.setattr(DA, "dense_groupby_sums", spy)
    pctx.sql(query(1, SF)).collect()
    pctx.sql(query(6, SF)).collect()
    assert calls == [(6, 7, 1), (1, 1, 0)]


@pytest.mark.parametrize("sql,ordered", [
    # empty input: a global aggregate still emits one row (count 0, sum NULL)
    ("select sum(l_extendedprice * l_discount) s, count(*) c, avg(l_quantity) a "
     "from lineitem where l_quantity < 0", True),
    # bounds-proven small integer keys (rebased to their minimum), presorted
    ("select l_linenumber, count(*) c, sum(l_quantity) q, avg(l_discount) d "
     "from lineitem group by l_linenumber order by l_linenumber", True),
    # bool and string keys, descending sort over the aggregate's output
    ("select l_returnflag, l_shipdate > date '1995-01-01' late, count(*) c "
     "from lineitem group by l_returnflag, l_shipdate > date '1995-01-01' "
     "order by c desc, l_returnflag", True),
    # a selective filter compacts before a full top-k sort
    ("select l_orderkey, l_linenumber, l_quantity from lineitem "
     "where l_quantity >= 50 and l_discount = 0.1 "
     "order by l_quantity desc, l_orderkey, l_linenumber limit 7", True),
    ("select l_orderkey * 2 + 1 k, l_extendedprice / l_quantity p "
     "from lineitem where l_orderkey < 40 limit 9", True),
    # string comparisons against literals outside the column's dictionary
    ("select count(*) c, sum(l_quantity) q from lineitem "
     "where l_returnflag = 'R' and l_shipmode < 'RAIL' and l_linestatus <> 'X'", True),
    # a global aggregate no kernel pair factors: global_aggregate
    ("select min(l_quantity) from lineitem", True),
    # a high-cardinality key: sort-based grouping
    ("select l_orderkey, sum(l_quantity) from lineitem group by l_orderkey", False),
    # max beside the dense ids: _reduce_one on the dense path
    ("select l_returnflag, max(l_tax) from lineitem group by l_returnflag", False),
    ("select count(distinct l_returnflag) from lineitem", True),
    ("select distinct l_returnflag, l_linestatus from lineitem", False),
    # the sort path emits groups ascending by key: the ORDER BY is elided
    ("select l_orderkey, min(l_shipdate) m, count(*) c from lineitem "
     "group by l_orderkey order by l_orderkey limit 20", True),
    # a window function (physical/window.py)
    ("select l_orderkey, row_number() over (partition by l_returnflag "
     "order by l_orderkey) rn from lineitem", False),
    ("select sqrt(l_quantity) from lineitem", False),
    ("select l_orderkey from lineitem where l_quantity < 2 "
     "union all select l_orderkey from lineitem where l_quantity > 49", False),
])
def test_more_queries_match_jax(sessions, sql, ordered):
    jctx, pctx, _ = sessions
    ours = pctx.sql(sql).to_pandas()
    assert len(ours) > 0
    assert frames_diff(ours, jctx.sql(sql).to_pandas(), ordered) is None


@pytest.mark.parametrize("sql", [
    "select date_trunc('month', l_shipdate) from lineitem",  # ported: item 9a
    "select unnest(make_array(l_orderkey, l_partkey)) from lineitem",  # ported: 9b
    "with recursive r(n) as (select 1 union all select n + 1 from r where n < 3) "
    "select n from r",  # ported: item 12
])
def test_once_unported_queries_match_jax(sessions, sql):
    """Each raised NotImplementedError naming its ROADMAP item until that
    item was ported (the function library, the nested types, recursive
    queries); each now equals the JAX package."""
    jctx, pctx, _ = sessions
    assert frames_diff(pctx.sql(sql).to_pandas(), jctx.sql(sql).to_pandas(),
                       ordered=True) is None


def test_explain_lists_the_port_plan(sessions):
    text = "\n".join(sessions[1].sql("explain " + query(1, SF)).to_pydict()["plan"])
    assert "SortExec" in text and "(presorted)" in text
    assert "AggregateExec: group=[l_returnflag, l_linestatus]" in text
    assert "CompactExec" in text
    tree = sessions[1].sql(query(6, SF)).explain(format="tree")
    assert "└── AggregateExec: group=[]" in tree


def test_sorted_aggregate_and_distinct_count_as_sorted(sessions):
    for sql in ("select l_orderkey, count(*) c from lineitem group by l_orderkey "
                "order by l_orderkey",
                "select distinct l_returnflag from lineitem order by l_returnflag"):
        text = "\n".join(sessions[1].sql("explain " + sql).to_pydict()["plan"])
        assert "(presorted)" in text, text


def test_operator_spans_and_metrics(sessions):
    from datafusion_tpu_torch.runtime.tracing import TRACER

    TRACER.enabled = True
    TRACER.reset()
    try:
        df = sessions[1].sql(query(6, SF))
        ctx = sessions[1].exec_context()
        df.physical_plan().execute(ctx)
    finally:
        TRACER.enabled = False
    names = [e["name"] for e in TRACER.events]
    assert sum(n.startswith("FilterExec") for n in names) == 4
    assert any(n.startswith("AggregateExec") for n in names)
    assert ctx.metrics["AggregateExec"].elapsed_seconds > 0
    assert ctx.memory_pool.peak > 0

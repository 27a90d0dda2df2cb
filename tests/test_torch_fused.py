"""The port's FusedQuery (physical/fused.py) on the CPU: discovery, then the
steady state (the walker, run eagerly here; a captured CUDA graph on the
card), held against discovery, the pandas oracle and the JAX package's
FusedQuery. Also: overflow flags that send a query back to discovery,
discovery hints, dictionary work done once per dictionary, the batched host
copy, and the session faults fixed beside them (pandas frames with string
columns, WITH RECURSIVE and VALUES with arrow_cast).

Tolerances: floats through models/tpch/compare.frames_diff (its relative
1e-6), integers, decimals and strings exact; the JAX comparison of Q3 is
exact (to_pydict equality)."""
import numpy as np
import pandas as pd
import pytest
import torch

from datafusion_tpu_torch import SessionContext
from datafusion_tpu_torch.data.device import to_host
from datafusion_tpu_torch.models.tpch.compare import LIMIT_QUERIES, frames_diff
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch
from datafusion_tpu_torch.models.tpch.queries import query
from datafusion_tpu_torch.models.tpch.queries_ref import ref_query
from datafusion_tpu_torch.physical import functions as F
from datafusion_tpu_torch.physical import plan as P
from datafusion_tpu_torch.physical.fused import FusedQuery, _Eager

SF = 0.005


@pytest.fixture(scope="module")
def tpch():
    tables = generate_tpch(SF)
    ctx = SessionContext(device="cpu")
    for name, t in tables.items():
        ctx.register_table(name, t)
    return ctx, {name: t.to_pandas() for name, t in tables.items()}


@pytest.fixture(scope="module")
def jax_tpch():
    """The reference session on the same data; its programs compile without
    XLA's optimizations, which would cost more than these small runs save."""
    import jax

    from datafusion_tpu.context import SessionContext as JaxSession
    from datafusion_tpu.models.tpch.datagen import generate_tpch as jax_generate

    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    ctx = JaxSession()
    for name, t in jax_generate(SF).items():
        ctx.register_table(name, t)
    yield ctx
    jax.config.update("jax_disable_most_optimizations", opt)


def _run3(df):
    """discovery, the steady state's build, a steady run: as host Tables."""
    out = [df.collect() for _ in range(3)]
    assert isinstance(df._fused_query()._fused, _Eager)
    return out


# ---------------------------------------------------------------------------
# counterparts of tests/test_fused.py
# ---------------------------------------------------------------------------


def test_fused_matches_discovery_and_jax_tpch_q3(tpch, jax_tpch):
    from datafusion_tpu.data.device import to_host as jax_to_host
    from datafusion_tpu.physical.fused import FusedQuery as JaxFused

    ctx, _ = tpch
    fq = FusedQuery(ctx.sql(query(3, SF)).physical_plan())
    ectx = ctx.exec_context()
    first = to_host(fq.execute(ectx)).to_pydict()  # discovery
    assert fq._discovered and fq._fused is None
    second = to_host(fq.execute(ectx)).to_pydict()  # builds, runs the steady state
    third = to_host(fq.execute(ectx)).to_pydict()
    assert isinstance(fq._fused, _Eager)
    assert first == second == third

    jfq = JaxFused(jax_tpch.sql(query(3, SF)).physical_plan())
    je = jax_tpch.exec_context()
    jax_to_host(jfq.execute(je))
    want = jax_to_host(jfq.execute(je)).to_pydict()  # the fused program
    assert frames_diff(pd.DataFrame(third), pd.DataFrame(want), ordered=True) is None


def _swap_device_columns(ctx, table, **cols):
    """Replace columns of `table`'s cached device scan (same capacity)."""
    prov = ctx.catalog.get(table)
    (_, cache), = prov._device.items()
    for name, values in cols.items():
        c = cache[name]
        data = c.data.clone()
        data[:len(values)] = torch.as_tensor(values, dtype=data.dtype)
        cache[name] = type(c)(data, c.validity, c.dtype, c.dictionary, c.bounds)


def test_fused_overflow_rediscovers():
    ctx = SessionContext(device="cpu")
    # duplicate live keys on both sides: the join expands (sort-merge)
    ctx.register_table("a", {"k": [1] + list(range(1, 10)),
                             "v": [float(i) for i in range(10)]})
    ctx.register_table("b", {"k": [1, 1, 2, 3] + [9] * 196,
                             "w": [1.0, 1.5, 2.0, 3.0] + [0.5] * 196})
    sql = "SELECT a.k, v, w FROM a JOIN b ON a.k = b.k WHERE b.w > 0.75"
    df = ctx.sql(sql)
    fq = df._fused_query()
    r1, r2 = df.collect().to_pydict(), df.collect().to_pydict()
    assert r1 == r2 and len(r1["k"]) == 6
    join = next(p for p in fq._nodes_preorder() if isinstance(p, P.JoinExec))
    co = join._last_co
    assert join.path == "sort-merge" and co == 128
    # every row of b now has key 1 and passes the filter: 400 matches
    # overflow the discovered expansion capacity (128)
    _swap_device_columns(ctx, "b", k=[1] * 200, w=[1.0] * 200)
    r3 = df.collect().to_pydict()
    assert len(r3["k"]) == 400 and set(r3["k"]) == {1}
    assert join._last_co == 512 and fq._discovered and fq._fused is None
    assert df.collect().to_pydict() == df.collect().to_pydict() == r3


def test_fused_aggregate_and_sort():
    ctx = SessionContext(device="cpu")
    rng = np.random.default_rng(0)
    ctx.register_table("t", {"g": rng.integers(0, 50, 500).tolist(),
                             "v": rng.random(500).tolist()})
    df = ctx.sql("SELECT g, sum(v) AS s, count(*) AS n FROM t GROUP BY g "
                 "ORDER BY s DESC LIMIT 5")
    a, b, c = (t.to_pydict() for t in _run3(df))
    assert a == b == c and len(a["g"]) == 5


def test_fused_direct_join_dup_flag_rediscovers():
    """A direct-address join keeps its unique-build assumption from
    discovery; a duplicate build key appearing later raises the steady
    state's flag and the query rediscovers (sort-merge), dropping no match."""
    ctx = SessionContext(device="cpu")
    ctx.register_table("f", {"k": [1, 2, 3, 2, 1], "v": [10, 20, 30, 21, 11]})
    ctx.register_table("d", {"k": [1, 2, 3], "w": [100, 200, 300]})
    df = ctx.sql("SELECT f.v, d.w FROM f JOIN d ON f.k = d.k")
    r1 = df.collect().to_pydict()
    assert sorted(r1["v"]) == [10, 11, 20, 21, 30]
    assert df.collect().to_pydict() == r1
    join = next(p for p in df._fused_query()._nodes_preorder()
                if isinstance(p, P.JoinExec))
    assert join.path == "direct"
    _swap_device_columns(ctx, "d", k=[1, 2, 2], w=[100, 200, 250])
    r2 = df.collect().to_pydict()
    # k=2 now matches two build rows (200 and 250); k=3 has no match
    assert sorted(r2["w"]) == [100, 100, 200, 200, 250, 250], r2
    assert join.path == "direct-dup,sort-merge"


# ---------------------------------------------------------------------------
# the steady state against discovery and the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qid", [1, 13, 18, 19, 21, 22])
def test_steady_state_matches_discovery_and_oracle(tpch, qid, request):
    ctx, frames = tpch
    runs = [t.to_pandas() for t in _run3(ctx.sql(query(qid, SF)))]
    ordered = qid in LIMIT_QUERIES
    if qid == 19:
        # no row passes Q19's filter at this scale: SQL's sum over no rows is
        # NULL where the pandas oracle gives 0.0, so the reference decides
        want = request.getfixturevalue("jax_tpch").sql(query(qid, SF)).to_pandas()
    else:
        want = ref_query(qid, frames, SF)
    for got in runs:
        assert frames_diff(got, want, ordered=ordered) is None
    assert frames_diff(runs[2], runs[0], ordered=True) is None


# ---------------------------------------------------------------------------
# discovery hints
# ---------------------------------------------------------------------------


def _stale_session():
    """A join input compacted from 131,072 slots, an expanding sort-merge
    join (duplicate build keys) and a sorted aggregate (float keys)."""
    n = 70_000
    i = np.arange(n)
    ctx = SessionContext(device="cpu")
    ctx.register_table("t", {"a": i.tolist(), "k": (i % 500).tolist(),
                             "v": (i % 13).tolist()})
    ctx.register_table("s", {"k": (np.arange(1000) % 500).tolist(),
                             "g": (np.arange(1000) % 300 / 4).tolist()})
    sql = ("SELECT s.g, count(*) AS n, sum(t.v) AS sv FROM t JOIN s "
           "ON t.k = s.k WHERE t.a < 3000 GROUP BY s.g ORDER BY s.g")
    return ctx, sql


def _nodes(fq, kind):
    return [p for p in fq._nodes_preorder() if isinstance(p, kind)]


def test_planted_hints_skip_discovery():
    ctx, sql = _stale_session()
    df = ctx.sql(sql)
    want = df.collect().to_pydict()
    hints = df._fused_query().discovery_hints()
    fresh = ctx.sql(sql)._fused_query()
    assert fresh.plant_hints(hints)
    calls = []
    fresh.plan.execute = lambda c: calls.append(c)  # discovery would call it
    got = to_host(fresh.execute(ctx.exec_context())).to_pydict()
    assert got == want and not calls and isinstance(fresh._fused, _Eager)
    assert not FusedQuery(ctx.sql("SELECT k FROM s").physical_plan()).plant_hints(hints)


@pytest.mark.parametrize("stale", ["compaction", "aggregate", "join", "all"])
def test_stale_hints_raise_the_flag_and_rediscover(stale):
    ctx, sql = _stale_session()
    df = ctx.sql(sql)
    want = df.collect().to_pydict()
    fq = df._fused_query()
    (compact,) = [c for c in _nodes(fq, P.CompactExec) if c._decision[0] == "compact"]
    (agg,), (join,) = _nodes(fq, P.AggregateExec), _nodes(fq, P.JoinExec)
    assert compact._decision == ("compact", 4096) and join.path == "direct-dup,sort-merge"
    caps = (compact._decision, agg._last_cap, join._last_co)
    hints = fq.discovery_hints()
    for kind, attrs in hints:
        if kind == "CompactExec" and attrs["_decision"][0] == "compact" \
                and stale in ("compaction", "all"):
            attrs["_decision"] = ("compact", attrs["_decision"][1] // 2)
        if kind == "AggregateExec" and stale in ("aggregate", "all"):
            attrs["_last_cap"] //= 2
        if kind == "JoinExec" and stale in ("join", "all"):
            attrs["_last_co"] //= 2
    fresh = ctx.sql(sql)._fused_query()
    assert fresh.plant_hints(hints)
    got = to_host(fresh.execute(ctx.exec_context())).to_pydict()
    assert got == want  # the full answer, from the rediscovery
    assert fresh._discovered and fresh._fused is None
    (c2,) = [c for c in _nodes(fresh, P.CompactExec) if c._decision[0] == "compact"]
    (a2,), (j2,) = _nodes(fresh, P.AggregateExec), _nodes(fresh, P.JoinExec)
    assert (c2._decision, a2._last_cap, j2._last_co) == caps
    assert to_host(fresh.execute(ctx.exec_context())).to_pydict() == want


# ---------------------------------------------------------------------------
# dictionary work once per dictionary
# ---------------------------------------------------------------------------


def test_like_predicate_runs_once_per_dictionary(monkeypatch):
    calls = []
    orig = F.dict_predicate

    def spy(col, op, args, pred_fn):
        def counted(vals):
            calls.append((op, args))
            return pred_fn(vals)
        return orig(col, op, args, counted)

    monkeypatch.setattr(F, "dict_predicate", spy)
    ctx = SessionContext(device="cpu")
    words = [f"w{i:04d}{'x' if i % 3 else 'y'}" for i in range(2000)]
    ctx.register_table("t", {"s": words, "v": list(range(2000))})
    sql = "SELECT count(*) AS n, sum(v) AS sv FROM t WHERE s LIKE '%y'"
    df = ctx.sql(sql)
    got = [df.collect().to_pydict() for _ in range(3)]
    got += [ctx.sql(sql).collect().to_pydict() for _ in range(2)]
    assert calls == [("like", ("%y", False))]
    assert all(g == {"n": [667], "sv": [sum(range(0, 2000, 3))]} for g in got)


def test_substring_returns_the_same_dictionary_on_a_hit():
    ctx = SessionContext(device="cpu")
    ctx.register_table("t", {"p": ["13-1", "31-2", "13-3", "29-4"]})
    df = ctx.sql("SELECT substring(p from 1 for 2) AS c FROM t")
    a, b = df.collect(), ctx.sql("SELECT substring(p, 1, 2) AS c FROM t").collect()
    assert a.to_pydict() == b.to_pydict() == {"c": ["13", "31", "13", "29"]}
    assert a.columns[0].dictionary is b.columns[0].dictionary


_LITERAL_PREDICATES = {
    "s = 'b'": lambda x: x == "b", "s <> 'b'": lambda x: x != "b",
    "s < 'b'": lambda x: x < "b", "s <= 'b'": lambda x: x <= "b",
    "s > 'b'": lambda x: x > "b", "s >= 'b'": lambda x: x >= "b",
    "'b' < s": lambda x: "b" < x, "s = 'bb'": lambda x: x == "bb",
    "s < 'bb'": lambda x: x < "bb", "s > 'bb'": lambda x: x > "bb",
    "s IN ('a', 'c', 'zz')": lambda x: x in ("a", "c", "zz"),
    "s NOT IN ('a', 'c')": lambda x: x not in ("a", "c"),
}


@pytest.mark.parametrize("pred", sorted(_LITERAL_PREDICATES))
def test_string_literal_comparisons(pred):
    """A dictionary column against string literals, on codes: the rows
    Python's string order picks, NULL rows never (SQL's NULL comparison)."""
    s = ["a", "b", None, "c", "b", "d", "bc"]
    ctx = SessionContext(device="cpu")
    ctx.register_table("t", {"s": s, "v": list(range(len(s)))})
    df = ctx.sql(f"SELECT v FROM t WHERE {pred} ORDER BY v")
    want = [i for i, x in enumerate(s) if x is not None and _LITERAL_PREDICATES[pred](x)]
    assert df.collect().to_pydict() == df.collect().to_pydict() == {"v": want}


# ---------------------------------------------------------------------------
# the host copy
# ---------------------------------------------------------------------------


def test_to_host_keeps_nulls_strings_and_lists():
    from datafusion_tpu_torch.data.device import to_device
    from datafusion_tpu_torch.data.table import Table

    t = Table.from_pydict({"l": [[1, 2], [3], None, [], [None, 4]],
                           "s": ["a", None, "c", "a", "b"],
                           "x": [1.5, None, 2.0, 3.0, None], "i": [1, 2, 3, 4, 5]})
    rel = to_device(t, device="cpu")
    keep = torch.tensor([True, True, False, True, True] + [False] * (rel.capacity - 5))
    got = to_host(rel.with_sel(keep)).to_pydict()
    assert got == {"l": [[1, 2], [3], [], [None, 4]], "s": ["a", None, "a", "b"],
                   "x": [1.5, None, 3.0, None], "i": [1, 2, 4, 5]}
    assert to_host(rel).to_pydict() == t.to_pydict()


# ---------------------------------------------------------------------------
# session faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nulls", [False, True])
def test_pandas_frames_with_string_columns_register(nulls):
    from datafusion_tpu.context import SessionContext as JaxSession

    s = ["b", "a", "b", "c"] if not nulls else ["b", None, "b", "c"]
    frame = pd.DataFrame({"s": s, "v": [1, 2, 3, 4]})
    sql = "SELECT s, sum(v) AS sv, count(*) AS n FROM t GROUP BY s ORDER BY s"
    ctx, jctx = SessionContext(device="cpu"), JaxSession()
    ctx.register_table("t", frame)
    jctx.register_table("t", frame)
    assert ctx.sql(sql).to_pydict() == jctx.sql(sql).to_pydict()


def test_with_recursive_raises_not_implemented():
    """Named when WITH RECURSIVE raised NotImplementedError naming its
    ROADMAP item; now ported: three collect()s equal the JAX package's
    answer, and the plan keeps per-operator execution (no steady state)."""
    from datafusion_tpu.context import SessionContext as JaxSession

    sql = ("WITH RECURSIVE r(n) AS (SELECT 1 UNION ALL SELECT n + 1 "
           "FROM r WHERE n < 3) SELECT n FROM r")
    ctx = SessionContext(device="cpu")
    df = ctx.sql(sql)
    want = JaxSession().sql(sql).collect().to_pydict()
    for _ in range(3):
        assert df.collect().to_pydict() == want == {"n": [1, 2, 3]}
    assert df._fused_query()._fused is False


def test_values_with_arrow_cast_reaches_the_planner():
    """VALUES holding arrow_cast plans, runs and equals the reference; its
    relation is made once and kept (the steady state reads it again)."""
    from datafusion_tpu.context import SessionContext as JaxSession

    sql = ("SELECT x, y, x + 1 AS z FROM (VALUES (arrow_cast(1, 'Int8'), 'a'), "
           "(arrow_cast(-3, 'Int8'), 'b')) AS t(x, y) ORDER BY y")
    ctx = SessionContext(device="cpu")
    df = ctx.sql(sql)
    got = [df.to_pydict() for _ in range(3)]
    assert got[0] == got[1] == got[2] == JaxSession().sql(sql).to_pydict()
    leaf = df._fused_query().leaves[0]
    assert isinstance(leaf, P.ValuesExec)
    assert leaf.execute(ctx.exec_context()) is leaf.execute(ctx.exec_context())


_ARROW_NAMES = sorted(F._ARROW_PARSE) + [
    "Decimal128(12, 2)", "Timestamp(Microsecond, None)", "Date64",
    "Time64(Nanosecond)", "Duration(Second)", "Interval(YearMonth)",
    "Interval(DayTime)", "Dictionary(Int32, Utf8)", "List(Int64)",
    "LargeList(Float64)", "FixedSizeList(3, Int32)", "FixedSizeBinary(16)"]


@pytest.mark.parametrize("name", _ARROW_NAMES)
def test_parse_arrow_type_matches_the_reference(name):
    from datafusion_tpu.physical.functions import parse_arrow_type as ref

    assert repr(F.parse_arrow_type(name)) == repr(ref(name))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graph capture has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sql", [
    # a direct join, a sort-merge join, a sorted aggregate
    "SELECT a.k, sum(v) AS sv, count(*) AS n FROM a JOIN b ON a.k = b.k "
    "GROUP BY a.k ORDER BY a.k",
    "SELECT b.g, sum(a.v) AS sv FROM a JOIN b ON a.k = b.j WHERE a.v > 3 "
    "GROUP BY b.g ORDER BY b.g",
    # the dense kernel's path
    "SELECT a.k % 5 AS m, sum(v) AS sv, count(*) AS n FROM a GROUP BY a.k % 5 "
    "ORDER BY m",
    # a union of a filtered scan, another table and VALUES
    "SELECT k, sum(v) AS sv FROM (SELECT k, v FROM a WHERE v > 7 UNION ALL "
    "SELECT j AS k, k AS v FROM b UNION ALL SELECT * FROM (VALUES (1, 2), (3, 4)) "
    "AS t(k, v)) u GROUP BY k ORDER BY k",
    # a window: ranks, a running sum, a framed max (the doubling scan and
    # the range reduction), lag
    "SELECT k, v, rank() OVER (PARTITION BY k ORDER BY v) AS r, "
    "sum(v) OVER (PARTITION BY k ORDER BY v) AS s, "
    "max(v) OVER (PARTITION BY k % 7 ORDER BY v, k) AS mx, "
    "min(v) OVER (PARTITION BY k ORDER BY v ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS mn, "
    "lag(v, 2, -1) OVER (PARTITION BY k ORDER BY v) AS lg FROM a WHERE v < 8 "
    "ORDER BY k, v, r, s, mx, mn, lg",
    # a window top-k
    "SELECT k, v, row_number() OVER (PARTITION BY k ORDER BY v DESC) AS rn FROM a "
    "QUALIFY rn <= 2 ORDER BY k, rn",
])
def test_capture_makes_no_host_sync_and_replay_equals_eager(sql):
    from datafusion_tpu_torch.physical.fused import _Graph

    dev = _card()
    ctx, cpu = SessionContext(device=dev), SessionContext(device="cpu")
    rng = np.random.default_rng(1)
    a = {"k": rng.integers(0, 100, 50_000).tolist(),
         "v": rng.integers(0, 10, 50_000).tolist()}
    b = {"k": list(range(100)), "j": (np.arange(100) % 40).tolist(),
         "g": (np.arange(100) / 7.0).tolist()}
    for c in (ctx, cpu):
        c.register_table("a", a)
        c.register_table("b", b)
    want = cpu.sql(sql).to_pydict()
    df = ctx.sql(sql)
    assert df.collect().to_pydict() == want  # discovery
    fq = df._fused_query()
    inputs = tuple(leaf.execute(ctx.exec_context()) for leaf in fq.leaves)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a sync in warm-up or capture raises
    try:
        graph = _Graph(fq._steady_fn(), inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rel, overflow = graph.run()
    assert not overflow and to_host(rel).to_pydict() == want
    eager = to_host(fq.plan.execute(ctx.exec_context())).to_pydict()
    assert eager == want
    assert [df.collect().to_pydict() for _ in range(3)] == [want] * 3
    assert isinstance(fq._fused, _Graph)


@pytest.mark.cuda
def test_new_scan_tensors_cause_a_recapture():
    dev = _card()
    ctx = SessionContext(device=dev)
    ctx.register_table("t", {"k": [1, 2, 3, 1], "v": [10, 20, 30, 40]})
    df = ctx.sql("SELECT k, sum(v) AS sv FROM t GROUP BY k ORDER BY k")
    r = [df.collect().to_pydict() for _ in range(3)]
    graph = df._fused_query()._fused
    _swap_device_columns(ctx, "t", v=[1, 2, 3, 4])
    got = df.collect().to_pydict()
    assert got == {"k": [1, 2, 3], "sv": [5, 2, 3]} != r[2]
    assert df._fused_query()._fused is not graph


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["scalar", "udaf_grouped", "udaf_global", "window"])
def test_udf_family_captures_without_a_host_sync(family):
    """Each user-function family of testing/udf_cases.py captured under
    set_sync_debug_mode("error") and replayed, equal to the CPU (floats to
    rtol 1e-9: the monoid scans)."""
    from datafusion_tpu_torch.expr import udf as U
    from datafusion_tpu_torch.physical.fused import _Graph
    from datafusion_tpu_torch.testing import udf_cases as UC

    dev = _card()
    ctx, cpu = SessionContext(device=dev), SessionContext(device="cpu")
    for c in (ctx, cpu):
        for name, cols in UC.tables().items():
            c.register_table(name, cols)
        UC.register(c)
    sql = UC.FAMILIES[family]
    want = cpu.sql(sql).to_pandas()
    df = ctx.sql(sql)
    df.collect()
    fq = df._fused_query()
    with U.activate(ctx.functions):
        inputs = tuple(leaf.execute(ctx.exec_context()) for leaf in fq.leaves)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph = _Graph(fq._steady_fn(), inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rel, overflow = graph.run()
    assert not overflow
    pd.testing.assert_frame_equal(to_host(rel).to_pandas(), want, rtol=1e-9, atol=1e-9)
    assert isinstance([df.collect() for _ in range(2)] and fq._fused, _Graph)


@pytest.mark.cuda
def test_udf_host_calls_run_eagerly_and_a_syncing_udf_is_refused():
    """A host function's steady state is the walker run eagerly on the
    card; a UDF that reads a device value on the host (`.item()`) cannot be
    captured."""
    from datafusion_tpu_torch.physical.fused import _Eager
    from datafusion_tpu_torch.testing import udf_cases as UC

    ctx = SessionContext(device=_card())
    for name, cols in UC.tables().items():
        ctx.register_table(name, cols)
    UC.register(ctx)
    df = ctx.sql(UC.CASES["async_plain"])
    assert [df.collect().to_pydict() for _ in range(3)] == [{"s": [26.0]}] * 3
    assert isinstance(df._fused_query()._fused, _Eager)
    df = ctx.sql(UC.SYNCING)
    df.collect()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            df.collect()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_decoded_q6_captures_without_a_host_sync():
    """Q6 decoded from Substrait and from LogicalPlanNode bytes: its steady
    state captured under set_sync_debug_mode("error") and replayed to the
    SQL query's answer; a recursive query on the card keeps per-operator
    execution."""
    import json

    from datafusion_tpu_torch.physical.fused import _Graph

    ctx = SessionContext(device=_card())
    for name, t in generate_tpch(0.01).items():
        ctx.register_table(name, t)
    sql_df = ctx.sql(query(6, 0.01))
    want = sql_df.collect().to_pydict()
    for back in (ctx.from_substrait(json.dumps(sql_df.to_substrait())),
                 ctx.from_proto(sql_df.to_proto())):
        assert back.collect().to_pydict() == want  # discovery
        fq = back._fused_query()
        inputs = tuple(leaf.execute(ctx.exec_context()) for leaf in fq.leaves)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph = _Graph(fq._steady_fn(), inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rel, overflow = graph.run()
        assert not overflow and to_host(rel).to_pydict() == want
    df = ctx.sql("WITH RECURSIVE r(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM r "
                 "WHERE n < 3) SELECT n FROM r")
    assert [df.collect().to_pydict() for _ in range(3)] == [{"n": [1, 2, 3]}] * 3
    assert df._fused_query()._fused is False

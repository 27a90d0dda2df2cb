"""WITH RECURSIVE in the port (RecursiveQueryExec over catalog.WorkTable)
against the JAX package on the CPU: the six cases of tests/test_recursive.py
(the runaway one with the cap lowered to 8 in both packages), a recursion
carrying strings through a join on string keys, a work table that grows
and then shrinks, a recursive arm joining a table by direct address, an
out-of-core session, a recursion over an endless stream (refused),
interrupt() inside the recursion; the port alone: the
cap of 100, a CPU session that never builds a steady state, R1 and R2 of
testing/recursive_cases.py on a 4,096-node tree against the numpy oracle,
and the reference's cte.slt against its golden rows. Answers are compared
exactly (integers and strings)."""
import pathlib

import jax
import pytest

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.physical import plan as JP
from datafusion_tpu_torch import SessionContext
from datafusion_tpu_torch.catalog import catalog as C
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.common.errors import ExecutionError, PlanError, QueryCancelled
from datafusion_tpu_torch.physical import fused as FQ
from datafusion_tpu_torch.physical import plan as P
from datafusion_tpu_torch.testing import recursive_cases as RC
from datafusion_tpu_torch.testing.slt import run_slt_file

CTE_SLT = pathlib.Path(__file__).resolve().parent / "slt" / "ported" / "cte.slt"


@pytest.fixture(scope="module", autouse=True)
def fast_reference():
    """The reference compiled with its optimizations off, for this module."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


def _tables(ctx):
    ctx.register_table("edges", {"src": [1, 1, 2, 3, 4], "dst": [2, 3, 4, 4, 5]})
    ctx.register_table("emp", {
        "name": ["ceo", "ann", "bob", "cat", "dan", "eve", "fay"],
        "boss": [None, "ceo", "ceo", "ann", "ann", "bob", "eve"]})
    ctx.register_table("fan", {"lvl": [lv for lv in range(8) for _ in range(4)],
                               "k": [k for _ in range(8) for k in range(4)]})
    ctx.register_table("nodes", {"id": list(range(64)),
                                 "nxt": [(i * 7 + 3) % 64 for i in range(64)],
                                 "label": [f"n{i % 5}" for i in range(64)]})
    return ctx


@pytest.fixture(scope="module")
def sessions():
    return _tables(JaxSession()), _tables(SessionContext(device="cpu"))


CASES = {
    "sequence": "WITH RECURSIVE seq(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM seq "
                "WHERE n < 10) SELECT sum(n) s, count(*) cnt FROM seq",
    "reachability": "WITH RECURSIVE reach(node) AS (SELECT 1 UNION ALL "
                    "SELECT e.dst FROM reach r, edges e WHERE e.src = r.node) "
                    "SELECT node, count(*) paths FROM reach GROUP BY node ORDER BY node",
    "multi_column_state": "WITH RECURSIVE fib(a, b) AS (SELECT 0, 1 UNION ALL "
                          "SELECT b, a + b FROM fib WHERE b < 100) SELECT max(b) m FROM fib",
    "column_alias_list": "WITH t(a) AS (SELECT 41) SELECT a + 1 b FROM t",
    "strings": "WITH RECURSIVE chain(name, path, lvl) AS ("
               "SELECT name, name AS path, 0 AS lvl FROM emp WHERE boss IS NULL "
               "UNION ALL SELECT e.name, chain.path || '/' || e.name, chain.lvl + 1 "
               "FROM emp e JOIN chain ON e.boss = chain.name) "
               "SELECT name, path, lvl, upper(path) AS up FROM chain ORDER BY path",
    "grow_then_shrink": "WITH RECURSIVE r(lvl, v) AS (SELECT 0 AS lvl, 1 AS v UNION ALL "
                        "SELECT r.lvl + 1, r.v * 4 + f.k FROM r JOIN fan f ON f.lvl = r.lvl "
                        "WHERE r.lvl < 3 OR (r.v % 2 = 0 AND f.k = 1)) "
                        "SELECT lvl, count(*) AS n, sum(v) AS s FROM r GROUP BY lvl "
                        "ORDER BY lvl",
    "direct_join": "WITH RECURSIVE walk(id, label, hops) AS ("
                   "SELECT 1 AS id, 'start' AS label, 0 AS hops UNION ALL "
                   "SELECT n.nxt, n.label, walk.hops + 1 FROM walk JOIN nodes n "
                   "ON n.id = walk.id WHERE walk.hops < 6) "
                   "SELECT id, label, hops FROM walk ORDER BY hops",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(sessions, name):
    jctx, pctx = sessions
    df = pctx.sql(CASES[name])
    want = jctx.sql(CASES[name]).collect().to_pydict()
    for _ in range(3):  # discovery, then the per-operator steady state
        assert df.collect().to_pydict() == want
    recursive = name != "column_alias_list"
    assert (df._fused_query()._fused is False) == recursive


def test_work_table_grows_then_shrinks(sessions, monkeypatch):
    """The live rows the recursive arm reads each step: 1, 4, 16, 64, then
    32; every step unbinds, so no scan outside the loop sees a relation."""
    seen = []
    scan = C.WorkTable.scan_device

    def spy(self, ctx, filters=(), projection=None):
        rel = scan(self, ctx, filters, projection)
        seen.append(int(rel.sel.sum()))
        return rel

    monkeypatch.setattr(C.WorkTable, "scan_device", spy)
    df = sessions[1].sql(CASES["grow_then_shrink"])
    df.collect()
    assert seen == [1, 4, 16, 64, 32]
    (rq,) = [p for p in _nodes(df.physical_plan()) if isinstance(p, P.RecursiveQueryExec)]
    assert rq.iterations == 5 and rq.work_table._rel is None
    with pytest.raises(PlanError, match="outside its recursion"):
        rq.work_table.scan_device(sessions[1].exec_context())


def test_recursive_arm_joins_by_direct_address(sessions):
    df = sessions[1].sql(CASES["direct_join"])
    df.collect()
    (join,) = [p for p in _nodes(df.physical_plan()) if isinstance(p, P.JoinExec)]
    assert join.path == "direct"


def _nodes(plan):
    out, stack = [], [plan]
    while stack:
        p = stack.pop()
        out.append(p)
        stack.extend(p.children())
    return out


def test_union_distinct_rejected_like_jax(sessions):
    sql = ("WITH RECURSIVE s(n) AS (SELECT 1 UNION SELECT n + 1 FROM s "
           "WHERE n < 3) SELECT * FROM s")
    messages = []
    for ctx in sessions:
        with pytest.raises(Exception, match="UNION ALL") as info:
            ctx.sql(sql).collect()
        messages.append((type(info.value).__name__, str(info.value)))
    assert messages[0] == messages[1] and messages[1][0] == "PlanError"


def test_runaway_recursion_capped_like_jax(sessions, monkeypatch):
    """The cap lowered to 8 in both packages: the same class and message."""
    monkeypatch.setattr(JP.RecursiveQueryExec, "MAX_ITERATIONS", 8)
    monkeypatch.setattr(P.RecursiveQueryExec, "MAX_ITERATIONS", 8)
    messages = []
    for ctx in sessions:
        with pytest.raises(Exception, match="exceeded 8 iterations") as info:
            ctx.sql(RC.RUNAWAY).collect()
        messages.append((type(info.value).__name__, str(info.value)))
    assert messages[0] == messages[1]


def test_runaway_recursion_capped_at_100():
    ctx = SessionContext(device="cpu")
    df = ctx.sql(RC.RUNAWAY)
    with pytest.raises(ExecutionError, match="'s' exceeded 100 iterations"):
        df.collect()
    (rq,) = [p for p in _nodes(df.physical_plan()) if isinstance(p, P.RecursiveQueryExec)]
    assert rq.work_table._rel is None


def test_interrupt_inside_the_recursion_like_jax():
    """A UDF in the recursive arm calls interrupt(): QueryCancelled in both
    packages, the work table unbound, and the next query runs."""
    from datafusion_tpu.common import types as JT

    sql = ("WITH RECURSIVE s(n) AS (SELECT 1.0 UNION ALL SELECT stop(n) + 1.0 "
           "FROM s WHERE n < 5.0) SELECT count(*) AS c FROM s")
    outs = []
    for ctx, dtype in ((SessionContext(device="cpu"), T.FLOAT64),
                       (JaxSession(), JT.FLOAT64)):
        def stop(a, ctx=ctx):
            ctx.interrupt()
            return a

        ctx.register_udf("stop", stop, dtype)
        df = ctx.sql(sql)
        with pytest.raises(Exception) as info:
            df.collect()
        outs.append(type(info.value).__name__)
        if dtype is T.FLOAT64:
            (rq,) = [p for p in _nodes(df.physical_plan())
                     if isinstance(p, P.RecursiveQueryExec)]
            assert rq.work_table._rel is None
        assert ctx.sql("SELECT 1 + 1 AS x").collect().to_pydict() == {"x": [2]}
    assert outs == ["QueryCancelled", "QueryCancelled"]
    assert issubclass(QueryCancelled, ExecutionError)


def test_out_of_core_session_runs_the_recursion_resident_like_jax():
    """In a chunked session the recursion is an operator the chunked
    executor does not stream: it runs resident under the streamed
    aggregate, as in the JAX package (physical/chunked.py)."""
    edges = RC.hierarchy(600, 5)
    config = {"execution.out_of_core": "on", "execution.chunk_rows": 256}
    answers = []
    for ctx in (SessionContext(device="cpu", config=config), JaxSession(config=config)):
        ctx.register_table("edges", {k: v.tolist() for k, v in edges.items()})
        df = ctx.sql(RC.R1)
        answers.append(df.collect().to_pydict())
        assert df._cq is not None
    assert answers[0] == answers[1] == RC.oracle(edges)["R1"]


def test_recursion_over_an_unbounded_stream_is_refused_like_jax():
    """RecursiveQueryExec is a pipeline breaker (plan_boundedness): over an
    endless stream both packages refuse the plan with the same message."""
    import itertools

    from datafusion_tpu.common import types as JT

    def batches():
        for i in itertools.count():
            yield {"v": [i] * 8}

    sql = ("WITH RECURSIVE r(n) AS (SELECT v FROM s UNION ALL SELECT n + 1 FROM r "
           "WHERE n < 3) SELECT count(*) AS c FROM r")
    messages = []
    for ctx, types in ((SessionContext(device="cpu"), T), (JaxSession(), JT)):
        ctx.register_streaming_table("s", batches, {"v": types.INT64}, unbounded=True)
        with pytest.raises(Exception, match="RecursiveQueryExec cannot run over an "
                                            "unbounded stream") as info:
            ctx.sql(sql).collect()
        messages.append((type(info.value).__name__, str(info.value)))
    assert messages[0] == messages[1]


def test_cpu_session_never_builds_a_steady_state(monkeypatch):
    """The plan is marked per-operator before any leaf of a steady state
    runs: neither steady state is ever made, and nothing scans the work
    table outside its recursion."""
    def refuse(*args):
        raise AssertionError("a steady state was built for a recursive plan")

    monkeypatch.setattr(FQ, "_Graph", refuse)
    monkeypatch.setattr(FQ, "_Eager", refuse)
    ctx = SessionContext(device="cpu")
    df = ctx.sql(CASES["sequence"])
    for _ in range(3):
        assert df.collect().to_pydict() == {"s": [55], "cnt": [10]}
    assert df._fused_query()._fused is False


@pytest.mark.parametrize("name", ["R1", "R2"])
def test_hierarchy_matches_numpy_oracle(name):
    edges = RC.hierarchy(1 << 12, 0)
    oracle = RC.oracle(edges)
    ctx = SessionContext(device="cpu")
    ctx.register_table("edges", edges)
    df = ctx.sql(getattr(RC, name))
    assert df.collect().to_pydict() == oracle[name]
    (rq,) = [p for p in _nodes(df.physical_plan()) if isinstance(p, P.RecursiveQueryExec)]
    assert rq.iterations == oracle["iterations"]


def test_cte_slt_matches_its_golden_rows():
    """Every record of the reference's cte.slt; the JAX package passes all
    of them too (tests/test_sqllogic.py), so none may fail here."""
    failures = run_slt_file(str(CTE_SLT), ctx=SessionContext(device="cpu"))
    assert not failures, "\n".join(str(f) for f in failures)

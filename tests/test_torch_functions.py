"""The port's scalar function library (datafusion_tpu_torch/physical/
functions.py) and its string casts (expr_compiler.cast_column /
string_cast_column) against the JAX package, through SQL on the same table.

The table is made from a seed with numpy around fixed edge values: NULLs,
NaN, +-0.0, +-inf, INT64_MIN / INT64_MAX, empty and non-ASCII strings, dates
and timestamps before 1970 and at the int64 extremes. Each case is one SQL
expression evaluated over every row on the JAX package and on the port
(device="cpu"); the two answers must have the same type, the same NULLs and
the same values: integers, dates, timestamps, decimals and strings exactly,
floats to rtol 1e-12 / atol 1e-12 (NaN equal to NaN). A case the reference
rejects must raise the same exception class on the port.

Also here: `random` raising PlanError, now() over three collect()s of one
DataFrame, a string cast's value table missing a new value (back to
discovery), information_schema.views and routines, and, on the card, each
family replayed from a captured CUDA graph under
torch.cuda.set_sync_debug_mode("error")."""
import math
import time

import jax
import pytest
import torch

from datafusion_tpu.common import types as JT
from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.data.table import Table as JTable
from datafusion_tpu.physical import functions as JF
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.common.errors import PlanError
from datafusion_tpu_torch.data.device import to_host
from datafusion_tpu_torch.data.table import Table as PTable
from datafusion_tpu_torch.physical import functions as PF
from datafusion_tpu_torch.physical.fused import _Graph
from datafusion_tpu_torch.testing.edge_cases import (CASES, ERRORS, FAMILIES,
                                                     edge_table, edge_types)

RTOL = ATOL = 1e-12


@pytest.fixture(scope="module")
def sessions():
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    jctx.register_table("t", JTable.from_pydict(edge_table(), edge_types(JT)))
    pctx.register_table("t", PTable.from_pydict(edge_table(), edge_types(T)))
    yield jctx, pctx
    jax.config.update("jax_disable_most_optimizations", opt)


def _cells(table):
    """Per column (type name, [raw value or None per row]): string codes
    decoded through the dictionary, numbers as stored."""
    out = []
    for f, c in zip(table.schema.fields, table.columns):
        valid = c.valid_mask()
        vals = []
        for r in range(table.num_rows):
            if not valid[r]:
                vals.append(None)
            elif f.dtype.is_string:
                vals.append(c.dictionary.values[int(c.data[r])])
            else:
                vals.append(c.data[r].item() if hasattr(c.data[r], "item") else c.data[r])
        out.append((repr(f.dtype), vals))
    return out


def _same(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or math.isclose(a, b, rel_tol=RTOL, abs_tol=ATOL)
    return a == b


def _run(ctx, sql):
    try:
        return "ok", _cells(ctx.sql(sql).collect())
    except Exception as e:  # noqa: BLE001 -- compared with the reference's
        return "error", type(e).__name__


def _assert_equal(jctx, pctx, sql):
    want, got = _run(jctx, sql), _run(pctx, sql)
    assert want[0] == "ok", f"the reference rejects {sql}: {want[1]}"
    assert got[0] == "ok", f"{sql}: the port raises {got[1]}"
    assert len(got[1]) == len(want[1])
    for (gt, gv), (wt, wv) in zip(got[1], want[1]):
        assert gt == wt, f"{sql}: type {gt} != {wt}"
        assert len(gv) == len(wv), f"{sql}: {len(gv)} rows != {len(wv)}"
        bad = [(r, x, y) for r, (x, y) in enumerate(zip(gv, wv)) if not _same(x, y)]
        assert not bad, f"{sql}: (row, port, JAX) {bad[:4]}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_jax(sessions, case):
    jctx, pctx = sessions
    _assert_equal(jctx, pctx, f"SELECT k, {CASES[case]} AS v FROM t")


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_rejected_call_raises_like_jax(sessions, case):
    jctx, pctx = sessions
    sql = f"SELECT k, {ERRORS[case]} AS v FROM t"
    want, got = _run(jctx, sql), _run(pctx, sql)
    assert want[0] == "error", f"the reference accepts {sql}"
    assert got == want


@pytest.mark.parametrize("sql", [
    "SELECT k, to_char(ts, '%H:%M') AS v FROM t WHERE k < 7 AND k <> 5",
    "SELECT CAST(f AS VARCHAR) AS v, count(*) AS c FROM t GROUP BY 1",
    "SELECT approx_distinct(s) AS a, approx_distinct(i) AS b FROM t",
    "SELECT b, approx_distinct(sd) AS a FROM t GROUP BY b",
    "SELECT k FROM t WHERE arrow_cast(s, 'Binary') = 'Apple'",
])
def test_queries_over_live_rows_match_jax(sessions, sql):
    """String casts render only the live rows; approx_distinct counts
    exactly by sorted runs; a binary is compared with a string as bytes."""
    jctx, pctx = sessions
    _assert_equal(jctx, pctx, sql + (" ORDER BY 1" if "GROUP BY" in sql else ""))


def test_random_raises_plan_error(sessions):
    _, pctx = sessions
    with pytest.raises(PlanError, match="'random' not implemented"):
        pctx.sql("SELECT random()").collect()


def test_builtin_names_are_the_reference_less_nested():
    """The whole of the reference's set, the nested family included (its
    names are physical/nested.py's NESTED_FNS)."""
    from datafusion_tpu.physical import nested as JN
    from datafusion_tpu_torch.physical import nested as PN

    assert PF.builtin_function_names() == JF.builtin_function_names()
    assert set(PN.NESTED_FNS) == set(JN.NESTED_FNS)


def test_information_schema_routines_match_jax_less_nested(sessions):
    """The same rows as the reference's view (neither side lists the Spark
    functions; tests/test_torch_spark.py holds a Spark-enabled session's
    view equal too)."""
    jctx, pctx = sessions
    sql = "SELECT routine_name, routine_type FROM information_schema.routines"

    def rows(ctx):
        d = ctx.sql(sql).to_pydict()
        return set(zip(d["routine_name"], d["routine_type"]))

    want, got = rows(jctx), rows(pctx)
    assert got == want and ("array_agg", "AGGREGATE") in got
    assert ("unnest", "SCALAR") in got or ("make_array", "SCALAR") in got


def test_information_schema_views_answer_like_jax(sessions):
    jctx, pctx = sessions
    sql = "SELECT * FROM information_schema.views"
    for ctx in (jctx, pctx):
        ctx.catalog.views["v_cast"] = ctx.sql(
            "SELECT k, CAST(k AS VARCHAR) AS s FROM t WHERE k > 3")._plan
    try:
        assert pctx.sql(sql).to_pydict() == jctx.sql(sql).to_pydict()
        assert pctx.sql(sql).to_pydict()["table_name"] == ["v_cast"]
    finally:
        for ctx in (jctx, pctx):
            ctx.catalog.views.pop("v_cast")


def test_now_is_read_once_per_steady_state(sessions):
    """The reference: the first collect() of a DataFrame reads the clock
    then, every later one returns the reading of the second (its jitted
    steady state bakes the value in); the port's steady state keeps its
    first reading, which a CUDA graph captures."""
    _, pctx = sessions
    df = pctx.sql("SELECT now() AS a, current_date AS d, current_time AS t FROM t LIMIT 1")
    seen = []
    for _ in range(3):
        seen.append(df.to_pydict())
        time.sleep(0.002)
    assert seen[0]["a"] != seen[1]["a"]
    assert seen[1] == seen[2]
    assert df._fq._fused is not None and df._fq._fused is not False
    assert df.to_pydict() == seen[1]


def test_uuid_has_the_shape_and_format_of_the_reference(sessions):
    """uuid() makes one value per row on the host: its shape and format are
    compared, not its values."""
    import re

    for ctx in sessions:
        (dtype, vals), = _cells(ctx.sql("SELECT uuid() AS u FROM t").collect())[:1]
        assert dtype == repr(T.STRING) and len(vals) == 16 and len(set(vals)) == 16
        assert all(re.fullmatch(r"[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}-"
                                r"[0-9a-f]{12}", v) for v in vals)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_string_cast_new_value_goes_back_to_discovery(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a captured CUDA graph)")
    ctx = PortSession(device=device)
    ctx.register_table("u", {"x": [1, 2, 3, 1]})
    df = ctx.sql("SELECT CAST(x AS VARCHAR) AS s FROM u")
    assert [df.to_pydict()["s"] for _ in range(3)] == [["1", "2", "3", "1"]] * 3
    steady = df._fq._fused
    assert steady is not None and steady is not False
    # the scan's tensor changes in place: the steady state sees a value its
    # table (from discovery) lacks, raises the flag and rediscovers
    scan = ctx.catalog.get("u")._device[str(ctx.device)]["x"]
    scan.data[1] = 77
    assert df.to_pydict()["s"] == ["1", "77", "3", "1"]
    assert df._fq._fused is None  # discovery ran again
    assert df.to_pydict()["s"] == ["1", "77", "3", "1"]
    assert df.to_pydict()["s"] == ["1", "77", "3", "1"]


# --- on the card: each family replayed from a captured graph ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_replays_from_a_captured_graph(family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a captured CUDA graph)")
    cpu, gpu = PortSession(device="cpu"), PortSession(device="cuda")
    for ctx, tp in ((cpu, T), (gpu, T)):
        ctx.register_table("t", PTable.from_pydict(edge_table(), edge_types(tp)))
    sql = f"SELECT k, {FAMILIES[family]} AS v FROM t WHERE k <> 8"
    want = _cells(cpu.sql(sql).collect())
    df = gpu.sql(sql)
    got = [_cells(df.collect())]  # discovery
    fq = df._fused_query()
    inputs = tuple(leaf.execute(gpu.exec_context()) for leaf in fq.leaves)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a sync in warm-up or capture raises
    try:
        graph = _Graph(fq._steady_fn(), inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rel, overflow = graph.run()
    assert not overflow
    got.append(_cells(to_host(rel)))
    got += [_cells(df.collect()) for _ in range(3)]
    assert isinstance(fq._fused, _Graph)
    if family == "clock":
        return
    for cells in got:
        for (gt, gv), (wt, wv) in zip(cells, want):
            assert gt == wt and all(_same(x, y) for x, y in zip(gv, wv)), family

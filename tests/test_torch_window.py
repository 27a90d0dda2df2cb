"""Window functions through the port's SessionContext(device="cpu") against
the JAX package's SessionContext on the same tables: every window function,
ROWS / RANGE / GROUPS frames (RANGE offsets on int, date and decimal keys),
NULL and NaN in partition and order keys, dead rows under a window, and the
window top-k rewrite for <=, < and =. Integers, strings, dates and decimals
compare exactly, floats to rtol 1e-9 / atol 1e-12; NULL and NaN are told
apart. Each query holds several window expressions, so that the reference
compiles few programs."""
import math

import jax
import numpy as np
import pytest

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.data.table import Table
from datafusion_tpu_torch.physical.window import WindowExec, WindowTopKExec

NAN = float("nan")


def _table():
    """40 rows: int and string partition keys with NULLs, a float order key
    with NULL and NaN (and ties), a float argument with NULL and NaN, int,
    date and decimal keys."""
    rng = np.random.default_rng(3)
    n = 40
    g = rng.integers(0, 4, n).astype(object)
    g[[3, 17]] = None
    s = np.array([f"s{i}" for i in rng.integers(0, 3, n)], dtype=object)
    s[[5, 6, 30]] = None
    k = rng.integers(0, 8, n).astype(float).astype(object)
    k[[2, 11]] = None
    k[[7, 23, 24]] = NAN
    v = rng.normal(size=n).round(3).astype(object)
    v[[1, 9, 20]] = None
    v[[4, 33]] = NAN
    i = rng.integers(-20, 20, n).astype(object)
    i[[8, 21]] = None
    d = (10_950 + rng.integers(0, 12, n)).astype(object)
    d[[13]] = None
    m = (rng.integers(-500, 500, n) / 100).astype(object)
    m[[15, 27]] = None
    data = {"id": list(range(n)), "g": list(g), "s": list(s), "k": list(k),
            "v": list(v), "i": list(i), "d": list(d), "m": list(m)}
    types = {"id": T.INT64, "g": T.INT64, "s": T.STRING, "k": T.FLOAT64,
             "v": T.FLOAT64, "i": T.INT64, "d": T.DATE32, "m": T.decimal(7, 2)}
    return data, types


@pytest.fixture(autouse=True, scope="module")
def quick_reference_compiles():
    """The reference compiles each query once: XLA's optimizations would
    cost more than these 40-row runs save."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


@pytest.fixture(scope="module")
def sessions():
    from datafusion_tpu.data.table import Table as JaxTable

    data, types = _table()
    jtypes = {c: _jax_type(t) for c, t in types.items()}
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    jctx.register_table("t", JaxTable.from_pydict(data, jtypes))
    pctx.register_table("t", Table.from_pydict(data, types))
    return jctx, pctx


def _jax_type(t):
    from datafusion_tpu.common import types as JT

    return JT.decimal(t.precision, t.scale) if t.is_decimal else getattr(
        JT, {T.INT64: "INT64", T.STRING: "STRING", T.FLOAT64: "FLOAT64",
             T.DATE32: "DATE32"}[t])


def _same_value(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)
    return a == b


def assert_same(ours: dict, ref: dict) -> None:
    assert list(ours) == list(ref)
    for c in ref:
        assert len(ours[c]) == len(ref[c]), c
        bad = [(r, x, y) for r, (x, y) in enumerate(zip(ours[c], ref[c]))
               if not _same_value(x, y)]
        assert not bad, f"column {c}: (row, port, reference) {bad[:5]}"


def _find(plan, cls):
    if isinstance(plan, cls):
        return plan
    for c in plan.children():
        hit = _find(c, cls)
        if hit is not None:
            return hit
    return None


W = "PARTITION BY g ORDER BY k"
CASES = {
    "ranking": f"""SELECT id, row_number() OVER ({W}, id) rn, rank() OVER ({W}) rk,
        dense_rank() OVER ({W}) dr, percent_rank() OVER ({W}) pr,
        cume_dist() OVER ({W}) cd, ntile(3) OVER ({W}, id) nt FROM t ORDER BY id""",
    "lead_lag": f"""SELECT id, lag(v) OVER ({W}, id) a, lead(v, 2) OVER ({W}, id) b,
        lag(s, 1, 'zz') OVER ({W}, id) c, lead(i, 1, -1) OVER ({W}, id) e,
        lag(m, 3) OVER (ORDER BY id) f FROM t ORDER BY id""",
    "value_functions": f"""SELECT id, first_value(v) OVER ({W}, id) a,
        last_value(v) OVER ({W}) b, nth_value(i, 2) OVER ({W}, id) c,
        first_value(s) OVER (PARTITION BY s ORDER BY d) e FROM t ORDER BY id""",
    "running_aggregates": f"""SELECT id, sum(v) OVER ({W}) a, avg(i) OVER ({W}) b,
        count(v) OVER ({W}) c, min(v) OVER ({W}, id) e, max(v) OVER ({W}, id) f,
        count(*) OVER ({W}) h, sum(m) OVER ({W}, id) j, avg(m) OVER ({W}) l,
        max(s) OVER ({W}, id) o FROM t ORDER BY id""",
    "partition_aggregates": """SELECT id, sum(v) OVER (PARTITION BY g) a,
        avg(m) OVER (PARTITION BY s) b, count(*) OVER (PARTITION BY g) c,
        min(i) OVER (PARTITION BY g) e, max(v) OVER (PARTITION BY s) f,
        min(s) OVER (PARTITION BY g) h, count(i) OVER () j FROM t ORDER BY id""",
    "ignore_nulls": f"""SELECT id, lag(v) IGNORE NULLS OVER ({W}, id) a,
        lead(i, 2) IGNORE NULLS OVER ({W}, id) b,
        lag(i, 1, -1) IGNORE NULLS OVER ({W}, id) c,
        first_value(v) IGNORE NULLS OVER ({W}, id) e,
        last_value(i) IGNORE NULLS OVER ({W}, id) f FROM t ORDER BY id""",
    "filter_clause": """SELECT id, count(*) FILTER (WHERE i > 0) OVER (PARTITION BY g) a,
        sum(v) FILTER (WHERE i % 2 = 0) OVER (PARTITION BY g ORDER BY id) b
        FROM t ORDER BY id""",
    "rows_frames": f"""SELECT id,
        sum(v) OVER ({W}, id ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING) a,
        min(v) OVER ({W}, id ROWS BETWEEN 3 PRECEDING AND CURRENT ROW) b,
        max(i) OVER ({W}, id ROWS BETWEEN 1 FOLLOWING AND 3 FOLLOWING) c,
        avg(v) OVER ({W}, id ROWS BETWEEN UNBOUNDED PRECEDING AND 2 FOLLOWING) e,
        count(v) OVER ({W}, id ROWS BETWEEN 4 PRECEDING AND 2 PRECEDING) f,
        first_value(v) OVER ({W}, id ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) h,
        last_value(i) OVER ({W}, id ROWS BETWEEN 1 PRECEDING AND UNBOUNDED FOLLOWING) j,
        nth_value(v, 2) OVER ({W}, id ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) l,
        max(v) OVER (ORDER BY id ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) o
        FROM t ORDER BY id""",
    "range_int_key": """SELECT id,
        sum(v) OVER (PARTITION BY g ORDER BY i RANGE BETWEEN 3 PRECEDING AND 2 FOLLOWING) a,
        count(*) OVER (PARTITION BY s ORDER BY i DESC RANGE BETWEEN 2 PRECEDING AND CURRENT ROW) b,
        min(v) OVER (PARTITION BY g ORDER BY i RANGE BETWEEN CURRENT ROW AND 4 FOLLOWING) c,
        max(v) OVER (ORDER BY i DESC NULLS LAST RANGE BETWEEN 5 PRECEDING AND 1 PRECEDING) e
        FROM t ORDER BY id""",
    "range_float_key": """SELECT id,
        sum(i) OVER (PARTITION BY g ORDER BY k RANGE BETWEEN 1.5 PRECEDING AND 1 FOLLOWING) a,
        count(v) OVER (ORDER BY k DESC RANGE BETWEEN 2 PRECEDING AND 2 FOLLOWING) b
        FROM t ORDER BY id""",
    "range_date_key": """SELECT id,
        count(*) OVER (PARTITION BY g ORDER BY d RANGE BETWEEN 3 PRECEDING AND CURRENT ROW) a,
        sum(i) OVER (ORDER BY d RANGE BETWEEN 2 PRECEDING AND 2 FOLLOWING) b
        FROM t ORDER BY id""",
    "range_decimal_key": """SELECT id,
        sum(i) OVER (PARTITION BY g ORDER BY m RANGE BETWEEN 1.25 PRECEDING AND 0.5 FOLLOWING) a,
        max(v) OVER (ORDER BY m DESC RANGE BETWEEN 2 PRECEDING AND CURRENT ROW) b
        FROM t ORDER BY id""",
    "groups_frames": f"""SELECT id,
        sum(v) OVER ({W} GROUPS BETWEEN 1 PRECEDING AND 1 FOLLOWING) a,
        count(*) OVER ({W} GROUPS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) b,
        count(v) OVER ({W} GROUPS BETWEEN CURRENT ROW AND 2 FOLLOWING) c,
        sum(i) OVER (ORDER BY d GROUPS BETWEEN 2 PRECEDING AND 1 PRECEDING) e
        FROM t ORDER BY id""",
    "null_nan_keys": """SELECT id, row_number() OVER (PARTITION BY k ORDER BY id) a,
        rank() OVER (PARTITION BY s ORDER BY v DESC NULLS FIRST) b,
        dense_rank() OVER (ORDER BY k NULLS FIRST) c,
        sum(i) OVER (PARTITION BY k, s ORDER BY v) e,
        max(v) OVER (PARTITION BY s ORDER BY k DESC) f FROM t ORDER BY id""",
    "dead_rows": f"""SELECT id, row_number() OVER ({W}, id) a, sum(v) OVER ({W}) b,
        lag(i) OVER ({W}, id) c, last_value(v) OVER ({W}) e,
        cume_dist() OVER ({W}) f, min(v) OVER ({W}, id ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) h
        FROM t WHERE i > -8 AND id % 3 <> 1 ORDER BY id""",
    "global_window": """SELECT id, row_number() OVER (ORDER BY v DESC, id) a,
        sum(i) OVER () b, rank() OVER (ORDER BY s) c, ntile(4) OVER (ORDER BY id) e
        FROM t ORDER BY id""",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_matches_jax(sessions, case):
    jctx, pctx = sessions
    sql = CASES[case]
    df = pctx.sql(sql)
    assert _find(df.physical_plan(), WindowExec) is not None
    assert_same(df.to_pydict(), jctx.sql(sql).to_pydict())


TOPK = {
    "row_number_le": ("SELECT g, v, id, row_number() OVER (PARTITION BY g ORDER BY v DESC, id) rn "
                      "FROM t QUALIFY rn <= 2 ORDER BY g, rn"),
    "rank_lt": ("SELECT * FROM (SELECT s, i, id, rank() OVER (PARTITION BY s ORDER BY i) rk "
                "FROM t) sub WHERE rk < 3 ORDER BY s, rk, id"),
    "dense_rank_eq": ("SELECT s, k, id FROM t QUALIFY dense_rank() OVER "
                      "(PARTITION BY s ORDER BY k DESC) = 1 ORDER BY s, id"),
    "dead_rows_le": ("SELECT g, i, row_number() OVER (PARTITION BY g ORDER BY i, id) rn "
                     "FROM t WHERE v > 0 QUALIFY rn <= 3 ORDER BY g, rn"),
}


@pytest.mark.parametrize("case", sorted(TOPK))
def test_window_topk_matches_jax(sessions, case):
    jctx, pctx = sessions
    sql = TOPK[case]
    df = pctx.sql(sql)
    tk = _find(df.physical_plan(), WindowTopKExec)
    assert tk is not None
    assert_same(df.to_pydict(), jctx.sql(sql).to_pydict())
    assert tk._last_cap is not None


def test_rank_filter_that_is_no_topk_keeps_the_window(sessions):
    jctx, pctx = sessions
    sql = ("SELECT g, id, row_number() OVER (PARTITION BY g ORDER BY id) rn "
           "FROM t QUALIFY rn = 2 ORDER BY g")
    df = pctx.sql(sql)
    assert _find(df.physical_plan(), WindowTopKExec) is None
    assert_same(df.to_pydict(), jctx.sql(sql).to_pydict())


def test_window_steady_state_matches_discovery(sessions):
    """Three collect()s of one DataFrame (discovery, the steady state's
    build, a run of it) give one answer, for a window and a top-k. A top-k
    applied with too small a capacity keeps the survivors that fit (no
    write past it); in a steady state that raises the overflow flag, and the
    query is discovered again."""
    _, pctx = sessions
    for sql in (CASES["rows_frames"], TOPK["row_number_le"]):
        df = pctx.sql(sql)
        first = df.to_pydict()
        for _ in range(2):
            assert_same(df.to_pydict(), first)
        assert df._fused_query()._fused not in (None, False)
    tk = _find(df.physical_plan(), WindowTopKExec)
    rel = tk.input.execute(pctx.exec_context())
    perm, rank, keep = tk._phase1(rel)
    out = tk._apply(rel, perm, rank, keep, 4)
    assert int(keep.sum()) > 4 and out.capacity == 4 and bool(out.sel.all())
    assert out.columns[-1].data.tolist() == rank[keep].tolist()[:4]
    tk._last_cap = 4
    assert_same(df.to_pydict(), first)  # the flag sent it back to discovery
    assert tk._last_cap >= len(first["g"])

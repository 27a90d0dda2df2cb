"""The Spark function library in the port (spark/functions.py, spark/
javafmt.py, the Spark dispatch of physical/functions.py,
enable_spark_functions) against the JAX package on the CPU, on the same
inputs: the cases of tests/test_spark_functions.py, shifts by every count
(XLA defines shifts by 64 or more and by negative counts; torch leaves them
to C++), the Spark family query of testing/udf_cases.py,
information_schema.routines of a Spark-enabled session, and one of the
reference's Spark SQL files per family, record by record through both
copies of testing/slt.py (chip_smoke.py runs all 67 on the card against the
CPU). Each answer renders the same rows on both packages, or both fail."""
import dataclasses
import math
import pathlib

import jax
import pytest

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.testing import slt as jax_slt
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.testing import slt as port_slt
from datafusion_tpu_torch.testing import udf_cases as UC

RTOL = 1e-12
SLT = pathlib.Path(__file__).resolve().parent / "slt" / "ported"
# one file per family: math, bitwise, hash, string, datetime, url,
# conversion, aggregate
FILES = ["spark__math__round.slt", "spark__bitwise__shiftrightunsigned.slt",
         "spark__hash__xxhash64.slt", "spark__string__substring.slt",
         "spark__datetime__last_day.slt", "spark__url__parse_url.slt",
         "spark__conversion__cast_int_to_timestamp.slt",
         "spark__aggregate__try_sum.slt"]
RECORDS = {name: port_slt.parse_slt((SLT / name).read_text()) for name in FILES}
SLT_CASES = [(name, i) for name in FILES for i in range(len(RECORDS[name]))]

T_ROWS = {"k": [1, 2, 3, 4], "x": [2.5, -2.5, 3.45, 1.15],
          "s": ["hello", "WORLD", "abc", "1234567812345670"],
          "d": ["2024-01-31", "2024-02-29", "2023-12-15", "2024-07-04"],
          "n": [5, 12, 255, 1]}
# int64 extremes and shift counts outside [0, 64)
SHIFTS = {"x": [5, -5, 1, -1, (1 << 63) - 1, -(1 << 63), 123456789, -987654321, 0, 7],
          "n": [-1, 0, 1, 63, 64, 65, 100, -64, 3, 62]}

QUERIES = [
    "SELECT round(x) r, bround(x) b FROM t2",
    "SELECT pmod(-7, 3) p, hypot(3.0, 4.0) h FROM t2 LIMIT 1",
    "SELECT bit_count(n) bc, shiftleft(n, 2) sl, bit_get(n, 2) bg, bitwise_not(n) bn "
    "FROM t2 ORDER BY k",
    "SELECT width_bucket(x, 0.0, 4.0, 4) wb FROM t2 ORDER BY k",
    "SELECT hex(n) h, bin(n) b FROM t2 ORDER BY k",
    "SELECT sha1(s) a, sha2(s, 256) b, crc32(s) c, xxhash64(s) x FROM t2 ORDER BY k",
    "SELECT base64(s) e, unbase64(base64(s)) rt, soundex(s) sx FROM t2 ORDER BY k",
    "SELECT luhn_check(s) l FROM t2 ORDER BY k",
    "SELECT substring(s, -3) t1, substring(s, 2, 3) t2 FROM t2 ORDER BY k",
    "SELECT elt(2, 'a', 'b', 'c') e FROM t2 LIMIT 1",
    "SELECT add_months(d, 1) am, date_add(d, 10) da, datediff(d, d) z, last_day(d) ld, "
    "weekday(d) wd, dayofweek(d) dw FROM t2 ORDER BY k",
    "SELECT next_day(d, 'Mon') nd, months_between(d, date_sub(d, 40)) mb, "
    "unix_timestamp(d) u FROM t2 ORDER BY k",
    "SELECT if(x > 0, 'pos', 'neg') c, nvl2(s, 'has', 'nul') nv, isnull(x) i1, "
    "isnotnull(x) i2 FROM t2 ORDER BY k",
    "SELECT monotonically_increasing_id() id, k FROM t2 ORDER BY k",
    "SELECT try_sum(n) ts, collect_list(k) cl FROM t2",
    "SELECT expm1(x) e, log1p(x + 3) l, rint(x) r, negative(n) ng, positive(x) p "
    "FROM t2 ORDER BY k",
    "SELECT round(CAST(x AS DECIMAL(10, 3)), 1) r, bround(CAST(x AS DECIMAL(10, 3)), 1) b, "
    "round(CAST(n AS DECIMAL(10, 0)), -1) t FROM t2 ORDER BY k",
    "SELECT space(k) sp, format_string('%s-%05d', 'a', 42) f, url_encode(s) ue "
    "FROM t2 ORDER BY k",
    "SELECT shiftleft(x, n) sl, shiftright(x, n) sr, shiftrightunsigned(x, n) su, "
    "bit_get(x, n) bg, getbit(x, 63) g63, bit_count(x) bc FROM shifts",
]


@pytest.fixture(scope="module", autouse=True)
def fast_reference():
    """The reference compiled with its optimizations off, for this module."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


def _spark(ctx):
    ctx.register_table("t", T_ROWS)
    ctx.register_table("shifts", SHIFTS)
    ctx.register_table("r", UC.tables()["r"])
    ctx.sql("CREATE TABLE t2 AS SELECT k, x, s, CAST(d AS DATE) d, n FROM t")
    ctx.enable_spark_functions()
    return ctx


@pytest.fixture(scope="module")
def sessions():
    return _spark(JaxSession()), _spark(PortSession(device="cpu"))


def _answer(ctx, sql):
    try:
        return ctx.sql(sql).collect().to_pydict()
    except Exception as e:  # noqa: BLE001 -- an error is an outcome
        return type(e).__name__


def _same(a, b) -> bool:
    """Equal answers: the same columns and values, floats to RTOL (XLA
    rewrites a division by a constant as a product, one ulp away)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(
            len(a[k]) == len(b[k]) and all(_same(x, y) for x, y in zip(a[k], b[k]))
            for k in a)
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or math.isclose(a, b, rel_tol=RTOL, abs_tol=RTOL) or \
            (math.isnan(a) and math.isnan(b))
    return a == b


def _port_three(ctx, sql):
    """The answer of three collect()s of one DataFrame (discovery, the
    steady state's build, a steady-state run), which must agree; or the
    class of the error it raises."""
    try:
        df = ctx.sql(sql)
        got = [df.collect().to_pydict() for _ in range(3)]
    except Exception as e:  # noqa: BLE001 -- an error is an outcome
        return type(e).__name__
    assert got[0] == got[1] == got[2], sql
    return got[0]


@pytest.mark.parametrize("sql", QUERIES)
def test_query_matches_jax(sessions, sql):
    jctx, pctx = sessions
    got = _port_three(pctx, sql)
    assert isinstance(got, dict) and _same(got, _answer(jctx, sql)), got


def test_spark_family_query_matches_jax(sessions):
    jctx, pctx = sessions
    assert _same(_port_three(pctx, UC.SPARK_FAMILY), _answer(jctx, UC.SPARK_FAMILY))


def test_spark_names_need_the_opt_in():
    for ctx in (PortSession(device="cpu"), JaxSession()):
        ctx.register_table("t", {"s": ["x"]})
        with pytest.raises(Exception):
            ctx.sql("SELECT sha2(s, 256) FROM t").to_pydict()


def test_core_round_unchanged_without_spark():
    for ctx in (PortSession(device="cpu"), JaxSession()):
        ctx.register_table("t", {"x": [2.5, 3.5]})
        assert ctx.sql("SELECT round(x) r FROM t").to_pydict()["r"] == [2.0, 4.0]


def test_information_schema_routines_of_a_spark_session_match_jax(sessions):
    jctx, pctx = sessions
    sql = ("SELECT routine_name, routine_type FROM information_schema.routines "
           "ORDER BY routine_name, routine_type")
    assert pctx.sql(sql).to_pydict() == jctx.sql(sql).to_pydict()


# ---------------------------------------------------------------------------
# the reference's Spark SQL files, one per family
# ---------------------------------------------------------------------------

def _outcome(slt, ctx, rec):
    try:
        table = ctx.sql(rec.sql).collect()
    except Exception:  # noqa: BLE001 -- an error is an outcome
        return ("error",)
    if rec.kind == "query":
        return ("rows", tuple(slt.format_rows(table, rec.types, rec.sort_mode)))
    return ("ok",)


@pytest.fixture(scope="module")
def outcomes():
    """Every record of each file, in order, on a fresh Spark-enabled
    session of each package: {file: [(port outcome, JAX outcome), ...]}."""
    out = {}
    for name in FILES:
        pctx, jctx = PortSession(device="cpu"), JaxSession()
        pctx.enable_spark_functions()
        jctx.enable_spark_functions()
        out[name] = [(_outcome(port_slt, pctx, rec), _outcome(jax_slt, jctx, rec))
                     for rec in RECORDS[name]]
    return out


def test_the_copy_parses_like_the_original():
    for name in FILES:
        text = (SLT / name).read_text()
        assert [dataclasses.astuple(r) for r in port_slt.parse_slt(text)] == \
            [dataclasses.astuple(r) for r in jax_slt.parse_slt(text)]


@pytest.mark.parametrize("name,i", SLT_CASES,
                         ids=[f"{n}:{RECORDS[n][i].line}" for n, i in SLT_CASES])
def test_record_outcome_matches_jax(outcomes, name, i):
    port, ref = outcomes[name][i]
    assert port == ref, f"{name}:{RECORDS[name][i].line} {RECORDS[name][i].sql}"

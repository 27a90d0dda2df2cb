"""The port's expression compiler (datafusion_tpu_torch/physical/
expr_compiler.py) against the JAX package's, slot by slot with bounds: on
TPC-H Q1's and Q6's own expressions (each package plans the same SQL, and the
port evaluates over a relation rebuilt from the JAX scan's numpy leaves), on
decimal/integer arithmetic with negative values, and on the TPC-H subset of
LIKE, CASE, IN lists, extract(year/month/day) and substring."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu.common.types as JT
import datafusion_tpu.expr.nodes as JE
from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.data import device as JD
from datafusion_tpu.data.table import Table as JTable
from datafusion_tpu.models.tpch.datagen import generate_tpch as jax_generate
from datafusion_tpu.physical import expr_compiler as JX
from datafusion_tpu.physical import plan as JP
from datafusion_tpu.utils import dates as JDU
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.data import device as TD
from datafusion_tpu_torch.data.table import Table as PTable
from datafusion_tpu_torch.expr import nodes as E
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch as port_generate
from datafusion_tpu_torch.models.tpch.queries import query
from datafusion_tpu_torch.physical import expr_compiler as PX
from datafusion_tpu_torch.physical import plan as PP
from datafusion_tpu_torch.utils import dates as PDU


@pytest.fixture(scope="module")
def sessions():
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    jctx.register_table("lineitem", jax_generate(0.01)["lineitem"])
    pctx.register_table("lineitem", port_generate(0.01)["lineitem"])
    return jctx, pctx


def _find(node, cls):
    while not isinstance(node, cls):
        node = node.children()[0]
    return node


def _plan_exprs(plan):
    """Scan filters, aggregate arguments and group keys of a
    scan -> aggregate plan, in plan order."""
    args, keys = [], []
    node = plan
    while node.children():
        if type(node).__name__ == "Aggregate":
            keys = list(node.group_exprs)
            for a in node.aggr_exprs:
                args.extend(getattr(a, "expr", a).args)
        node = node.children()[0]
    return list(node.filters) + args + keys


def _scan_relations(jctx, pctx, sql):
    """The JAX scan's relation, and the port's rebuilt from its numpy leaves."""
    jrel = _find(jctx.sql(sql).physical_plan(), JP.ScanExec).execute(jctx.exec_context())
    pscan = _find(pctx.sql(sql).physical_plan(), PP.ScanExec)
    leaves = [(np.asarray(c.data), None if c.validity is None else np.asarray(c.validity),
               None if c.dictionary is None else c.dictionary.values, c.bounds)
              for c in jrel.columns]
    return jrel, TD.relation_from_numpy(pscan.schema, leaves, np.asarray(jrel.sel),
                                        device="cpu")


def _same_column(p, j) -> None:
    assert repr(p.dtype) == repr(j.dtype)
    jd = np.asarray(j.data)
    assert p.data.numpy().dtype == jd.dtype
    assert np.array_equal(p.data.numpy(), jd)
    assert (p.validity is None) == (j.validity is None)
    if j.validity is not None:
        assert np.array_equal(p.validity.numpy(), np.asarray(j.validity))
    assert p.bounds == (None if j.bounds is None else tuple(int(b) for b in j.bounds))


@pytest.mark.parametrize("qid", [1, 6])
def test_query_expressions_match_slot_by_slot(sessions, qid):
    jctx, pctx = sessions
    sql = query(qid, 0.01)
    jrel, prel = _scan_relations(jctx, pctx, sql)
    jexprs = _plan_exprs(jctx.sql(sql).optimized_plan())
    pexprs = _plan_exprs(pctx.sql(sql).optimized_plan())
    assert [e.name() for e in pexprs] == [e.name() for e in jexprs]
    assert len(pexprs) == {1: 10, 6: 5}[qid]  # filters + agg args + keys
    for je, pe in zip(jexprs, pexprs):
        got = PX.eval_expr(pe, prel)
        _same_column(got, JX.eval_expr(je, jrel))
        if got.dtype == T.BOOL:
            assert np.array_equal(PX.eval_predicate(pe, prel).numpy(),
                                  np.asarray(JX.eval_predicate(je, jrel)))


def test_q6_between_keeps_the_boundary_discounts(sessions):
    """The folded float bounds 0.0499.. and 0.0699.. compare at the decimal
    column's scale, so l_discount = 0.05 and 0.07 stay inside."""
    sql = query(6, 0.01)
    _, prel = _scan_relations(*sessions, sql)
    between = [f for f in _plan_exprs(sessions[1].sql(sql).optimized_plan())
               if isinstance(f, E.Between)]
    assert len(between) == 1
    disc = prel.column("l_discount").data
    assert bool(((disc == 5) & prel.sel).any()) and bool(((disc == 7) & prel.sel).any())
    keep = PX.eval_predicate(between[0], prel) & prel.sel
    assert torch.equal(keep, prel.sel & (disc >= 5) & (disc <= 7))


_D = [-12.34, -1.0, -0.99, -0.01, 0.0, 0.01, 0.99, 12.34]
_I = [-7, -3, 3, 0, 5, -2, 7, 2]


def _arith(N, Ty, case):
    c, k = N.Column("d"), N.Column("i")
    return {
        "rescale_down": N.Cast(c, Ty.decimal(12, 0)),
        "rescale_up": N.Cast(c, Ty.decimal(14, 4)),
        "to_int": N.Cast(c, Ty.INT64),
        "to_float": N.Cast(c, Ty.FLOAT64),
        "int_to_decimal": N.Cast(k, Ty.decimal(10, 2)),
        "decimal_div": N.BinaryOp(N.Op.DIV, c, k),
        "decimal_mul": N.BinaryOp(N.Op.MUL, c, N.BinaryOp(N.Op.SUB, N.lit(1), c)),
        "int_mod": N.BinaryOp(N.Op.MOD, k, N.lit(4)),
        "int_div": N.BinaryOp(N.Op.DIV, k, N.lit(2)),
        "add_sub": N.BinaryOp(N.Op.SUB, N.BinaryOp(N.Op.ADD, c, k), N.lit(1)),
        "negative": N.Negative(c),
        "compare_float": N.BinaryOp(N.Op.LE, c, N.lit(0.0099999)),
    }[case]


@pytest.mark.parametrize("case", ["rescale_down", "rescale_up", "to_int", "to_float",
                                  "int_to_decimal", "decimal_div", "decimal_mul",
                                  "int_mod", "int_div", "add_sub", "negative",
                                  "compare_float"])
def test_arithmetic_with_negatives_matches(case):
    """Decimal rescales floor-divide (and so do their bounds), decimal -> int
    truncates toward zero, SQL integer division and remainder truncate: all
    over negative values, against the JAX package."""
    data = {"d": _D, "i": _I}
    jt = JTable.from_pydict(data, {"d": JT.decimal(12, 2), "i": JT.INT64})
    pt = PTable.from_pydict(data, {"d": T.decimal(12, 2), "i": T.INT64})
    got = PX.eval_expr(_arith(E, T, case), TD.to_device(pt, device="cpu"))
    _same_column(got, JX.eval_expr(_arith(JE, JT, case), JD.to_device(jt)))


def test_dates_accept_numpy_and_tensors():
    """add_months and civil_from_days give the JAX package's values on numpy
    arrays (the optimizer folds literals with numpy) and on tensors (the
    expression compiler)."""
    days = np.arange(-800_000, 800_000, 997, dtype=np.int32)
    want = np.asarray(JDU.add_months(jnp.asarray(days), np.int64(13)))
    got_np = PDU.add_months(days, np.int64(13))
    got_t = PDU.add_months(torch.from_numpy(days), torch.tensor(13))
    assert isinstance(got_np, np.ndarray) and got_np.dtype == np.int32
    assert np.array_equal(got_np, want) and np.array_equal(got_t.numpy(), want)
    for a, b in zip(PDU.civil_from_days(torch.from_numpy(days)),
                    JDU.civil_from_days(jnp.asarray(days))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(PDU.days_from_civil(*PDU.civil_from_days(days)), days)


def _formerly_unported(E, T, what):
    return {
        "string_function": E.ScalarFunction("md5", (E.Column("s"),)),
        "date_trunc": E.ScalarFunction("date_trunc", (E.lit("month"), E.Column("d"))),
        "string_to_number": E.Cast(E.Column("s"), T.INT64),
        "function": E.ScalarFunction("atan2", (E.Column("x"), E.Column("x"))),
        "string_cast": E.Cast(E.Column("x"), T.STRING),
    }[what]


@pytest.mark.parametrize("what", ["string_function", "date_trunc", "string_to_number",
                                  "function", "string_cast"])
def test_unported_expressions_raise(what):
    """These expressions raised NotImplementedError until the function
    library and the string casts were ported; each now evaluates as the JAX
    package's does, and a string that is not a number raises its
    ValueError on both."""
    data = {"s": ["a", "b"], "x": [1, 2], "d": [-40, 10_000]}
    rel = TD.to_device(PTable.from_pydict(data, {"d": T.DATE32}), device="cpu")
    jrel = JD.to_device(JTable.from_pydict(data, {"d": JT.DATE32}))
    try:
        want = JX.eval_expr(_formerly_unported(JE, JT, what), jrel)
    except ValueError:
        with pytest.raises(ValueError):
            PX.eval_expr(_formerly_unported(E, T, what), rel)
        return
    got = PX.eval_expr(_formerly_unported(E, T, what), rel)
    assert repr(got.dtype) == repr(want.dtype)
    if got.dictionary is not None:
        assert [got.dictionary.values[c] for c in got.data.tolist()] == \
            [want.dictionary.values[c] for c in np.asarray(want.data).tolist()]
    else:
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                                   rtol=1e-12, atol=1e-12)


# .5 ties of both signs, at one and two decimal digits
_TIES = {"q": [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, -0.25, 0.25, 1.25, -1.35, None, 0.0],
         "f": [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, -0.25, 0.25, 1.25, -1.35, None, 0.125],
         "n": [-25, -15, -5, 5, 15, 25, 35, -35, 0, 7, None, 1],
         "s": ["1995-01-01", "1994-12-31", "1995-1-2", None, "2000-02-29", "1970-01-01",
               "1969-12-31", "1995-01-01", "1996-06-30", "1995-01-02", "1995-03-15",
               "1995-01-01"],
         "day": [9131, 9130, 9132, 9131, 0, -1, 11016, 9131, 9131, 9500, 9204, None]}


def _ties_pair():
    def types(Ty):
        return {"q": Ty.decimal(7, 2), "f": Ty.FLOAT64, "n": Ty.INT64,
                "s": Ty.STRING, "day": Ty.DATE32}
    return (JD.to_device(JTable.from_pydict(_TIES, types(JT))),
            TD.to_device(PTable.from_pydict(_TIES, types(T)), device="cpu"))


def _ported_expr(N, Ty, case):
    s, t, d, i, day = (N.Column(c) for c in ("s", "t", "d", "i", "day"))
    q, f, n = (N.Column(c) for c in ("q", "f", "n"))

    def fn(name, *args):
        return N.ScalarFunction(name, tuple(args))

    return {
        "upper": fn("upper", s), "lower": fn("lower", t), "trim": fn("btrim", s),
        "abs_int": fn("abs", i), "abs_decimal": fn("abs", d),
        "ceil_decimal": fn("ceil", d), "floor_decimal": fn("floor", d),
        "sign_int": fn("signum", i),
        "coalesce_ints": fn("coalesce", i, N.lit(-1)),
        "coalesce_decimals": fn("coalesce", d, N.BinaryOp(N.Op.MUL, d, d)),
        "coalesce_strings": fn("coalesce", s, t, N.lit("none")),
        "nullif_int": fn("nullif", i, N.lit(3)),
        "nullif_strings": fn("nullif", s, t),
        "concat": fn("concat", N.lit("<"), s, N.lit("|"), t, N.lit(7)),
        "string_vs_date": N.BinaryOp(N.Op.LT, N.Literal("1995-01-01", Ty.STRING), day),
        "date_between_strings": N.Between(day, N.lit("1994-12-31"), N.lit("1995-06-01")),
        "round_decimal": fn("round", q),
        "round_decimal_1": fn("round", q, N.lit(1)),
        "round_decimal_0": fn("round", q, N.lit(0)),
        "round_int_digits": fn("round", n, N.lit(-1)),
        "round_float": fn("round", f),
        "round_float_2": fn("round", f, N.lit(2)),
        "string_column_vs_date": N.BinaryOp(N.Op.EQ, s, day),
        "cast_string_date": N.Cast(s, Ty.DATE32),
    }[case]


_ROW_CASES = ["upper", "lower", "trim", "abs_int", "abs_decimal", "ceil_decimal",
              "floor_decimal", "sign_int", "coalesce_ints",
              "coalesce_decimals", "coalesce_strings", "nullif_int",
              "nullif_strings", "concat"]
_TIE_CASES = ["string_vs_date", "date_between_strings", "round_decimal",
              "round_decimal_1", "round_decimal_0", "round_int_digits",
              "round_float", "round_float_2", "string_column_vs_date",
              "cast_string_date"]


@pytest.mark.parametrize("case", _ROW_CASES + _TIE_CASES)
def test_ported_functions_match_jax(case):
    """The TPC-DS function subset, string-to-date comparison and rounding
    (.5 ties of both signs) against the JAX package, slot by slot, exactly."""
    jrel, prel = _ties_pair() if case in _TIE_CASES else _rel_pair()
    got = PX.eval_expr(_ported_expr(E, T, case), prel)
    want = JX.eval_expr(_ported_expr(JE, JT, case), jrel)
    _same_column(got, want)
    assert (got.dictionary is None) == (want.dictionary is None)
    if want.dictionary is not None:
        assert list(got.dictionary.values) == list(want.dictionary.values)


# ---------------------------------------------------------------------------
# the TPC-H expression subset: LIKE, CASE, IN, extract, substring
# ---------------------------------------------------------------------------

_DATES = [-800_000, -719_468, -25_567, -366, -365, -1, 0, 59, 365, 11_016, 19_000, 2_932_896]
_ROWS = {
    "s": ["apple", "banana", None, "x%y", "xzy", "Apple", "a_b", "", "kiwi", "x\\y",
          "PROMO BRUSHED", "13-555"],
    "t": ["pear", "kiwi", "fig", None, "kiwi", "a", "b", "c", "pear", "d", "e", "31-1"],
    "d": [-12.34, 1.0, -0.99, 5.5, 0.0, 0.01, 0.99, 12.34, None, 3.0, -3.0, 7.77],
    "i": [-7, 3, None, 0, 5, -2, 7, 2, 1, 9, 4, -1],
    "day": _DATES,
}


def _rel_pair():
    def types(Ty):
        return {"d": Ty.decimal(12, 2), "day": Ty.DATE32, "i": Ty.INT64,
                "s": Ty.STRING, "t": Ty.STRING}
    return (JD.to_device(JTable.from_pydict(_ROWS, types(JT))),
            TD.to_device(PTable.from_pydict(_ROWS, types(T)), device="cpu"))


def _subset_expr(N, Ty, case):
    s, t, d, i, day = (N.Column(c) for c in ("s", "t", "d", "i", "day"))
    gt = N.BinaryOp(N.Op.GT, i, N.lit(1))
    year = N.ScalarFunction("extract", (N.Literal("year", Ty.STRING), day))
    return {
        "like_prefix": N.Like(s, N.lit("a%")),
        "like_infix": N.Like(s, N.lit("%an%")),
        "like_underscore": N.Like(s, N.lit("_i%")),
        "like_escape": N.Like(s, N.lit("x\\%y")),
        "like_literal_backslash": N.Like(s, N.lit("x\\\\y")),
        "not_like": N.Like(s, N.lit("PROMO%"), negated=True),
        "ilike": N.Like(s, N.lit("apple"), case_insensitive=True),
        "case_searched": N.Case(None, ((gt, N.lit(1)),), N.lit(0)),
        "case_no_else": N.Case(None, ((gt, d), (N.IsNull(i), N.lit(2.5))), None),
        "case_operand": N.Case(i, ((N.lit(3), N.lit("three")), (N.lit(7), s)),
                               N.lit("other")),
        "case_strings": N.Case(None, ((N.Like(s, N.lit("a%")), s),), t),
        "case_decimal": N.Case(None, ((N.Like(s, N.lit("PROMO%")), N.BinaryOp(
            N.Op.MUL, d, N.BinaryOp(N.Op.SUB, N.lit(1), d))),), N.lit(0)),
        "in_ints": N.InList(i, (N.lit(1), N.lit(3), N.lit(9))),
        "not_in_with_null": N.InList(i, (N.lit(1), N.Literal(None, Ty.INT64)), negated=True),
        "in_strings": N.InList(N.ScalarFunction("substring", (s, N.lit(1), N.lit(2))),
                               (N.lit("13"), N.lit("31"), N.lit("ap"))),
        "not_in_strings": N.InList(t, (N.lit("kiwi"), N.lit("zz")), negated=True),
        "extract_year": year,
        "extract_month": N.ScalarFunction("extract", (N.Literal("month", Ty.STRING), day)),
        "extract_day": N.ScalarFunction("date_part", (N.Literal("day", Ty.STRING), day)),
        "year_arith": N.BinaryOp(N.Op.SUB, year, N.lit(1)),
        "substring_from_for": N.ScalarFunction("substring", (s, N.lit(2), N.lit(3))),
        "substring_from": N.ScalarFunction("substr", (t, N.lit(2))),
        "substring_from_zero": N.ScalarFunction("substring", (s, N.lit(0), N.lit(3))),
    }[case]


@pytest.mark.parametrize("case", [
    "like_prefix", "like_infix", "like_underscore", "like_escape", "like_literal_backslash",
    "not_like", "ilike", "case_searched", "case_no_else", "case_operand", "case_strings",
    "case_decimal", "in_ints", "not_in_with_null", "in_strings", "not_in_strings",
    "extract_year", "extract_month", "extract_day", "year_arith", "substring_from_for",
    "substring_from", "substring_from_zero"])
def test_tpch_subset_matches_jax(case):
    """Each expression over one 12-row relation (NULLs, dates before 1970,
    LIKE metacharacters as data) against the JAX package: data, validity,
    bounds and the dictionary of string results."""
    jrel, prel = _rel_pair()
    got = PX.eval_expr(_subset_expr(E, T, case), prel)
    want = JX.eval_expr(_subset_expr(JE, JT, case), jrel)
    _same_column(got, want)
    assert (got.dictionary is None) == (want.dictionary is None)
    if want.dictionary is not None:
        assert list(got.dictionary.values) == list(want.dictionary.values)
    if got.dtype == T.BOOL:
        assert np.array_equal(PX.eval_predicate(_subset_expr(E, T, case), prel).numpy(),
                              np.asarray(JX.eval_predicate(_subset_expr(JE, JT, case), jrel)))

"""The port's expression compiler (datafusion_tpu_torch/physical/
expr_compiler.py) against the JAX package's, slot by slot with bounds: on
TPC-H Q1's and Q6's own expressions (each package plans the same SQL, and the
port evaluates over a relation rebuilt from the JAX scan's numpy leaves), and
on decimal/integer arithmetic with negative values."""
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


@pytest.mark.parametrize("what", ["like", "case", "in_list", "function", "string_cast"])
def test_unported_expressions_raise(what):
    rel = TD.to_device(PTable.from_pydict({"s": ["a", "b"], "x": [1, 2]}), device="cpu")
    gt = E.BinaryOp(E.Op.GT, E.Column("x"), E.lit(1))
    e = {
        "like": E.Like(E.Column("s"), E.lit("a%")),
        "case": E.Case(None, ((gt, E.lit(1)),), E.lit(0)),
        "in_list": E.InList(E.Column("x"), (E.lit(1), E.lit(2))),
        "function": E.ScalarFunction("abs", (E.Column("x"),)),
        "string_cast": E.Cast(E.Column("x"), T.STRING),
    }[what]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PX.eval_expr(e, rel)

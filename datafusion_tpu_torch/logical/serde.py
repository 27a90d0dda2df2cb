# Verbatim copy of datafusion_tpu/logical/serde.py; host-only, kept in step with the original.
"""Logical plan (de)serialization.

Capability analog of the reference's plan protobuf + substrait interchange
(datafusion/proto/src/logical_plan/, proto-models/proto/datafusion.proto;
substrait/src/logical_plan/{producer,consumer}): plans round-trip through a
JSON-able dict form so they can be shipped between processes/hosts (the
distributed layer cuts plans at exchange boundaries, parallel/distributed.py)
or persisted.  Table sources are serialized by name and re-bound against the
receiving catalog."""
from __future__ import annotations

import json
from typing import Any, Dict

from ..common import types as T
from ..common.errors import PlanError
from ..expr import nodes as E
from . import plan as L

# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------


def type_to_dict(t: T.DataType) -> Dict:
    d = {"kind": t.kind.value}
    if t.kind is T.TypeKind.DECIMAL:
        d["precision"] = t.precision
        d["scale"] = t.scale
    return d


def type_from_dict(d: Dict) -> T.DataType:
    kind = T.TypeKind(d["kind"])
    if kind is T.TypeKind.DECIMAL:
        return T.decimal(d["precision"], d["scale"])
    return T.DataType(kind)


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------


def expr_to_dict(e: E.Expr) -> Dict:
    if isinstance(e, E.Column):
        return {"t": "col", "name": e.cname, "q": e.qualifier}
    if isinstance(e, E.Literal):
        return {"t": "lit", "v": e.value, "dt": type_to_dict(e.dtype)}
    if isinstance(e, E.BinaryOp):
        return {"t": "bin", "op": e.op.name,
                "l": expr_to_dict(e.left), "r": expr_to_dict(e.right)}
    if isinstance(e, E.Not):
        return {"t": "not", "e": expr_to_dict(e.expr)}
    if isinstance(e, E.Negative):
        return {"t": "neg", "e": expr_to_dict(e.expr)}
    if isinstance(e, E.IsNull):
        return {"t": "isnull", "e": expr_to_dict(e.expr)}
    if isinstance(e, E.Cast):
        return {"t": "cast", "e": expr_to_dict(e.expr), "dt": type_to_dict(e.dtype),
                "safe": e.safe}
    if isinstance(e, E.Case):
        return {"t": "case",
                "operand": expr_to_dict(e.operand) if e.operand else None,
                "branches": [[expr_to_dict(w), expr_to_dict(th)] for w, th in e.branches],
                "else": expr_to_dict(e.else_expr) if e.else_expr else None}
    if isinstance(e, E.InList):
        return {"t": "inlist", "e": expr_to_dict(e.expr),
                "vals": [expr_to_dict(v) for v in e.values], "neg": e.negated}
    if isinstance(e, E.Between):
        return {"t": "between", "e": expr_to_dict(e.expr),
                "lo": expr_to_dict(e.low), "hi": expr_to_dict(e.high), "neg": e.negated}
    if isinstance(e, E.Like):
        return {"t": "like", "e": expr_to_dict(e.expr), "p": expr_to_dict(e.pattern),
                "neg": e.negated, "ci": e.case_insensitive}
    if isinstance(e, E.ScalarFunction):
        return {"t": "fn", "name": e.fname, "args": [expr_to_dict(a) for a in e.args]}
    if isinstance(e, E.AggregateFunction):
        return {"t": "agg", "name": e.fname, "args": [expr_to_dict(a) for a in e.args],
                "distinct": e.distinct,
                "filter": expr_to_dict(e.filter) if e.filter else None}
    if isinstance(e, E.WindowFunction):
        out = {"t": "win", "name": e.fname, "args": [expr_to_dict(a) for a in e.args],
               "pb": [expr_to_dict(p) for p in e.partition_by],
               "ob": [sortspec_to_dict(s) for s in e.order_by]}
        if e.filter is not None:
            out["filter"] = expr_to_dict(e.filter)
        if e.frame is not None:
            out["frame"] = [e.frame.units, e.frame.start_kind, e.frame.start_offset,
                            e.frame.end_kind, e.frame.end_offset]
        return out
    if isinstance(e, E.Alias):
        out = {"t": "alias", "e": expr_to_dict(e.expr), "name": e.aname}
        if e.qualifier is not None:
            out["q"] = e.qualifier
        return out
    if isinstance(e, E.SortSpec):
        return sortspec_to_dict(e)
    raise PlanError(f"cannot serialize expr {type(e).__name__}")


def sortspec_to_dict(s: E.SortSpec) -> Dict:
    return {"t": "sort", "e": expr_to_dict(s.expr), "asc": s.asc, "nf": s.nulls_first}


def expr_from_dict(d: Dict) -> E.Expr:
    t = d["t"]
    if t == "col":
        return E.Column(d["name"], d.get("q"))
    if t == "lit":
        return E.Literal(d["v"], type_from_dict(d["dt"]))
    if t == "bin":
        return E.BinaryOp(E.Op[d["op"]], expr_from_dict(d["l"]), expr_from_dict(d["r"]))
    if t == "not":
        return E.Not(expr_from_dict(d["e"]))
    if t == "neg":
        return E.Negative(expr_from_dict(d["e"]))
    if t == "isnull":
        return E.IsNull(expr_from_dict(d["e"]))
    if t == "cast":
        return E.Cast(expr_from_dict(d["e"]), type_from_dict(d["dt"]), d["safe"])
    if t == "case":
        return E.Case(
            expr_from_dict(d["operand"]) if d["operand"] else None,
            tuple((expr_from_dict(w), expr_from_dict(th)) for w, th in d["branches"]),
            expr_from_dict(d["else"]) if d["else"] else None,
        )
    if t == "inlist":
        return E.InList(expr_from_dict(d["e"]),
                        tuple(expr_from_dict(v) for v in d["vals"]), d["neg"])
    if t == "between":
        return E.Between(expr_from_dict(d["e"]), expr_from_dict(d["lo"]),
                         expr_from_dict(d["hi"]), d["neg"])
    if t == "like":
        return E.Like(expr_from_dict(d["e"]), expr_from_dict(d["p"]), d["neg"], d["ci"])
    if t == "fn":
        return E.ScalarFunction(d["name"], tuple(expr_from_dict(a) for a in d["args"]))
    if t == "agg":
        return E.AggregateFunction(
            d["name"], tuple(expr_from_dict(a) for a in d["args"]), d["distinct"],
            expr_from_dict(d["filter"]) if d["filter"] else None)
    if t == "win":
        fr = d.get("frame")
        return E.WindowFunction(
            d["name"], tuple(expr_from_dict(a) for a in d["args"]),
            tuple(expr_from_dict(p) for p in d["pb"]),
            tuple(expr_from_dict(s) for s in d["ob"]),
            E.WindowFrame(*fr) if fr else None,
            expr_from_dict(d["filter"]) if d.get("filter") else None)
    if t == "alias":
        return E.Alias(expr_from_dict(d["e"]), d["name"], d.get("q"))
    if t == "sort":
        return E.SortSpec(expr_from_dict(d["e"]), d["asc"], d["nf"])
    raise PlanError(f"cannot deserialize expr tag {t!r}")


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def plan_to_dict(p: L.LogicalPlan) -> Dict:
    if isinstance(p, L.TableScan):
        return {"t": "scan", "name": p.name, "alias": p.alias,
                "projection": p.projection,
                "filters": [expr_to_dict(f) for f in p.filters]}
    if isinstance(p, L.Projection):
        return {"t": "proj", "input": plan_to_dict(p.input),
                "exprs": [expr_to_dict(e) for e in p.proj_exprs]}
    if isinstance(p, L.Filter):
        return {"t": "filter", "input": plan_to_dict(p.input),
                "pred": expr_to_dict(p.predicate)}
    if isinstance(p, L.Aggregate):
        return {"t": "agg", "input": plan_to_dict(p.input),
                "groups": [expr_to_dict(e) for e in p.group_exprs],
                "aggs": [expr_to_dict(e) for e in p.aggr_exprs]}
    if isinstance(p, L.Sort):
        return {"t": "sort", "input": plan_to_dict(p.input),
                "specs": [sortspec_to_dict(s) for s in p.sort_specs], "fetch": p.fetch}
    if isinstance(p, L.Limit):
        return {"t": "limit", "input": plan_to_dict(p.input),
                "skip": p.skip, "fetch": p.fetch}
    if isinstance(p, L.Join):
        return {"t": "join", "left": plan_to_dict(p.left), "right": plan_to_dict(p.right),
                "on": [[expr_to_dict(l), expr_to_dict(r)] for l, r in p.on],
                "jt": p.join_type.value,
                "filter": expr_to_dict(p.filter) if p.filter else None}
    if isinstance(p, L.SubqueryAlias):
        return {"t": "alias", "input": plan_to_dict(p.input), "name": p.alias}
    if isinstance(p, L.Distinct):
        return {"t": "distinct", "input": plan_to_dict(p.input)}
    if isinstance(p, L.Union):
        return {"t": "union", "inputs": [plan_to_dict(i) for i in p.inputs], "all": p.all}
    if isinstance(p, L.Window):
        return {"t": "window", "input": plan_to_dict(p.input),
                "exprs": [expr_to_dict(e) for e in p.window_exprs]}
    if isinstance(p, L.EmptyRelation):
        return {"t": "empty", "one_row": p.produce_one_row}
    raise PlanError(f"cannot serialize plan {type(p).__name__}")


def plan_from_dict(d: Dict, catalog) -> L.LogicalPlan:
    t = d["t"]
    if t == "scan":
        provider = catalog.get(d["name"])
        return L.TableScan(d["name"], provider, d.get("projection"),
                           [expr_from_dict(f) for f in d.get("filters", [])],
                           d.get("alias"))
    if t == "proj":
        return L.Projection(plan_from_dict(d["input"], catalog),
                            [expr_from_dict(e) for e in d["exprs"]])
    if t == "filter":
        return L.Filter(plan_from_dict(d["input"], catalog), expr_from_dict(d["pred"]))
    if t == "agg":
        return L.Aggregate(plan_from_dict(d["input"], catalog),
                           [expr_from_dict(e) for e in d["groups"]],
                           [expr_from_dict(e) for e in d["aggs"]])
    if t == "sort":
        return L.Sort(plan_from_dict(d["input"], catalog),
                      [expr_from_dict(s) for s in d["specs"]], d.get("fetch"))
    if t == "limit":
        return L.Limit(plan_from_dict(d["input"], catalog), d["skip"], d["fetch"])
    if t == "join":
        return L.Join(plan_from_dict(d["left"], catalog),
                      plan_from_dict(d["right"], catalog),
                      [(expr_from_dict(l), expr_from_dict(r)) for l, r in d["on"]],
                      L.JoinType(d["jt"]),
                      expr_from_dict(d["filter"]) if d["filter"] else None)
    if t == "alias":
        return L.SubqueryAlias(plan_from_dict(d["input"], catalog), d["name"])
    if t == "distinct":
        return L.Distinct(plan_from_dict(d["input"], catalog))
    if t == "union":
        return L.Union([plan_from_dict(i, catalog) for i in d["inputs"]], d["all"])
    if t == "window":
        return L.Window(plan_from_dict(d["input"], catalog),
                        [expr_from_dict(e) for e in d["exprs"]])
    if t == "empty":
        return L.EmptyRelation(d["one_row"])
    raise PlanError(f"cannot deserialize plan tag {t!r}")


def plan_to_json(p: L.LogicalPlan) -> str:
    return json.dumps(plan_to_dict(p))


def plan_from_json(s: str, catalog) -> L.LogicalPlan:
    return plan_from_dict(json.loads(s), catalog)

# Verbatim copy of datafusion_tpu/interchange/substrait.py; host-only, kept in step with the original.
"""Substrait logical-plan producer/consumer (protobuf-JSON form).

Capability analog of the reference's substrait crate
(datafusion/substrait/src/logical_plan/{producer.rs,consumer.rs}): plans
serialize to the engine-neutral Substrait IR so they can be exchanged with
other engines, and Substrait plans produced elsewhere execute here. We speak
the canonical proto3-JSON serialization of `substrait.Plan` (the `.proto`
schema at substrait.io; int64 values are JSON strings, oneof fields appear as
camelCase members) rather than binary protobuf, so no protobuf runtime is
needed and documents are human-auditable.

Coverage: ReadRel (named tables, projection, filter), ProjectRel (+emit),
FilterRel, AggregateRel (groupings, measures, DISTINCT, FILTER), SortRel,
FetchRel, JoinRel (equi-pair extraction from the condition + residual
filter), CrossRel, SetRel (UNION [ALL]); expressions: field references,
literals (bool/int/float/string/date/timestamp/decimal/null), scalar
functions from the standard extension YAMLs, CAST, CASE (IfThen),
IN (SingularOrList), BETWEEN, LIKE, window functions.
"""
from __future__ import annotations

import base64
import decimal
from typing import Dict, List, Optional, Sequence, Tuple

from ..common import types as T
from ..common.errors import PlanError
from ..common.schema import Field, Schema
from ..expr import nodes as E
from ..logical import plan as L

# ---------------------------------------------------------------------------
# standard extension URIs (the substrait-io/substrait extension YAMLs)
# ---------------------------------------------------------------------------

_URI_BASE = "https://github.com/substrait-io/substrait/blob/main/extensions/"
_FN_URI = {
    "arithmetic": _URI_BASE + "functions_arithmetic.yaml",
    "comparison": _URI_BASE + "functions_comparison.yaml",
    "boolean": _URI_BASE + "functions_boolean.yaml",
    "string": _URI_BASE + "functions_string.yaml",
    "datetime": _URI_BASE + "functions_datetime.yaml",
    "aggregate": _URI_BASE + "functions_aggregate_generic.yaml",
    "rounding": _URI_BASE + "functions_rounding.yaml",
}

# binary op -> (substrait base name, yaml category)
_OP_FN = {
    E.Op.ADD: ("add", "arithmetic"),
    E.Op.SUB: ("subtract", "arithmetic"),
    E.Op.MUL: ("multiply", "arithmetic"),
    E.Op.DIV: ("divide", "arithmetic"),
    E.Op.MOD: ("modulus", "arithmetic"),
    E.Op.EQ: ("equal", "comparison"),
    E.Op.NEQ: ("not_equal", "comparison"),
    E.Op.LT: ("lt", "comparison"),
    E.Op.LE: ("lte", "comparison"),
    E.Op.GT: ("gt", "comparison"),
    E.Op.GE: ("gte", "comparison"),
    E.Op.AND: ("and", "boolean"),
    E.Op.OR: ("or", "boolean"),
}
_FN_OP = {name: op for op, (name, _) in _OP_FN.items()}

# aggregate base names shared with the standard YAMLs; anything else passes
# through by name (substrait allows engine extensions via the same mechanism)
_AGG_CATEGORY = {
    "count": "aggregate", "any_value": "aggregate",
    "sum": "arithmetic", "avg": "arithmetic", "min": "arithmetic",
    "max": "arithmetic", "median": "arithmetic",
    "stddev": "arithmetic", "stddev_samp": "arithmetic",
    "stddev_pop": "arithmetic", "var_samp": "arithmetic",
    "var_pop": "arithmetic", "corr": "arithmetic",
}

_SORT_DIR = {
    (True, True): "SORT_DIRECTION_ASC_NULLS_FIRST",
    (True, False): "SORT_DIRECTION_ASC_NULLS_LAST",
    (False, True): "SORT_DIRECTION_DESC_NULLS_FIRST",
    (False, False): "SORT_DIRECTION_DESC_NULLS_LAST",
}
_DIR_SORT = {v: k for k, v in _SORT_DIR.items()}

_JOIN_TYPE = {
    L.JoinType.INNER: "JOIN_TYPE_INNER",
    L.JoinType.LEFT: "JOIN_TYPE_LEFT",
    L.JoinType.RIGHT: "JOIN_TYPE_RIGHT",
    L.JoinType.FULL: "JOIN_TYPE_OUTER",
    L.JoinType.LEFT_SEMI: "JOIN_TYPE_LEFT_SEMI",
    L.JoinType.LEFT_ANTI: "JOIN_TYPE_LEFT_ANTI",
    L.JoinType.RIGHT_SEMI: "JOIN_TYPE_RIGHT_SEMI",
    L.JoinType.RIGHT_ANTI: "JOIN_TYPE_RIGHT_ANTI",
}
_TYPE_JOIN = {v: k for k, v in _JOIN_TYPE.items()}


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------


def _nullability(nullable: bool) -> str:
    return "NULLABILITY_NULLABLE" if nullable else "NULLABILITY_REQUIRED"


def type_to_substrait(t: T.DataType, nullable: bool = True) -> Dict:
    n = {"nullability": _nullability(nullable)}
    k = t.kind
    if k is T.TypeKind.BOOL:
        return {"bool": n}
    if k is T.TypeKind.INT8:
        return {"i8": n}
    if k is T.TypeKind.INT16:
        return {"i16": n}
    if k is T.TypeKind.INT32:
        return {"i32": n}
    if k is T.TypeKind.INT64:
        return {"i64": n}
    if k is T.TypeKind.FLOAT32:
        return {"fp32": n}
    if k is T.TypeKind.FLOAT64:
        return {"fp64": n}
    if k is T.TypeKind.STRING:
        return {"string": n}
    if k is T.TypeKind.DATE32:
        return {"date": n}
    if k is T.TypeKind.TIMESTAMP:
        return {"timestamp": n}
    if k is T.TypeKind.DECIMAL:
        return {"decimal": {"precision": t.precision, "scale": t.scale, **n}}
    if k is T.TypeKind.INTERVAL_DAYS:
        return {"intervalDay": n}
    if k is T.TypeKind.INTERVAL_MONTHS:
        return {"intervalYear": n}
    if k is T.TypeKind.NULL:
        return {"i64": {"nullability": "NULLABILITY_NULLABLE"}}
    raise PlanError(f"cannot map type {t} to substrait")


def type_from_substrait(d: Dict) -> Tuple[T.DataType, bool]:
    (tag, body), = d.items()
    nullable = (body or {}).get("nullability", "") != "NULLABILITY_REQUIRED"
    simple = {
        "bool": T.BOOL, "i8": T.INT8, "i16": T.INT16, "i32": T.INT32,
        "i64": T.INT64, "fp32": T.FLOAT32, "fp64": T.FLOAT64,
        "string": T.STRING, "varchar": T.STRING, "fixedChar": T.STRING,
        "date": T.DATE32, "timestamp": T.TIMESTAMP,
        "precisionTimestamp": T.TIMESTAMP,
        "intervalDay": T.INTERVAL_DAYS, "intervalYear": T.INTERVAL_MONTHS,
    }
    if tag in simple:
        return simple[tag], nullable
    if tag == "decimal":
        return T.decimal(int(body.get("precision", 38)),
                         int(body.get("scale", 0))), nullable
    raise PlanError(f"cannot map substrait type {tag!r}")


# ---------------------------------------------------------------------------
# producer
# ---------------------------------------------------------------------------


class _Registry:
    """Collects extension-function declarations; one anchor per compound
    name (substrait: extensionUris + extension_function declarations)."""

    def __init__(self):
        self.uris: Dict[str, int] = {}
        self.fns: Dict[str, int] = {}
        self.decls: List[Dict] = []

    def uri(self, category: str) -> int:
        u = _FN_URI.get(category, _FN_URI["string"])
        if u not in self.uris:
            self.uris[u] = len(self.uris) + 1
        return self.uris[u]

    def fn(self, compound: str, category: str) -> int:
        if compound not in self.fns:
            anchor = len(self.fns) + 1
            self.fns[compound] = anchor
            self.decls.append({"extensionFunction": {
                "extensionUriReference": self.uri(category),
                "functionAnchor": anchor,
                "name": compound,
            }})
        return self.fns[compound]


def _sig(dtypes: Sequence[T.DataType]) -> str:
    def one(t: T.DataType) -> str:
        k = t.kind
        m = {T.TypeKind.BOOL: "bool", T.TypeKind.INT8: "i8",
             T.TypeKind.INT16: "i16", T.TypeKind.INT32: "i32",
             T.TypeKind.INT64: "i64", T.TypeKind.FLOAT32: "fp32",
             T.TypeKind.FLOAT64: "fp64", T.TypeKind.STRING: "str",
             T.TypeKind.DATE32: "date", T.TypeKind.TIMESTAMP: "ts",
             T.TypeKind.DECIMAL: "dec"}
        return m.get(k, "any")

    return "_".join(one(t) for t in dtypes) or "any"


class _Producer:
    def __init__(self):
        self.reg = _Registry()

    # -- expressions ------------------------------------------------------
    def expr(self, e: E.Expr, schema: Schema) -> Dict:
        from ..expr.typing import infer

        if isinstance(e, E.Alias):  # names live in RelRoot / emit order
            return self.expr(e.expr, schema)
        if isinstance(e, E.Column):
            idx = schema.index_of(e.flat_name)
            return {"selection": {"directReference": {"structField": {"field": idx}},
                                  "rootReference": {}}}
        if isinstance(e, E.Literal):
            return {"literal": self.literal(e)}
        if isinstance(e, E.BinaryOp):
            name, cat = _OP_FN[e.op]
            return self.call(name, cat, [e.left, e.right], e, schema)
        if isinstance(e, E.Not):
            return self.call("not", "boolean", [e.expr], e, schema)
        if isinstance(e, E.Negative):
            return self.call("negate", "arithmetic", [e.expr], e, schema)
        if isinstance(e, E.IsNull):
            return self.call("is_null", "comparison", [e.expr], e, schema)
        if isinstance(e, E.Cast):
            dt, nullable = infer(e.expr, schema)
            behavior = ("FAILURE_BEHAVIOR_RETURN_NULL" if e.safe
                        else "FAILURE_BEHAVIOR_THROW_EXCEPTION")
            return {"cast": {"type": type_to_substrait(e.dtype, True),
                             "input": self.expr(e.expr, schema),
                             "failureBehavior": behavior}}
        if isinstance(e, E.Case):
            ifs = []
            for w, th in e.branches:
                cond = (w if e.operand is None
                        else E.BinaryOp(E.Op.EQ, e.operand, w))
                ifs.append({"if": self.expr(cond, schema),
                            "then": self.expr(th, schema)})
            out = {"ifs": ifs}
            if e.else_expr is not None:
                out["else"] = self.expr(e.else_expr, schema)
            return {"ifThen": out}
        if isinstance(e, E.InList):
            inner = {"singularOrList": {
                "value": self.expr(e.expr, schema),
                "options": [self.expr(v, schema) for v in e.values]}}
            if e.negated:
                return self.call_raw("not", "boolean", [inner], T.BOOL)
            return inner
        if isinstance(e, E.Between):
            lo = E.BinaryOp(E.Op.GE, e.expr, e.low)
            hi = E.BinaryOp(E.Op.LE, e.expr, e.high)
            out = E.BinaryOp(E.Op.AND, lo, hi)
            if e.negated:
                out = E.Not(out)
            return self.expr(out, schema)
        if isinstance(e, E.Like):
            name = "ilike" if e.case_insensitive else "like"
            inner = self.call(name, "string", [e.expr, e.pattern], e, schema)
            if e.negated:
                return self.call_raw("not", "boolean", [inner], T.BOOL)
            return inner
        if isinstance(e, E.ScalarFunction):
            return self.call(e.fname, "string", list(e.args), e, schema)
        if isinstance(e, E.WindowFunction):
            return self.window(e, schema)
        raise PlanError(f"cannot produce substrait for expr {type(e).__name__}")

    def call(self, name: str, category: str, args: List[E.Expr],
             e: E.Expr, schema: Schema) -> Dict:
        from ..expr.typing import infer

        dtypes = [infer(a, schema)[0] for a in args]
        out_dt, out_nullable = infer(e, schema)
        return {"scalarFunction": {
            "functionReference": self.reg.fn(f"{name}:{_sig(dtypes)}", category),
            "outputType": type_to_substrait(out_dt, out_nullable),
            "arguments": [{"value": self.expr(a, schema)} for a in args],
        }}

    def call_raw(self, name: str, category: str, args: List[Dict],
                 out_dt: T.DataType) -> Dict:
        return {"scalarFunction": {
            "functionReference": self.reg.fn(f"{name}:any", category),
            "outputType": type_to_substrait(out_dt, True),
            "arguments": [{"value": a} for a in args],
        }}

    def literal(self, e: E.Literal) -> Dict:
        v, k = e.value, e.dtype.kind
        if v is None:
            return {"null": type_to_substrait(e.dtype, True)}
        if k is T.TypeKind.BOOL:
            return {"boolean": bool(v)}
        if k in (T.TypeKind.INT8, T.TypeKind.INT16):
            return {("i8" if k is T.TypeKind.INT8 else "i16"): int(v)}
        if k is T.TypeKind.INT32:
            return {"i32": int(v)}
        if k is T.TypeKind.INT64:
            return {"i64": str(int(v))}  # proto3 JSON: int64 as string
        if k is T.TypeKind.FLOAT32:
            return {"fp32": float(v)}
        if k is T.TypeKind.FLOAT64:
            return {"fp64": float(v)}
        if k is T.TypeKind.STRING:
            return {"string": str(v)}
        if k is T.TypeKind.DATE32:
            return {"date": int(v)}
        if k is T.TypeKind.TIMESTAMP:
            return {"timestamp": str(int(v))}
        if k is T.TypeKind.DECIMAL:
            scaled = int(round(decimal.Decimal(str(v)) * (10 ** e.dtype.scale)))
            raw = scaled.to_bytes(16, "little", signed=True)
            return {"decimal": {"value": base64.b64encode(raw).decode(),
                                "precision": e.dtype.precision,
                                "scale": e.dtype.scale}}
        if k is T.TypeKind.INTERVAL_DAYS:
            return {"intervalDayToSecond": {"days": int(v)}}
        if k is T.TypeKind.INTERVAL_MONTHS:
            return {"intervalYearToMonth": {"months": int(v)}}
        raise PlanError(f"cannot produce substrait literal of {e.dtype}")

    def window(self, e: E.WindowFunction, schema: Schema) -> Dict:
        from ..expr.typing import infer

        dtypes = [infer(a, schema)[0] for a in e.args]
        out_dt, out_nullable = infer(e, schema)
        out = {
            "functionReference": self.reg.fn(f"{e.fname}:{_sig(dtypes)}",
                                             "aggregate"),
            "arguments": [{"value": self.expr(a, schema)} for a in e.args],
            "outputType": type_to_substrait(out_dt, out_nullable),
            "partitions": [self.expr(p, schema) for p in e.partition_by],
            "sorts": [{"expr": self.expr(s.expr, schema),
                       "direction": _SORT_DIR[(s.asc, s.nulls_first)]}
                      for s in e.order_by],
        }
        if e.frame is not None:
            out["boundsType"] = {"rows": "BOUNDS_TYPE_ROWS",
                                 "range": "BOUNDS_TYPE_RANGE",
                                 "groups": "BOUNDS_TYPE_ROWS"}[e.frame.units]

            def bound(kind, off):
                if kind == "unbounded_preceding":
                    return {"unbounded": {}}
                if kind == "unbounded_following":
                    return {"unbounded": {}}
                if kind == "current_row":
                    return {"currentRow": {}}
                if kind == "preceding":
                    return {"preceding": {"offset": str(int(off))}}
                return {"following": {"offset": str(int(off))}}

            out["lowerBound"] = bound(e.frame.start_kind, e.frame.start_offset)
            out["upperBound"] = bound(e.frame.end_kind, e.frame.end_offset)
        return {"windowFunction": out}

    # -- relations --------------------------------------------------------
    def rel(self, p: L.LogicalPlan) -> Dict:
        if isinstance(p, L.TableScan):
            base = p.source.schema()
            names = [f.name for f in base.fields]
            struct = {"types": [type_to_substrait(f.dtype, f.nullable)
                                for f in base.fields],
                      "nullability": "NULLABILITY_REQUIRED"}
            read = {"common": {"direct": {}},
                    "baseSchema": {"names": names, "struct": struct},
                    "namedTable": {"names": [p.name]}}
            scan_schema = base.with_qualifier(p.alias)
            if p.filters:
                pred = p.filters[0]
                for f in p.filters[1:]:
                    pred = E.BinaryOp(E.Op.AND, pred, f)
                read["filter"] = self.expr(pred, scan_schema)
            if p.projection is not None:
                items = [{"field": scan_schema.index_of(c)} for c in p.projection]
                read["projection"] = {"select": {"structItems": items},
                                      "maintainSingularStruct": True}
            return {"read": read}
        if isinstance(p, L.Projection):
            win = [e for e in p.proj_exprs if E.contains_window(e)]
            if win:
                raise PlanError("window exprs must sit under a Window node")
            n_in = len(p.input.schema)
            return {"project": {
                "common": {"emit": {"outputMapping":
                                    [n_in + i for i in range(len(p.proj_exprs))]}},
                "input": self.rel(p.input),
                "expressions": [self.expr(e, p.input.schema)
                                for e in p.proj_exprs]}}
        if isinstance(p, L.Window):
            n_in = len(p.input.schema)
            return {"project": {
                "common": {"emit": {"outputMapping": list(range(
                    n_in + len(p.window_exprs)))}},
                "input": self.rel(p.input),
                "expressions": [self.expr(e, p.input.schema)
                                for e in p.window_exprs]}}
        if isinstance(p, L.Filter):
            return {"filter": {"input": self.rel(p.input),
                               "condition": self.expr(p.predicate, p.input.schema)}}
        if isinstance(p, L.Aggregate):
            from ..expr.typing import infer

            measures = []
            for a in p.aggr_exprs:
                agg = a.expr if isinstance(a, E.Alias) else a
                if not isinstance(agg, E.AggregateFunction):
                    raise PlanError("aggregate exprs must be aggregate calls")
                dtypes = [infer(x, p.input.schema)[0] for x in agg.args]
                out_dt, out_nullable = infer(agg, p.input.schema)
                cat = _AGG_CATEGORY.get(agg.fname, "aggregate")
                m = {"functionReference": self.reg.fn(
                        f"{agg.fname}:{_sig(dtypes)}", cat),
                     "arguments": [{"value": self.expr(x, p.input.schema)}
                                   for x in agg.args],
                     "outputType": type_to_substrait(out_dt, out_nullable),
                     "phase": "AGGREGATION_PHASE_INITIAL_TO_RESULT",
                     "invocation": ("AGGREGATION_INVOCATION_DISTINCT"
                                    if agg.distinct
                                    else "AGGREGATION_INVOCATION_ALL")}
                entry = {"measure": m}
                if agg.filter is not None:
                    entry["filter"] = self.expr(agg.filter, p.input.schema)
                measures.append(entry)
            return {"aggregate": {
                "input": self.rel(p.input),
                "groupings": [{"groupingExpressions":
                               [self.expr(g, p.input.schema)
                                for g in p.group_exprs]}],
                "measures": measures}}
        if isinstance(p, L.Sort):
            out = {"sort": {"input": self.rel(p.input),
                            "sorts": [{"expr": self.expr(s.expr, p.input.schema),
                                       "direction": _SORT_DIR[(s.asc, s.nulls_first)]}
                                      for s in p.sort_specs]}}
            if p.fetch is not None:
                return {"fetch": {"input": out, "offset": "0",
                                  "count": str(p.fetch)}}
            return out
        if isinstance(p, L.Limit):
            return {"fetch": {"input": self.rel(p.input),
                              "offset": str(p.skip),
                              "count": str(-1 if p.fetch is None else p.fetch)}}
        if isinstance(p, L.Join):
            if p.join_type is L.JoinType.CROSS:
                out = {"cross": {"left": self.rel(p.left),
                                 "right": self.rel(p.right)}}
                if p.filter is not None:
                    both = p.left.schema.join(p.right.schema)
                    return {"filter": {"input": out,
                                       "condition": self.expr(p.filter, both)}}
                return out
            both = p.left.schema.join(p.right.schema)
            cond: Optional[E.Expr] = None
            for l, r in p.on:
                eq = E.BinaryOp(E.Op.EQ, l, r)
                cond = eq if cond is None else E.BinaryOp(E.Op.AND, cond, eq)
            if p.filter is not None:
                cond = p.filter if cond is None else E.BinaryOp(
                    E.Op.AND, cond, p.filter)
            join = {"left": self.rel(p.left), "right": self.rel(p.right),
                    "type": _JOIN_TYPE[p.join_type]}
            if cond is not None:
                join["expression"] = self._join_cond(cond, p)
            return {"join": join}
        if isinstance(p, L.SubqueryAlias):
            return self.rel(p.input)  # names carry via RelRoot / references
        if isinstance(p, L.Distinct):
            n = len(p.input.schema)
            return {"aggregate": {
                "input": self.rel(p.input),
                "groupings": [{"groupingExpressions": [
                    {"selection": {"directReference": {"structField": {"field": i}},
                                   "rootReference": {}}} for i in range(n)]}],
                "measures": []}}
        if isinstance(p, L.Union):
            return {"set": {"inputs": [self.rel(i) for i in p.inputs],
                            "op": ("SET_OP_UNION_ALL" if p.all
                                   else "SET_OP_UNION_DISTINCT")}}
        if isinstance(p, L.EmptyRelation):
            vt = {"values": [{}]} if p.produce_one_row else {}
            return {"read": {"common": {"direct": {}},
                             "baseSchema": {"names": [], "struct": {"types": []}},
                             "virtualTable": vt}}
        if isinstance(p, L.Values):
            rows = []
            for row in p.rows:
                rows.append({"fields": [self.literal(v) for v in row]})
            struct = {"types": [type_to_substrait(f.dtype, f.nullable)
                                for f in p.schema.fields],
                      "nullability": "NULLABILITY_REQUIRED"}
            return {"read": {"common": {"direct": {}},
                             "baseSchema": {"names": [f.name for f in p.schema.fields],
                                            "struct": struct},
                             "virtualTable": {"values": rows}}}
        raise PlanError(f"cannot produce substrait for {type(p).__name__}")

    def _join_cond(self, cond: E.Expr, p: L.Join) -> Dict:
        """Join conditions reference the CONCATENATED (left ++ right) schema;
        right-side field indices shift by len(left)."""
        both = p.left.schema.join(p.right.schema)
        return self.expr(cond, both)


def plan_to_substrait(plan: L.LogicalPlan) -> Dict:
    """LogicalPlan -> substrait.Plan (proto3-JSON dict)."""
    prod = _Producer()
    body = prod.rel(plan)
    uris = [{"extensionUriAnchor": a, "uri": u}
            for u, a in sorted(prod.reg.uris.items(), key=lambda kv: kv[1])]
    return {
        "version": {"minorNumber": 53, "producer": "datafusion-tpu"},
        "extensionUris": uris,
        "extensions": prod.reg.decls,
        "relations": [{"root": {
            "input": body,
            "names": [f.name for f in plan.schema.fields],
        }}],
    }


# ---------------------------------------------------------------------------
# consumer
# ---------------------------------------------------------------------------


class _Consumer:
    def __init__(self, doc: Dict, catalog):
        self.catalog = catalog
        self._alias_seq = 0
        self.fns: Dict[int, str] = {}
        for ext in doc.get("extensions", []):
            f = ext.get("extensionFunction")
            if f:
                name = f.get("name", "")
                self.fns[int(f.get("functionAnchor", 0))] = name.split(":")[0]

    # -- expressions ------------------------------------------------------
    def expr(self, d: Dict, schema: Schema) -> E.Expr:
        if "selection" in d:
            sel = d["selection"]
            ref = sel.get("directReference", {}).get("structField", {})
            idx = int(ref.get("field", 0))
            if idx >= len(schema.fields):
                raise PlanError(f"substrait field reference {idx} out of "
                                f"range for schema of {len(schema.fields)}")
            f = schema.fields[idx]
            return E.Column(f.name, f.qualifier)
        if "literal" in d:
            return self.literal(d["literal"])
        if "scalarFunction" in d:
            return self.scalar_fn(d["scalarFunction"], schema)
        if "cast" in d:
            c = d["cast"]
            dt, _ = type_from_substrait(c["type"])
            safe = c.get("failureBehavior") == "FAILURE_BEHAVIOR_RETURN_NULL"
            return E.Cast(self.expr(c["input"], schema), dt, safe)
        if "ifThen" in d:
            c = d["ifThen"]
            branches = tuple((self.expr(b["if"], schema),
                              self.expr(b["then"], schema)) for b in c["ifs"])
            els = self.expr(c["else"], schema) if "else" in c else None
            return E.Case(None, branches, els)
        if "singularOrList" in d:
            c = d["singularOrList"]
            return E.InList(self.expr(c["value"], schema),
                            tuple(self.expr(o, schema)
                                  for o in c.get("options", [])))
        if "windowFunction" in d:
            return self.window_fn(d["windowFunction"], schema)
        raise PlanError(f"cannot consume substrait expression {list(d)!r}")

    def scalar_fn(self, d: Dict, schema: Schema) -> E.Expr:
        name = self.fns.get(int(d.get("functionReference", 0)), "")
        args = [self.expr(a["value"], schema) for a in d.get("arguments", [])
                if "value" in a]
        if name in _FN_OP and len(args) >= 2:
            out = E.BinaryOp(_FN_OP[name], args[0], args[1])
            for a in args[2:]:  # variadic and/or
                out = E.BinaryOp(_FN_OP[name], out, a)
            return out
        if name == "not":
            return E.Not(args[0])
        if name == "negate":
            return E.Negative(args[0])
        if name == "is_null":
            return E.IsNull(args[0])
        if name == "is_not_null":
            return E.Not(E.IsNull(args[0]))
        if name in ("like", "ilike"):
            return E.Like(args[0], args[1], False, name == "ilike")
        if name == "between" and len(args) == 3:
            return E.Between(args[0], args[1], args[2])
        if not name:
            raise PlanError("substrait scalar function without a declared "
                            "extension name")
        return E.ScalarFunction(name, tuple(args))

    def window_fn(self, d: Dict, schema: Schema) -> E.WindowFunction:
        name = self.fns.get(int(d.get("functionReference", 0)), "")
        args = tuple(self.expr(a["value"], schema)
                     for a in d.get("arguments", []) if "value" in a)
        parts = tuple(self.expr(p, schema) for p in d.get("partitions", []))
        sorts = tuple(self.sort(s, schema) for s in d.get("sorts", []))
        frame = None
        if "lowerBound" in d or "upperBound" in d:
            units = ("range" if d.get("boundsType") == "BOUNDS_TYPE_RANGE"
                     else "rows")

            def bound(b, default_kind, unbounded_kind):
                if b is None:
                    return default_kind, None
                if "unbounded" in b:
                    return unbounded_kind, None
                if "currentRow" in b:
                    return "current_row", None
                if "preceding" in b:
                    return "preceding", int(b["preceding"].get("offset", 0))
                if "following" in b:
                    return "following", int(b["following"].get("offset", 0))
                return default_kind, None

            sk, so = bound(d.get("lowerBound"), "unbounded_preceding",
                           "unbounded_preceding")
            ek, eo = bound(d.get("upperBound"), "current_row",
                           "unbounded_following")
            frame = E.WindowFrame(units, sk, so, ek, eo)
        return E.WindowFunction(name, args, parts, sorts, frame)

    def sort(self, d: Dict, schema: Schema) -> E.SortSpec:
        asc, nf = _DIR_SORT.get(d.get("direction", ""), (True, False))
        return E.SortSpec(self.expr(d["expr"], schema), asc, nf)

    def literal(self, d: Dict) -> E.Literal:
        if "null" in d:
            dt, _ = type_from_substrait(d["null"])
            return E.Literal(None, dt)
        if "boolean" in d:
            return E.Literal(bool(d["boolean"]), T.BOOL)
        for tag, dt in (("i8", T.INT8), ("i16", T.INT16), ("i32", T.INT32)):
            if tag in d:
                return E.Literal(int(d[tag]), dt)
        if "i64" in d:
            return E.Literal(int(d["i64"]), T.INT64)
        if "fp32" in d:
            return E.Literal(float(d["fp32"]), T.FLOAT32)
        if "fp64" in d:
            return E.Literal(float(d["fp64"]), T.FLOAT64)
        if "string" in d:
            return E.Literal(d["string"], T.STRING)
        if "date" in d:
            return E.Literal(int(d["date"]), T.DATE32)
        if "timestamp" in d:
            return E.Literal(int(d["timestamp"]), T.TIMESTAMP)
        if "decimal" in d:
            c = d["decimal"]
            scaled = int.from_bytes(base64.b64decode(c["value"]), "little",
                                    signed=True)
            scale = int(c.get("scale", 0))
            v = decimal.Decimal(scaled) / (10 ** scale)
            return E.Literal(float(v), T.decimal(int(c.get("precision", 38)),
                                                 scale))
        if "intervalDayToSecond" in d:
            return E.Literal(int(d["intervalDayToSecond"].get("days", 0)),
                             T.INTERVAL_DAYS)
        if "intervalYearToMonth" in d:
            return E.Literal(int(d["intervalYearToMonth"].get("months", 0)),
                             T.INTERVAL_MONTHS)
        raise PlanError(f"cannot consume substrait literal {list(d)!r}")

    # -- relations --------------------------------------------------------
    def rel(self, d: Dict) -> L.LogicalPlan:
        (tag, body), = d.items()
        out = self._rel_body(tag, body)
        emit = (body.get("common", {}) or {}).get("emit") if isinstance(
            body, dict) else None
        return out if emit is None else self._apply_emit(out, emit)

    def _apply_emit(self, plan: L.LogicalPlan, emit: Dict) -> L.LogicalPlan:
        mapping = [int(i) for i in emit.get("outputMapping", [])]
        if mapping == list(range(len(plan.schema.fields))):
            return plan
        cols = []
        for i in mapping:
            f = plan.schema.fields[i]
            cols.append(E.Column(f.name, f.qualifier))
        return L.Projection(plan, cols)

    def _rel_body(self, tag: str, body: Dict) -> L.LogicalPlan:
        if tag == "read":
            return self.read(body)
        if tag == "project":
            inp = self.rel(body["input"])
            exprs = [self.expr(e, inp.schema)
                     for e in body.get("expressions", [])]
            # hoist window-function subtrees into a Window node, then
            # reference its appended output columns
            wfns: List[E.WindowFunction] = []

            def collect(x: E.Expr):
                if isinstance(x, E.WindowFunction):
                    if x not in wfns:
                        wfns.append(x)
                    return
                for c in x.children():
                    collect(c)

            for e in exprs:
                collect(e)
            input_fields = list(inp.schema.fields)
            if wfns:
                inp = L.Window(inp, wfns)
                wcols = {w: E.Column(inp.schema.fields[len(input_fields) + i].name)
                         for i, w in enumerate(wfns)}
                exprs = [E.map_expr(e, lambda x: wcols.get(x, x))
                         for e in exprs]
            # substrait project output = input fields ++ expressions; alias
            # each computed expression to a unique placeholder so emit /
            # downstream index references never hit ambiguous names (RelRoot
            # names restore user-facing names at the top)
            cols: List[E.Expr] = [E.Column(f.name, f.qualifier)
                                  for f in input_fields]
            for e in exprs:
                self._alias_seq += 1
                cols.append(E.Alias(e, f"__sx{self._alias_seq}"))
            return L.Projection(inp, cols)
        if tag == "filter":
            inp = self.rel(body["input"])
            return L.Filter(inp, self.expr(body["condition"], inp.schema))
        if tag == "aggregate":
            return self.aggregate(body)
        if tag == "sort":
            inp = self.rel(body["input"])
            specs = [self.sort(s, inp.schema) for s in body.get("sorts", [])]
            return L.Sort(inp, specs)
        if tag == "fetch":
            inp = self.rel(body["input"])
            count = int(body.get("count", -1))
            offset = int(body.get("offset", 0))
            fetch = None if count < 0 else count
            if isinstance(inp, L.Sort) and offset == 0 and inp.fetch is None:
                return L.Sort(inp.input, inp.sort_specs, fetch)
            return L.Limit(inp, offset, fetch)
        if tag == "join":
            return self.join(body)
        if tag == "cross":
            left, right = self.rel(body["left"]), self.rel(body["right"])
            return L.Join(left, right, [], L.JoinType.CROSS)
        if tag == "set":
            inputs = [self.rel(i) for i in body.get("inputs", [])]
            op = body.get("op", "SET_OP_UNION_ALL")
            if op == "SET_OP_UNION_ALL":
                return L.Union(inputs, all=True)
            if op == "SET_OP_UNION_DISTINCT":
                return L.Distinct(L.Union(inputs, all=True))
            raise PlanError(f"unsupported substrait set op {op!r}")
        raise PlanError(f"cannot consume substrait relation {tag!r}")

    def read(self, body: Dict) -> L.LogicalPlan:
        if "virtualTable" in body:
            vt = body["virtualTable"] or {}
            rows_in = vt.get("values", [])
            names = (body.get("baseSchema", {}) or {}).get("names", [])
            if not names:
                return L.EmptyRelation(produce_one_row=bool(rows_in))
            types = body["baseSchema"]["struct"]["types"]
            fields = []
            for n, t in zip(names, types):
                dt, nullable = type_from_substrait(t)
                fields.append(Field(n, dt, nullable))
            rows = [[self.literal(f) for f in r.get("fields", [])]
                    for r in rows_in]
            return L.Values(Schema(fields), rows)
        names = body.get("namedTable", {}).get("names", [])
        if not names:
            raise PlanError("substrait read without namedTable")
        tname = names[-1]
        provider = self.catalog.get(tname)
        scan: L.LogicalPlan = L.TableScan(tname, provider)
        proj = body.get("projection")
        if proj:
            items = proj.get("select", {}).get("structItems", [])
            base = provider.schema()
            cols = [base.fields[int(i.get("field", 0))].name for i in items]
            scan = L.TableScan(tname, provider, projection=cols)
        if "filter" in body:
            scan = L.Filter(scan, self.expr(body["filter"], scan.schema))
        if "bestEffortFilter" in body:
            scan = L.Filter(scan, self.expr(body["bestEffortFilter"],
                                            scan.schema))
        return scan

    def aggregate(self, body: Dict) -> L.LogicalPlan:
        inp = self.rel(body["input"])
        groupings = body.get("groupings", [])
        if len(groupings) > 1:
            raise PlanError("multiple substrait groupings (grouping sets) "
                            "not supported in consumption yet")
        group_exprs = [self.expr(g, inp.schema)
                       for g in (groupings[0].get("groupingExpressions", [])
                                 if groupings else [])]
        aggr_exprs = []
        for entry in body.get("measures", []):
            m = entry["measure"]
            name = self.fns.get(int(m.get("functionReference", 0)), "")
            args = tuple(self.expr(a["value"], inp.schema)
                         for a in m.get("arguments", []) if "value" in a)
            distinct = m.get("invocation") == "AGGREGATION_INVOCATION_DISTINCT"
            filt = (self.expr(entry["filter"], inp.schema)
                    if "filter" in entry else None)
            if not name:
                raise PlanError("substrait measure without a declared "
                                "extension name")
            # unique placeholder alias: downstream references are by index,
            # and duplicate display names would make them ambiguous
            self._alias_seq += 1
            aggr_exprs.append(E.Alias(
                E.AggregateFunction(name, args, distinct, filt),
                f"__ax{self._alias_seq}"))
        if not aggr_exprs and group_exprs and all(
                isinstance(g, E.Column) for g in group_exprs) and len(
                group_exprs) == len(inp.schema.fields):
            return L.Distinct(inp)
        return L.Aggregate(inp, group_exprs, aggr_exprs)

    def join(self, body: Dict) -> L.LogicalPlan:
        left, right = self.rel(body["left"]), self.rel(body["right"])
        jt = _TYPE_JOIN.get(body.get("type", ""), L.JoinType.INNER)
        both = left.schema.join(right.schema)
        on: List[Tuple[E.Expr, E.Expr]] = []
        residual: Optional[E.Expr] = None
        if "expression" in body:
            cond = self.expr(body["expression"], both)
            nleft = len(left.schema.fields)

            def side(e: E.Expr) -> Optional[int]:
                cols = E.collect_columns(e)
                if not cols:
                    return None
                idxs = {both.index_of(c.flat_name) for c in cols}
                if all(i < nleft for i in idxs):
                    return 0
                if all(i >= nleft for i in idxs):
                    return 1
                return None

            def walk(e: E.Expr):
                nonlocal residual
                if isinstance(e, E.BinaryOp) and e.op is E.Op.AND:
                    walk(e.left)
                    walk(e.right)
                    return
                if isinstance(e, E.BinaryOp) and e.op is E.Op.EQ:
                    ls, rs = side(e.left), side(e.right)
                    if ls == 0 and rs == 1:
                        on.append((e.left, e.right))
                        return
                    if ls == 1 and rs == 0:
                        on.append((e.right, e.left))
                        return
                residual = e if residual is None else E.BinaryOp(
                    E.Op.AND, residual, e)

            walk(cond)
        return L.Join(left, right, on, jt, residual)


def plan_from_substrait(doc: Dict, catalog) -> L.LogicalPlan:
    """substrait.Plan (proto3-JSON dict) -> LogicalPlan bound to `catalog`.

    The RelRoot's `names` rename the output columns (a trailing aliasing
    Projection is added when they differ from the derived schema)."""
    cons = _Consumer(doc, catalog)
    rels = doc.get("relations", [])
    if not rels:
        raise PlanError("substrait plan has no relations")
    root = rels[0].get("root")
    if root is None:
        raise PlanError("substrait plan's first relation is not a root")
    plan = cons.rel(root["input"])
    names = root.get("names", [])
    ours = [f.name for f in plan.schema.fields]
    if names and names != ours:
        if len(names) != len(ours):
            raise PlanError(
                f"substrait root names count {len(names)} != plan output "
                f"columns {len(ours)}")
        cols = [E.Alias(E.Column(f.name, f.qualifier), n)
                for f, n in zip(plan.schema.fields, names)]
        plan = L.Projection(plan, cols)
    return plan

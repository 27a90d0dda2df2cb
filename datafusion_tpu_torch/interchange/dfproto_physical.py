"""DataFusion protobuf PHYSICAL-plan interchange.

Port of datafusion_tpu/interchange/dfproto_physical.py over this package's
operators. Producer/consumer for `PhysicalPlanNode` over the vendored wire
schema (reference: `proto-models/proto/datafusion.proto:862-903`, codecs in
`datafusion/proto/src/physical_plan/{to_proto,from_proto}.rs`): the
physical operator tree serializes to the reference's physical wire format
and back. Operators with a direct reference analog use the standard nodes
(Filter/Projection/Aggregate/HashJoin/Sort/Limit/Union/WindowAgg/
CoalesceBatches=Compact/Empty); the engine's own operators (WindowTopKExec,
ValuesExec, AliasExec, table scans re-bound by name) ride
`PhysicalExtensionNode` with a JSON payload, the same escape hatch the
reference gives custom ExecutionPlans (PhysicalExtensionCodec). Operators
outside that set (UnnestExec, RecursiveQueryExec) raise PlanError.

A decoded plan is what this package's planner builds: a scan under
filters gets them as pruning hints, a top-k sort marks its scan
(`_attach_topk_hint`), and a join with no key pairs takes the range path
when its filter holds one inequality between the sides, else the
constant-key join. A range join encodes its inequality into the join
filter, which has no slot of its own on the wire.

Physical expressions encode as `PhysicalExprNode` with columns resolved to
(name, index) against the operator's input schema — the reference's
convention — and decode back to this engine's expression IR by index, so
qualifiers survive round-trips.
"""
from __future__ import annotations

import base64
import json
from types import SimpleNamespace
from typing import Optional

from ..common import types as T
from ..common.errors import PlanError
from ..common.schema import Field, Schema
from ..expr import nodes as E
from ..expr.typing import infer
from ..logical.plan import JoinType
from ..physical import plan as PP
from ..physical.planner import (AliasExec, _attach_topk_hint,
                                _extract_range_predicate)
from ..physical.window import WindowExec, WindowTopKExec
from .dfproto import (_ExprCodec, scalar_from_pb, scalar_to_pb, type_from_pb,
                      type_to_pb)
from .proto import common_pb2 as C
from .proto import plan_pb2 as P

_JT_TO_PB = {
    JoinType.INNER: C.JoinType.INNER, JoinType.LEFT: C.JoinType.LEFT,
    JoinType.RIGHT: C.JoinType.RIGHT, JoinType.FULL: C.JoinType.FULL,
    JoinType.LEFT_SEMI: C.JoinType.LEFTSEMI,
    JoinType.LEFT_ANTI: C.JoinType.LEFTANTI,
    JoinType.RIGHT_SEMI: C.JoinType.RIGHTSEMI,
    JoinType.RIGHT_ANTI: C.JoinType.RIGHTANTI,
}
_JT_FROM_PB = {v: k for k, v in _JT_TO_PB.items()}

_OP_TO_NAME = {
    E.Op.EQ: "Eq", E.Op.NEQ: "NotEq", E.Op.LT: "Lt", E.Op.LE: "LtEq",
    E.Op.GT: "Gt", E.Op.GE: "GtEq", E.Op.ADD: "Plus", E.Op.SUB: "Minus",
    E.Op.MUL: "Multiply", E.Op.DIV: "Divide", E.Op.MOD: "Modulo",
    E.Op.AND: "And", E.Op.OR: "Or",
}
_NAME_TO_OP = {v: k for k, v in _OP_TO_NAME.items()}


class _PhysExprCodec:
    """E.Expr <-> PhysicalExprNode against a fixed input schema."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self._logical = _ExprCodec()

    # -- encode ------------------------------------------------------------
    def _col_index(self, e: E.Column) -> int:
        for i, f in enumerate(self.schema.fields):
            if f.name == e.cname and (e.qualifier is None
                                      or f.qualifier == e.qualifier):
                return i
        idx = self.schema.find(e.cname)
        if idx is None:
            raise PlanError(f"physical proto: column {e.cname!r} not in "
                            f"input schema")
        return idx

    def to_pb(self, e: E.Expr) -> P.PhysicalExprNode:
        out = P.PhysicalExprNode()
        if isinstance(e, E.Alias):  # physical exprs carry no alias
            return self.to_pb(e.expr)
        if isinstance(e, E.Column):
            i = self._col_index(e)
            out.column.name = self.schema.fields[i].name
            out.column.index = i
            return out
        if isinstance(e, E.Literal):
            out.literal.CopyFrom(scalar_to_pb(e.value, e.dtype))
            return out
        if isinstance(e, E.BinaryOp):
            out.binary_expr.op = _OP_TO_NAME[e.op]
            out.binary_expr.l.CopyFrom(self.to_pb(e.left))
            out.binary_expr.r.CopyFrom(self.to_pb(e.right))
            return out
        if isinstance(e, E.Between):
            # the reference desugars BETWEEN before physical planning
            low = E.BinaryOp(E.Op.GE, e.expr, e.low)
            high = E.BinaryOp(E.Op.LE, e.expr, e.high)
            both: E.Expr = E.BinaryOp(E.Op.AND, low, high)
            return self.to_pb(E.Not(both) if e.negated else both)
        if isinstance(e, E.Not):
            out.not_expr.expr.CopyFrom(self.to_pb(e.expr))
            return out
        if isinstance(e, E.Negative):
            out.negative.expr.CopyFrom(self.to_pb(e.expr))
            return out
        if isinstance(e, E.IsNull):
            out.is_null_expr.expr.CopyFrom(self.to_pb(e.expr))
            return out
        if isinstance(e, E.Cast):
            tgt = out.try_cast if e.safe else out.cast
            tgt.expr.CopyFrom(self.to_pb(e.expr))
            tgt.arrow_type.CopyFrom(type_to_pb(e.dtype))
            return out
        if isinstance(e, E.Case):
            c = out.case_
            if e.operand is not None:
                c.expr.CopyFrom(self.to_pb(e.operand))
            for w, t_ in e.branches:
                wt = c.when_then_expr.add()
                wt.when_expr.CopyFrom(self.to_pb(w))
                wt.then_expr.CopyFrom(self.to_pb(t_))
            if e.else_expr is not None:
                c.else_expr.CopyFrom(self.to_pb(e.else_expr))
            return out
        if isinstance(e, E.InList):
            out.in_list.expr.CopyFrom(self.to_pb(e.expr))
            for v in e.values:
                out.in_list.list.add().CopyFrom(self.to_pb(v))
            out.in_list.negated = e.negated
            return out
        if isinstance(e, E.Like):
            out.like_expr.negated = e.negated
            out.like_expr.case_insensitive = e.case_insensitive
            out.like_expr.expr.CopyFrom(self.to_pb(e.expr))
            out.like_expr.pattern.CopyFrom(self.to_pb(e.pattern))
            return out
        if isinstance(e, E.ScalarFunction):
            u = out.scalar_udf
            u.name = e.fname
            for a in e.args:
                u.args.add().CopyFrom(self.to_pb(a))
            try:
                dt, _ = infer(e, self.schema)
                u.return_type.CopyFrom(type_to_pb(dt))
            except Exception:  # noqa: BLE001 -- best-effort return type
                pass
            return out
        if isinstance(e, E.AggregateFunction):
            return self.agg_to_pb_node(e)
        if isinstance(e, E.WindowFunction):
            out.window_expr.CopyFrom(self.window_to_pb(e))
            return out
        raise PlanError(
            f"physical proto: unsupported expr {type(e).__name__}")

    def agg_to_pb(self, e: E.AggregateFunction) -> P.PhysicalAggregateExprNode:
        n = P.PhysicalAggregateExprNode()
        n.user_defined_aggr_function = e.fname
        for a in e.args:
            n.expr.add().CopyFrom(self.to_pb(a))
        n.distinct = e.distinct
        return n

    def agg_to_pb_node(self, e: E.AggregateFunction) -> P.PhysicalExprNode:
        out = P.PhysicalExprNode()
        out.aggregate_expr.CopyFrom(self.agg_to_pb(e))
        return out

    def window_to_pb(self, e: E.WindowFunction) -> P.PhysicalWindowExprNode:
        n = P.PhysicalWindowExprNode()
        n.user_defined_window_function = e.fname
        for a in e.args:
            n.args.add().CopyFrom(self.to_pb(a))
        for p_ in e.partition_by:
            n.partition_by.add().CopyFrom(self.to_pb(p_))
        for s in e.order_by:
            n.order_by.add().CopyFrom(self.sort_to_pb(s))
        if e.frame is not None:
            self._logical._frame_to_pb(e.frame, n.window_frame)
        n.name = e.name()
        n.ignore_nulls = bool(e.ignore_nulls)
        return n

    def sort_to_pb(self, s: E.SortSpec) -> P.PhysicalSortExprNode:
        n = P.PhysicalSortExprNode()
        n.expr.CopyFrom(self.to_pb(s.expr))
        n.asc = s.asc
        n.nulls_first = bool(s.nulls_first)
        return n

    # -- decode ------------------------------------------------------------
    def _col_ref(self, i: int, name: str) -> E.Column:
        if 0 <= i < len(self.schema.fields):
            f = self.schema.fields[i]
            return E.Column(f.name, f.qualifier)
        return E.Column(name)

    def from_pb(self, n: P.PhysicalExprNode) -> E.Expr:
        which = n.WhichOneof("ExprType")
        if which == "column":
            return self._col_ref(n.column.index, n.column.name)
        if which == "unknown_column":
            return E.Column(n.unknown_column.name)
        if which == "literal":
            v, t = scalar_from_pb(n.literal)
            return E.Literal(v, t)
        if which == "binary_expr":
            b = n.binary_expr
            ops = ([self.from_pb(x) for x in b.operands]
                   or [self.from_pb(b.l), self.from_pb(b.r)])
            op = _NAME_TO_OP.get(b.op)
            if op is None:
                raise PlanError(f"physical proto: operator {b.op!r}")
            cur = ops[0]
            for x in ops[1:]:
                cur = E.BinaryOp(op, cur, x)
            return cur
        if which == "is_null_expr":
            return E.IsNull(self.from_pb(n.is_null_expr.expr))
        if which == "is_not_null_expr":
            return E.Not(E.IsNull(self.from_pb(n.is_not_null_expr.expr)))
        if which == "not_expr":
            return E.Not(self.from_pb(n.not_expr.expr))
        if which == "negative":
            return E.Negative(self.from_pb(n.negative.expr))
        if which == "case_":
            c = n.case_
            return E.Case(
                self.from_pb(c.expr) if c.HasField("expr") else None,
                tuple((self.from_pb(wt.when_expr), self.from_pb(wt.then_expr))
                      for wt in c.when_then_expr),
                self.from_pb(c.else_expr) if c.HasField("else_expr") else None)
        if which == "cast":
            return E.Cast(self.from_pb(n.cast.expr),
                          type_from_pb(n.cast.arrow_type), False)
        if which == "try_cast":
            return E.Cast(self.from_pb(n.try_cast.expr),
                          type_from_pb(n.try_cast.arrow_type), True)
        if which == "in_list":
            return E.InList(self.from_pb(n.in_list.expr),
                            tuple(self.from_pb(x) for x in n.in_list.list),
                            n.in_list.negated)
        if which == "like_expr":
            return E.Like(self.from_pb(n.like_expr.expr),
                          self.from_pb(n.like_expr.pattern),
                          n.like_expr.negated, n.like_expr.case_insensitive)
        if which == "scalar_udf":
            return E.ScalarFunction(
                n.scalar_udf.name,
                tuple(self.from_pb(a) for a in n.scalar_udf.args))
        if which == "aggregate_expr":
            return self.agg_from_pb(n.aggregate_expr)
        if which == "window_expr":
            return self.window_from_pb(n.window_expr)
        if which == "sort":
            return self.sort_from_pb(n.sort)
        raise PlanError(f"physical proto: unsupported expr node {which!r}")

    def agg_from_pb(self, n: P.PhysicalAggregateExprNode
                    ) -> E.AggregateFunction:
        return E.AggregateFunction(
            n.user_defined_aggr_function,
            tuple(self.from_pb(a) for a in n.expr), n.distinct)

    def window_from_pb(self, n: P.PhysicalWindowExprNode) -> E.WindowFunction:
        frame = self._logical._frame_from_pb(n.window_frame) \
            if n.HasField("window_frame") else None
        fname = (n.user_defined_window_function
                 or n.user_defined_aggr_function)
        return E.WindowFunction(
            fname, tuple(self.from_pb(a) for a in n.args),
            tuple(self.from_pb(p_) for p_ in n.partition_by),
            tuple(self.sort_from_pb(s) for s in n.order_by),
            frame, ignore_nulls=n.ignore_nulls)

    def sort_from_pb(self, n: P.PhysicalSortExprNode) -> E.SortSpec:
        return E.SortSpec(self.from_pb(n.expr), n.asc, n.nulls_first)


def _schema_to_pb(schema: Schema) -> C.Schema:
    out = C.Schema()
    for f in schema.fields:
        fb = out.columns.add()
        fb.name = f.name
        fb.arrow_type.CopyFrom(type_to_pb(f.dtype))
        fb.nullable = f.nullable
        if f.qualifier:
            fb.metadata["qualifier"] = f.qualifier
    return out


def _schema_from_pb(s: C.Schema) -> Schema:
    fields = []
    for fb in s.columns:
        fields.append(Field(fb.name, type_from_pb(fb.arrow_type),
                            nullable=fb.nullable,
                            qualifier=fb.metadata.get("qualifier") or None))
    return Schema(fields)


def _ext(kind: str, payload: dict, *inputs) -> P.PhysicalPlanNode:
    out = P.PhysicalPlanNode()
    payload = dict(payload)
    payload["kind"] = kind
    out.extension.node = json.dumps(payload).encode()
    for i in inputs:
        out.extension.inputs.add().CopyFrom(i)
    return out


class _PhysPlanCodec:
    def __init__(self, catalog=None):
        self.catalog = catalog

    def _provider_name(self, p: PP.ScanExec) -> str:
        """Registered catalog name of the scan's provider; the plan-level
        alias ('l1', '__lm0_orders') is NOT the catalog name."""
        if self.catalog is not None:
            try:
                for name in self.catalog.names():
                    if self.catalog.get(name) is p.provider:
                        return name
            except Exception:  # noqa: BLE001 -- fall back to the alias
                pass
        return p.alias

    # ---- encode ----------------------------------------------------------
    def to_pb(self, p: PP.PhysicalPlan) -> P.PhysicalPlanNode:
        out = P.PhysicalPlanNode()
        if isinstance(p, PP.ScanExec):
            return _ext("scan", {
                "table": self._provider_name(p),
                "alias": p.alias,
                "projection": p.projection,
                "schema": base64.b64encode(
                    _schema_to_pb(p.schema).SerializeToString()).decode(),
            })
        if isinstance(p, PP.EmptyExec):
            out.empty.schema.CopyFrom(_schema_to_pb(p.schema))
            out.empty.partitions = 1
            return out
        if isinstance(p, PP.ValuesExec):
            rows = []
            for row in p.rows:
                rows.append([base64.b64encode(scalar_to_pb(
                    lit.value, lit.dtype).SerializeToString()).decode()
                    for lit in row])
            return _ext("values", {
                "schema": base64.b64encode(
                    _schema_to_pb(p.schema).SerializeToString()).decode(),
                "rows": rows})
        if isinstance(p, PP.FilterExec):
            out.filter.input.CopyFrom(self.to_pb(p.input))
            ec = _PhysExprCodec(p.input.schema)
            out.filter.expr.CopyFrom(ec.to_pb(p.predicate))
            return out
        if isinstance(p, PP.ProjectionExec):
            out.projection.input.CopyFrom(self.to_pb(p.input))
            ec = _PhysExprCodec(p.input.schema)
            for e, f in zip(p.exprs, p.schema.fields):
                out.projection.expr.add().CopyFrom(ec.to_pb(e))
                out.projection.expr_name.append(f.qualified_name)
            return out
        if isinstance(p, PP.CompactExec):
            # the selection-mask re-densify op IS batch coalescing
            out.coalesce_batches.input.CopyFrom(self.to_pb(p.input))
            out.coalesce_batches.target_batch_size = 8192
            return out
        if isinstance(p, AliasExec):
            return _ext("alias", {
                "schema": base64.b64encode(
                    _schema_to_pb(p.schema).SerializeToString()).decode(),
            }, self.to_pb(p.input))
        if isinstance(p, PP.LimitExec):
            out.global_limit.input.CopyFrom(self.to_pb(p.input))
            out.global_limit.skip = p.skip or 0
            out.global_limit.fetch = -1 if p.fetch is None else p.fetch
            return out
        if isinstance(p, PP.SortExec):
            out.sort.input.CopyFrom(self.to_pb(p.input))
            ec = _PhysExprCodec(p.input.schema)
            for s in p.specs:
                out.sort.expr.add().CopyFrom(
                    _wrap_sort(ec.sort_to_pb(s)))
            out.sort.fetch = -1 if p.fetch is None else p.fetch
            return out
        if isinstance(p, PP.DistinctExec):
            # reference plans DISTINCT as a group-by-all aggregate
            n = out.aggregate
            n.input.CopyFrom(self.to_pb(p.input))
            ec = _PhysExprCodec(p.input.schema)
            for f in p.input.schema.fields:
                n.group_expr.add().CopyFrom(
                    ec.to_pb(E.Column(f.name, f.qualifier)))
                n.group_expr_name.append(f.name)
            n.mode = P.AggregateMode.SINGLE
            n.input_schema.CopyFrom(_schema_to_pb(p.input.schema))
            return out
        if isinstance(p, PP.AggregateExec):
            n = out.aggregate
            n.input.CopyFrom(self.to_pb(p.input))
            ec = _PhysExprCodec(p.input.schema)
            ng = len(p.group_exprs)
            for e, f in zip(p.group_exprs, p.schema.fields[:ng]):
                n.group_expr.add().CopyFrom(ec.to_pb(e))
                n.group_expr_name.append(f.qualified_name)
            for e, f in zip(p.agg_exprs, p.schema.fields[ng:]):
                a = e.expr if isinstance(e, E.Alias) else e
                n.aggr_expr.add().CopyFrom(ec.agg_to_pb_node(a))
                n.aggr_expr_name.append(f.qualified_name)
            n.mode = P.AggregateMode.SINGLE
            n.input_schema.CopyFrom(_schema_to_pb(p.input.schema))
            return out
        if isinstance(p, PP.JoinExec):
            if p.join_type not in _JT_TO_PB:
                raise PlanError(
                    f"physical proto: join type {p.join_type} unsupported")
            n = out.hash_join
            n.left.CopyFrom(self.to_pb(p.left))
            n.right.CopyFrom(self.to_pb(p.right))
            lc = _PhysExprCodec(p.left.schema)
            rc = _PhysExprCodec(p.right.schema)
            for le, re_ in p.on:
                jo = n.on.add()
                jo.left.CopyFrom(lc.to_pb(le))
                jo.right.CopyFrom(rc.to_pb(re_))
            n.join_type = _JT_TO_PB[p.join_type]
            n.partition_mode = P.PartitionMode.AUTO
            filt = p.filter
            if p.range_on is not None:
                le, re_, op = p.range_on
                cmp = E.BinaryOp(_RANGE_TO_OP[op], le, re_)
                filt = cmp if filt is None else E.BinaryOp(E.Op.AND, cmp, filt)
            if filt is not None:
                joined = Schema(list(p.left.schema.fields)
                                + list(p.right.schema.fields))
                jc = _PhysExprCodec(joined)
                n.filter.expression.CopyFrom(jc.to_pb(filt))
                n.filter.schema.CopyFrom(_schema_to_pb(joined))
                nl = len(p.left.schema.fields)
                for i in range(len(joined.fields)):
                    ci = n.filter.column_indices.add()
                    ci.index = i if i < nl else i - nl
                    ci.side = (C.JoinSide.LEFT_SIDE if i < nl
                               else C.JoinSide.RIGHT_SIDE)
            return out
        if isinstance(p, PP.UnionExec):
            for c in p.inputs:
                out.union.inputs.add().CopyFrom(self.to_pb(c))
            return out
        if isinstance(p, WindowExec):
            n = out.window
            n.input.CopyFrom(self.to_pb(p.input))
            ec = _PhysExprCodec(p.input.schema)
            for e in p.window_exprs:
                w = e.expr if isinstance(e, E.Alias) else e
                n.window_expr.add().CopyFrom(ec.window_to_pb(w))
            n.sorted.SetInParent()
            return out
        if isinstance(p, WindowTopKExec):
            ec = _PhysExprCodec(p.input.schema)
            w = p.wexpr.expr if isinstance(p.wexpr, E.Alias) else p.wexpr
            return _ext("window_topk", {
                "op": p.op.value, "k": p.k,
                "wexpr": base64.b64encode(
                    ec.window_to_pb(w).SerializeToString()).decode(),
                "schema": base64.b64encode(
                    _schema_to_pb(p.schema).SerializeToString()).decode(),
            }, self.to_pb(p.input))
        raise PlanError(
            f"physical proto: unsupported operator {type(p).__name__}")

    # ---- decode ----------------------------------------------------------
    def from_pb(self, n: P.PhysicalPlanNode) -> PP.PhysicalPlan:
        which = n.WhichOneof("PhysicalPlanType")
        if which == "extension":
            payload = json.loads(n.extension.node.decode())
            kind = payload["kind"]
            if kind == "scan":
                if self.catalog is None:
                    raise PlanError("physical proto: scan needs a catalog")
                schema = _schema_from_pb(C.Schema.FromString(
                    base64.b64decode(payload["schema"])))
                prov = self.catalog.get(payload["table"])
                return PP.ScanExec(prov, schema, payload.get("projection"),
                                   payload.get("alias") or payload["table"])
            if kind == "alias":
                schema = _schema_from_pb(C.Schema.FromString(
                    base64.b64decode(payload["schema"])))
                return AliasExec(self.from_pb(n.extension.inputs[0]), schema)
            if kind == "values":
                schema = _schema_from_pb(C.Schema.FromString(
                    base64.b64decode(payload["schema"])))
                rows = []
                for row in payload["rows"]:
                    lits = []
                    for b in row:
                        v, t = scalar_from_pb(
                            C.ScalarValue.FromString(base64.b64decode(b)))
                        lits.append(E.Literal(v, t))
                    rows.append(lits)
                return PP.ValuesExec(schema, rows)
            if kind == "window_topk":
                inp = self.from_pb(n.extension.inputs[0])
                ec = _PhysExprCodec(inp.schema)
                w = ec.window_from_pb(P.PhysicalWindowExprNode.FromString(
                    base64.b64decode(payload["wexpr"])))
                schema = _schema_from_pb(C.Schema.FromString(
                    base64.b64decode(payload["schema"])))
                return WindowTopKExec(inp, w, E.Op(payload["op"]),
                                      payload["k"], schema)
            raise PlanError(f"physical proto: unknown extension {kind!r}")
        if which == "empty":
            return PP.EmptyExec(_schema_from_pb(n.empty.schema), False)
        if which == "placeholder_row":
            return PP.EmptyExec(_schema_from_pb(n.placeholder_row.schema),
                                True)
        if which == "filter":
            inp = self.from_pb(n.filter.input)
            ec = _PhysExprCodec(inp.schema)
            pred = ec.from_pb(n.filter.expr)
            scan = inp
            while isinstance(scan, PP.FilterExec):
                scan = scan.input
            if isinstance(scan, PP.ScanExec):
                # the planner hands a scan's filters to it as pruning hints
                scan.filters = scan.filters + (pred,)
            return PP.FilterExec(inp, pred)
        if which == "projection":
            inp = self.from_pb(n.projection.input)
            ec = _PhysExprCodec(inp.schema)
            exprs, fields = [], []
            for pe, qname in zip(n.projection.expr, n.projection.expr_name):
                name, qual = _split_qname(qname)
                e = ec.from_pb(pe)
                exprs.append(E.Alias(e, name))
                dt, nullable = _infer_or(e, inp.schema)
                fields.append(Field(name, dt, nullable=nullable,
                                    qualifier=qual))
            return PP.ProjectionExec(inp, exprs, Schema(fields))
        if which == "coalesce_batches":
            return PP.CompactExec(self.from_pb(n.coalesce_batches.input))
        if which == "global_limit":
            g = n.global_limit
            return PP.LimitExec(self.from_pb(g.input), g.skip,
                                None if g.fetch < 0 else g.fetch)
        if which == "local_limit":
            return PP.LimitExec(self.from_pb(n.local_limit.input), 0,
                                n.local_limit.fetch)
        if which == "sort" or which == "sort_preserving_merge":
            s = n.sort if which == "sort" else n.sort_preserving_merge
            inp = self.from_pb(s.input)
            ec = _PhysExprCodec(inp.schema)
            specs = [_unwrap_sort(ec, x) for x in s.expr]
            out = PP.SortExec(inp, specs, None if s.fetch < 0 else s.fetch)
            _attach_topk_hint(out)
            return out
        if which == "aggregate":
            a = n.aggregate
            inp = self.from_pb(a.input)
            ec = _PhysExprCodec(inp.schema)
            groups = [ec.from_pb(g) for g in a.group_expr]
            aggs = [ec.from_pb(x) for x in a.aggr_expr]
            if not aggs and groups:
                if all(isinstance(g, E.Column) for g in groups) \
                        and len(groups) == len(inp.schema.fields):
                    return PP.DistinctExec(inp)
            fields = []
            for g, qname in zip(groups, a.group_expr_name):
                name, qual = _split_qname(qname)
                dt, nullable = _infer_or(g, inp.schema)
                fields.append(Field(name, dt, nullable=nullable,
                                    qualifier=qual))
            for x, qname in zip(aggs, a.aggr_expr_name):
                name, qual = _split_qname(qname)
                dt, nullable = _infer_or(x, inp.schema)
                fields.append(Field(name, dt, nullable=nullable,
                                    qualifier=qual))
            return PP.AggregateExec(inp, groups, aggs, Schema(fields))
        if which == "hash_join" or which == "sort_merge_join":
            h = n.hash_join if which == "hash_join" else n.sort_merge_join
            left = self.from_pb(h.left)
            right = self.from_pb(h.right)
            lc = _PhysExprCodec(left.schema)
            rc = _PhysExprCodec(right.schema)
            on = [(lc.from_pb(jo.left), rc.from_pb(jo.right)) for jo in h.on]
            jt = _JT_FROM_PB.get(h.join_type, JoinType.INNER)
            filt = None
            if h.HasField("filter"):
                joined = Schema(list(left.schema.fields)
                                + list(right.schema.fields))
                filt = _PhysExprCodec(joined).from_pb(h.filter.expression)
            schema = _join_schema(left, right, jt)
            if not on:
                return _keyless_join(left, right, jt, filt, schema)
            return PP.JoinExec(left, right, on, jt, filt, schema)
        if which == "cross_join":
            left = self.from_pb(n.cross_join.left)
            right = self.from_pb(n.cross_join.right)
            schema = _join_schema(left, right, JoinType.INNER)
            return _keyless_join(left, right, JoinType.INNER, None, schema)
        if which == "union" or which == "interleave":
            src = n.union if which == "union" else n.interleave
            inputs = [self.from_pb(c) for c in src.inputs]
            return PP.UnionExec(inputs, inputs[0].schema)
        if which == "window":
            inp = self.from_pb(n.window.input)
            ec = _PhysExprCodec(inp.schema)
            wfns = [ec.window_from_pb(w) for w in n.window.window_expr]
            fields = list(inp.schema.fields)
            for w in wfns:
                dt, nullable = _infer_or(w, inp.schema)
                fields.append(Field(w.name(), dt, nullable=nullable))
            return WindowExec(inp, wfns, Schema(fields))
        if which == "coalesce_partitions" or which == "merge":
            return self.from_pb(getattr(n, which).input)
        if which == "repartition":
            return self.from_pb(n.repartition.input)
        if which == "cooperative":
            return self.from_pb(n.cooperative.input)
        if which == "analyze":
            return self.from_pb(n.analyze.input)
        raise PlanError(f"physical proto: unsupported plan node {which!r}")


def _split_qname(name: str):
    """'qualifier.name' -> (bare, qualifier); expr_name slots carry the
    QUALIFIED output name so rebuilt schemas keep their qualifiers (a later
    operator's Column('n_name', 'n1') must still resolve unambiguously in a
    self-join). Engine-generated field names never contain dots."""
    if "." in name:
        q, _, bare = name.partition(".")
        return bare, q
    return name, None


def _infer_or(e: E.Expr, schema: Schema):
    try:
        return infer(e, schema)
    except Exception:  # noqa: BLE001 -- fall back to a permissive field
        return T.FLOAT64, True


def _wrap_sort(sn: P.PhysicalSortExprNode) -> P.PhysicalExprNode:
    out = P.PhysicalExprNode()
    out.sort.CopyFrom(sn)
    return out


def _unwrap_sort(ec: _PhysExprCodec, x: P.PhysicalExprNode) -> E.SortSpec:
    if x.WhichOneof("ExprType") == "sort":
        return ec.sort_from_pb(x.sort)
    return E.SortSpec(ec.from_pb(x), True, False)


_RANGE_TO_OP = {"lt": E.Op.LT, "le": E.Op.LE, "gt": E.Op.GT, "ge": E.Op.GE}


def _keyless_join(left: PP.PhysicalPlan, right: PP.PhysicalPlan,
                  jt: JoinType, filt: Optional[E.Expr],
                  schema: Schema) -> PP.JoinExec:
    """A join without key pairs as the planner builds it (its
    `_cross_join`): the range path over one inequality between the sides,
    the rest of the filter residual; else an equi-join on a constant key
    with the whole filter residual."""
    if filt is not None:
        sides = SimpleNamespace(left=SimpleNamespace(schema=left.schema),
                                right=SimpleNamespace(schema=right.schema),
                                filter=filt)
        range_on, residual = _extract_range_predicate(sides)
        if range_on is not None:
            return PP.JoinExec(left, right, [], jt, residual, schema,
                               range_on=range_on)
    one = E.lit(1)
    return PP.JoinExec(left, right, [(one, one)], jt, filt, schema)


def _join_schema(left: PP.PhysicalPlan, right: PP.PhysicalPlan,
                 jt: JoinType) -> Schema:
    lf = list(left.schema.fields)
    rf = list(right.schema.fields)
    if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
        return Schema(lf)
    if jt in (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
        return Schema(rf)
    if jt in (JoinType.LEFT, JoinType.FULL):
        rf = [Field(f.name, f.dtype, nullable=True, qualifier=f.qualifier)
              for f in rf]
    if jt in (JoinType.RIGHT, JoinType.FULL):
        lf = [Field(f.name, f.dtype, nullable=True, qualifier=f.qualifier)
              for f in lf]
    return Schema(lf + rf)


# --------------------------------------------------------------------------
# public API (mirrors the logical dfproto functions)
# --------------------------------------------------------------------------

def physical_plan_to_proto(plan: PP.PhysicalPlan,
                           catalog=None) -> P.PhysicalPlanNode:
    return _PhysPlanCodec(catalog).to_pb(plan)


def physical_plan_to_proto_bytes(plan: PP.PhysicalPlan,
                                 catalog=None) -> bytes:
    return physical_plan_to_proto(plan, catalog).SerializeToString()


def physical_plan_from_proto(node: P.PhysicalPlanNode,
                             catalog=None) -> PP.PhysicalPlan:
    return _PhysPlanCodec(catalog).from_pb(node)


def physical_plan_from_proto_bytes(data: bytes,
                                   catalog=None) -> PP.PhysicalPlan:
    return physical_plan_from_proto(P.PhysicalPlanNode.FromString(data),
                                    catalog)

# Verbatim copy of datafusion_tpu/optimizer/latemat.py; host-only, kept in step with the original.
"""Late materialization of functionally-determined group keys.

TPU-motivated optimizer rule with no direct reference counterpart (the
reference exploits declared functional dependence to VALIDATE such group
keys -- expr/src/logical_plan/plan.rs Aggregate + DFSchema functional
dependencies -- but keeps them in the grouping): when a GROUP BY key is
functionally determined by another key through a unique-key join chain
(e.g. TPC-H Q3's o_orderdate/o_shippriority, determined by l_orderkey via
orders' primary key), the column's only job above the join is to ride along
into the aggregation output.  On TPU that ride is expensive: every build
payload column occupies lanes in the join's direct-address table and the
probe-side row gather, and the aggregation must sort/carry it (measured
+185 ms of TPC-H Q3's 322 ms at SF1 on one v5e chip).

Rewrite:
    Aggregate[G ∪ D, aggs](input)                 -- S ⊂ G determines D
      =>
    Projection[original output order](
        Join(... Join(Aggregate[G \\ D, aggs](input), scan_1) ..., scan_k))

where each scan_i is a fresh base-table scan of a table whose verified
unique key is reachable (via join-key equality classes) from the kept
group keys, and D's columns are re-attached by those joins.  Group
granularity is unchanged (determined keys never split groups), every
aggregate sees the same rows, and projection pruning then strips D from
the original join tree -- the payload stops moving.

Uniqueness is exact: declared unique keys or a cached one-time host
np.unique pass (catalog.TableProvider.is_unique); estimates are never used.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..expr import nodes as E
from ..logical import plan as L


class _UF:
    """Union-find over qualified column names."""

    def __init__(self):
        self.p: Dict[str, str] = {}

    def find(self, x: str) -> str:
        p = self.p
        while p.setdefault(x, x) != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def union(self, a: str, b: str) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


def _qcol(e: E.Expr, schema) -> Optional[Tuple[str, str]]:
    """(qualifier, cname) for a plain column expr, resolving a missing
    qualifier through the given schema; None when not a plain column."""
    if not isinstance(e, E.Column):
        return None
    q = e.qualifier
    if q is None:
        try:
            q = schema.field(e.cname).qualifier
        except Exception:  # noqa: BLE001 -- unresolvable: treat as opaque
            return None
    if q is None:
        return None
    return q, e.cname


def _collect(plan: L.LogicalPlan):
    """Walk the aggregate input subtree collecting base scans and join-key
    equality classes. Returns (scans, uf, ok): scans maps alias ->
    TableScan; classes only merge across INNER joins; null-extending join
    sides and set-ops contribute nothing (their columns can then never be
    dropped -- safe by construction)."""
    scans: Dict[str, L.TableScan] = {}
    uf = _UF()
    ok = True

    def walk(p) -> None:
        nonlocal ok
        if not ok:
            return
        if isinstance(p, L.TableScan):
            if p.alias in scans and scans[p.alias] is not p:
                ok = False  # colliding aliases would merge classes wrongly
            scans[p.alias] = p
            return
        if isinstance(p, L.Join):
            jt = p.join_type
            if jt is L.JoinType.INNER:
                for l, r in p.on:
                    lc = _qcol(l, p.left.schema)
                    rc = _qcol(r, p.right.schema)
                    if lc is not None and rc is not None:
                        uf.union(f"{lc[0]}.{lc[1]}", f"{rc[0]}.{rc[1]}")
                walk(p.left)
                walk(p.right)
            elif jt is L.JoinType.CROSS:
                walk(p.left)
                walk(p.right)
            elif jt in (L.JoinType.LEFT_SEMI, L.JoinType.LEFT_ANTI,
                        L.JoinType.LEFT):
                walk(p.left)  # right side is filtered out or null-extended
            elif jt in (L.JoinType.RIGHT_SEMI, L.JoinType.RIGHT_ANTI,
                        L.JoinType.RIGHT):
                walk(p.right)
            # FULL: neither side's FDs survive null extension
            return
        if isinstance(p, (L.Union,)):
            return  # merged columns are not pass-through from one scan
        for c in p.children():
            walk(c)

    walk(plan)
    return scans, uf, ok


def _scan_classes(scan: L.TableScan, uf: _UF) -> List[str]:
    return [uf.find(f"{scan.alias}.{f.name}")
            for f in scan.source.schema().fields]


def _join_key_cols(scans, uf) -> Dict[str, List[str]]:
    """Per scan: base columns that participate in some equality class with
    more than one member (candidate unique keys worth testing)."""
    multi = {}
    for alias, scan in scans.items():
        for f in scan.source.schema().fields:
            c = uf.find(f"{alias}.{f.name}")
            multi.setdefault(c, []).append((alias, f.name))
    out: Dict[str, List[str]] = {a: [] for a in scans}
    for c, members in multi.items():
        if len(members) > 1:
            for alias, name in members:
                out[alias].append(name)
    return out


def _derivation(avail: set, scans, uf, keycols):
    """Fixpoint: attach every scan whose verified unique key's classes are
    all available; availability then includes all its base columns.
    Returns (ordered attach list [(alias, key_cols)], final avail)."""
    order: List[Tuple[str, Tuple[str, ...]]] = []
    attached = set()
    changed = True
    while changed:
        changed = False
        for alias, scan in scans.items():
            if alias in attached:
                continue
            cand = [k for k in keycols.get(alias, ())
                    if uf.find(f"{alias}.{k}") in avail]
            key: Optional[Tuple[str, ...]] = None
            for k in cand:
                if scan.source.is_unique((k,)):
                    key = (k,)
                    break
            if key is None and len(cand) > 1:
                if scan.source.is_unique(tuple(cand)):
                    key = tuple(cand)
            if key is None:
                continue
            attached.add(alias)
            order.append((alias, key))
            for c in _scan_classes(scan, uf):
                if c not in avail:
                    avail.add(c)
            changed = True
    return order, avail


def _rewrite_aggregate(p: L.LogicalPlan) -> L.LogicalPlan:
    if not isinstance(p, L.Aggregate) or len(p.group_exprs) < 2:
        return p
    in_schema = p.input.schema
    scans, uf, ok = _collect(p.input)
    if not ok or not scans:
        return p
    keycols = _join_key_cols(scans, uf)
    if not any(keycols.values()):
        return p

    group = list(p.group_exprs)
    qcols = [_qcol(e, in_schema) for e in group]

    def avail_from(kept_idx) -> set:
        return {uf.find(f"{qcols[i][0]}.{qcols[i][1]}")
                for i in kept_idx if qcols[i] is not None}

    # Greedily drop group keys whose class is derivable from the others.
    kept_idx = list(range(len(group)))
    dropped_idx: List[int] = []
    for i, qc in enumerate(qcols):
        if qc is None or qc[0] not in scans:
            continue
        scan = scans[qc[0]]
        if qc[1] not in {f.name for f in scan.source.schema().fields}:
            continue
        trial = [j for j in kept_idx if j != i]
        if not trial:
            continue
        _, avail = _derivation(avail_from(trial), scans, uf, keycols)
        if uf.find(f"{qc[0]}.{qc[1]}") in avail:
            kept_idx = trial
            dropped_idx.append(i)
    if not dropped_idx:
        return p

    try:
        return _build(p, group, qcols, kept_idx, dropped_idx, scans, uf, keycols)
    except Exception:  # noqa: BLE001 -- any construction snag: keep original
        return p


def _build(p, group, qcols, kept_idx, dropped_idx, scans, uf, keycols):
    new_agg = L.Aggregate(p.input, [group[i] for i in kept_idx], p.aggr_exprs)

    # Witnesses: class -> column expr available in the current output.
    witness: Dict[str, E.Expr] = {}
    for i in kept_idx:
        if qcols[i] is not None:
            q, n = qcols[i]
            witness.setdefault(uf.find(f"{q}.{n}"), E.Column(n, q))

    order, _ = _derivation(set(witness), scans, uf, keycols)

    # Backward-prune: keep only scans providing a dropped column or a
    # witness for a later needed scan.
    needed = {qcols[i][0] for i in dropped_idx}
    for alias, key in reversed(order):
        if alias not in needed:
            continue
        for k in key:
            c = uf.find(f"{alias}.{k}")
            if c in witness:
                continue
            # find the earlier attach that made c available
            for a2, _k2 in order:
                if a2 == alias:
                    break
                if c in set(_scan_classes(scans[a2], uf)):
                    needed.add(a2)
                    break
    order = [(a, k) for a, k in order if a in needed]
    if {qcols[i][0] for i in dropped_idx} - {a for a, _ in order}:
        return p  # a dropped column's table did not become attachable

    cur: L.LogicalPlan = new_agg
    fresh: Dict[str, str] = {}
    for n, (alias, key) in enumerate(order):
        scan = scans[alias]
        fa = f"__lm{n}_{alias}"
        fresh[alias] = fa
        rescan = L.TableScan(scan.name, scan.source, None, (), fa)
        on = []
        for k in key:
            c = uf.find(f"{alias}.{k}")
            w = witness.get(c)
            if w is None:
                return p
            on.append((w, E.Column(k, fa)))
        cur = L.Join(cur, rescan, on, L.JoinType.INNER)
        for f in scan.source.schema().fields:
            witness.setdefault(uf.find(f"{alias}.{f.name}"),
                               E.Column(f.name, fa))

    # Restore the original output schema (names, qualifiers, order).
    out: List[E.Expr] = []
    dropped = set(dropped_idx)
    for i, e in enumerate(group):
        if i in dropped:
            q, n = qcols[i]
            out.append(E.Alias(E.Column(n, fresh[q]), n, qualifier=q))
        else:
            q = e.qualifier if isinstance(e, E.Column) else None
            out.append(E.Column(e.name(), q))
    for e in p.aggr_exprs:
        out.append(E.Column(e.name(), None))
    proj = L.Projection(cur, out)
    old, new = p.schema.fields, proj.schema.fields
    if len(old) != len(new) or any(
            a.name != b.name or a.qualifier != b.qualifier or a.dtype != b.dtype
            for a, b in zip(old, new)):
        return p
    return proj


def late_materialization_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    return L.transform_up(plan, _rewrite_aggregate)

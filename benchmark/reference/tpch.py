# Written from the pandas oracles of datafusion_tpu_torch/models/tpch/queries_ref.py
# (itself a copy of datafusion_tpu/models/tpch/queries_ref.py), rewritten in
# plain NumPy with exact decimal arithmetic. It imports nothing of the program.
"""The plain reference of the 22 TPC-H queries, over the benchmark's own
columns (dfbench.columns.Col).

Decimals are exact: int64 units of 10**-scale, with the output scales of the
queries' SQL types (a sum keeps its operands' scale, a product adds scales,
AVG of decimal(15,2) is decimal(19,6), truncated toward zero, and a decimal
quotient is rounded to the nearest unit of its type's scale). Quotients that the SQL makes
floating point (Q14, Q17) come from the exact rational value.

`precision="control"` is the same program one step below what the
configuration states: decimals computed in float64 and rounded to their
scale at the end, floating-point results in float32. It serves as the
control that the comparison must reject."""
from __future__ import annotations

import re
from fractions import Fraction
from typing import Callable, Dict

import numpy as np

from dfbench.answers import NULL_INT, Answer, RefCol

EPOCH = np.datetime64("1970-01-01", "D")


def _day(s: str) -> int:
    return int((np.datetime64(s, "D") - EPOCH).astype(np.int64))


def _year(days: np.ndarray) -> np.ndarray:
    return (days.astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64)
            + 1970)


class _Q:
    """The tables and the arithmetic of one precision."""

    def __init__(self, tables, sf: float, precision: str):
        self.t = tables
        self.sf = sf
        self.exact = precision == "exact"
        self._rows = {}
        if precision not in ("exact", "control"):
            raise ValueError(precision)

    # -- columns -------------------------------------------------------
    def v(self, table: str, col: str) -> np.ndarray:
        return self.t[table][col].data

    def rows(self, table: str, key: str, probe_table: str, probe: str) -> np.ndarray:
        """The row of `table` whose unique `key` each row's `probe` names
        (every probe key is present: a foreign key)."""
        memo = (table, key, probe_table, probe)
        if memo not in self._rows:
            self._rows[memo] = lookup(self.v(table, key), self.v(probe_table, probe))[0]
        return self._rows[memo]

    def dec(self, table: str, col: str) -> np.ndarray:
        """A decimal column's units, int64 (exact) or float64 (control)."""
        d = self.t[table][col].data
        return d if self.exact else d.astype(np.float64)

    def code(self, table: str, col: str, value: str) -> int:
        """The code of `value` in a string column's dictionary, or -1."""
        d = self.t[table][col].dictionary
        i = int(np.searchsorted(d, value))
        return i if i < len(d) and d[i] == value else -1

    def is_(self, table: str, col: str, *values: str) -> np.ndarray:
        codes = [self.code(table, col, x) for x in values]
        return np.isin(self.v(table, col), [c for c in codes if c >= 0])

    def match(self, table: str, col: str, pred: Callable[[str], bool]) -> np.ndarray:
        """Rows whose string satisfies pred, decided once per dictionary entry."""
        d = self.t[table][col].dictionary
        hit = np.fromiter((pred(s) for s in d), dtype=bool, count=len(d))
        return hit[self.v(table, col)]

    def strings(self, table: str, col: str, rows) -> RefCol:
        c = self.t[table][col]
        return RefCol(col, "string", c.dictionary[c.data[rows]].astype(object))

    # -- output --------------------------------------------------------
    def out_dec(self, name: str, units, scale: int) -> RefCol:
        units = np.asarray(units)
        if not self.exact:
            units = np.rint(units.astype(np.float64)).astype(np.int64)
        return RefCol(name, "decimal", units.astype(np.int64), scale)

    def total_dec(self, name: str, units, scale: int) -> RefCol:
        """SUM over all rows of `units`: NULL over no rows."""
        if len(units) == 0:
            return RefCol(name, "decimal", np.array([NULL_INT]), scale)
        return self.out_dec(name, [units.sum()], scale)

    def avg_dec(self, sums, counts) -> np.ndarray:
        """AVG of a scale-2 decimal as decimal(19,6): sum * 10**4 / count,
        truncated toward zero."""
        if self.exact:
            return np.array([_trunc_div(int(s) * 10**4, int(c))
                             for s, c in zip(sums, counts)], dtype=np.int64)
        return np.asarray(sums, dtype=np.float64) * 1e4 / np.asarray(counts)

    def ratio_dec(self, num, den, scale: int) -> np.ndarray:
        """num / den (decimals of one scale) as a decimal of `scale`, rounded
        to the nearest unit (half to even)."""
        if self.exact:
            return np.array([round(Fraction(int(a) * 10**scale, int(b)))
                             for a, b in zip(num, den)], dtype=np.int64)
        return np.asarray(num, dtype=np.float64) * 10.0**scale / np.asarray(den)

    def out_float(self, name: str, num, den, factor: int) -> RefCol:
        """A float64 result, factor * num / den: the exact rational value, or
        (control) in float32; NULL (NaN) where den is 0."""
        if not den:
            return RefCol(name, "float", np.array([np.nan]))
        if self.exact:
            return RefCol(name, "float", np.array([float(Fraction(factor * int(num), int(den)))]))
        f = np.float32(factor) * np.float32(num) / np.float32(den)
        return RefCol(name, "float", np.array([f], dtype=np.float32).astype(np.float64))


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


# ---------------------------------------------------------------------------
# relational helpers
# ---------------------------------------------------------------------------

SMALL_RANGE = 1 << 24


def lookup(keys: np.ndarray, probe: np.ndarray):
    """(row of each probe key in `keys`, found): `keys` unique."""
    if len(keys) and np.all(keys[1:] > keys[:-1]) and \
            int(keys[-1]) - int(keys[0]) + 1 == len(keys):
        pos = probe.astype(np.int64) - int(keys[0])
        found = (pos >= 0) & (pos < len(keys))
        return np.where(found, pos, 0), found
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    pos = np.searchsorted(sk, probe)
    pos_c = np.minimum(pos, max(len(sk) - 1, 0))
    found = (pos < len(sk)) & (sk[pos_c] == probe) if len(sk) else \
        np.zeros(len(probe), dtype=bool)
    return order[pos_c], found


def _factorize(k: np.ndarray):
    """(sorted distinct values, index of each row's value among them)."""
    if len(k) and k.dtype.kind in "iu":
        lo, hi = int(k.min()), int(k.max())
        if hi - lo < SMALL_RANGE:
            present = np.zeros(hi - lo + 1, dtype=bool)
            present[k - lo] = True
            rank = np.cumsum(present) - 1
            return np.flatnonzero(present) + lo, rank[k - lo]
    u, inv = np.unique(k, return_inverse=True)
    return u, inv.reshape(-1)


def group(*keys: np.ndarray):
    """(group id of each row, a row of each group) over int key columns,
    groups in ascending key order (the first key most significant)."""
    n = len(keys[0])
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    packed = np.zeros(n, dtype=np.int64)
    for k in keys:
        u, inv = _factorize(k)
        packed = packed * len(u) + inv
    u, gid = _factorize(packed)
    rep = np.empty(len(u), dtype=np.int64)
    rep[gid] = np.arange(n)
    return gid, rep


def gsum(gid: np.ndarray, values: np.ndarray, ngroups: int) -> np.ndarray:
    """Per-group sums: exact for int64 (in two halves of bits, each summed
    exactly in float64), float64 otherwise."""
    if values.dtype.kind == "f":
        return np.bincount(gid, weights=values, minlength=ngroups)
    v = values.astype(np.int64)
    hi, lo = v >> 26, v & ((1 << 26) - 1)
    return (np.rint(np.bincount(gid, weights=hi, minlength=ngroups)).astype(np.int64) << 26) \
        + np.rint(np.bincount(gid, weights=lo, minlength=ngroups)).astype(np.int64)


def gcount(gid: np.ndarray, ngroups: int) -> np.ndarray:
    return np.bincount(gid, minlength=ngroups).astype(np.int64)


def top(n: int, *sort_keys):
    """Row order of np.lexsort(sort_keys) (last key most significant), cut
    to n rows."""
    return np.lexsort(sort_keys)[:n]


def desc(x):
    return -x.astype(np.float64) if x.dtype.kind == "f" else -x


# ---------------------------------------------------------------------------
# the 22 queries
# ---------------------------------------------------------------------------

def q1(Q: _Q) -> Answer:
    m = Q.v("lineitem", "l_shipdate") <= _day("1998-12-01") - 90
    rf = Q.v("lineitem", "l_returnflag")[m]
    ls = Q.v("lineitem", "l_linestatus")[m]
    qty = Q.dec("lineitem", "l_quantity")[m]
    price = Q.dec("lineitem", "l_extendedprice")[m]
    disc = Q.dec("lineitem", "l_discount")[m]
    tax = Q.dec("lineitem", "l_tax")[m]
    gid, first = group(rf, ls)
    G = len(first)
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    cnt = gcount(gid, G)
    rows = np.flatnonzero(m)[first]
    return Answer([
        Q.strings("lineitem", "l_returnflag", rows),
        Q.strings("lineitem", "l_linestatus", rows),
        Q.out_dec("sum_qty", gsum(gid, qty, G), 2),
        Q.out_dec("sum_base_price", gsum(gid, price, G), 2),
        Q.out_dec("sum_disc_price", gsum(gid, disc_price, G), 4),
        Q.out_dec("sum_charge", gsum(gid, charge, G), 6),
        Q.out_dec("avg_qty", Q.avg_dec(gsum(gid, qty, G), cnt), 6),
        Q.out_dec("avg_price", Q.avg_dec(gsum(gid, price, G), cnt), 6),
        Q.out_dec("avg_disc", Q.avg_dec(gsum(gid, disc, G), cnt), 6),
        RefCol("count_order", "int", cnt),
    ], order=[(0, False), (1, False)])


def _nation_of(Q: _Q, nationkeys: np.ndarray) -> np.ndarray:
    row, _ = lookup(Q.v("nation", "n_nationkey"), nationkeys)
    return row


def _region_nations(Q: _Q, region: str) -> np.ndarray:
    """Nation keys of a region."""
    rk = Q.v("region", "r_regionkey")[Q.is_("region", "r_name", region)]
    return Q.v("nation", "n_nationkey")[np.isin(Q.v("nation", "n_regionkey"), rk)]


def q2(Q: _Q) -> Answer:
    eu = _region_nations(Q, "EUROPE")
    srow = Q.rows("supplier", "s_suppkey", "partsupp", "ps_suppkey")
    ps_eu = np.isin(Q.v("supplier", "s_nationkey")[srow], eu)
    pk = Q.v("partsupp", "ps_partkey")
    cost = Q.dec("partsupp", "ps_supplycost")
    # the least supply cost of each part among European suppliers
    eu_pk, eu_cost = pk[ps_eu], cost[ps_eu]
    order = np.lexsort((eu_cost, eu_pk))
    first = np.r_[True, eu_pk[order][1:] != eu_pk[order][:-1]]
    min_pk, min_cost = eu_pk[order][first], eu_cost[order][first]
    prow, _ = lookup(Q.v("part", "p_partkey"), pk)
    pm = (Q.v("part", "p_size") == 15) & Q.match("part", "p_type", lambda s: s.endswith("BRASS"))
    mrow, mfound = lookup(min_pk, pk)
    keep = np.flatnonzero(ps_eu & pm[prow] & mfound & (cost == min_cost[mrow]))
    s = srow[keep]
    p = prow[keep]
    n = _nation_of(Q, Q.v("supplier", "s_nationkey")[s])
    acct = Q.v("supplier", "s_acctbal")[s]
    o = top(100, Q.v("part", "p_partkey")[p], Q.v("supplier", "s_name")[s],
            Q.v("nation", "n_name")[n], -acct)
    s, p, n = s[o], p[o], n[o]
    return Answer([
        Q.out_dec("s_acctbal", Q.v("supplier", "s_acctbal")[s], 2),
        Q.strings("supplier", "s_name", s),
        Q.strings("nation", "n_name", n),
        RefCol("p_partkey", "int", Q.v("part", "p_partkey")[p].astype(np.int64)),
        Q.strings("part", "p_mfgr", p),
        Q.strings("supplier", "s_address", s),
        Q.strings("supplier", "s_phone", s),
        Q.strings("supplier", "s_comment", s),
    ], order=[(0, True), (2, False), (1, False), (3, False)])


def _revenue(Q: _Q, m) -> np.ndarray:
    """l_extendedprice * (1 - l_discount) of the lineitem rows m, scale 4."""
    return Q.dec("lineitem", "l_extendedprice")[m] * (100 - Q.dec("lineitem", "l_discount")[m])


def q3(Q: _Q) -> Answer:
    cust = Q.v("customer", "c_custkey")[Q.is_("customer", "c_mktsegment", "BUILDING")]
    om = (Q.v("orders", "o_orderdate") < _day("1995-03-15")) & np.isin(Q.v("orders", "o_custkey"), cust)
    lm = Q.v("lineitem", "l_shipdate") > _day("1995-03-15")
    orow, found = lookup(Q.v("orders", "o_orderkey"), Q.v("lineitem", "l_orderkey"))
    lm &= found & om[orow]
    gid, first = group(Q.v("lineitem", "l_orderkey")[lm])
    rev = gsum(gid, _revenue(Q, lm), len(first))
    o_rows = orow[np.flatnonzero(lm)[first]]
    date = Q.v("orders", "o_orderdate")[o_rows]
    o = top(10, date, desc(rev))
    return Answer([
        RefCol("l_orderkey", "int", Q.v("orders", "o_orderkey")[o_rows][o].astype(np.int64)),
        Q.out_dec("revenue", rev[o], 4),
        RefCol("o_orderdate", "date", date[o].astype(np.int64)),
        RefCol("o_shippriority", "int", Q.v("orders", "o_shippriority")[o_rows][o].astype(np.int64)),
    ], order=[(1, True), (2, False)])


def q4(Q: _Q) -> Answer:
    d = Q.v("orders", "o_orderdate")
    om = (d >= _day("1993-07-01")) & (d < _day("1993-10-01"))
    late = Q.v("lineitem", "l_commitdate") < Q.v("lineitem", "l_receiptdate")
    om &= np.isin(Q.v("orders", "o_orderkey"), Q.v("lineitem", "l_orderkey")[late])
    gid, first = group(Q.v("orders", "o_orderpriority")[om])
    rows = np.flatnonzero(om)[first]
    return Answer([Q.strings("orders", "o_orderpriority", rows),
                   RefCol("order_count", "int", gcount(gid, len(first)))],
                  order=[(0, False)])


def q5(Q: _Q) -> Answer:
    asia = _region_nations(Q, "ASIA")
    orow = Q.rows("orders", "o_orderkey", "lineitem", "l_orderkey")
    d = Q.v("orders", "o_orderdate")[orow]
    crow = Q.rows("customer", "c_custkey", "orders", "o_custkey")[orow]
    srow = Q.rows("supplier", "s_suppkey", "lineitem", "l_suppkey")
    sn = Q.v("supplier", "s_nationkey")[srow]
    m = ((d >= _day("1994-01-01")) & (d < _day("1995-01-01"))
         & (Q.v("customer", "c_nationkey")[crow] == sn) & np.isin(sn, asia))
    n = _nation_of(Q, sn[m])
    gid, first = group(Q.v("nation", "n_name")[n])
    rev = gsum(gid, _revenue(Q, m), len(first))
    o = top(len(first), desc(rev))
    return Answer([Q.strings("nation", "n_name", n[first][o]),
                   Q.out_dec("revenue", rev[o], 4)], order=[(1, True)])


def q6(Q: _Q) -> Answer:
    ship = Q.v("lineitem", "l_shipdate")
    disc = Q.v("lineitem", "l_discount")
    m = ((ship >= _day("1994-01-01")) & (ship < _day("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (Q.v("lineitem", "l_quantity") < 2400))
    rev = Q.dec("lineitem", "l_extendedprice")[m] * Q.dec("lineitem", "l_discount")[m]
    return Answer([Q.total_dec("revenue", rev, 4)], order=[])


def q7(Q: _Q) -> Answer:
    ship = Q.v("lineitem", "l_shipdate")
    m = (ship >= _day("1995-01-01")) & (ship <= _day("1996-12-31"))
    srow = Q.rows("supplier", "s_suppkey", "lineitem", "l_suppkey")
    orow = Q.rows("orders", "o_orderkey", "lineitem", "l_orderkey")
    crow = Q.rows("customer", "c_custkey", "orders", "o_custkey")[orow]
    n1 = _nation_of(Q, Q.v("supplier", "s_nationkey")[srow])
    n2 = _nation_of(Q, Q.v("customer", "c_nationkey")[crow])
    fr = Q.code("nation", "n_name", "FRANCE")
    de = Q.code("nation", "n_name", "GERMANY")
    name = Q.v("nation", "n_name")
    a, b = name[n1], name[n2]
    m &= ((a == fr) & (b == de)) | ((a == de) & (b == fr))
    year = _year(ship[m])
    gid, first = group(a[m], b[m], year)
    rev = gsum(gid, _revenue(Q, m), len(first))
    rows = np.flatnonzero(m)[first]
    return Answer([
        RefCol("supp_nation", "string", Q.t["nation"]["n_name"].dictionary[a[rows]].astype(object)),
        RefCol("cust_nation", "string", Q.t["nation"]["n_name"].dictionary[b[rows]].astype(object)),
        RefCol("l_year", "int", year[first]),
        Q.out_dec("revenue", rev, 4),
    ], order=[(0, False), (1, False), (2, False)])


def q8(Q: _Q) -> Answer:
    america = _region_nations(Q, "AMERICA")
    prow = Q.rows("part", "p_partkey", "lineitem", "l_partkey")
    m = Q.is_("part", "p_type", "ECONOMY ANODIZED STEEL")[prow]
    orow = Q.rows("orders", "o_orderkey", "lineitem", "l_orderkey")
    d = Q.v("orders", "o_orderdate")[orow]
    m &= (d >= _day("1995-01-01")) & (d <= _day("1996-12-31"))
    crow = Q.rows("customer", "c_custkey", "orders", "o_custkey")[orow]
    m &= np.isin(Q.v("customer", "c_nationkey")[crow], america)
    srow = Q.rows("supplier", "s_suppkey", "lineitem", "l_suppkey")
    n2 = _nation_of(Q, Q.v("supplier", "s_nationkey")[srow][m])
    brazil = Q.v("nation", "n_name")[n2] == Q.code("nation", "n_name", "BRAZIL")
    year = _year(d[m])
    gid, first = group(year)
    vol = _revenue(Q, m)
    b = gsum(gid, np.where(brazil, vol, 0 * vol), len(first))
    tot = gsum(gid, vol, len(first))
    return Answer([RefCol("o_year", "int", year[first]),
                   Q.out_dec("mkt_share", Q.ratio_dec(b, tot, 8), 8)],
                  order=[(0, False)])


def q9(Q: _Q) -> Answer:
    prow = Q.rows("part", "p_partkey", "lineitem", "l_partkey")
    m = Q.match("part", "p_name", lambda s: "green" in s)[prow]
    lp, ls = Q.v("lineitem", "l_partkey")[m].astype(np.int64), Q.v("lineitem", "l_suppkey")[m].astype(np.int64)
    big = int(max(Q.v("partsupp", "ps_suppkey").max(), ls.max(initial=0))) + 1
    psrow, _ = lookup(Q.v("partsupp", "ps_partkey").astype(np.int64) * big
                      + Q.v("partsupp", "ps_suppkey"), lp * big + ls)
    orow = Q.rows("orders", "o_orderkey", "lineitem", "l_orderkey")[m]
    srow, _ = lookup(Q.v("supplier", "s_suppkey"), ls)
    n = _nation_of(Q, Q.v("supplier", "s_nationkey")[srow])
    year = _year(Q.v("orders", "o_orderdate")[orow])
    amount = _revenue(Q, m) - Q.dec("partsupp", "ps_supplycost")[psrow] * Q.dec("lineitem", "l_quantity")[m]
    name = Q.v("nation", "n_name")[n]
    gid, first = group(name, -year)
    return Answer([
        RefCol("nation", "string", Q.t["nation"]["n_name"].dictionary[name[first]].astype(object)),
        RefCol("o_year", "int", year[first]),
        Q.out_dec("sum_profit", gsum(gid, amount, len(first)), 4),
    ], order=[(0, False), (1, True)])


def q10(Q: _Q) -> Answer:
    orow = Q.rows("orders", "o_orderkey", "lineitem", "l_orderkey")
    d = Q.v("orders", "o_orderdate")[orow]
    m = ((d >= _day("1993-10-01")) & (d < _day("1994-01-01"))
         & Q.is_("lineitem", "l_returnflag", "R"))
    cust = Q.v("orders", "o_custkey")[orow][m]
    gid, first = group(cust)
    rev = gsum(gid, _revenue(Q, m), len(first))
    crow, _ = lookup(Q.v("customer", "c_custkey"), cust[first])
    o = top(20, desc(rev))
    c = crow[o]
    n = _nation_of(Q, Q.v("customer", "c_nationkey")[c])
    return Answer([
        RefCol("c_custkey", "int", Q.v("customer", "c_custkey")[c].astype(np.int64)),
        Q.strings("customer", "c_name", c),
        Q.out_dec("revenue", rev[o], 4),
        Q.out_dec("c_acctbal", Q.v("customer", "c_acctbal")[c], 2),
        Q.strings("nation", "n_name", n),
        Q.strings("customer", "c_address", c),
        Q.strings("customer", "c_phone", c),
        Q.strings("customer", "c_comment", c),
    ], order=[(2, True)])


def q11(Q: _Q) -> Answer:
    srow = Q.rows("supplier", "s_suppkey", "partsupp", "ps_suppkey")
    de = Q.v("nation", "n_nationkey")[Q.is_("nation", "n_name", "GERMANY")]
    m = np.isin(Q.v("supplier", "s_nationkey")[srow], de)
    value = Q.dec("partsupp", "ps_supplycost")[m] * Q.v("partsupp", "ps_availqty")[m]
    total = value.sum()
    gid, first = group(Q.v("partsupp", "ps_partkey")[m])
    val = gsum(gid, value, len(first))
    # HAVING value > total * FRACTION, FRACTION the query's literal
    frac = Fraction(repr(0.0001 / max(Q.sf, 1e-6)))
    if Q.exact:
        keep = np.array([int(v) * frac.denominator > int(total) * frac.numerator
                         for v in val], dtype=bool)
    else:
        keep = val > total * float(frac)
    pk = Q.v("partsupp", "ps_partkey")[m][first][keep]
    val = val[keep]
    o = top(len(val), desc(val))
    return Answer([RefCol("ps_partkey", "int", pk[o].astype(np.int64)),
                   Q.out_dec("value", val[o], 2)], order=[(1, True)])


def q12(Q: _Q) -> Answer:
    L = "lineitem"
    commit, receipt, ship = Q.v(L, "l_commitdate"), Q.v(L, "l_receiptdate"), Q.v(L, "l_shipdate")
    m = (Q.is_(L, "l_shipmode", "MAIL", "SHIP") & (commit < receipt) & (ship < commit)
         & (receipt >= _day("1994-01-01")) & (receipt < _day("1995-01-01")))
    orow = Q.rows("orders", "o_orderkey", L, "l_orderkey")[m]
    high = Q.is_("orders", "o_orderpriority", "1-URGENT", "2-HIGH")[orow].astype(np.int64)
    gid, first = group(Q.v(L, "l_shipmode")[m])
    G = len(first)
    return Answer([Q.strings(L, "l_shipmode", np.flatnonzero(m)[first]),
                   RefCol("high_line_count", "int", gsum(gid, high, G)),
                   RefCol("low_line_count", "int", gsum(gid, 1 - high, G))],
                  order=[(0, False)])


def q13(Q: _Q) -> Answer:
    pat = re.compile("special.*requests", re.S)
    om = ~Q.match("orders", "o_comment", lambda s: pat.search(s) is not None)
    crow, found = lookup(Q.v("customer", "c_custkey"), Q.v("orders", "o_custkey")[om])
    per_cust = np.bincount(crow[found], minlength=len(Q.v("customer", "c_custkey")))
    c_count, custdist = np.unique(per_cust, return_counts=True)
    o = top(len(c_count), desc(c_count), desc(custdist))
    return Answer([RefCol("c_count", "int", c_count[o].astype(np.int64)),
                   RefCol("custdist", "int", custdist[o].astype(np.int64))],
                  order=[(1, True), (0, True)])


def q14(Q: _Q) -> Answer:
    ship = Q.v("lineitem", "l_shipdate")
    m = (ship >= _day("1995-09-01")) & (ship < _day("1995-10-01"))
    prow = Q.rows("part", "p_partkey", "lineitem", "l_partkey")[m]
    promo = Q.match("part", "p_type", lambda s: s.startswith("PROMO"))[prow]
    rev = _revenue(Q, m)
    return Answer([Q.out_float("promo_revenue", rev[promo].sum(), rev.sum(), 100)], order=[])


def q15(Q: _Q) -> Answer:
    ship = Q.v("lineitem", "l_shipdate")
    m = (ship >= _day("1996-01-01")) & (ship < _day("1996-04-01"))
    gid, first = group(Q.v("lineitem", "l_suppkey")[m])
    rev = gsum(gid, _revenue(Q, m), len(first))
    best = rev == rev.max()
    supp = Q.v("lineitem", "l_suppkey")[m][first][best]
    srow, _ = lookup(Q.v("supplier", "s_suppkey"), supp)
    o = np.argsort(supp, kind="stable")
    s = srow[o]
    return Answer([
        RefCol("s_suppkey", "int", supp[o].astype(np.int64)),
        Q.strings("supplier", "s_name", s),
        Q.strings("supplier", "s_address", s),
        Q.strings("supplier", "s_phone", s),
        Q.out_dec("total_revenue", rev[best][o], 4),
    ], order=[(0, False)])


def q16(Q: _Q) -> Answer:
    pat = re.compile("Customer.*Complaints", re.S)
    bad = Q.v("supplier", "s_suppkey")[
        Q.match("supplier", "s_comment", lambda s: pat.search(s) is not None)]
    pm = (~Q.is_("part", "p_brand", "Brand#45")
          & ~Q.match("part", "p_type", lambda s: s.startswith("MEDIUM POLISHED"))
          & np.isin(Q.v("part", "p_size"), [49, 14, 23, 45, 19, 3, 36, 9]))
    prow = Q.rows("part", "p_partkey", "partsupp", "ps_partkey")
    m = pm[prow] & ~np.isin(Q.v("partsupp", "ps_suppkey"), bad)
    p = prow[m]
    brand, ptype, size = Q.v("part", "p_brand")[p], Q.v("part", "p_type")[p], Q.v("part", "p_size")[p]
    gid, first = group(brand, ptype, size)
    # distinct suppliers per group
    _, pair_first = group(gid, Q.v("partsupp", "ps_suppkey")[m])
    cnt = np.bincount(gid[pair_first], minlength=len(first)).astype(np.int64)
    o = top(len(first), size[first], ptype[first], brand[first], -cnt)
    rows = p[first][o]
    return Answer([Q.strings("part", "p_brand", rows), Q.strings("part", "p_type", rows),
                   RefCol("p_size", "int", Q.v("part", "p_size")[rows].astype(np.int64)),
                   RefCol("supplier_cnt", "int", cnt[o])],
                  order=[(3, True), (0, False), (1, False), (2, False)])


def q17(Q: _Q) -> Answer:
    pm = Q.is_("part", "p_brand", "Brand#23") & Q.is_("part", "p_container", "MED BOX")
    prow = Q.rows("part", "p_partkey", "lineitem", "l_partkey")
    m = pm[prow]
    qty = Q.v("lineitem", "l_quantity")[m]
    gid, first = group(Q.v("lineitem", "l_partkey")[m])
    sq = gsum(gid, qty, len(first))[gid]
    cnt = gcount(gid, len(first))[gid]
    # l_quantity < 0.2 * avg(l_quantity) of its part
    keep = qty * 5 * cnt < sq
    s = Q.dec("lineitem", "l_extendedprice")[m][keep].sum()
    # sum(l_extendedprice) / 7.0, the sum in cents: NULL over no rows
    return Answer([Q.out_float("avg_yearly", s, 700 if keep.any() else 0, 1)], order=[])


def q18(Q: _Q) -> Answer:
    th = (300 if Q.sf >= 0.1 else 250) * 100
    lk = Q.v("lineitem", "l_orderkey")
    gid, first = group(lk)
    sq = gsum(gid, Q.v("lineitem", "l_quantity"), len(first))
    big = lk[first][sq > th]
    m = np.isin(lk, big)
    gid, first = group(lk[m])
    qty = gsum(gid, Q.dec("lineitem", "l_quantity")[m], len(first))
    orow, _ = lookup(Q.v("orders", "o_orderkey"), lk[m][first])
    crow = Q.rows("customer", "c_custkey", "orders", "o_custkey")[orow]
    total = Q.v("orders", "o_totalprice")[orow]
    date = Q.v("orders", "o_orderdate")[orow]
    o = top(100, date, -total)
    c, r = crow[o], orow[o]
    return Answer([
        Q.strings("customer", "c_name", c),
        RefCol("c_custkey", "int", Q.v("customer", "c_custkey")[c].astype(np.int64)),
        RefCol("o_orderkey", "int", Q.v("orders", "o_orderkey")[r].astype(np.int64)),
        RefCol("o_orderdate", "date", date[o].astype(np.int64)),
        Q.out_dec("o_totalprice", total[o], 2),
        Q.out_dec("sum(l_quantity)", qty[o], 2),
    ], order=[(4, True), (3, False)])


def q19(Q: _Q) -> Answer:
    L = "lineitem"
    prow = Q.rows("part", "p_partkey", L, "l_partkey")
    base = Q.is_(L, "l_shipmode", "AIR", "AIR REG") & Q.is_(L, "l_shipinstruct", "DELIVER IN PERSON")
    qty = Q.v(L, "l_quantity")
    size = Q.v("part", "p_size")[prow]
    m = np.zeros(len(qty), dtype=bool)
    for brand, cont, q_lo, size_hi in (
            ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
            ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 10),
            ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 15)):
        m |= (Q.is_("part", "p_brand", brand)[prow] & Q.is_("part", "p_container", *cont)[prow]
              & (qty >= q_lo * 100) & (qty <= (q_lo + 10) * 100)
              & (size >= 1) & (size <= size_hi))
    m &= base
    return Answer([Q.total_dec("revenue", _revenue(Q, m), 4)], order=[])


def q20(Q: _Q) -> Answer:
    forest = Q.v("part", "p_partkey")[Q.match("part", "p_name", lambda s: s.startswith("forest"))]
    L = "lineitem"
    ship = Q.v(L, "l_shipdate")
    lm = (ship >= _day("1994-01-01")) & (ship < _day("1995-01-01"))
    big = int(max(Q.v("partsupp", "ps_suppkey").max(), Q.v(L, "l_suppkey").max())) + 1
    lkey = Q.v(L, "l_partkey")[lm].astype(np.int64) * big + Q.v(L, "l_suppkey")[lm]
    gid, first = group(lkey)
    sq = gsum(gid, Q.v(L, "l_quantity")[lm], len(first))
    pskey = Q.v("partsupp", "ps_partkey").astype(np.int64) * big + Q.v("partsupp", "ps_suppkey")
    row, found = lookup(lkey[first], pskey)
    # ps_availqty > 0.5 * sum(l_quantity); no lineitem: NULL, not kept
    ok = (np.isin(Q.v("partsupp", "ps_partkey"), forest) & found
          & (Q.v("partsupp", "ps_availqty").astype(np.int64) * 200 > sq[row]))
    good = np.unique(Q.v("partsupp", "ps_suppkey")[ok])
    ca = Q.v("nation", "n_nationkey")[Q.is_("nation", "n_name", "CANADA")]
    sm = np.isin(Q.v("supplier", "s_suppkey"), good) & np.isin(Q.v("supplier", "s_nationkey"), ca)
    s = np.flatnonzero(sm)
    s = s[np.argsort(Q.v("supplier", "s_name")[s], kind="stable")]
    return Answer([Q.strings("supplier", "s_name", s), Q.strings("supplier", "s_address", s)],
                  order=[(0, False)])


def q21(Q: _Q) -> Answer:
    L = "lineitem"
    lk = Q.v(L, "l_orderkey")
    sk = Q.v(L, "l_suppkey")
    late = Q.v(L, "l_receiptdate") > Q.v(L, "l_commitdate")
    order_id, _ = group(lk)
    n_orders = int(order_id.max()) + 1 if len(order_id) else 0
    # distinct suppliers of each order, and distinct late suppliers
    _, pf = group(order_id, sk)
    n_supp = np.bincount(order_id[pf], minlength=n_orders)
    _, lf = group(order_id[late], sk[late])
    n_late = np.bincount(order_id[late][lf], minlength=n_orders)
    sa = Q.v("nation", "n_nationkey")[Q.is_("nation", "n_name", "SAUDI ARABIA")]
    srow, _ = lookup(Q.v("supplier", "s_suppkey"), sk)
    orow, _ = lookup(Q.v("orders", "o_orderkey"), lk)
    m = (late & np.isin(Q.v("supplier", "s_nationkey")[srow], sa)
         & Q.is_("orders", "o_orderstatus", "F")[orow]
         & (n_supp[order_id] > 1) & (n_late[order_id] == 1))
    names = Q.v("supplier", "s_name")[srow[m]]
    code, cnt = np.unique(names, return_counts=True)
    o = top(100, code, -cnt)
    d = Q.t["supplier"]["s_name"].dictionary
    return Answer([RefCol("s_name", "string", d[code[o]].astype(object)),
                   RefCol("numwait", "int", cnt[o].astype(np.int64))],
                  order=[(1, True), (0, False)])


def q22(Q: _Q) -> Answer:
    codes = ("13", "31", "23", "29", "30", "18", "17")
    phone = Q.t["customer"]["c_phone"]
    cc_of = np.array([s[:2] for s in phone.dictionary], dtype=object)
    cc = cc_of[phone.data]
    inlist = np.isin(cc, codes)
    acct = Q.v("customer", "c_acctbal")
    pos = inlist & (acct > 0)
    if Q.exact:
        avg = _trunc_div(int(acct[pos].sum()) * 10**4, int(pos.sum()))
        above = acct.astype(np.int64) * 10**4 > avg
    else:
        above = acct > acct[pos].astype(np.float64).sum() / pos.sum()
    has_order = np.isin(Q.v("customer", "c_custkey"), Q.v("orders", "o_custkey"))
    m = inlist & above & ~has_order
    u, inv = np.unique(cc[m].astype(str), return_inverse=True)
    inv = inv.reshape(-1)
    return Answer([RefCol("cntrycode", "string", u.astype(object)),
                   RefCol("numcust", "int", np.bincount(inv, minlength=len(u)).astype(np.int64)),
                   Q.out_dec("totacctbal", gsum(inv, Q.dec("customer", "c_acctbal")[m], len(u)), 2)],
                  order=[(0, False)])


def answers(tables, config: dict, names, precision: str = "exact") -> Dict[str, Answer]:
    """{name: Answer} for the queries `names` ("q1".."q22")."""
    Q = _Q(tables, float(config["scale_factor"]), precision)
    return {n: globals()[n](Q) for n in names}

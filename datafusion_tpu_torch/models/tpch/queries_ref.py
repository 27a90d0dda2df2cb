# Verbatim copy of datafusion_tpu/models/tpch/queries_ref.py; host-only, kept in step with the original.
"""Known-good pandas implementations of the 22 TPC-H queries.

Differential-testing oracle for the engine (the role DataFusion's
sqllogictest answer files + Postgres-differential runs play, SURVEY.md §4):
same generated data goes through the TPU engine and through these pandas
programs; results must agree (floats to tolerance, everything else exactly).
"""
from __future__ import annotations

import numpy as np
import pandas as pd


def _d(s: str):
    return np.datetime64(s)


def ref_query(n: int, t, sf: float = 1.0) -> pd.DataFrame:
    return globals()[f"q{n}"](t, sf)


def q1(t, sf):
    l = t["lineitem"]
    d = l[l.l_shipdate <= _d("1998-12-01") - np.timedelta64(90, "D")].copy()
    d["disc_price"] = d.l_extendedprice * (1 - d.l_discount)
    d["charge"] = d.disc_price * (1 + d.l_tax)
    g = d.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "size"),
    )
    return g.sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True)


def q2(t, sf):
    p, s, ps, n, r = t["part"], t["supplier"], t["partsupp"], t["nation"], t["region"]
    eu = n.merge(r[r.r_name == "EUROPE"], left_on="n_regionkey", right_on="r_regionkey")
    se = s.merge(eu, left_on="s_nationkey", right_on="n_nationkey")
    j = ps.merge(se, left_on="ps_suppkey", right_on="s_suppkey")
    mins = j.groupby("ps_partkey")["ps_supplycost"].min().rename("min_cost")
    pj = p[(p.p_size == 15) & p.p_type.str.endswith("BRASS")]
    out = pj.merge(j, left_on="p_partkey", right_on="ps_partkey")
    out = out.merge(mins, left_on="p_partkey", right_index=True)
    out = out[out.ps_supplycost == out.min_cost]
    out = out[["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
               "s_address", "s_phone", "s_comment"]]
    out = out.sort_values(["s_acctbal", "n_name", "s_name", "p_partkey"],
                          ascending=[False, True, True, True])
    return out.head(100).reset_index(drop=True)


def q3(t, sf):
    c, o, l = t["customer"], t["orders"], t["lineitem"]
    j = (c[c.c_mktsegment == "BUILDING"]
         .merge(o[o.o_orderdate < _d("1995-03-15")], left_on="c_custkey", right_on="o_custkey")
         .merge(l[l.l_shipdate > _d("1995-03-15")], left_on="o_orderkey", right_on="l_orderkey"))
    j["revenue"] = j.l_extendedprice * (1 - j.l_discount)
    g = j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"], as_index=False)["revenue"].sum()
    g = g[["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]]
    g = g.sort_values(["revenue", "o_orderdate"], ascending=[False, True])
    return g.head(10).reset_index(drop=True)


def q4(t, sf):
    o, l = t["orders"], t["lineitem"]
    od = o[(o.o_orderdate >= _d("1993-07-01")) & (o.o_orderdate < _d("1993-10-01"))]
    keys = l[l.l_commitdate < l.l_receiptdate].l_orderkey.unique()
    od = od[od.o_orderkey.isin(keys)]
    g = od.groupby("o_orderpriority", as_index=False).size()
    g.columns = ["o_orderpriority", "order_count"]
    return g.sort_values("o_orderpriority").reset_index(drop=True)


def q5(t, sf):
    c, o, l, s, n, r = (t["customer"], t["orders"], t["lineitem"],
                        t["supplier"], t["nation"], t["region"])
    j = (r[r.r_name == "ASIA"]
         .merge(n, left_on="r_regionkey", right_on="n_regionkey")
         .merge(s, left_on="n_nationkey", right_on="s_nationkey")
         .merge(l, left_on="s_suppkey", right_on="l_suppkey")
         .merge(o[(o.o_orderdate >= _d("1994-01-01")) & (o.o_orderdate < _d("1995-01-01"))],
                left_on="l_orderkey", right_on="o_orderkey")
         .merge(c, left_on="o_custkey", right_on="c_custkey"))
    j = j[j.c_nationkey == j.s_nationkey]
    j["revenue"] = j.l_extendedprice * (1 - j.l_discount)
    g = j.groupby("n_name", as_index=False)["revenue"].sum()
    return g.sort_values("revenue", ascending=False).reset_index(drop=True)


def q6(t, sf):
    l = t["lineitem"]
    d = l[(l.l_shipdate >= _d("1994-01-01")) & (l.l_shipdate < _d("1995-01-01"))
          & (l.l_discount >= 0.05 - 1e-9) & (l.l_discount <= 0.07 + 1e-9)
          & (l.l_quantity < 24)]
    return pd.DataFrame({"revenue": [(d.l_extendedprice * d.l_discount).sum()]})


def q7(t, sf):
    s, l, o, c, n = t["supplier"], t["lineitem"], t["orders"], t["customer"], t["nation"]
    ld = l[(l.l_shipdate >= _d("1995-01-01")) & (l.l_shipdate <= _d("1996-12-31"))]
    j = (ld.merge(s, left_on="l_suppkey", right_on="s_suppkey")
         .merge(o, left_on="l_orderkey", right_on="o_orderkey")
         .merge(c, left_on="o_custkey", right_on="c_custkey")
         .merge(n.rename(columns=lambda x: x + "_1"), left_on="s_nationkey", right_on="n_nationkey_1")
         .merge(n.rename(columns=lambda x: x + "_2"), left_on="c_nationkey", right_on="n_nationkey_2"))
    m = (((j.n_name_1 == "FRANCE") & (j.n_name_2 == "GERMANY"))
         | ((j.n_name_1 == "GERMANY") & (j.n_name_2 == "FRANCE")))
    j = j[m].copy()
    j["l_year"] = j.l_shipdate.dt.year.astype(np.int64)
    j["volume"] = j.l_extendedprice * (1 - j.l_discount)
    g = j.groupby(["n_name_1", "n_name_2", "l_year"], as_index=False)["volume"].sum()
    g.columns = ["supp_nation", "cust_nation", "l_year", "revenue"]
    return g.sort_values(["supp_nation", "cust_nation", "l_year"]).reset_index(drop=True)


def q8(t, sf):
    p, s, l, o, c, n, r = (t["part"], t["supplier"], t["lineitem"], t["orders"],
                           t["customer"], t["nation"], t["region"])
    j = (l.merge(p[p.p_type == "ECONOMY ANODIZED STEEL"], left_on="l_partkey", right_on="p_partkey")
         .merge(s, left_on="l_suppkey", right_on="s_suppkey")
         .merge(o[(o.o_orderdate >= _d("1995-01-01")) & (o.o_orderdate <= _d("1996-12-31"))],
                left_on="l_orderkey", right_on="o_orderkey")
         .merge(c, left_on="o_custkey", right_on="c_custkey")
         .merge(n.add_suffix("_1"), left_on="c_nationkey", right_on="n_nationkey_1")
         .merge(r[r.r_name == "AMERICA"], left_on="n_regionkey_1", right_on="r_regionkey")
         .merge(n.add_suffix("_2"), left_on="s_nationkey", right_on="n_nationkey_2"))
    j["o_year"] = j.o_orderdate.dt.year.astype(np.int64)
    j["volume"] = j.l_extendedprice * (1 - j.l_discount)
    j["brazil"] = np.where(j.n_name_2 == "BRAZIL", j.volume, 0.0)
    g = j.groupby("o_year", as_index=False).agg(b=("brazil", "sum"), v=("volume", "sum"))
    g["mkt_share"] = g.b / g.v
    return g[["o_year", "mkt_share"]].sort_values("o_year").reset_index(drop=True)


def q9(t, sf):
    p, s, l, ps, o, n = (t["part"], t["supplier"], t["lineitem"], t["partsupp"],
                         t["orders"], t["nation"])
    j = (l.merge(p[p.p_name.str.contains("green")], left_on="l_partkey", right_on="p_partkey")
         .merge(s, left_on="l_suppkey", right_on="s_suppkey")
         .merge(ps, left_on=["l_partkey", "l_suppkey"], right_on=["ps_partkey", "ps_suppkey"])
         .merge(o, left_on="l_orderkey", right_on="o_orderkey")
         .merge(n, left_on="s_nationkey", right_on="n_nationkey"))
    j["o_year"] = j.o_orderdate.dt.year.astype(np.int64)
    j["amount"] = j.l_extendedprice * (1 - j.l_discount) - j.ps_supplycost * j.l_quantity
    g = j.groupby(["n_name", "o_year"], as_index=False)["amount"].sum()
    g.columns = ["nation", "o_year", "sum_profit"]
    return g.sort_values(["nation", "o_year"], ascending=[True, False]).reset_index(drop=True)


def q10(t, sf):
    c, o, l, n = t["customer"], t["orders"], t["lineitem"], t["nation"]
    j = (c.merge(o[(o.o_orderdate >= _d("1993-10-01")) & (o.o_orderdate < _d("1994-01-01"))],
                 left_on="c_custkey", right_on="o_custkey")
         .merge(l[l.l_returnflag == "R"], left_on="o_orderkey", right_on="l_orderkey")
         .merge(n, left_on="c_nationkey", right_on="n_nationkey"))
    j["revenue"] = j.l_extendedprice * (1 - j.l_discount)
    g = j.groupby(["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                   "c_address", "c_comment"], as_index=False)["revenue"].sum()
    g = g[["c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
           "c_address", "c_phone", "c_comment"]]
    return g.sort_values("revenue", ascending=False).head(20).reset_index(drop=True)


def q11(t, sf):
    ps, s, n = t["partsupp"], t["supplier"], t["nation"]
    j = (ps.merge(s, left_on="ps_suppkey", right_on="s_suppkey")
         .merge(n[n.n_name == "GERMANY"], left_on="s_nationkey", right_on="n_nationkey"))
    j["value"] = j.ps_supplycost * j.ps_availqty
    frac = 0.0001 / max(sf, 1e-6)  # TPC-H spec: FRACTION = 0.0001 / SF
    thresh = j.value.sum() * frac
    g = j.groupby("ps_partkey", as_index=False)["value"].sum()
    g = g[g.value > thresh]
    return g.sort_values("value", ascending=False).reset_index(drop=True)


def q12(t, sf):
    o, l = t["orders"], t["lineitem"]
    d = l[l.l_shipmode.isin(["MAIL", "SHIP"])
          & (l.l_commitdate < l.l_receiptdate)
          & (l.l_shipdate < l.l_commitdate)
          & (l.l_receiptdate >= _d("1994-01-01"))
          & (l.l_receiptdate < _d("1995-01-01"))]
    j = d.merge(o, left_on="l_orderkey", right_on="o_orderkey")
    j["high"] = j.o_orderpriority.isin(["1-URGENT", "2-HIGH"]).astype(np.int64)
    j["low"] = 1 - j.high
    g = j.groupby("l_shipmode", as_index=False).agg(
        high_line_count=("high", "sum"), low_line_count=("low", "sum"))
    return g.sort_values("l_shipmode").reset_index(drop=True)


def q13(t, sf):
    c, o = t["customer"], t["orders"]
    od = o[~o.o_comment.str.contains("special.*requests", regex=True)]
    cnt = od.groupby("o_custkey").size()
    c_count = c.c_custkey.map(cnt).fillna(0).astype(np.int64)
    g = pd.DataFrame({"c_count": c_count}).groupby("c_count", as_index=False).size()
    g.columns = ["c_count", "custdist"]
    return g.sort_values(["custdist", "c_count"], ascending=[False, False]).reset_index(drop=True)


def q14(t, sf):
    l, p = t["lineitem"], t["part"]
    d = l[(l.l_shipdate >= _d("1995-09-01")) & (l.l_shipdate < _d("1995-10-01"))]
    j = d.merge(p, left_on="l_partkey", right_on="p_partkey")
    j["rev"] = j.l_extendedprice * (1 - j.l_discount)
    promo = j.rev[j.p_type.str.startswith("PROMO")].sum()
    return pd.DataFrame({"promo_revenue": [100.0 * promo / j.rev.sum()]})


def q15(t, sf):
    l, s = t["lineitem"], t["supplier"]
    d = l[(l.l_shipdate >= _d("1996-01-01")) & (l.l_shipdate < _d("1996-04-01"))].copy()
    d["rev"] = d.l_extendedprice * (1 - d.l_discount)
    rev = d.groupby("l_suppkey", as_index=False)["rev"].sum()
    rev.columns = ["supplier_no", "total_revenue"]
    mx = rev.total_revenue.max()
    j = s.merge(rev[np.isclose(rev.total_revenue, mx)], left_on="s_suppkey", right_on="supplier_no")
    out = j[["s_suppkey", "s_name", "s_address", "s_phone", "total_revenue"]]
    return out.sort_values("s_suppkey").reset_index(drop=True)


def q16(t, sf):
    ps, p, s = t["partsupp"], t["part"], t["supplier"]
    bad = s[s.s_comment.str.contains("Customer.*Complaints", regex=True)].s_suppkey
    pp = p[(p.p_brand != "Brand#45")
           & ~p.p_type.str.startswith("MEDIUM POLISHED")
           & p.p_size.isin([49, 14, 23, 45, 19, 3, 36, 9])]
    j = ps.merge(pp, left_on="ps_partkey", right_on="p_partkey")
    j = j[~j.ps_suppkey.isin(bad)]
    g = j.groupby(["p_brand", "p_type", "p_size"], as_index=False)["ps_suppkey"].nunique()
    g.columns = ["p_brand", "p_type", "p_size", "supplier_cnt"]
    return g.sort_values(["supplier_cnt", "p_brand", "p_type", "p_size"],
                         ascending=[False, True, True, True]).reset_index(drop=True)


def q17(t, sf):
    l, p = t["lineitem"], t["part"]
    pp = p[(p.p_brand == "Brand#23") & (p.p_container == "MED BOX")]
    j = l.merge(pp, left_on="l_partkey", right_on="p_partkey")
    avg = l.groupby("l_partkey")["l_quantity"].mean()
    j = j[j.l_quantity < 0.2 * j.l_partkey.map(avg)]
    return pd.DataFrame({"avg_yearly": [j.l_extendedprice.sum() / 7.0]})


def q18(t, sf):
    c, o, l = t["customer"], t["orders"], t["lineitem"]
    th = 300 if sf >= 0.1 else 250
    big = l.groupby("l_orderkey")["l_quantity"].sum()
    big = big[big > th].index
    j = (o[o.o_orderkey.isin(big)]
         .merge(c, left_on="o_custkey", right_on="c_custkey")
         .merge(l, left_on="o_orderkey", right_on="l_orderkey"))
    g = j.groupby(["c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice"],
                  as_index=False)["l_quantity"].sum()
    g.columns = ["c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice",
                 "sum(l_quantity)"]
    return g.sort_values(["o_totalprice", "o_orderdate"],
                         ascending=[False, True]).head(100).reset_index(drop=True)


def q19(t, sf):
    l, p = t["lineitem"], t["part"]
    j = l.merge(p, left_on="l_partkey", right_on="p_partkey")
    base = j.l_shipmode.isin(["AIR", "AIR REG"]) & (j.l_shipinstruct == "DELIVER IN PERSON")
    m1 = ((j.p_brand == "Brand#12")
          & j.p_container.isin(["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
          & (j.l_quantity >= 1) & (j.l_quantity <= 11) & (j.p_size.between(1, 5)))
    m2 = ((j.p_brand == "Brand#23")
          & j.p_container.isin(["MED BAG", "MED BOX", "MED PKG", "MED PACK"])
          & (j.l_quantity >= 10) & (j.l_quantity <= 20) & (j.p_size.between(1, 10)))
    m3 = ((j.p_brand == "Brand#34")
          & j.p_container.isin(["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
          & (j.l_quantity >= 20) & (j.l_quantity <= 30) & (j.p_size.between(1, 15)))
    d = j[base & (m1 | m2 | m3)]
    return pd.DataFrame({"revenue": [(d.l_extendedprice * (1 - d.l_discount)).sum()]})


def q20(t, sf):
    s, n, ps, p, l = t["supplier"], t["nation"], t["partsupp"], t["part"], t["lineitem"]
    forest = p[p.p_name.str.startswith("forest")].p_partkey
    ld = l[(l.l_shipdate >= _d("1994-01-01")) & (l.l_shipdate < _d("1995-01-01"))]
    qty = ld.groupby(["l_partkey", "l_suppkey"], as_index=False)["l_quantity"].sum()
    j = ps[ps.ps_partkey.isin(forest)].merge(
        qty, left_on=["ps_partkey", "ps_suppkey"], right_on=["l_partkey", "l_suppkey"],
        how="inner")
    good = j[j.ps_availqty > 0.5 * j.l_quantity].ps_suppkey.unique()
    out = s[s.s_suppkey.isin(good)].merge(
        n[n.n_name == "CANADA"], left_on="s_nationkey", right_on="n_nationkey")
    return out[["s_name", "s_address"]].sort_values("s_name").reset_index(drop=True)


def q21(t, sf):
    s, l, o, n = t["supplier"], t["lineitem"], t["orders"], t["nation"]
    l1 = l[l.l_receiptdate > l.l_commitdate]
    j = (l1.merge(s.merge(n[n.n_name == "SAUDI ARABIA"], left_on="s_nationkey",
                          right_on="n_nationkey"),
                  left_on="l_suppkey", right_on="s_suppkey")
         .merge(o[o.o_orderstatus == "F"], left_on="l_orderkey", right_on="o_orderkey"))
    # exists: another supplier on same order
    per_order = l.groupby("l_orderkey")["l_suppkey"].nunique()
    j = j[j.l_orderkey.map(per_order) > 1]
    # not exists: another supplier late on same order
    late_per_order = l1.groupby("l_orderkey")["l_suppkey"].nunique()
    late_n = j.l_orderkey.map(late_per_order).fillna(0)
    # late suppliers on the order other than this one
    j = j[(late_n - 1) == 0]
    g = j.groupby("s_name", as_index=False).size()
    g.columns = ["s_name", "numwait"]
    return g.sort_values(["numwait", "s_name"], ascending=[False, True]).head(100).reset_index(drop=True)


def q22(t, sf):
    c, o = t["customer"], t["orders"]
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    cc = c.c_phone.str[:2]
    base = c[cc.isin(codes)].copy()
    base["cntrycode"] = base.c_phone.str[:2]
    avg = base[base.c_acctbal > 0].c_acctbal.mean()
    has_order = base.c_custkey.isin(o.o_custkey)
    d = base[(base.c_acctbal > avg) & ~has_order]
    g = d.groupby("cntrycode", as_index=False).agg(
        numcust=("c_custkey", "size"), totacctbal=("c_acctbal", "sum"))
    return g.sort_values("cntrycode").reset_index(drop=True)

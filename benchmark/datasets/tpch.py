# Frozen copy of datafusion_tpu_torch/models/tpch/datagen.py (itself a copy of
# datafusion_tpu/models/tpch/datagen.py), kept with the benchmark so that no
# later change to the program changes the data. It makes the same values from
# the same seed; what differs: it returns plain columns (dfbench.columns.Col)
# instead of the program's tables, has no on-disk cache, encodes the word
# columns and the small vocabularies without a string sort, and draws the
# order keys and o_custkey as the TPC-H specification (v3.0.1, 4.2.3) does:
# 8 keys of every 32, and no orders for a customer whose key is a multiple
# of 3.
"""The TPC-H dataset: the 8 tables at a scale factor, generated from a seed
with dbgen-like value domains, the 22 queries with the default substitution
parameters (`tpch_queries.py`), and the order of TPC-H stream 00."""
from __future__ import annotations

from typing import Dict

import numpy as np

from dfbench.columns import Col, bounded_unique, strings

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod", "green",
    "grey", "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
    "lace", "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
    "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose", "rosy",
    "royal", "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
    "slate", "smoke", "snow", "spring", "steel", "tan", "thistle", "tomato",
    "turquoise", "violet", "wheat", "white", "yellow",
]
COMMENT_WORDS = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "final",
    "ironic", "regular", "express", "special", "pending", "bold", "even",
    "silent", "unusual", "deposits", "requests", "packages", "accounts",
    "instructions", "foxes", "ideas", "theodolites", "pinto", "beans",
    "platelets", "asymptotes", "dependencies", "excuses", "waters",
    "sleep", "nag", "haggle", "wake", "cajole", "integrate", "boost",
]

START_DATE = int(np.datetime64("1992-01-01", "D").astype(np.int32))
END_DATE = int(np.datetime64("1998-08-02", "D").astype(np.int32))

# TPC-H Appendix A: the query order of stream 00
STREAMS = {"default": ["q14", "q2", "q9", "q20", "q6", "q17", "q18", "q8",
                       "q21", "q13", "q3", "q22", "q16", "q4", "q11", "q15",
                       "q1", "q10", "q19", "q5", "q7", "q12"]}

# a presence table larger than this falls back to np.unique's sort
_PRESENCE_MAX = 1 << 24


def _money(rng, lo: float, hi: float, n: int) -> np.ndarray:
    """decimal(15,2) cents."""
    return rng.integers(int(lo * 100), int(hi * 100) + 1, n, dtype=np.int64)


def _dict_col(strings_per_code: np.ndarray, inv: np.ndarray) -> Col:
    """A string column from per-distinct strings + row->distinct map; the
    distinct strings are deduplicated and sorted, so codes keep their order."""
    uniq, sinv = np.unique(np.asarray(strings_per_code, dtype="U"),
                           return_inverse=True)
    return Col("string", sinv.astype(np.int32)[inv], uniq.astype(object))


def _words_col(w: np.ndarray, words, mask=None, inject: str = "") -> Col:
    """Space-joined word rows -> dictionary column: rows pack to int64 keys
    of the words' ranks in sorted order, only the distinct keys render to
    text. The words are distinct and hold no character at or below " ", so
    the keys' order is the rendered strings' order (a row with the injected
    tail sorts right after the same row without it): the distinct keys give
    the sorted dictionary and the codes with no string sort."""
    n, k = w.shape
    warr, rank = _vocab(words)
    V = len(warr)
    w = rank[w]
    packed = w[:, 0].astype(np.int64)
    for i in range(1, k):
        packed = packed * V + w[:, i]
    bound = V ** k
    if mask is not None:
        packed = packed * 2 + mask
        bound *= 2
    if bound <= _PRESENCE_MAX:
        uniq, inv = bounded_unique(packed, bound)
    else:
        uniq, inv = np.unique(packed, return_inverse=True)
    u = uniq.copy()
    um = None
    if mask is not None:
        um = (u % 2).astype(bool)
        u //= 2
    cols = []
    for _ in range(k):
        cols.append(u % V)
        u //= V
    cols.reverse()
    wobj = warr.astype(object)
    tail = [" " + inject if m else "" for m in um.tolist()] if um is not None else None
    rows = zip(*[wobj[c].tolist() for c in cols], *([tail] if tail else []))
    s = np.empty(len(uniq), dtype=object)
    s[:] = [" ".join(r[:k]) + r[k] for r in rows] if tail else [" ".join(r) for r in rows]
    return Col("string", inv.astype(np.int32).reshape(-1), s)


def _comments(rng, n: int, nwords: int = 5, inject: str = "", inject_frac: float = 0.0):
    w = rng.choice(len(COMMENT_WORDS), size=(n, nwords))
    mask = None
    if inject and inject_frac > 0:
        mask = rng.random(n) < inject_frac
    return _words_col(w, COMMENT_WORDS, mask, inject)


def _zfilled(prefix: str, keys: np.ndarray, width: int = 9) -> Col:
    uniq, inv = np.unique(keys, return_inverse=True)
    s = np.char.add(prefix, np.char.zfill(uniq.astype("U"), width))
    return _dict_col(s, inv)


def _vocab(vocab):
    """(sorted vocabulary, code of each vocabulary entry in it)."""
    sv = np.unique(np.asarray(vocab, dtype="U"))
    return sv, np.searchsorted(sv, np.asarray(vocab, dtype="U")).astype(np.int32)


def _choice(rng, vocab, n: int) -> Col:
    """rng.choice over a small vocabulary, drawn as indices: rng.choice(a, n)
    draws rng.choice(len(a), n) and takes a[idx], so the values are the same."""
    sv, code = _vocab(vocab)
    return Col("string", code[rng.choice(len(vocab), n)], sv.astype(object))


def _known(idx: np.ndarray, vocab) -> Col:
    """The column whose row i is vocab[idx[i]]."""
    sv, code = _vocab(vocab)
    return Col("string", code[idx], sv.astype(object))


def _phones(rng, nations: np.ndarray) -> Col:
    n = len(nations)
    s1 = rng.integers(100, 1000, n)
    s2 = rng.integers(100, 1000, n)
    s3 = rng.integers(1000, 10000, n)
    # fixed-width segments: numeric packed order == lexicographic order
    packed = (((nations * 900 + (s1 - 100)) * 900 + (s2 - 100)) * 9000
              + (s3 - 1000))
    uniq, inv = np.unique(packed, return_inverse=True)
    u = uniq.copy()
    p3 = (u % 9000) + 1000
    u //= 9000
    p2 = (u % 900) + 100
    u //= 900
    p1 = (u % 900) + 100
    nat = (u // 900) + 10
    s = np.char.add(np.char.add(nat.astype("U"), "-"), p1.astype("U"))
    s = np.char.add(np.char.add(s, "-"), p2.astype("U"))
    s = np.char.add(np.char.add(s, "-"), p3.astype("U"))
    return _dict_col(s, inv)


TABLE_NAMES = ("region", "nation", "supplier", "customer", "part",
               "partsupp", "orders", "lineitem")


def generate(config: dict, seed: int) -> Dict[str, Dict[str, Col]]:
    """The 8 tables at config["scale_factor"], from `seed`."""
    return generate_tpch(float(config["scale_factor"]), seed)


def generate_tpch(sf: float, seed: int) -> Dict[str, Dict[str, Col]]:
    rng = np.random.default_rng(seed)
    n_supp = max(int(10_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 30)
    n_part = max(int(200_000 * sf), 40)
    n_ord = max(int(1_500_000 * sf), 150)

    # ---- region / nation -------------------------------------------------
    region = {
        "r_regionkey": Col("int64", np.arange(5, dtype=np.int64)),
        "r_name": strings(REGIONS),
        "r_comment": strings(["" for _ in REGIONS]),
    }
    nation = {
        "n_nationkey": Col("int64", np.arange(25, dtype=np.int64)),
        "n_name": strings([n for n, _ in NATIONS]),
        "n_regionkey": Col("int64", np.asarray([r for _, r in NATIONS], dtype=np.int64)),
        "n_comment": strings(["" for _ in NATIONS]),
    }

    # ---- supplier --------------------------------------------------------
    skey = np.arange(1, n_supp + 1, dtype=np.int64)
    s_nation = rng.integers(0, 25, n_supp).astype(np.int64)
    supplier = _decimal_table({
        "s_suppkey": skey,
        "s_name": _zfilled("Supplier#", skey),
        "s_address": _comments(rng, n_supp, 2),
        "s_nationkey": s_nation,
        "s_phone": _phones(rng, s_nation),
        "s_acctbal": _money(rng, -999.99, 9999.99, n_supp),
        "s_comment": _comments(rng, n_supp, 6, "Customer Complaints", 0.01),
    }, money=["s_acctbal"])

    # ---- part ------------------------------------------------------------
    pkey = np.arange(1, n_part + 1, dtype=np.int64)
    w = rng.choice(len(P_NAME_WORDS), size=(n_part, 5))
    p_name = _words_col(w, P_NAME_WORDS)
    mfgr_n = rng.integers(1, 6, n_part)
    brand_n = mfgr_n * 10 + rng.integers(1, 6, n_part)
    t1 = rng.choice(TYPE_1, n_part)
    t2 = rng.choice(TYPE_2, n_part)
    t3 = rng.choice(TYPE_3, n_part)
    p_type = np.char.add(np.char.add(np.char.add(np.char.add(t1.astype("U"), " "), t2.astype("U")), " "), t3.astype("U"))
    cont = np.char.add(np.char.add(rng.choice(CONTAINER_1, n_part).astype("U"), " "),
                       rng.choice(CONTAINER_2, n_part).astype("U"))
    p_retail = 90000 + ((pkey * 100) % 20001) + 100 * (pkey % 1000)  # cents
    part = _decimal_table({
        "p_partkey": pkey,
        "p_name": p_name,
        "p_mfgr": np.char.add("Manufacturer#", mfgr_n.astype("U")),
        "p_brand": np.char.add("Brand#", brand_n.astype("U")),
        "p_type": p_type,
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
        "p_container": cont,
        "p_retailprice": p_retail.astype(np.int64),
        "p_comment": _comments(rng, n_part, 3),
    }, money=["p_retailprice"])

    # ---- partsupp --------------------------------------------------------
    ps_part = np.repeat(pkey, 4)
    ii = np.tile(np.arange(4, dtype=np.int64), n_part)
    ps_supp = ((ps_part + ii * (n_supp // 4 + (ps_part - 1) // n_supp)) % n_supp) + 1
    nps = len(ps_part)
    partsupp = _decimal_table({
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10_000, nps).astype(np.int64),
        "ps_supplycost": _money(rng, 1.00, 1000.00, nps),
        "ps_comment": _comments(rng, nps, 4),
    }, money=["ps_supplycost"])

    # ---- customer --------------------------------------------------------
    ckey = np.arange(1, n_cust + 1, dtype=np.int64)
    c_nation = rng.integers(0, 25, n_cust).astype(np.int64)
    customer = _decimal_table({
        "c_custkey": ckey,
        "c_name": _zfilled("Customer#", ckey),
        "c_address": _comments(rng, n_cust, 2),
        "c_nationkey": c_nation,
        "c_phone": _phones(rng, c_nation),
        "c_acctbal": _money(rng, -999.99, 9999.99, n_cust),
        "c_mktsegment": _choice(rng, SEGMENTS, n_cust),
        "c_comment": _comments(rng, n_cust, 6, "special requests", 0.02),
    }, money=["c_acctbal"])

    # ---- orders ----------------------------------------------------------
    # dbgen's sparse order keys: the first 8 of every 32
    i_ord = np.arange(n_ord, dtype=np.int64)
    okey = (i_ord // 8) * 32 + i_ord % 8 + 1
    # dbgen's o_custkey: uniform over the customers whose key is not a
    # multiple of 3, so a third of the customers have no orders. A draw on
    # a multiple of 3 is drawn again, from a stream of its own, so that
    # every other column keeps the program generator's values.
    o_cust = rng.integers(1, n_cust + 1, n_ord).astype(np.int64)
    redraw = np.random.default_rng([seed, 3])
    bad = o_cust % 3 == 0
    while bad.any():
        o_cust[bad] = redraw.integers(1, n_cust + 1, int(bad.sum()))
        bad = o_cust % 3 == 0
    o_date = rng.integers(START_DATE, END_DATE - 151, n_ord).astype(np.int32)

    # ---- lineitem --------------------------------------------------------
    nlines = rng.integers(1, 8, n_ord)
    l_order = np.repeat(okey, nlines)
    l_odate = np.repeat(o_date, nlines)
    nl = len(l_order)
    first = np.concatenate([[0], np.cumsum(nlines)[:-1]])
    l_linenumber = (np.arange(nl, dtype=np.int64) - np.repeat(first, nlines)) + 1
    l_part = rng.integers(1, n_part + 1, nl).astype(np.int64)
    which = rng.integers(0, 4, nl)
    l_supp = ((l_part + which * (n_supp // 4 + (l_part - 1) // n_supp)) % n_supp) + 1
    l_qty = rng.integers(1, 51, nl).astype(np.int64)
    l_price = l_qty * p_retail[l_part - 1]  # cents
    l_disc = rng.integers(0, 11, nl).astype(np.int64)  # scale-2 cents (0.00-0.10)
    l_tax = rng.integers(0, 9, nl).astype(np.int64)
    l_ship = l_odate + rng.integers(1, 122, nl).astype(np.int32)
    l_commit = l_odate + rng.integers(30, 91, nl).astype(np.int32)
    l_receipt = l_ship + rng.integers(1, 31, nl).astype(np.int32)
    cutoff = int(np.datetime64("1995-06-17", "D").astype(np.int32))
    l_open = l_ship > cutoff
    # indices into ["O", "F"] and ["R", "A", "N"]
    l_linestatus = np.where(l_open, 0, 1)
    ret = rng.random(nl)
    l_returnflag = np.where(l_receipt <= cutoff, np.where(ret < 0.5, 0, 1), 2)

    lineitem = _decimal_table({
        "l_orderkey": l_order,
        "l_partkey": l_part,
        "l_suppkey": l_supp,
        "l_linenumber": l_linenumber,
        "l_quantity": l_qty * 100,  # decimal(15,2)
        "l_extendedprice": l_price,
        "l_discount": l_disc,
        "l_tax": l_tax,
        "l_returnflag": _known(l_returnflag, ["R", "A", "N"]),
        "l_linestatus": _known(l_linestatus, ["O", "F"]),
        "l_shipdate": l_ship,
        "l_commitdate": l_commit,
        "l_receiptdate": l_receipt,
        "l_shipinstruct": _choice(rng, SHIPINSTRUCT, nl),
        "l_shipmode": _choice(rng, SHIPMODES, nl),
        "l_comment": _comments(rng, nl, 3),
    }, money=["l_quantity", "l_extendedprice", "l_discount", "l_tax"],
        dates=["l_shipdate", "l_commitdate", "l_receiptdate"])

    # order aggregates from lineitems
    gross = (l_price * (100 - l_disc) * (100 + l_tax)) // 10000
    oidx = np.repeat(np.arange(n_ord), nlines)
    # bincount sums are exact here (per-order totals < 2^53)
    o_total = np.bincount(oidx, weights=gross.astype(np.float64),
                          minlength=n_ord).astype(np.int64)
    n_open = np.bincount(oidx, weights=l_open.astype(np.float64),
                         minlength=n_ord).astype(np.int64)
    # indices into ["O", "P", "F"]
    o_status = np.where(n_open == nlines, 0, np.where(n_open > 0, 1, 2))

    orders = _decimal_table({
        "o_orderkey": okey,
        "o_custkey": o_cust,
        "o_orderstatus": _known(o_status, ["O", "P", "F"]),
        "o_totalprice": o_total,
        "o_orderdate": o_date,
        "o_orderpriority": _choice(rng, PRIORITIES, n_ord),
        "o_clerk": _zfilled("Clerk#", rng.integers(1, max(n_supp // 10, 2), n_ord).astype(np.int64)),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": _comments(rng, n_ord, 5, "special requests", 0.02),
    }, money=["o_totalprice"], dates=["o_orderdate"])

    return {
        "region": region, "nation": nation, "supplier": supplier,
        "part": part, "partsupp": partsupp, "customer": customer,
        "orders": orders, "lineitem": lineitem,
    }


def _decimal_table(data: Dict, money=(), dates=()) -> Dict[str, Col]:
    """Plain columns where `money` columns are decimal(15,2) given as cents
    and `dates` are date32 epoch days; integer columns that fit take int32."""
    out = {}
    for name, values in data.items():
        if isinstance(values, Col):
            col = values
        elif values.dtype.kind in ("U", "O"):
            col = strings(values)
        elif name in money:
            col = Col("decimal", np.asarray(values, dtype=np.int64), None, 15, 2)
        elif name in dates:
            col = Col("date32", np.asarray(values, dtype=np.int32))
        elif np.issubdtype(values.dtype, np.integer):
            small = values.size == 0 or (
                values.min() >= -(2**31) and values.max() < 2**31)
            col = Col("int32", values.astype(np.int32)) if small else \
                Col("int64", values.astype(np.int64))
        else:
            col = Col("float64", values.astype(np.float64))
        out[name] = col
    return out


def queries(config: dict) -> Dict[str, str]:
    """{"q1": text, ...}: the 22 queries with their substitution parameters."""
    from dfbench.manifest import sibling

    query = sibling(__file__, "tpch_queries").query
    sf = float(config["scale_factor"])
    return {f"q{n}": query(n, sf) for n in range(1, 23)}

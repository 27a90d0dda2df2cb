# Verbatim copy of datafusion_tpu/models/tpch/datagen.py; host-only, kept in step with the original.
"""TPC-H data generator (vectorized numpy, dbgen-like distributions).

Generates the 8 TPC-H tables at a given scale factor with the value domains
the 22 queries select on (segments, brands, types, date ranges, comment
patterns), deterministic under a fixed seed.  Not byte-identical to dbgen:
correctness testing is differential (same data into this engine and into the
pandas reference implementations in queries_ref.py), mirroring the
reference's fuzzing strategy (datafusion/core/tests/fuzz_cases/
aggregation_fuzzer, SURVEY.md §4).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict

import numpy as np

from ...data.column import Dictionary, HostColumn
from ...data.table import Table

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

_DATE0 = np.datetime64("1992-01-01").astype("datetime64[D]").astype(np.int32)
START_DATE = int(np.datetime64("1992-01-01", "D").astype(np.int32))
END_DATE = int(np.datetime64("1998-08-02", "D").astype(np.int32))


def _money(rng, lo: float, hi: float, n: int) -> np.ndarray:
    """decimal(15,2) cents."""
    return rng.integers(int(lo * 100), int(hi * 100) + 1, n, dtype=np.int64)


def _dict_col(strings_per_code: np.ndarray, inv: np.ndarray):
    """HostColumn(STRING) from per-distinct strings + row->distinct map.

    Dedups + sorts the distinct strings (two packed keys can render the same
    text, e.g. an injected phrase whose words are also vocabulary words) so
    codes stay order-preserving against a SORTED dictionary."""
    from ...common import types as T

    uniq, sinv = np.unique(np.asarray(strings_per_code, dtype="U"),
                           return_inverse=True)
    codes = sinv.astype(np.int32)[inv]
    return HostColumn(T.STRING, codes, None, Dictionary(uniq.astype(object)))


def _words_col(w: np.ndarray, words, mask=None, inject: str = ""):
    """Space-joined word rows -> dictionary column, built without ever
    materializing the n full strings: rows pack to int64 keys, only the
    distinct keys render to text (SF10 lineitem comments: 60M rows but only
    ~50k distinct)."""
    n, k = w.shape
    V = len(words)
    packed = w[:, 0].astype(np.int64)
    for i in range(1, k):
        packed = packed * V + w[:, i]
    if mask is not None:
        packed = packed * 2 + mask
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
    warr = np.asarray(words, dtype="U")
    s = warr[cols[0]]
    for c in cols[1:]:
        s = np.char.add(np.char.add(s, " "), warr[c])
    if um is not None:
        s = np.where(um, np.char.add(np.char.add(s, " "), inject), s)
    return _dict_col(s, inv)


def _comments(rng, n: int, nwords: int = 5, inject: str = "", inject_frac: float = 0.0):
    w = rng.choice(len(COMMENT_WORDS), size=(n, nwords))
    mask = None
    if inject and inject_frac > 0:
        mask = rng.random(n) < inject_frac
    return _words_col(w, COMMENT_WORDS, mask, inject)


def _zfilled(prefix: str, keys: np.ndarray, width: int = 9):
    uniq, inv = np.unique(keys, return_inverse=True)
    s = np.char.add(prefix, np.char.zfill(uniq.astype("U"), width))
    return _dict_col(s, inv)


def _choice(rng, vocab, n: int):
    """rng.choice over a small vocabulary, dictionary-encoded by
    searchsorted instead of a full n-row string sort."""
    arr = rng.choice(vocab, n)
    return _known(arr, vocab)


def _known(arr: np.ndarray, vocab):
    from ...common import types as T

    sv = np.unique(np.asarray(vocab, dtype="U"))
    codes = np.searchsorted(sv, np.asarray(arr, dtype="U")).astype(np.int32)
    return HostColumn(T.STRING, codes, None, Dictionary(sv.astype(object)))


def _phones(rng, nations: np.ndarray):
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

_CACHE_ENV = "DATAFUSION_TPU_DATA_CACHE"


def _cache_dir(sf: float, seed: int) -> str:
    base = os.environ.get(_CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "datafusion_tpu_data")
    return os.path.join(base, f"tpch_sf{sf:g}_seed{seed}")


def _dtype_token(dt) -> list:
    return [dt.kind.value, dt.precision, dt.scale]


def _dtype_from_token(tok):
    from ...common import types as T

    kind = T.TypeKind(tok[0])
    if kind is T.TypeKind.DECIMAL:
        return T.decimal(tok[1], tok[2])
    return T.DataType(kind)


def _save_table(path: str, table: Table) -> None:
    arrays = {}
    schema = []
    for f, c in zip(table.schema.fields, table.columns):
        schema.append([f.name, _dtype_token(f.dtype), bool(f.nullable)])
        arrays[f"{f.name}.data"] = c.data
        if c.validity is not None:
            arrays[f"{f.name}.valid"] = c.validity
        if c.dictionary is not None:
            arrays[f"{f.name}.dict"] = c.dictionary.values
    arrays["schema.json"] = np.frombuffer(
        json.dumps(schema).encode(), dtype=np.uint8).copy()
    np.savez(path, **arrays)


def _load_table(path: str) -> Table:
    from ...common.schema import Field, Schema
    from ...data.column import Dictionary, HostColumn

    with np.load(path, allow_pickle=True) as z:
        schema = json.loads(bytes(z["schema.json"]).decode())
        fields, cols = [], []
        for name, tok, nullable in schema:
            dt = _dtype_from_token(tok)
            data = z[f"{name}.data"]
            valid = z[f"{name}.valid"] if f"{name}.valid" in z else None
            d = (Dictionary(z[f"{name}.dict"])
                 if f"{name}.dict" in z else None)
            fields.append(Field(name, dt, nullable=nullable))
            cols.append(HostColumn(dt, data, valid, d))
    return Table(Schema(fields), cols)


def generate_tpch(sf: float = 0.01, seed: int = 42,
                  cache: bool = True) -> Dict[str, Table]:
    """Generate (or load from the on-disk cache) the 8 TPC-H tables.

    Generation at SF1 costs ~3 minutes of numpy time; bench runs under a
    driver timeout cannot afford that twice, so tables for sf >= 0.05 are
    cached under ~/.cache/datafusion_tpu_data as npz files preserving the
    exact host representation (dtype, data, validity, sorted dictionary)."""
    if cache and sf >= 0.05:
        d = _cache_dir(sf, seed)
        try:
            if all(os.path.exists(os.path.join(d, f"{n}.npz"))
                   for n in TABLE_NAMES):
                return {n: _load_table(os.path.join(d, f"{n}.npz"))
                        for n in TABLE_NAMES}
        except Exception:
            pass  # unreadable cache: regenerate below
        tables = _generate_tpch(sf, seed)
        try:
            tmp = d + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            for n, t in tables.items():
                _save_table(os.path.join(tmp, f"{n}.npz"), t)
            shutil.rmtree(d, ignore_errors=True)
            os.replace(tmp, d)
        except Exception:
            pass  # cache write is best-effort
        return tables
    return _generate_tpch(sf, seed)


def _generate_tpch(sf: float, seed: int) -> Dict[str, Table]:
    rng = np.random.default_rng(seed)
    n_supp = max(int(10_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 30)
    n_part = max(int(200_000 * sf), 40)
    n_ord = max(int(1_500_000 * sf), 150)

    # ---- region / nation -------------------------------------------------
    region = Table.from_pydict({
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": REGIONS,
        "r_comment": ["" for _ in REGIONS],
    })
    nation = Table.from_pydict({
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": [n for n, _ in NATIONS],
        "n_regionkey": np.asarray([r for _, r in NATIONS], dtype=np.int64),
        "n_comment": ["" for _ in NATIONS],
    })

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
    okey = (np.arange(n_ord, dtype=np.int64) // 4) * 32 + (np.arange(n_ord, dtype=np.int64) % 4) * 2 + 1
    o_cust = rng.integers(1, n_cust + 1, n_ord).astype(np.int64)
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
    l_linestatus = np.where(l_open, "O", "F")
    ret = rng.random(nl)
    l_returnflag = np.where(l_receipt <= cutoff, np.where(ret < 0.5, "R", "A"), "N")

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
    o_status = np.where(n_open == nlines, "O", np.where(n_open > 0, "P", "F"))

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


def _decimal_table(data: Dict, money=(), dates=(), timestamps=()) -> Table:
    """Build a Table where `money` columns are decimal(15,2) given as cents,
    `dates` are date32 epoch days, `timestamps` are int64 epoch micros."""
    from ...common import types as T
    from ...common.schema import Field, Schema
    from ...data.column import HostColumn, column_from_values

    fields, cols = [], []
    for name, values in data.items():
        if isinstance(values, HostColumn):
            col = values
        elif isinstance(values, np.ndarray) and values.dtype.kind in ("U", "O"):
            # vectorized dictionary encoding (no per-element Python loop;
            # datagen strings are never NULL)
            uniq, inv = np.unique(np.asarray(values, dtype="U"),
                                  return_inverse=True)
            col = HostColumn(T.STRING, inv.astype(np.int32), None,
                             Dictionary(uniq.astype(object)))
        elif name in money:
            col = HostColumn(T.decimal(15, 2), np.asarray(values, dtype=np.int64))
        elif name in dates:
            col = HostColumn(T.DATE32, np.asarray(values, dtype=np.int32))
        elif name in timestamps:
            col = HostColumn(T.TIMESTAMP, np.asarray(values, dtype=np.int64))
        elif isinstance(values, np.ndarray) and values.dtype != object:
            if np.issubdtype(values.dtype, np.integer):
                # narrow keys that fit to int32: TPU sorts/joins on 32-bit
                # keys compile and run markedly faster than emulated 64-bit
                small = values.size == 0 or (
                    values.min() >= -(2**31) and values.max() < 2**31)
                dt = T.INT32 if small else T.INT64
            else:
                dt = T.FLOAT64
            col = HostColumn(dt, values.astype(dt.np_dtype()))
        else:
            col = column_from_values(list(values))
        fields.append(Field(name, col.dtype, nullable=False))
        cols.append(col)
    return Table(Schema(fields), cols)


def register_tpch(ctx, sf: float = 0.01, seed: int = 42) -> None:
    for name, table in generate_tpch(sf, seed).items():
        ctx.register_table(name, table)

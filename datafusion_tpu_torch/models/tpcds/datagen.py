# Verbatim copy of datafusion_tpu/models/tpcds/datagen.py; host-only, kept in step with the original.
"""TPC-DS data generator (vectorized numpy, dsdgen-like domains).

Generates all 24 TPC-DS tables at a small synthetic scale with the value
domains the 99 public queries select on (categories, states, demographics
cross-products, calendar dimensions, ticket/order line grouping, sales ->
returns referential links), deterministic under a fixed seed. Not
byte-identical to dsdgen: correctness testing is differential -- the same
data is loaded into this engine and into sqlite, and every supported query's
results are compared (tests/test_tpcds_exec.py), mirroring the reference's
answer-checking discipline (datafusion/sqllogictest/test_files/tpch/answers,
SURVEY.md §4) with an independent SQL engine as the oracle.

Schema: models/tpcds/schema.py (24 tables / 425 columns, from the public
TPC-DS specification, (c) 2015 TPC). Domain constants below come from the
same specification's column value lists.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ...common import types as T
from ...common.schema import Field, Schema
from ...data.column import HostColumn, column_from_values
from ...data.table import Table
from .schema import SCHEMAS

# ---------------------------------------------------------------------------
# spec value domains (TPC-DS v2 column lists; the 99 queries' literals are a
# subset of these)

CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry", "Men",
              "Music", "Shoes", "Sports", "Women"]
CLASSES = ["accessories", "birdal", "classical", "consignment", "fragrances",
           "musical", "pants", "parenting", "personal", "portable",
           "reference", "self-help", "wallpaper", "womens", "shirts",
           "dresses", "country", "rock", "pop", "fiction", "history",
           "mystery", "romance", "computers", "audio", "cameras",
           "televisions", "kids", "infants", "toddlers"]
COLORS = ["azure", "bisque", "burlywood", "burnished", "chiffon", "chocolate",
          "cornflower", "dim", "forest", "gainsboro", "lace", "maroon",
          "medium", "metallic", "midnight", "navajo", "navy", "orchid",
          "papaya", "purple", "salmon", "snow", "steel", "almond", "antique",
          "beige", "black", "blue", "blush", "brown", "coral", "cream",
          "cyan", "khaki", "lavender", "lemon", "linen", "magenta", "mint",
          "olive", "orange", "peach", "pink", "plum", "powder", "red",
          "rose", "royal", "saddle", "sandy", "seashell", "sienna", "sky",
          "slate", "smoke", "spring", "tan", "thistle", "tomato",
          "turquoise", "violet", "wheat", "white", "yellow"]
SIZES = ["petite", "small", "medium", "large", "extra large", "economy",
         "N/A"]
UNITS = ["Box", "Bunch", "Bundle", "Carton", "Dram", "Each", "Gram", "Gross",
         "Lb", "Ounce", "Oz", "Pound", "Tbl", "Tsp", "Unknown"]
BRAND_STEMS = ["amalgimporto", "edu packscholar", "exportiimporto",
               "exportiunivamalg", "importoamalg", "scholaramalgamalg",
               "amalgamalg", "univunivamalg", "brandbrand", "corpbrand",
               "edu packamalg", "importoexporti", "maxinamnamst"]
STORE_NAMES = ["ought", "able", "pri", "ese", "anti", "cally", "ation",
               "eing", "bar"]
CITIES = ["Greenwood", "Hopewell", "Oakland", "Riverside", "Salem", "Union",
          "Fairview", "Midway", "Centerville", "Georgetown", "Liberty",
          "Springfield", "Franklin", "Clinton", "Marion"]
COUNTIES = ["Barrow County", "Daviess County", "Dona Ana County",
            "Douglas County", "Fairfield County", "Franklin Parish",
            "Gaines County", "Luce County", "Richland County",
            "Walker County", "Williamson County", "Ziebach County"]
STATES = ["AL", "CA", "CO", "GA", "IL", "IN", "KY", "LA", "MI", "MN", "MO",
          "MS", "MT", "NC", "ND", "NM", "OH", "OK", "OR", "SC", "SD", "TN",
          "TX", "WA", "WI", "WV"]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
             "Advanced Degree", "Unknown"]
CREDIT_RATINGS = ["Low Risk", "Good", "High Risk", "Unknown"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000", "0-500",
                 "Unknown"]
CARRIERS = ["DIAMOND", "AIRBORNE", "UPS", "FEDEX", "USPS", "DHL", "TBS",
            "ZHOU", "LATVIAN", "ALLIANCE"]
SM_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY",
            "LIBRARY"]
SM_CODES = ["AIR", "SURFACE", "SEA"]
MEALS = ["breakfast", "lunch", "dinner"]
REASONS = ["Did not like the warranty", "Package was damaged", "Wrong size",
           "Not the product that was ordred", "Parts missing",
           "Does not work with a product that I have",
           "Gift exchange", "Did not like the color", "Did not fit",
           "Found a better price in a store", "Found a better extension",
           "No service location in my area", "Unauthorized purchase",
           "Did not like the model", "Did not like the make"]
FIRST_NAMES = ["James", "Mary", "John", "Linda", "Robert", "Barbara",
               "Michael", "Susan", "William", "Margaret", "David",
               "Dorothy", "Richard", "Lisa", "Charles", "Nancy", "Joseph",
               "Karen", "Thomas", "Betty", "Anthony", "Helen", "Donald",
               "Sandra", "Mark", "Donna", "Paul", "Carol", "Steven",
               "Ruth", "Kenneth", "Sharon"]
LAST_NAMES = ["Smith", "Johnson", "Williams", "Jones", "Brown", "Davis",
              "Miller", "Wilson", "Moore", "Taylor", "Anderson", "Thomas",
              "Jackson", "White", "Harris", "Martin", "Thompson", "Garcia",
              "Martinez", "Robinson", "Clark", "Rodriguez", "Lewis", "Lee",
              "Walker", "Hall", "Allen", "Young"]
STREET_NAMES = ["Main", "Oak", "Park", "First", "Second", "Cedar", "Elm",
                "View", "Lake", "Hill", "Pine", "Maple", "Spring", "Ridge",
                "Walnut", "College", "Church", "Mill", "River", "Sunset"]
STREET_TYPES = ["Street", "Ave", "Blvd", "Way", "Court", "Dr", "Circle",
                "Lane", "Parkway", "Road"]
LOCATION_TYPES = ["apartment", "condo", "single family"]
COUNTRIES = ["United States"]
BIRTH_COUNTRIES = ["UNITED STATES", "CANADA", "MEXICO", "GERMANY", "FRANCE",
                   "JAPAN", "CHINA", "BRAZIL", "INDIA", "ITALY", "SPAIN",
                   "NIGER", "TOGO", "CHILE", "GREECE"]
SALUTATIONS = ["Mr.", "Mrs.", "Ms.", "Miss", "Dr.", "Sir"]
WEB_NAMES = ["site_%d" % i for i in range(8)]

# calendar span: every query's year literal (1998-2002) falls inside
_D0 = int(np.datetime64("1996-01-01", "D").astype(np.int64))
_D1 = int(np.datetime64("2003-12-31", "D").astype(np.int64))
N_DAYS = _D1 - _D0 + 1
# d_date_sk follows the spec's julian-day convention (2415022 = 1900-01-01)
SK0 = 2415022 + (_D0 - int(np.datetime64("1900-01-01", "D").astype(np.int64)))


def _ids(prefix: str, keys: np.ndarray, width: int = 16) -> np.ndarray:
    return np.char.add(prefix, np.char.zfill(
        keys.astype(np.int64).astype("U"), width - len(prefix))).astype(object)


def _table(name: str, data: Dict) -> Table:
    """Build a Table matching SCHEMAS[name]'s declared types: decimals given
    as scaled ints, DATE32 as epoch days, CHAR/VARCHAR as object arrays."""
    fields, cols = [], []
    for cname, dt in SCHEMAS[name]:
        values = data[cname]
        if dt.is_decimal:
            v = np.asarray(values)
            mask = None
            if v.dtype == object:
                mask = np.array([x is None for x in values])
                v = np.where(mask, 0, v).astype(np.int64)
            col = HostColumn(dt, v.astype(np.int64),
                             ~mask if mask is not None else None)
        elif dt.kind is T.TypeKind.DATE32:
            v = np.asarray(values)
            if v.dtype == object:
                mask = np.array([x is None for x in values])
                v2 = np.where(mask, 0, v).astype(np.int32)
                col = HostColumn(dt, v2, ~mask)
            else:
                col = HostColumn(dt, v.astype(np.int32))
        elif isinstance(values, np.ndarray) and values.dtype != object:
            if np.issubdtype(values.dtype, np.floating) and dt.kind in (
                    T.TypeKind.INT32, T.TypeKind.INT64):
                # float array with NaNs encoding a nullable int column
                mask = np.isnan(values)
                v = np.where(mask, 0, values).astype(dt.np_dtype())
                col = HostColumn(dt, v, ~mask)
            else:
                col = HostColumn(dt, values.astype(dt.np_dtype()))
        else:
            col = column_from_values(list(values), dt)
        fields.append(Field(cname, col.dtype,
                            nullable=col.validity is not None))
        cols.append(col)
    return Table(Schema(fields), cols)


def _null_some(rng, a: np.ndarray, frac: float = 0.03) -> np.ndarray:
    """FK int column with a NULL fraction, encoded as float NaNs."""
    out = a.astype(np.float64)
    out[rng.random(a.size) < frac] = np.nan
    return out


def _money(rng, lo: float, hi: float, n: int) -> np.ndarray:
    return rng.integers(int(lo * 100), int(hi * 100) + 1, n, dtype=np.int64)


def _date_dim() -> Dict:
    days = np.arange(_D0, _D1 + 1, dtype=np.int64)
    d64 = days.astype("datetime64[D]")
    ymd = d64.astype("datetime64[Y]").astype(int) + 1970
    year = ymd
    month0 = d64.astype("datetime64[M]").astype(int) % 12  # 0-based
    dom = (d64 - d64.astype("datetime64[M]")).astype(int) + 1
    dow = ((days + 4) % 7).astype(int)  # 1970-01-01 was a Thursday
    qoy = month0 // 3 + 1
    seq = np.arange(len(days))
    month_seq = (year - 1900) * 12 + month0
    week_seq = ((days - _D0) // 7) + (_D0 // 7)
    first_dom = (d64.astype("datetime64[M]").astype("datetime64[D]")
                 - np.timedelta64(0, "D")).astype(np.int64)
    last_dom = ((d64.astype("datetime64[M]") + 1).astype("datetime64[D]")
                - np.timedelta64(1, "D")).astype(np.int64)
    return {
        "d_date_sk": days - _D0 + SK0,
        "d_date_id": _ids("D", days - _D0),
        "d_date": days.astype(np.int32),
        "d_month_seq": month_seq,
        "d_week_seq": week_seq,
        "d_quarter_seq": (year - 1900) * 4 + qoy - 1,
        "d_year": year,
        "d_dow": dow,
        "d_moy": month0 + 1,
        "d_dom": dom,
        "d_qoy": qoy,
        "d_fy_year": year,
        "d_fy_quarter_seq": (year - 1900) * 4 + qoy - 1,
        "d_fy_week_seq": week_seq,
        "d_day_name": np.asarray(DAY_NAMES, dtype=object)[dow],
        "d_quarter_name": np.char.add(
            year.astype("U"), np.char.add("Q", qoy.astype("U"))).astype(object),
        "d_holiday": np.where((month0 + 1 == 12) & (dom == 25), "Y", "N").astype(object),
        "d_weekend": np.where((dow == 0) | (dow == 6), "Y", "N").astype(object),
        "d_following_holiday": np.where((month0 + 1 == 12) & (dom == 26), "Y", "N").astype(object),
        "d_first_dom": first_dom - _D0 + SK0,
        "d_last_dom": last_dom - _D0 + SK0,
        "d_same_day_ly": days - _D0 + SK0 - 365,
        "d_same_day_lq": days - _D0 + SK0 - 91,
        "d_current_day": np.full(len(days), "N", dtype=object),
        "d_current_week": np.full(len(days), "N", dtype=object),
        "d_current_month": np.full(len(days), "N", dtype=object),
        "d_current_quarter": np.full(len(days), "N", dtype=object),
        "d_current_year": np.full(len(days), "N", dtype=object),
    }


def _time_dim() -> Dict:
    # one row per 10 seconds covers every (hour, minute) pair the queries
    # filter on at 1/10 the spec's 86400 rows
    secs = np.arange(0, 86400, 10, dtype=np.int64)
    hour = secs // 3600
    minute = (secs % 3600) // 60
    shift = np.where(hour < 8, "third", np.where(hour < 16, "first", "second"))
    meal = np.select(
        [(hour >= 6) & (hour < 9), (hour >= 11) & (hour < 13),
         (hour >= 17) & (hour < 20)],
        ["breakfast", "lunch", "dinner"], default="")
    return {
        "t_time_sk": secs,
        "t_time_id": _ids("T", secs),
        "t_time": secs,
        "t_hour": hour,
        "t_minute": minute,
        "t_second": secs % 60,
        "t_am_pm": np.where(hour < 12, "AM", "PM").astype(object),
        "t_shift": shift.astype(object),
        "t_sub_shift": shift.astype(object),
        "t_meal_time": meal.astype(object),
    }


def generate_tpcds(sf: float = 0.05, seed: int = 7) -> Dict[str, Table]:
    """All 24 tables; sf=1.0 gives ~480k store_sales rows (a differential
    test scale, not the TPC scale factor)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Table] = {}

    date_dim = _date_dim()
    out["date_dim"] = _table("date_dim", date_dim)
    time_dim = _time_dim()
    out["time_dim"] = _table("time_dim", time_dim)

    n_item = max(int(2000 * min(sf * 4, 1.0)), 200)
    n_cust = max(int(20000 * sf), 500)
    n_addr = max(n_cust // 2, 250)
    n_store = 12
    n_wh = 6
    n_promo = 300
    n_cc = 6
    n_cp = 800
    n_web_site = 8
    n_web_page = 60

    # ---- item (SCD: ~2 surrogate keys share one i_item_id) ----------------
    sk = np.arange(1, n_item + 1, dtype=np.int64)
    brand_stem = rng.integers(0, len(BRAND_STEMS), n_item)
    brand_num = rng.integers(1, 15, n_item)
    cat_idx = rng.integers(0, len(CATEGORIES), n_item)
    man_id = rng.integers(1, 1001, n_item)
    rec_split = (_D0 + N_DAYS // 2 - _D0 + SK0)
    item = {
        "i_item_sk": sk,
        "i_item_id": _ids("AAAAAAAA", sk // 2),
        "i_rec_start_date": np.full(n_item, _D0, dtype=np.int64).astype(np.int32),
        "i_rec_end_date": np.where(sk % 2 == 0, _D1, _D1).astype(np.int32),
        "i_item_desc": np.asarray(
            ["item description %d" % k for k in sk // 2], dtype=object),
        "i_current_price": _money(rng, 0.5, 99.0, n_item),
        "i_wholesale_cost": _money(rng, 0.3, 60.0, n_item),
        "i_brand_id": (brand_stem + 1) * 1000000 + brand_num * 1000 + man_id % 100,
        "i_brand": np.asarray(
            [f"{BRAND_STEMS[s]} #{b}" for s, b in zip(brand_stem, brand_num)],
            dtype=object),
        "i_class_id": rng.integers(1, 17, n_item),
        "i_class": rng.choice(CLASSES, n_item).astype(object),
        "i_category_id": cat_idx + 1,
        "i_category": np.asarray(CATEGORIES, dtype=object)[cat_idx],
        "i_manufact_id": man_id,
        "i_manufact": np.asarray(["manufact #%d" % m for m in man_id],
                                 dtype=object),
        "i_size": rng.choice(SIZES, n_item).astype(object),
        "i_formulation": _ids("F", rng.integers(0, 10**9, n_item), 20),
        "i_color": rng.choice(COLORS, n_item).astype(object),
        "i_units": rng.choice(UNITS, n_item).astype(object),
        "i_container": np.full(n_item, "Unknown", dtype=object),
        "i_manager_id": rng.integers(1, 101, n_item),
        "i_product_name": np.asarray(
            ["product %d" % k for k in sk], dtype=object),
    }
    out["item"] = _table("item", item)

    # ---- store ------------------------------------------------------------
    sk = np.arange(1, n_store + 1, dtype=np.int64)
    # the spec concentrates stores in TN; queries also hit other states
    s_state = np.asarray(["TN"] * 6 + list(rng.choice(STATES, n_store - 6)),
                         dtype=object)
    store = {
        "s_store_sk": sk,
        "s_store_id": _ids("S", sk),
        "s_rec_start_date": np.full(n_store, _D0).astype(np.int32),
        "s_rec_end_date": np.full(n_store, _D1).astype(np.int32),
        "s_closed_date_sk": _null_some(rng, np.full(n_store, SK0 + 100), 0.7),
        "s_store_name": np.asarray(
            [STORE_NAMES[i % len(STORE_NAMES)] for i in range(n_store)],
            dtype=object),
        "s_number_employees": rng.integers(200, 301, n_store),
        "s_floor_space": rng.integers(5000000, 10000001, n_store),
        "s_hours": np.full(n_store, "8AM-8PM", dtype=object),
        "s_manager": rng.choice(LAST_NAMES, n_store).astype(object),
        "s_market_id": rng.integers(1, 11, n_store),
        "s_geography_class": np.full(n_store, "Unknown", dtype=object),
        "s_market_desc": np.full(n_store, "market", dtype=object),
        "s_market_manager": rng.choice(LAST_NAMES, n_store).astype(object),
        "s_division_id": np.ones(n_store, dtype=np.int64),
        "s_division_name": np.full(n_store, "Unknown", dtype=object),
        "s_company_id": np.ones(n_store, dtype=np.int64),
        "s_company_name": np.full(n_store, "Unknown", dtype=object),
        "s_street_number": rng.integers(1, 1000, n_store).astype("U").astype(object),
        "s_street_name": rng.choice(STREET_NAMES, n_store).astype(object),
        "s_street_type": rng.choice(STREET_TYPES, n_store).astype(object),
        "s_suite_number": np.full(n_store, "Suite 100", dtype=object),
        "s_city": rng.choice(CITIES, n_store).astype(object),
        "s_county": rng.choice(COUNTIES, n_store).astype(object),
        "s_state": s_state,
        "s_zip": rng.integers(10000, 99999, n_store).astype("U").astype(object),
        "s_country": np.full(n_store, "United States", dtype=object),
        "s_gmt_offset": np.full(n_store, -500, dtype=np.int64),  # dec(5,2)
        "s_tax_precentage": rng.integers(0, 12, n_store),  # dec(5,2) cents
    }
    out["store"] = _table("store", store)

    # ---- customer_address -------------------------------------------------
    sk = np.arange(1, n_addr + 1, dtype=np.int64)
    ca = {
        "ca_address_sk": sk,
        "ca_address_id": _ids("A", sk),
        "ca_street_number": rng.integers(1, 1000, n_addr).astype("U").astype(object),
        "ca_street_name": rng.choice(STREET_NAMES, n_addr).astype(object),
        "ca_street_type": rng.choice(STREET_TYPES, n_addr).astype(object),
        "ca_suite_number": np.asarray(
            ["Suite %d" % x for x in rng.integers(1, 100, n_addr)], dtype=object),
        "ca_city": rng.choice(CITIES, n_addr).astype(object),
        "ca_county": rng.choice(COUNTIES, n_addr).astype(object),
        "ca_state": rng.choice(STATES, n_addr).astype(object),
        "ca_zip": rng.choice(
            ["24128", "76232", "65084", "87816", "83926", "77556", "20548",
             "26231", "43848", "15126", "91137", "61265", "98294", "25782",
             "17920", "18426", "98235", "40081", "84093", "28577", "55565",
             "17183", "54601", "67897", "22752", "86284", "18376", "38607",
             "45200", "21756", "29741", "96765", "23932", "89360", "29839",
             "25989", "28898", "91068", "72550", "10390"], n_addr).astype(object),
        "ca_country": np.full(n_addr, "United States", dtype=object),
        "ca_gmt_offset": rng.choice([-500, -600, -700, -800], n_addr),
        "ca_location_type": rng.choice(LOCATION_TYPES, n_addr).astype(object),
    }
    out["customer_address"] = _table("customer_address", ca)

    # ---- customer_demographics (structured cross product) -----------------
    g, m, e = np.meshgrid(np.arange(2), np.arange(5), np.arange(7),
                          indexing="ij")
    base = np.stack([g.ravel(), m.ravel(), e.ravel()], axis=1)
    reps = 56  # 70 * 56 = 3920 rows; purchase/credit/dep dims vary per rep
    base = np.tile(base, (reps, 1))
    n_cd = len(base)
    sk = np.arange(1, n_cd + 1, dtype=np.int64)
    cd = {
        "cd_demo_sk": sk,
        "cd_gender": np.asarray(GENDERS, dtype=object)[base[:, 0]],
        "cd_marital_status": np.asarray(MARITAL, dtype=object)[base[:, 1]],
        "cd_education_status": np.asarray(EDUCATION, dtype=object)[base[:, 2]],
        "cd_purchase_estimate": (rng.integers(1, 21, n_cd)) * 500,
        "cd_credit_rating": rng.choice(CREDIT_RATINGS, n_cd).astype(object),
        "cd_dep_count": rng.integers(0, 7, n_cd),
        "cd_dep_employed_count": rng.integers(0, 7, n_cd),
        "cd_dep_college_count": rng.integers(0, 7, n_cd),
    }
    out["customer_demographics"] = _table("customer_demographics", cd)

    # ---- household_demographics (income x potential x deps x vehicles) ----
    ib, bp, dc, vc = np.meshgrid(np.arange(1, 21), np.arange(6),
                                 np.arange(10), np.arange(-1, 5),
                                 indexing="ij")
    n_hd = ib.size
    sk = np.arange(1, n_hd + 1, dtype=np.int64)
    hd = {
        "hd_demo_sk": sk,
        "hd_income_band_sk": ib.ravel().astype(np.int64),
        "hd_buy_potential": np.asarray(BUY_POTENTIAL, dtype=object)[bp.ravel()],
        "hd_dep_count": dc.ravel().astype(np.int64),
        "hd_vehicle_count": vc.ravel().astype(np.int64),
    }
    out["household_demographics"] = _table("household_demographics", hd)

    ib_sk = np.arange(1, 21, dtype=np.int64)
    out["income_band"] = _table("income_band", {
        "ib_income_band_sk": ib_sk,
        "ib_lower_bound": (ib_sk - 1) * 10000,
        "ib_upper_bound": ib_sk * 10000,
    })

    # ---- customer ---------------------------------------------------------
    sk = np.arange(1, n_cust + 1, dtype=np.int64)
    birth_year = rng.integers(1924, 1993, n_cust)
    first_sales = rng.integers(SK0, SK0 + N_DAYS - 400, n_cust)
    customer = {
        "c_customer_sk": sk,
        "c_customer_id": _ids("C", sk),
        "c_current_cdemo_sk": _null_some(rng, rng.integers(1, n_cd + 1, n_cust)),
        "c_current_hdemo_sk": _null_some(rng, rng.integers(1, n_hd + 1, n_cust)),
        "c_current_addr_sk": rng.integers(1, n_addr + 1, n_cust),
        "c_first_shipto_date_sk": _null_some(rng, first_sales + 30),
        "c_first_sales_date_sk": _null_some(rng, first_sales),
        "c_salutation": rng.choice(SALUTATIONS, n_cust).astype(object),
        "c_first_name": rng.choice(FIRST_NAMES, n_cust).astype(object),
        "c_last_name": rng.choice(LAST_NAMES, n_cust).astype(object),
        "c_preferred_cust_flag": rng.choice(["Y", "N"], n_cust).astype(object),
        "c_birth_day": rng.integers(1, 29, n_cust),
        "c_birth_month": rng.integers(1, 13, n_cust),
        "c_birth_year": birth_year,
        "c_birth_country": rng.choice(BIRTH_COUNTRIES, n_cust).astype(object),
        "c_login": np.full(n_cust, "", dtype=object),
        "c_email_address": np.asarray(
            ["c%d@example.com" % k for k in sk], dtype=object),
        "c_last_review_date_sk": _null_some(rng, rng.integers(
            SK0, SK0 + N_DAYS, n_cust)),
    }
    out["customer"] = _table("customer", customer)

    # ---- small dimensions -------------------------------------------------
    sk = np.arange(1, n_wh + 1, dtype=np.int64)
    out["warehouse"] = _table("warehouse", {
        "w_warehouse_sk": sk,
        "w_warehouse_id": _ids("W", sk),
        "w_warehouse_name": np.asarray(
            ["Warehouse number %d" % k for k in sk], dtype=object),
        "w_warehouse_sq_ft": rng.integers(50000, 1000001, n_wh),
        "w_street_number": rng.integers(1, 1000, n_wh).astype("U").astype(object),
        "w_street_name": rng.choice(STREET_NAMES, n_wh).astype(object),
        "w_street_type": rng.choice(STREET_TYPES, n_wh).astype(object),
        "w_suite_number": np.full(n_wh, "Suite 1", dtype=object),
        "w_city": rng.choice(CITIES, n_wh).astype(object),
        "w_county": rng.choice(COUNTIES, n_wh).astype(object),
        "w_state": rng.choice(STATES, n_wh).astype(object),
        "w_zip": rng.integers(10000, 99999, n_wh).astype("U").astype(object),
        "w_country": np.full(n_wh, "United States", dtype=object),
        "w_gmt_offset": np.full(n_wh, -500, dtype=np.int64),
    })

    sk = np.arange(1, 21, dtype=np.int64)
    out["ship_mode"] = _table("ship_mode", {
        "sm_ship_mode_sk": sk,
        "sm_ship_mode_id": _ids("SM", sk),
        "sm_type": np.asarray([SM_TYPES[i % len(SM_TYPES)] for i in range(20)],
                              dtype=object),
        "sm_code": np.asarray([SM_CODES[i % len(SM_CODES)] for i in range(20)],
                              dtype=object),
        "sm_carrier": np.asarray(
            [CARRIERS[i % len(CARRIERS)] for i in range(20)], dtype=object),
        "sm_contract": _ids("K", sk, 10),
    })

    sk = np.arange(1, len(REASONS) + 1, dtype=np.int64)
    out["reason"] = _table("reason", {
        "r_reason_sk": sk,
        "r_reason_id": _ids("R", sk),
        "r_reason_desc": np.asarray(REASONS, dtype=object),
    })

    sk = np.arange(1, n_promo + 1, dtype=np.int64)
    out["promotion"] = _table("promotion", {
        "p_promo_sk": sk,
        "p_promo_id": _ids("P", sk),
        "p_start_date_sk": _null_some(rng, rng.integers(SK0, SK0 + N_DAYS - 60, n_promo)),
        "p_end_date_sk": _null_some(rng, rng.integers(SK0 + 60, SK0 + N_DAYS, n_promo)),
        "p_item_sk": _null_some(rng, rng.integers(1, n_item + 1, n_promo)),
        "p_cost": np.full(n_promo, 100000, dtype=np.int64),
        "p_response_target": np.ones(n_promo, dtype=np.int64),
        "p_promo_name": rng.choice(["anti", "ought", "able", "pri", "ese"],
                                   n_promo).astype(object),
        "p_channel_dmail": rng.choice(["Y", "N"], n_promo).astype(object),
        "p_channel_email": rng.choice(["N", "N", "N", "Y"], n_promo).astype(object),
        "p_channel_catalog": rng.choice(["N", "Y"], n_promo).astype(object),
        "p_channel_tv": rng.choice(["N", "N", "Y"], n_promo).astype(object),
        "p_channel_radio": rng.choice(["N", "Y"], n_promo).astype(object),
        "p_channel_press": rng.choice(["N", "Y"], n_promo).astype(object),
        "p_channel_event": rng.choice(["N", "N", "Y"], n_promo).astype(object),
        "p_channel_demo": rng.choice(["N", "Y"], n_promo).astype(object),
        "p_channel_details": np.full(n_promo, "promo details", dtype=object),
        "p_purpose": np.full(n_promo, "Unknown", dtype=object),
        "p_discount_active": rng.choice(["N", "Y"], n_promo).astype(object),
    })

    sk = np.arange(1, n_cc + 1, dtype=np.int64)
    out["call_center"] = _table("call_center", {
        "cc_call_center_sk": sk,
        "cc_call_center_id": _ids("CC", sk),
        "cc_rec_start_date": np.full(n_cc, _D0).astype(np.int32),
        "cc_rec_end_date": np.full(n_cc, _D1).astype(np.int32),
        "cc_closed_date_sk": _null_some(rng, np.full(n_cc, SK0), 0.9),
        "cc_open_date_sk": np.full(n_cc, SK0, dtype=np.int64),
        "cc_name": np.asarray(["call center %d" % k for k in sk], dtype=object),
        "cc_class": np.asarray(["small", "medium", "large", "small", "medium",
                                "large"][:n_cc], dtype=object),
        "cc_employees": rng.integers(100, 700, n_cc),
        "cc_sq_ft": rng.integers(10000, 50000, n_cc),
        "cc_hours": np.full(n_cc, "8AM-8PM", dtype=object),
        "cc_manager": rng.choice(LAST_NAMES, n_cc).astype(object),
        "cc_mkt_id": rng.integers(1, 7, n_cc),
        "cc_mkt_class": np.full(n_cc, "Unknown", dtype=object),
        "cc_mkt_desc": np.full(n_cc, "mkt", dtype=object),
        "cc_market_manager": rng.choice(LAST_NAMES, n_cc).astype(object),
        "cc_division": np.ones(n_cc, dtype=np.int64),
        "cc_division_name": np.full(n_cc, "pri", dtype=object),
        "cc_company": np.ones(n_cc, dtype=np.int64),
        "cc_company_name": np.full(n_cc, "Unknown", dtype=object),
        "cc_street_number": rng.integers(1, 1000, n_cc).astype("U").astype(object),
        "cc_street_name": rng.choice(STREET_NAMES, n_cc).astype(object),
        "cc_street_type": rng.choice(STREET_TYPES, n_cc).astype(object),
        "cc_suite_number": np.full(n_cc, "Suite 1", dtype=object),
        "cc_city": rng.choice(CITIES, n_cc).astype(object),
        "cc_county": rng.choice(COUNTIES, n_cc).astype(object),
        "cc_state": rng.choice(STATES, n_cc).astype(object),
        "cc_zip": rng.integers(10000, 99999, n_cc).astype("U").astype(object),
        "cc_country": np.full(n_cc, "United States", dtype=object),
        "cc_gmt_offset": np.full(n_cc, -500, dtype=np.int64),
        "cc_tax_percentage": rng.integers(0, 12, n_cc),
    })

    sk = np.arange(1, n_cp + 1, dtype=np.int64)
    out["catalog_page"] = _table("catalog_page", {
        "cp_catalog_page_sk": sk,
        "cp_catalog_page_id": _ids("CP", sk),
        "cp_start_date_sk": _null_some(rng, rng.integers(SK0, SK0 + N_DAYS - 90, n_cp)),
        "cp_end_date_sk": _null_some(rng, rng.integers(SK0 + 90, SK0 + N_DAYS, n_cp)),
        "cp_department": np.full(n_cp, "DEPARTMENT", dtype=object),
        "cp_catalog_number": rng.integers(1, 20, n_cp),
        "cp_catalog_page_number": rng.integers(1, 100, n_cp),
        "cp_description": np.asarray(["page %d" % k for k in sk], dtype=object),
        "cp_type": rng.choice(["bi-annual", "quarterly", "monthly"],
                              n_cp).astype(object),
    })

    sk = np.arange(1, n_web_site + 1, dtype=np.int64)
    out["web_site"] = _table("web_site", {
        "web_site_sk": sk,
        "web_site_id": _ids("WS", sk),
        "web_rec_start_date": np.full(n_web_site, _D0).astype(np.int32),
        "web_rec_end_date": np.full(n_web_site, _D1).astype(np.int32),
        "web_name": np.asarray(WEB_NAMES[:n_web_site], dtype=object),
        "web_open_date_sk": np.full(n_web_site, SK0, dtype=np.int64),
        "web_close_date_sk": _null_some(rng, np.full(n_web_site, SK0 + N_DAYS - 1), 0.8),
        "web_class": np.full(n_web_site, "Unknown", dtype=object),
        "web_manager": rng.choice(LAST_NAMES, n_web_site).astype(object),
        "web_mkt_id": rng.integers(1, 7, n_web_site),
        "web_mkt_class": np.full(n_web_site, "Unknown", dtype=object),
        "web_mkt_desc": np.full(n_web_site, "mkt", dtype=object),
        "web_market_manager": rng.choice(LAST_NAMES, n_web_site).astype(object),
        "web_company_id": np.ones(n_web_site, dtype=np.int64),
        "web_company_name": np.asarray(
            [STORE_NAMES[i % len(STORE_NAMES)] for i in range(n_web_site)],
            dtype=object),
        "web_street_number": rng.integers(1, 1000, n_web_site).astype("U").astype(object),
        "web_street_name": rng.choice(STREET_NAMES, n_web_site).astype(object),
        "web_street_type": rng.choice(STREET_TYPES, n_web_site).astype(object),
        "web_suite_number": np.full(n_web_site, "Suite 1", dtype=object),
        "web_city": rng.choice(CITIES, n_web_site).astype(object),
        "web_county": rng.choice(COUNTIES, n_web_site).astype(object),
        "web_state": rng.choice(STATES, n_web_site).astype(object),
        "web_zip": rng.integers(10000, 99999, n_web_site).astype("U").astype(object),
        "web_country": np.full(n_web_site, "United States", dtype=object),
        "web_gmt_offset": np.full(n_web_site, -500, dtype=np.int64),
        "web_tax_percentage": rng.integers(0, 12, n_web_site),
    })

    sk = np.arange(1, n_web_page + 1, dtype=np.int64)
    out["web_page"] = _table("web_page", {
        "wp_web_page_sk": sk,
        "wp_web_page_id": _ids("WP", sk),
        "wp_rec_start_date": np.full(n_web_page, _D0).astype(np.int32),
        "wp_rec_end_date": np.full(n_web_page, _D1).astype(np.int32),
        "wp_creation_date_sk": np.full(n_web_page, SK0, dtype=np.int64),
        "wp_access_date_sk": rng.integers(SK0, SK0 + N_DAYS, n_web_page),
        "wp_autogen_flag": rng.choice(["Y", "N"], n_web_page).astype(object),
        "wp_customer_sk": _null_some(rng, rng.integers(1, n_cust + 1, n_web_page), 0.7),
        "wp_url": np.full(n_web_page, "http://www.foo.com", dtype=object),
        "wp_type": rng.choice(["ad", "order", "welcome", "protected", "feedback",
                               "general", "dynamic"], n_web_page).astype(object),
        "wp_char_count": rng.integers(100, 8000, n_web_page),
        "wp_link_count": rng.integers(2, 25, n_web_page),
        "wp_image_count": rng.integers(1, 7, n_web_page),
        "wp_max_ad_count": rng.integers(0, 5, n_web_page),
    })

    # ---- sales channels ---------------------------------------------------
    def line_amounts(n):
        qty = rng.integers(1, 101, n).astype(np.int64)
        wholesale = _money(rng, 1.0, 70.0, n)
        mult = rng.integers(100, 201, n)  # 1.00x - 2.00x markup
        list_p = wholesale * mult // 100
        disc = rng.integers(0, 81, n)  # % of 100
        sales_p = list_p * (100 - disc) // 100
        coupon = np.where(rng.random(n) < 0.1,
                          _money(rng, 0.0, 10.0, n), 0)
        tax_pct = rng.integers(0, 10, n)
        ext_sales = sales_p * qty
        ext_list = list_p * qty
        ext_wholesale = wholesale * qty
        ext_disc = (list_p - sales_p) * qty
        net_paid = np.maximum(ext_sales - coupon, 0)
        ext_tax = net_paid * tax_pct // 100
        ship = _money(rng, 0.5, 20.0, n) * qty // 10
        return dict(qty=qty, wholesale=wholesale, list_p=list_p,
                    sales_p=sales_p, coupon=coupon, ext_sales=ext_sales,
                    ext_list=ext_list, ext_wholesale=ext_wholesale,
                    ext_disc=ext_disc, net_paid=net_paid, ext_tax=ext_tax,
                    ship=ship)

    def tickets(n_lines, avg_lines):
        n_t = max(n_lines // avg_lines, 1)
        tid = np.sort(rng.integers(0, n_t, n_lines)) + 1
        return tid, n_t

    # store_sales
    n_ss = max(int(120000 * sf), 4000)
    tid, n_t = tickets(n_ss, 6)
    t_date = rng.integers(SK0, SK0 + N_DAYS - 380, n_t + 1)
    t_time = time_dim["t_time_sk"][rng.integers(
        0, len(time_dim["t_time_sk"]), n_t + 1)]
    t_cust = rng.integers(1, n_cust + 1, n_t + 1)
    t_store = rng.integers(1, n_store + 1, n_t + 1)
    t_hdemo = rng.integers(1, n_hd + 1, n_t + 1)
    t_addr = rng.integers(1, n_addr + 1, n_t + 1)
    t_cdemo = rng.integers(1, n_cd + 1, n_t + 1)
    am = line_amounts(n_ss)
    ss = {
        "ss_sold_date_sk": _null_some(rng, t_date[tid], 0.02),
        "ss_sold_time_sk": _null_some(rng, t_time[tid], 0.02),
        "ss_item_sk": rng.integers(1, n_item + 1, n_ss),
        "ss_customer_sk": _null_some(rng, t_cust[tid], 0.02),
        "ss_cdemo_sk": _null_some(rng, t_cdemo[tid], 0.02),
        "ss_hdemo_sk": _null_some(rng, t_hdemo[tid], 0.02),
        "ss_addr_sk": _null_some(rng, t_addr[tid], 0.02),
        "ss_store_sk": _null_some(rng, t_store[tid], 0.02),
        "ss_promo_sk": _null_some(rng, rng.integers(1, n_promo + 1, n_ss), 0.05),
        "ss_ticket_number": tid.astype(np.int64),
        "ss_quantity": am["qty"],
        "ss_wholesale_cost": am["wholesale"],
        "ss_list_price": am["list_p"],
        "ss_sales_price": am["sales_p"],
        "ss_ext_discount_amt": am["ext_disc"],
        "ss_ext_sales_price": am["ext_sales"],
        "ss_ext_wholesale_cost": am["ext_wholesale"],
        "ss_ext_list_price": am["ext_list"],
        "ss_ext_tax": am["ext_tax"],
        "ss_coupon_amt": am["coupon"],
        "ss_net_paid": am["net_paid"],
        "ss_net_paid_inc_tax": am["net_paid"] + am["ext_tax"],
        "ss_net_profit": am["net_paid"] - am["ext_wholesale"],
    }
    out["store_sales"] = _table("store_sales", ss)

    # store_returns reference real sales lines
    ret_idx = rng.choice(n_ss, max(n_ss // 10, 100), replace=False)
    n_sr = len(ret_idx)
    ram = line_amounts(n_sr)
    ret_qty = np.minimum(ram["qty"], am["qty"][ret_idx])
    unit_paid = am["net_paid"][ret_idx] // np.maximum(am["qty"][ret_idx], 1)
    ret_amt = unit_paid * ret_qty
    ret_date = np.where(np.isnan(ss["ss_sold_date_sk"][ret_idx]),
                        SK0, ss["ss_sold_date_sk"][ret_idx]).astype(np.int64) \
        + rng.integers(1, 90, n_sr)
    sr = {
        "sr_returned_date_sk": _null_some(rng, ret_date, 0.02),
        "sr_return_time_sk": _null_some(rng, time_dim["t_time_sk"][
            rng.integers(0, len(time_dim["t_time_sk"]), n_sr)], 0.02),
        "sr_item_sk": ss["ss_item_sk"][ret_idx],
        "sr_customer_sk": ss["ss_customer_sk"][ret_idx],
        "sr_cdemo_sk": ss["ss_cdemo_sk"][ret_idx],
        "sr_hdemo_sk": ss["ss_hdemo_sk"][ret_idx],
        "sr_addr_sk": ss["ss_addr_sk"][ret_idx],
        "sr_store_sk": ss["ss_store_sk"][ret_idx],
        "sr_reason_sk": _null_some(rng, rng.integers(1, len(REASONS) + 1, n_sr), 0.03),
        "sr_ticket_number": ss["ss_ticket_number"][ret_idx],
        "sr_return_quantity": ret_qty,
        "sr_return_amt": ret_amt,
        "sr_return_tax": ret_amt // 20,
        "sr_return_amt_inc_tax": ret_amt + ret_amt // 20,
        "sr_fee": _money(rng, 0.5, 100.0, n_sr),
        "sr_return_ship_cost": _money(rng, 0.0, 30.0, n_sr),
        "sr_refunded_cash": ret_amt * rng.integers(50, 101, n_sr) // 100,
        "sr_reversed_charge": ret_amt // 10,
        "sr_store_credit": ret_amt // 20,
        "sr_net_loss": _money(rng, 0.5, 300.0, n_sr),
    }
    out["store_returns"] = _table("store_returns", sr)

    # catalog_sales
    n_cs = max(int(80000 * sf), 3000)
    oid, n_o = tickets(n_cs, 5)
    o_date = rng.integers(SK0, SK0 + N_DAYS - 380, n_o + 1)
    o_cust = rng.integers(1, n_cust + 1, n_o + 1)
    o_addr = rng.integers(1, n_addr + 1, n_o + 1)
    o_cc = rng.integers(1, n_cc + 1, n_o + 1)
    am = line_amounts(n_cs)
    ship_lag = rng.integers(1, 130, n_cs)
    cs = {
        "cs_sold_date_sk": _null_some(rng, o_date[oid], 0.02),
        "cs_sold_time_sk": _null_some(rng, time_dim["t_time_sk"][
            rng.integers(0, len(time_dim["t_time_sk"]), n_cs)], 0.02),
        "cs_ship_date_sk": _null_some(rng, o_date[oid] + ship_lag, 0.02),
        "cs_bill_customer_sk": _null_some(rng, o_cust[oid], 0.02),
        "cs_bill_cdemo_sk": _null_some(rng, rng.integers(1, n_cd + 1, n_cs), 0.02),
        "cs_bill_hdemo_sk": _null_some(rng, rng.integers(1, n_hd + 1, n_cs), 0.02),
        "cs_bill_addr_sk": _null_some(rng, o_addr[oid], 0.02),
        "cs_ship_customer_sk": _null_some(rng, o_cust[oid], 0.02),
        "cs_ship_cdemo_sk": _null_some(rng, rng.integers(1, n_cd + 1, n_cs), 0.02),
        "cs_ship_hdemo_sk": _null_some(rng, rng.integers(1, n_hd + 1, n_cs), 0.02),
        "cs_ship_addr_sk": _null_some(rng, o_addr[oid], 0.02),
        "cs_call_center_sk": _null_some(rng, o_cc[oid], 0.02),
        "cs_catalog_page_sk": _null_some(rng, rng.integers(1, n_cp + 1, n_cs), 0.02),
        "cs_ship_mode_sk": _null_some(rng, rng.integers(1, 21, n_cs), 0.02),
        "cs_warehouse_sk": _null_some(rng, rng.integers(1, n_wh + 1, n_cs), 0.02),
        "cs_item_sk": rng.integers(1, n_item + 1, n_cs),
        "cs_promo_sk": _null_some(rng, rng.integers(1, n_promo + 1, n_cs), 0.05),
        "cs_order_number": oid.astype(np.int64),
        "cs_quantity": am["qty"],
        "cs_wholesale_cost": am["wholesale"],
        "cs_list_price": am["list_p"],
        "cs_sales_price": am["sales_p"],
        "cs_ext_discount_amt": am["ext_disc"],
        "cs_ext_sales_price": am["ext_sales"],
        "cs_ext_wholesale_cost": am["ext_wholesale"],
        "cs_ext_list_price": am["ext_list"],
        "cs_ext_tax": am["ext_tax"],
        "cs_coupon_amt": am["coupon"],
        "cs_ext_ship_cost": am["ship"],
        "cs_net_paid": am["net_paid"],
        "cs_net_paid_inc_tax": am["net_paid"] + am["ext_tax"],
        "cs_net_paid_inc_ship": am["net_paid"] + am["ship"],
        "cs_net_paid_inc_ship_tax": am["net_paid"] + am["ship"] + am["ext_tax"],
        "cs_net_profit": am["net_paid"] - am["ext_wholesale"],
    }
    out["catalog_sales"] = _table("catalog_sales", cs)

    ret_idx = rng.choice(n_cs, max(n_cs // 10, 100), replace=False)
    n_cr = len(ret_idx)
    ret_qty = np.maximum(cs["cs_quantity"][ret_idx] // 2, 1)
    unit_paid = cs["cs_net_paid"][ret_idx] // np.maximum(cs["cs_quantity"][ret_idx], 1)
    ret_amt = unit_paid * ret_qty
    cr_date = np.where(np.isnan(cs["cs_sold_date_sk"][ret_idx]), SK0,
                       cs["cs_sold_date_sk"][ret_idx]).astype(np.int64) \
        + rng.integers(1, 90, n_cr)
    cr = {
        "cr_returned_date_sk": cr_date,
        "cr_returned_time_sk": time_dim["t_time_sk"][
            rng.integers(0, len(time_dim["t_time_sk"]), n_cr)],
        "cr_item_sk": cs["cs_item_sk"][ret_idx],
        "cr_refunded_customer_sk": cs["cs_bill_customer_sk"][ret_idx],
        "cr_refunded_cdemo_sk": cs["cs_bill_cdemo_sk"][ret_idx],
        "cr_refunded_hdemo_sk": cs["cs_bill_hdemo_sk"][ret_idx],
        "cr_refunded_addr_sk": cs["cs_bill_addr_sk"][ret_idx],
        "cr_returning_customer_sk": cs["cs_ship_customer_sk"][ret_idx],
        "cr_returning_cdemo_sk": cs["cs_ship_cdemo_sk"][ret_idx],
        "cr_returning_hdemo_sk": cs["cs_ship_hdemo_sk"][ret_idx],
        "cr_returning_addr_sk": cs["cs_ship_addr_sk"][ret_idx],
        "cr_call_center_sk": cs["cs_call_center_sk"][ret_idx],
        "cr_catalog_page_sk": cs["cs_catalog_page_sk"][ret_idx],
        "cr_ship_mode_sk": cs["cs_ship_mode_sk"][ret_idx],
        "cr_warehouse_sk": cs["cs_warehouse_sk"][ret_idx],
        "cr_reason_sk": _null_some(rng, rng.integers(1, len(REASONS) + 1, n_cr), 0.03),
        "cr_order_number": cs["cs_order_number"][ret_idx],
        "cr_return_quantity": ret_qty,
        "cr_return_amount": ret_amt,
        "cr_return_tax": ret_amt // 20,
        "cr_return_amt_inc_tax": ret_amt + ret_amt // 20,
        "cr_fee": _money(rng, 0.5, 100.0, n_cr),
        "cr_return_ship_cost": _money(rng, 0.0, 30.0, n_cr),
        "cr_refunded_cash": ret_amt * rng.integers(50, 101, n_cr) // 100,
        "cr_reversed_charge": ret_amt // 10,
        "cr_store_credit": ret_amt // 20,
        "cr_net_loss": _money(rng, 0.5, 300.0, n_cr),
    }
    out["catalog_returns"] = _table("catalog_returns", cr)

    # web_sales
    n_ws = max(int(50000 * sf), 2000)
    oid, n_o = tickets(n_ws, 4)
    o_date = rng.integers(SK0, SK0 + N_DAYS - 380, n_o + 1)
    o_cust = rng.integers(1, n_cust + 1, n_o + 1)
    o_addr = rng.integers(1, n_addr + 1, n_o + 1)
    o_site = rng.integers(1, n_web_site + 1, n_o + 1)
    am = line_amounts(n_ws)
    ship_lag = rng.integers(1, 130, n_ws)
    ws = {
        "ws_sold_date_sk": _null_some(rng, o_date[oid], 0.02),
        "ws_sold_time_sk": _null_some(rng, time_dim["t_time_sk"][
            rng.integers(0, len(time_dim["t_time_sk"]), n_ws)], 0.02),
        "ws_ship_date_sk": _null_some(rng, o_date[oid] + ship_lag, 0.02),
        "ws_item_sk": rng.integers(1, n_item + 1, n_ws),
        "ws_bill_customer_sk": _null_some(rng, o_cust[oid], 0.02),
        "ws_bill_cdemo_sk": _null_some(rng, rng.integers(1, n_cd + 1, n_ws), 0.02),
        "ws_bill_hdemo_sk": _null_some(rng, rng.integers(1, n_hd + 1, n_ws), 0.02),
        "ws_bill_addr_sk": _null_some(rng, o_addr[oid], 0.02),
        "ws_ship_customer_sk": _null_some(rng, o_cust[oid], 0.02),
        "ws_ship_cdemo_sk": _null_some(rng, rng.integers(1, n_cd + 1, n_ws), 0.02),
        "ws_ship_hdemo_sk": _null_some(rng, rng.integers(1, n_hd + 1, n_ws), 0.02),
        "ws_ship_addr_sk": _null_some(rng, o_addr[oid], 0.02),
        "ws_web_page_sk": _null_some(rng, rng.integers(1, n_web_page + 1, n_ws), 0.02),
        "ws_web_site_sk": _null_some(rng, o_site[oid], 0.02),
        "ws_ship_mode_sk": _null_some(rng, rng.integers(1, 21, n_ws), 0.02),
        "ws_warehouse_sk": _null_some(rng, rng.integers(1, n_wh + 1, n_ws), 0.02),
        "ws_promo_sk": _null_some(rng, rng.integers(1, n_promo + 1, n_ws), 0.05),
        "ws_order_number": oid.astype(np.int64),
        "ws_quantity": am["qty"],
        "ws_wholesale_cost": am["wholesale"],
        "ws_list_price": am["list_p"],
        "ws_sales_price": am["sales_p"],
        "ws_ext_discount_amt": am["ext_disc"],
        "ws_ext_sales_price": am["ext_sales"],
        "ws_ext_wholesale_cost": am["ext_wholesale"],
        "ws_ext_list_price": am["ext_list"],
        "ws_ext_tax": am["ext_tax"],
        "ws_coupon_amt": am["coupon"],
        "ws_ext_ship_cost": am["ship"],
        "ws_net_paid": am["net_paid"],
        "ws_net_paid_inc_tax": am["net_paid"] + am["ext_tax"],
        "ws_net_paid_inc_ship": am["net_paid"] + am["ship"],
        "ws_net_paid_inc_ship_tax": am["net_paid"] + am["ship"] + am["ext_tax"],
        "ws_net_profit": am["net_paid"] - am["ext_wholesale"],
    }
    out["web_sales"] = _table("web_sales", ws)

    ret_idx = rng.choice(n_ws, max(n_ws // 10, 100), replace=False)
    n_wr = len(ret_idx)
    ret_qty = np.maximum(ws["ws_quantity"][ret_idx] // 2, 1)
    unit_paid = ws["ws_net_paid"][ret_idx] // np.maximum(ws["ws_quantity"][ret_idx], 1)
    ret_amt = unit_paid * ret_qty
    wr_date = np.where(np.isnan(ws["ws_sold_date_sk"][ret_idx]), SK0,
                       ws["ws_sold_date_sk"][ret_idx]).astype(np.int64) \
        + rng.integers(1, 90, n_wr)
    wr = {
        "wr_returned_date_sk": _null_some(rng, wr_date, 0.02),
        "wr_returned_time_sk": _null_some(rng, time_dim["t_time_sk"][
            rng.integers(0, len(time_dim["t_time_sk"]), n_wr)], 0.02),
        "wr_item_sk": ws["ws_item_sk"][ret_idx],
        "wr_refunded_customer_sk": ws["ws_bill_customer_sk"][ret_idx],
        "wr_refunded_cdemo_sk": ws["ws_bill_cdemo_sk"][ret_idx],
        "wr_refunded_hdemo_sk": ws["ws_bill_hdemo_sk"][ret_idx],
        "wr_refunded_addr_sk": ws["ws_bill_addr_sk"][ret_idx],
        "wr_returning_customer_sk": ws["ws_ship_customer_sk"][ret_idx],
        "wr_returning_cdemo_sk": ws["ws_ship_cdemo_sk"][ret_idx],
        "wr_returning_hdemo_sk": ws["ws_ship_hdemo_sk"][ret_idx],
        "wr_returning_addr_sk": ws["ws_ship_addr_sk"][ret_idx],
        "wr_web_page_sk": ws["ws_web_page_sk"][ret_idx],
        "wr_reason_sk": _null_some(rng, rng.integers(1, len(REASONS) + 1, n_wr), 0.03),
        "wr_order_number": ws["ws_order_number"][ret_idx],
        "wr_return_quantity": ret_qty,
        "wr_return_amt": ret_amt,
        "wr_return_tax": ret_amt // 20,
        "wr_return_amt_inc_tax": ret_amt + ret_amt // 20,
        "wr_fee": _money(rng, 0.5, 100.0, n_wr),
        "wr_return_ship_cost": _money(rng, 0.0, 30.0, n_wr),
        "wr_refunded_cash": ret_amt * rng.integers(50, 101, n_wr) // 100,
        "wr_reversed_charge": ret_amt // 10,
        "wr_account_credit": ret_amt // 20,
        "wr_net_loss": _money(rng, 0.5, 300.0, n_wr),
    }
    out["web_returns"] = _table("web_returns", wr)

    # inventory: 4-weekly snapshot of an item subset x warehouse (the spec's
    # weekly full cross product would dwarf the fact tables at test scale)
    week_days = np.arange(SK0, SK0 + N_DAYS, 28, dtype=np.int64)
    n_inv_items = min(n_item, 120)
    inv_item = rng.choice(np.arange(1, n_item + 1), n_inv_items, replace=False)
    d, it, w = np.meshgrid(week_days, inv_item, np.arange(1, n_wh + 1),
                           indexing="ij")
    n_inv = d.size
    out["inventory"] = _table("inventory", {
        "inv_date_sk": d.ravel(),
        "inv_item_sk": it.ravel(),
        "inv_warehouse_sk": w.ravel(),
        "inv_quantity_on_hand": _null_some(
            rng, rng.integers(0, 1001, n_inv), 0.02),
    })

    return out


def register_tpcds_data(ctx, sf: float = 0.05, seed: int = 7) -> Dict[str, Table]:
    tables = generate_tpcds(sf, seed)
    for name, t in tables.items():
        ctx.register_table(name, t)
    return tables

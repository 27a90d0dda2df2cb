"""File tables and the session's statements, the port on device="cpu"
against the JAX package on the same files and SQL.

- TPC-H at SF 0.01 written to Parquet (decimals exact, a page index,
  lineitem as a directory of files) and to a pipe-delimited `.tbl`, each
  registered in both packages through CREATE EXTERNAL TABLE: Q1 and Q6
  (the dense-aggregation kernel's queries) equal the JAX package's answers,
  all 22 from Parquet equal the port's in-memory answers exactly, and a
  warm collect() uploads nothing.
- The pruning fixtures of tests/test_parquet_scan.py, test_parquet_bloom.py
  and test_dynamic_filter.py, rebuilt here: answers, `last_scan` counters
  and the TopK dynamic filter equal the JAX package's.
- CSV, JSON, Arrow IPC and Avro through COPY ... TO and back, a Parquet
  timestamp[ns] column, and an in-memory object store.
- The statements (INSERT, DELETE, UPDATE, CREATE VIEW, SHOW, SET,
  PREPARE/EXECUTE/DEALLOCATE): the same rows or the same error class.
"""
import io
import os
import re

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.io.object_store import InMemoryStore as JaxMemoryStore
from datafusion_tpu.physical import plan as JP
from datafusion_tpu.spark.functions import _xxhash64 as jax_xxhash64
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.catalog import catalog as PC
from datafusion_tpu_torch.io.object_store import InMemoryStore as PortMemoryStore
from datafusion_tpu_torch.models.tpch import files as TF
from datafusion_tpu_torch.models.tpch.compare import LIMIT_QUERIES, frames_diff
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch
from datafusion_tpu_torch.models.tpch.queries import query
from datafusion_tpu_torch.ops import dense_agg as DA
from datafusion_tpu_torch.physical import plan as PP
from datafusion_tpu_torch.spark.functions import _xxhash64
from datafusion_tpu_torch.testing import statement_cases as SC

SF = 0.01


@pytest.fixture(scope="module", autouse=True)
def _fast_reference():
    """The reference's programs compile without XLA's optimizations, which
    would cost more than these small runs save."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


def _port():
    return PortSession(device="cpu")


_run = SC.run


def _scan(plan, kind):
    if isinstance(plan, kind):
        return plan
    for c in plan.children():
        s = _scan(c, kind)
        if s is not None:
            return s
    return None


# ---------------------------------------------------------------------------
# TPC-H from files
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    """{name: Table}, the Parquet locations, and the lineitem `.tbl` path."""
    d = str(tmp_path_factory.mktemp("tpch"))
    tables = generate_tpch(SF)
    locs = TF.write_tpch_parquet(tables, d, lineitem_files=3)
    tbl = os.path.join(d, "lineitem.tbl")
    TF.write_tbl(tables["lineitem"], tbl)
    return tables, locs, tbl


def _parquet_sessions(tpch):
    tables, locs, _ = tpch
    port, ref = _port(), JaxSession()
    for ctx in (port, ref):
        for name in tables:
            ctx.sql(TF.external_table_sql(name, locs[name]))
    return port, ref


def _csv_sessions(tpch):
    tables, _, tbl = tpch
    port, ref = _port(), JaxSession()
    for ctx in (port, ref):
        ctx.sql(TF.external_table_sql("lineitem", tbl, "tbl", tables["lineitem"]))
    return port, ref


def test_tpch_files_keep_the_tables_types(tpch):
    tables, locs, tbl = tpch
    want = [(f.name, repr(f.dtype)) for f in tables["lineitem"].schema.fields]
    for prov in (PC.ParquetTable(locs["lineitem"]),
                 PC.CsvTable(tbl, False, "|", [(f.name, f.dtype) for f in
                                               tables["lineitem"].schema.fields])):
        assert [(f.name, repr(f.dtype)) for f in prov.schema().fields] == want
    assert len(os.listdir(locs["lineitem"])) == 3


def test_exact_decimals_keep_sign_and_nulls():
    import decimal

    from datafusion_tpu_torch.common import types as T
    from datafusion_tpu_torch.data.table import Table

    t = Table.from_pydict({"d": [-1.25, None, 3.5, -0.01], "k": [1, 2, 3, 4]},
                          {"d": T.decimal(15, 2), "k": T.INT64})
    at = TF.to_arrow_exact(t)
    assert at.column("d").type == pa.decimal128(15, 2)
    assert at.column("d").to_pylist() == [decimal.Decimal("-1.25"), None,
                                          decimal.Decimal("3.50"),
                                          decimal.Decimal("-0.01")]
    assert at.column("k").to_pylist() == [1, 2, 3, 4]


@pytest.mark.parametrize("source", ["parquet", "csv"])
@pytest.mark.parametrize("qid", [1, 6])
def test_kernel_queries_from_files_match_jax(tpch, monkeypatch, source, qid):
    """Q1 and Q6 over the files equal the JAX package's answers and reach
    the dense aggregation kernel's wrapper (its plain version here)."""
    port, ref = (_parquet_sessions if source == "parquet" else _csv_sessions)(tpch)
    calls = []
    real = DA.dense_groupby_sums

    def spy(seg, mask, pairs, G):
        calls.append(G)
        return real(seg, mask, pairs, G)

    monkeypatch.setattr(DA, "dense_groupby_sums", spy)
    df = port.sql(query(qid, SF))
    got = [df.to_pandas() for _ in range(3)]  # discovery, build, steady state
    want = ref.sql(query(qid, SF)).to_pandas()
    for g in got:
        assert frames_diff(g, want, ordered=qid in LIMIT_QUERIES) is None
    assert calls, f"Q{qid} from {source} made no dense_groupby_sums call"


@pytest.fixture(scope="module")
def tpch_port_sessions(tpch):
    tables, locs, _ = tpch
    mem, fil = _port(), _port()
    for name, t in tables.items():
        mem.register_table(name, t)
        fil.sql(TF.external_table_sql(name, locs[name]))
    return mem, fil


@pytest.mark.parametrize("qid", range(1, 23))
def test_tpch_from_parquet_equals_in_memory(tpch_port_sessions, qid):
    mem, fil = tpch_port_sessions
    want = mem.sql(query(qid, SF)).to_pydict()
    df = fil.sql(query(qid, SF))
    assert [df.to_pydict() for _ in range(3)] == [want] * 3


def test_warm_collect_uploads_nothing(tpch, monkeypatch):
    """The provider caches the uploaded relation per (device, units, page
    masks, projection): a warm collect() of the same DataFrame uploads
    nothing; a new filter set is a new relation."""
    port, _ = _parquet_sessions(tpch)
    uploads = []
    real = PC.to_device

    def spy(table, *a, **kw):
        uploads.append(table.num_rows)
        return real(table, *a, **kw)

    monkeypatch.setattr(PC, "to_device", spy)
    df = port.sql(query(6, SF))
    first = df.to_pydict()
    n = len(uploads)
    assert n == 1
    assert [df.to_pydict() for _ in range(3)] == [first] * 3
    assert len(uploads) == n
    prov = port.catalog.get("lineitem")
    port.sql(query(6, SF).replace("< 24", "< 25")).collect()
    port.sql(query(6, SF)).collect()
    assert len(uploads) == n  # the same pruned units and projection: a hit
    port.sql("SELECT sum(l_quantity) FROM lineitem WHERE l_orderkey < 100").collect()
    assert len(uploads) == n + 1 and len(prov._device) == 2


def test_device_scans_stay_bounded(paged_file, monkeypatch):
    """Each new literal prunes to other pages and uploads a relation of its
    own; the provider keeps the last PARQUET_DEVICE_SCANS of them. A
    DataFrame whose scan was dropped uploads it again and answers the
    same."""
    port = _port()
    port.register_parquet("t", paged_file)
    prov = port.catalog.get("t")
    uploads = []
    real = PC.to_device

    def spy(table, *a, **kw):
        uploads.append(table.num_rows)
        return real(table, *a, **kw)

    monkeypatch.setattr(PC, "to_device", spy)
    sql = "SELECT count(*) AS c, sum(k) AS s FROM t WHERE k < {}"
    first = port.sql(sql.format(1000))
    want = first.to_pydict()
    assert want == {"c": [1000], "s": [499500]}
    limits = range(2000, 2000 + 1000 * 2 * PC.PARQUET_DEVICE_SCANS, 1000)
    for k in limits:
        got = port.sql(sql.format(k)).to_pydict()
        assert got == {"c": [k], "s": [k * (k - 1) // 2]}
        assert len(prov._device) <= PC.PARQUET_DEVICE_SCANS
    assert len(uploads) == 1 + len(limits)
    assert len(prov._device) == PC.PARQUET_DEVICE_SCANS
    # the newest scan is a hit, the first was dropped and uploads again
    port.sql(sql.format(limits[-1])).collect()
    assert len(uploads) == 1 + len(limits)
    assert first.to_pydict() == want
    assert len(uploads) == 2 + len(limits)


def test_warm_collect_repeats_no_dictionary_work(tpch, monkeypatch):
    """The cached relation keeps its dictionaries, so LIKE over a Parquet
    string column runs its host predicate once over three collect()s of
    one DataFrame and a new DataFrame of the same query."""
    from datafusion_tpu_torch.physical import functions as F

    port, _ = _parquet_sessions(tpch)
    calls = []
    orig = F.dict_predicate

    def spy(col, op, args, pred_fn):
        def counted(vals):
            calls.append((op, args))
            return pred_fn(vals)
        return orig(col, op, args, counted)

    monkeypatch.setattr(F, "dict_predicate", spy)
    sql = "SELECT count(*) AS n FROM part WHERE p_name LIKE '%green%'"
    df = port.sql(sql)
    got = [df.to_pydict() for _ in range(3)] + [port.sql(sql).to_pydict()]
    assert calls == [("like", ("%green%", False))]
    assert got == [got[0]] * 4 and got[0]["n"][0] > 0


# ---------------------------------------------------------------------------
# pruning: hive partitions, row groups, pages, bloom filters, TopK
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hive_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hive")
    for year in (2022, 2023):
        for region in ("east", "west"):
            sub = d / f"year={year}" / f"region={region}"
            os.makedirs(sub, exist_ok=True)
            n = 4000
            base = (year - 2022) * 1_000_000 + (0 if region == "east" else 500_000)
            t = pa.table({"id": np.arange(base, base + n),
                          "v": np.linspace(0.0, 10.0, n),
                          "tag": [f"t{i % 7}" for i in range(n)]})
            pq.write_table(t, str(sub / "part.parquet"), row_group_size=500)
    return str(d)


@pytest.fixture(scope="module")
def paged_file(tmp_path_factory):
    """One row group of many small pages over a sorted column."""
    n = 40_000
    t = pa.table({"k": np.arange(n, dtype=np.int64),
                  "v": np.arange(n, dtype=np.float64) * 0.5,
                  "s": pa.array(["aa", "bb", "cc", "dd"] * (n // 4))})
    path = str(tmp_path_factory.mktemp("paged") / "paged.parquet")
    pq.write_table(t, path, row_group_size=n, data_page_size=2048,
                   write_page_index=True)
    return path


@pytest.fixture(scope="module")
def bloom_file(tmp_path_factory):
    """Two row groups whose min/max overlap but whose values are disjoint
    (evens vs odds): only the bloom filters can prune."""
    t1 = pa.table({"v": pa.array(range(0, 2000, 2), pa.int64()),
                   "s": pa.array([f"val{2 * i:04d}" for i in range(1000)]),
                   "f": pa.array(np.arange(0.0, 2000.0, 2.0))})
    t2 = pa.table({"v": pa.array(range(1, 2000, 2), pa.int64()),
                   "s": pa.array([f"val{2 * i + 1:04d}" for i in range(1000)]),
                   "f": pa.array(np.arange(1.0, 2000.0, 2.0))})
    p = str(tmp_path_factory.mktemp("bloom") / "t.parquet")
    pq.write_table(pa.concat_tables([t1, t2]), p, row_group_size=1000,
                   bloom_filter_options={"v": True, "s": True, "f": True})
    return p


@pytest.fixture(scope="module")
def topk_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("topk")
    n = 100_000
    tk = pa.table({"k": np.arange(n, dtype=np.int64),
                   "v": np.arange(n, dtype=np.float64) * 0.25})
    pq.write_table(tk, str(d / "tk.parquet"), row_group_size=8192,
                   write_page_index=True)
    m = 50_000
    ta = pa.table({"k": np.arange(m, dtype=np.int64) // 10,  # heavy ties
                   "r": np.arange(m, dtype=np.int64)})
    pq.write_table(ta, str(d / "ta.parquet"), row_group_size=4096,
                   write_page_index=True)
    return {"tk": str(d / "tk.parquet"), "ta": str(d / "ta.parquet")}


PRUNING = [
    ("hive", "SELECT count(*) AS n, min(id) AS m FROM t "
             "WHERE year = 2023 AND region = 'west'"),
    ("hive", "SELECT tag, count(*) AS n, sum(v) AS s FROM t WHERE year = 2022 "
             "AND region = 'east' AND id < 2000 GROUP BY tag ORDER BY tag"),
    ("hive", "SELECT count(*) AS n FROM t WHERE id BETWEEN 1200 AND 1799"),
    ("hive", "SELECT count(*) AS n FROM t WHERE id < 0"),
    ("hive", "SELECT id FROM t WHERE year = 1999"),
    ("hive", "SELECT year, region, tag, count(*) AS n FROM t "
             "GROUP BY year, region, tag ORDER BY year, region, tag"),
    ("paged", "SELECT count(*) c, sum(k) s FROM t WHERE k < 512"),
    ("paged", "SELECT count(*) c, sum(v) s FROM t WHERE k >= 20000 AND k <= 20100"),
    ("paged", "SELECT s, count(*) c FROM t WHERE k < 1000 GROUP BY s ORDER BY s"),
    ("bloom", "SELECT v, s FROM t WHERE s = 'val0013'"),
    ("bloom", "SELECT v FROM t WHERE v = 11"),
    ("bloom", "SELECT v FROM t WHERE v IN (11, 13) ORDER BY v"),
    ("bloom", "SELECT v FROM t WHERE v IN (10, 13) ORDER BY v"),
    ("bloom", "SET execution.parquet_bloom_pruning = false; "
              "SELECT v, s FROM t WHERE s = 'val0013'"),
    ("tk", "SELECT k, v FROM t ORDER BY k DESC LIMIT 7"),
    ("tk", "SELECT k, v FROM t ORDER BY k ASC LIMIT 100"),
    ("tk", "SELECT k AS kk, v FROM t ORDER BY kk DESC LIMIT 3"),
    ("tk", "SELECT k, v FROM t WHERE v > 10 ORDER BY k DESC LIMIT 7"),
    ("ta", "SELECT k, r FROM t ORDER BY k ASC, r DESC LIMIT 15"),
]


@pytest.mark.parametrize("fixture,sql", PRUNING,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(PRUNING)])
def test_pruning_matches_jax(request, hive_dir, paged_file, bloom_file,
                             topk_files, fixture, sql):
    path = {"hive": hive_dir, "paged": paged_file, "bloom": bloom_file,
            **topk_files}[fixture]
    out = []
    for ctx, plan_mod in ((_port(), PP), (JaxSession(), JP)):
        ctx.sql(f"CREATE EXTERNAL TABLE t STORED AS PARQUET LOCATION '{path}'")
        df = ctx.sql(sql)
        rows = df.to_pydict()
        scan = _scan(df.physical_plan(), plan_mod.ScanExec)
        topk = [f.name() for f in scan._topk_filters()]
        out.append((rows, dict(ctx.catalog.get("t").last_scan), topk,
                    " topk" in df.physical_plan().display()))
    assert out[0] == out[1]
    if fixture == "tk" and "WHERE" not in sql:
        assert out[0][2] and out[0][3]  # the dynamic filter was made
    if "LIMIT 7" in sql and "WHERE" not in sql:
        assert out[0][1]["row_groups_pruned"] >= 11
    if sql.startswith("SELECT v, s FROM t WHERE s"):
        assert out[0][1]["row_groups_bloom_pruned"] == 1


SORTED = [
    query(6, SF),
    "SELECT count(*) AS n, sum(l_quantity) AS q FROM lineitem WHERE l_orderkey = 4007",
    "SELECT l_orderkey, l_linenumber FROM lineitem "
    "ORDER BY l_orderkey DESC, l_linenumber LIMIT 10",
]


@pytest.mark.parametrize("sql", SORTED, ids=["q6", "bloom", "topk"])
def test_sorted_lineitem_prunes_like_jax(tpch, tmp_path_factory, sql):
    """lineitem sorted by l_shipdate with a bloom filter on l_orderkey (the
    chip run's pruning checks at SF 0.01): Q6 prunes row groups by
    statistics, an l_orderkey equality by bloom filter, a TopK carries its
    dynamic filter; answers equal the in-memory session's and the JAX
    package's, counters the JAX package's."""
    tables, _, _ = tpch
    path = str(tmp_path_factory.mktemp("sorted") / "lineitem.parquet")
    TF.write_sorted_lineitem(tables["lineitem"], path, row_group_size=2048)
    mem = _port()
    mem.register_table("lineitem", tables["lineitem"])
    out = []
    for ctx, plan_mod in ((_port(), PP), (JaxSession(), JP)):
        ctx.sql(TF.external_table_sql("lineitem", path))
        df = ctx.sql(sql)
        scan = _scan(df.physical_plan(), plan_mod.ScanExec)
        out.append((df.to_pydict(), dict(ctx.catalog.get("lineitem").last_scan),
                    [f.name() for f in scan._topk_filters()]))
    assert out[0] == out[1]
    rows, scan, topk = out[0]
    assert rows == mem.sql(sql).to_pydict()
    if "l_shipdate" in sql:
        assert scan["row_groups_pruned"] > 0
    elif "= 4007" in sql:
        assert rows["n"][0] > 0 and scan["row_groups_bloom_pruned"] > 0
    else:
        assert topk and scan["row_groups_pruned"] > 0


def test_pruning_counters_of_a_listing_table_match_jax(hive_dir):
    """The footer statistics and the pruning counters of plan_units, one
    level under SQL."""
    from datafusion_tpu.io.parquet import ParquetDataset as JaxDataset

    from datafusion_tpu_torch.io.parquet import ParquetDataset as PortDataset

    stats = []
    for ds in (PortDataset(hive_dir), JaxDataset(hive_dir)):
        stats.append((ds.num_rows(),
                      {k: (s.lo, s.hi, s.null_count)
                       for k, s in ds.column_stats().items()}))
    assert stats[0] == stats[1]
    port = PC.ParquetTable(hive_dir).statistics()
    assert port.num_rows == 16000


# ---------------------------------------------------------------------------
# the other formats, COPY, object stores
# ---------------------------------------------------------------------------

_SRC = SC.COPY_SOURCE


@pytest.mark.parametrize("fmt,ext,opts", SC.COPY_FORMATS)
def test_copy_round_trip_matches_jax(tmp_path, fmt, ext, opts):
    out = [SC.copy_round_trip(ctx, fmt, opts, str(tmp_path / f"{i}.{ext}"))
           for i, ctx in enumerate((_port(), JaxSession()))]
    assert out[0] == out[1]
    assert out[0][0] == {"count": [4]}


def test_copy_of_a_query_and_register_functions_match_jax(tmp_path):
    out = []
    for i, ctx in enumerate((_port(), JaxSession())):
        d = tmp_path / str(i)
        os.makedirs(d)
        ctx.sql(_SRC)
        ctx.sql(f"COPY (SELECT column1 AS k, column3 AS x FROM src WHERE column1 > 1) "
                f"TO '{d}/q.parquet'")
        ctx.sql(f"COPY src TO '{d}/s.csv' STORED AS CSV")
        ctx.sql(f"COPY src TO '{d}/s.json' STORED AS JSON")
        ctx.register_parquet("p", f"{d}/q.parquet")
        ctx.register_csv("c", f"{d}/s.csv")
        ctx.register_json("j", f"{d}/s.json")
        res = [_run(ctx, "SELECT k, x FROM p ORDER BY k"),
               _run(ctx, "SELECT column1, column2 FROM c ORDER BY column1"),
               _run(ctx, "SELECT * FROM j ORDER BY column1")]
        ctx.deregister_table("p")
        res.append(_run(ctx, "SELECT * FROM p"))
        ctx.sql("CREATE TABLE cp AS VALUES (5, 'e')")
        ctx.sql(f"COPY cp TO '{d}/cp.parquet'")
        ctx.sql(f"CREATE EXTERNAL TABLE cpx STORED AS PARQUET LOCATION '{d}/cp.parquet'")
        res.append(_run(ctx, "SELECT * FROM cpx"))
        out.append(res)
    assert out[0] == out[1]
    assert out[0][3] == "PlanError"


def test_dataframe_write_methods_match_jax(tmp_path):
    out = []
    for i, ctx in enumerate((_port(), JaxSession())):
        ctx.sql(_SRC)
        df = ctx.sql("SELECT column1 AS k, column2 AS s FROM src")
        df.write_parquet(str(tmp_path / f"{i}.parquet"))
        df.write_csv(str(tmp_path / f"{i}.csv"))
        out.append((pq.read_table(str(tmp_path / f"{i}.parquet")).to_pydict(),
                    (tmp_path / f"{i}.csv").read_text()))
    assert out[0] == out[1]


def test_json_schema_inference_matches_jax(tmp_path):
    path = tmp_path / "x.json"
    path.write_text('{"a": 1, "b": "x", "c": 1.5, "d": true}\n'
                    '{"a": null, "b": null, "c": 2, "d": null, "e": [1, 2]}\n'
                    '{"a": 3, "b": "z", "c": null, "d": false, "e": []}\n')
    out = []
    for ctx in (_port(), JaxSession()):
        ctx.sql(f"CREATE EXTERNAL TABLE j STORED AS JSON LOCATION '{path}'")
        out.append(([(f.name, repr(f.dtype), f.nullable)
                     for f in ctx.catalog.get("j").schema().fields],
                    _run(ctx, "SELECT a, b, c, d FROM j ORDER BY a"),
                    _run(ctx, "SELECT sum(a) AS s, count(b) AS n FROM j")))
    assert out[0] == out[1]


def test_parquet_timestamp_ns_and_decimals_match_jax(tmp_path):
    import decimal

    path = str(tmp_path / "ts.parquet")
    ts = np.array(["2024-01-01T00:00:00.123456789", "2024-06-30T12:00:00",
                   "1999-12-31T23:59:59.000000001"], dtype="datetime64[ns]")
    pq.write_table(pa.table({
        "t": pa.array(ts, pa.timestamp("ns")),
        "d": pa.array([decimal.Decimal("1.25"), None, decimal.Decimal("-3.50")],
                      pa.decimal128(10, 2)),
        "k": pa.array([1, 2, 3], pa.int32())}), path, write_page_index=True)
    out = []
    for ctx in (_port(), JaxSession()):
        ctx.sql(f"CREATE EXTERNAL TABLE ts STORED AS PARQUET LOCATION '{path}'")
        out.append((_run(ctx, "SELECT k, t, d FROM ts ORDER BY t"),
                    _run(ctx, "SELECT k FROM ts WHERE t > TIMESTAMP '2000-01-01 00:00:00'"
                              " ORDER BY k"),
                    _run(ctx, "SELECT sum(d) AS s FROM ts WHERE d < 2"),
                    dict(ctx.catalog.get("ts").last_scan)))
    assert out[0] == out[1]


def _parquet_bytes(table, **kw):
    buf = io.BytesIO()
    pq.write_table(table, buf, **kw)
    return buf.getvalue()


def test_in_memory_object_store_matches_jax():
    n = 5000
    t = pa.table({"k": np.arange(n, dtype=np.int64),
                  "v": np.arange(n, dtype=np.float64) * 2.0})
    blob = _parquet_bytes(t, row_group_size=1024, write_page_index=True)
    out = []
    for ctx, store in ((_port(), PortMemoryStore()), (JaxSession(), JaxMemoryStore())):
        store.put("data/part.parquet", blob)
        for y in (2023, 2024):
            store.put(f"lake/year={y}/f.parquet",
                      _parquet_bytes(pa.table({"v": np.arange(10, dtype=np.int64) + y})))
        ctx.register_object_store("mem://", store)
        ctx.sql("CREATE EXTERNAL TABLE m STORED AS PARQUET "
                "LOCATION 'mem:///data/part.parquet'")
        ctx.sql("CREATE EXTERNAL TABLE lake STORED AS PARQUET LOCATION 'mem:///lake'")
        out.append((_run(ctx, "SELECT count(*) c, sum(k) s FROM m"),
                    _run(ctx, "SELECT count(*) c FROM m WHERE k < 100"),
                    dict(ctx.catalog.get("m").last_scan),
                    _run(ctx, "SELECT year, count(*) c FROM lake GROUP BY year "
                              "ORDER BY year"),
                    _run(ctx, "CREATE EXTERNAL TABLE x STORED AS PARQUET "
                              "LOCATION 's3://bucket/path'; SELECT * FROM x")))
    assert out[0] == out[1]
    assert out[0][0] == {"c": [n], "s": [n * (n - 1) // 2]}


def test_xxhash64_matches_jax():
    rng = np.random.default_rng(11)
    for _ in range(200):
        b = rng.integers(0, 256, int(rng.integers(0, 101)), dtype=np.uint8).tobytes()
        seed = int(rng.integers(0, 2**63))
        assert _xxhash64(b) == jax_xxhash64(b)
        assert _xxhash64(b, seed=0) == jax_xxhash64(b, seed=0)
        assert _xxhash64(b, seed=seed) == jax_xxhash64(b, seed=seed)


# ---------------------------------------------------------------------------
# the session's statements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sql", SC.STATEMENTS)
def test_statement_matches_jax(sql):
    assert _run(_port(), SC.SETUP + sql) == _run(JaxSession(), SC.SETUP + sql)


def test_still_unported_statements_name_their_item():
    """EXPLAIN ANALYZE, which raised naming item 12 until it was ported:
    the same operators, output rows and metric names as the JAX package's
    (the times differ)."""
    def lines(ctx):
        ctx.sql(SC.SETUP)
        plan = ctx.sql("EXPLAIN ANALYZE SELECT id FROM t WHERE id > 1").to_pydict()["plan"]
        return [re.sub(r"[0-9.]+ ms", "<ms>", line) for line in plan]

    got = lines(_port())
    assert got == lines(JaxSession())
    assert "-- total: <ms>, output rows: 2" in got


@pytest.mark.parametrize("source", ["memory", "parquet"])
def test_dataframe_planned_before_an_insert(tmp_path, source):
    """A DataFrame keeps the provider it was planned with: collected again
    after an INSERT into its table it answers as the JAX package's does."""
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": [1, 2, 3], "b": ["x", "y", None]}), path)
    out = []
    for ctx in (_port(), JaxSession()):
        if source == "memory":
            ctx.register_table("t", {"a": [1, 2, 3], "b": ["x", "y", None]})
        else:
            ctx.sql(f"CREATE EXTERNAL TABLE t STORED AS PARQUET LOCATION '{path}'")
        df = ctx.sql("SELECT count(*) AS n, sum(a) AS s, count(b) AS nb FROM t")
        before = df.to_pydict()
        ctx.sql("INSERT INTO t VALUES (10, 'z')")
        out.append((before, df.to_pydict(), df.to_pydict(),
                    ctx.sql("SELECT count(*) AS n, sum(a) AS s, count(b) AS nb "
                            "FROM t").to_pydict()))
    assert out[0] == out[1]


def test_register_pyarrow_table():
    at = pa.table({"a": [1, 2, 3], "s": ["x", None, "x"]})
    out = []
    for ctx in (_port(), JaxSession()):
        ctx.register_table("t", at)
        out.append((ctx.sql("SELECT sum(a) FROM t").to_pydict(),
                    ctx.sql("SELECT s, count(*) AS n FROM t GROUP BY s "
                            "ORDER BY s").to_pydict()))
    assert out[0] == out[1]
    assert out[0][0] == {"sum(a)": [6]}

"""The session-statement case table, shared by the differential tests
(tests/test_torch_files.py, against the JAX package on the CPU) and
chip_smoke.py's files phase (the card against the CPU).

SETUP makes the table every case reads; STATEMENTS are SQL scripts run
after it on a fresh session, each answered by the rows of its last
statement or the class of the error it raises. COPY_SOURCE and
COPY_FORMATS drive `copy_round_trip`: a table written by COPY ... TO in
each format and read back through CREATE EXTERNAL TABLE."""

SETUP = ("CREATE TABLE t(id INT, name VARCHAR, v DOUBLE); "
         "INSERT INTO t VALUES (1, 'a', 1.5), (2, NULL, 2.5), (3, 'c', NULL); ")

STATEMENTS = [
    "INSERT INTO t VALUES (4, 'd', 4.5)",
    "INSERT INTO t VALUES (4, 'd', -4.5), (5, NULL, NULL); SELECT * FROM t ORDER BY id",
    "INSERT INTO t SELECT id + 10, name, v FROM t WHERE id > 1; SELECT * FROM t ORDER BY id",
    "INSERT INTO t SELECT id, name FROM t",
    "INSERT INTO t (name, id) VALUES ('x', 9); SELECT * FROM t ORDER BY id",
    "INSERT INTO nope VALUES (1)",
    "DELETE FROM t WHERE v > 2",
    "DELETE FROM t WHERE v > 2; SELECT * FROM t ORDER BY id",
    "DELETE FROM t WHERE name = 'a' OR name IS NULL; SELECT * FROM t ORDER BY id",
    "DELETE FROM t; SELECT count(*) AS n FROM t",
    "UPDATE t SET v = v * 2 WHERE id >= 2",
    "UPDATE t SET v = v * 2 WHERE id >= 2; SELECT * FROM t ORDER BY id",
    "UPDATE t SET name = 'z', v = 0; SELECT * FROM t ORDER BY id",
    "UPDATE t SET name = NULL WHERE v > 2; SELECT * FROM t ORDER BY id",
    "UPDATE t SET nope = 1",
    "CREATE VIEW w AS SELECT id, v FROM t WHERE id > 1; SELECT * FROM w ORDER BY id",
    "CREATE VIEW w AS SELECT id FROM t; INSERT INTO t VALUES (7, 'g', 7.0); "
    "SELECT * FROM w ORDER BY id",
    "CREATE VIEW w AS SELECT id FROM t WHERE v > 1; SHOW CREATE TABLE w",
    "CREATE VIEW w AS SELECT id FROM t; DROP TABLE w; SELECT * FROM w",
    "SHOW TABLES",
    "SHOW COLUMNS FROM t",
    "SHOW COLUMNS FROM t LIKE 'n%'",
    "SHOW CREATE TABLE t",
    "SHOW CREATE TABLE nope",
    "SHOW execution.parquet_bloom_pruning",
    "SHOW nope.nope",
    "SHOW ALL",
    "SET execution.parquet_bloom_pruning = false; SHOW execution.parquet_bloom_pruning",
    "SET datafusion.execution.batch_size = 1024; SHOW datafusion.execution.batch_size",
    "PREPARE p(INT) AS SELECT name FROM t WHERE id = $1; EXECUTE p(2)",
    "PREPARE p AS SELECT id FROM t WHERE v > $1 ORDER BY id; EXECUTE p(2.0)",
    "PREPARE p(INT, VARCHAR) AS SELECT id FROM t WHERE id > $1 AND name = $2; "
    "EXECUTE p(1, 'c')",
    "PREPARE p(INT) AS INSERT INTO t VALUES ($1, 'p', 0.5); EXECUTE p(8); "
    "SELECT * FROM t ORDER BY id",
    "PREPARE p(INT) AS SELECT 1; DEALLOCATE p; EXECUTE p(1)",
    "PREPARE p(INT) AS SELECT $1 + 1 AS x; EXECUTE p(1, 2)",
    "DEALLOCATE nope",
    "EXECUTE nope(1)",
    "DROP TABLE t; SELECT * FROM t",
    "CREATE EXTERNAL TABLE x STORED AS ORC LOCATION 'x.orc'",
    "EXPLAIN SELECT id FROM t WHERE id > 1",
]

COPY_SOURCE = (
    "CREATE TABLE src AS VALUES (1, 'a', 1.5, DATE '2020-01-01', true), "
    "(2, NULL, NULL, DATE '2021-06-30', false), (3, 'c', -2.25, NULL, NULL), "
    "(4, 'dd', 1e10, DATE '1999-12-31', true)")

# (STORED AS name, file extension, OPTIONS clause of the read-back)
COPY_FORMATS = [
    ("parquet", "parquet", ""),
    ("csv", "csv", " OPTIONS ('format.has_header' 'true')"),
    ("json", "json", ""),
    ("arrow", "arrow", ""),
    ("avro", "avro", ""),
]


def run(ctx, sql: str):
    """The rows of the last statement, or the class name of the error."""
    try:
        return ctx.sql(sql).to_pydict()
    except Exception as e:  # noqa: BLE001 -- an error is an outcome
        return type(e).__name__


def copy_round_trip(ctx, fmt: str, opts: str, path: str):
    """COPY_SOURCE written to `path` as `fmt` and read back: (COPY's count,
    the read-back schema, its rows, an aggregate over it)."""
    ctx.sql(COPY_SOURCE)
    n = run(ctx, f"COPY src TO '{path}' STORED AS {fmt}")
    ctx.sql(f"CREATE EXTERNAL TABLE back STORED AS {fmt.upper()}{opts} "
            f"LOCATION '{path}'")
    schema = [(f.name, repr(f.dtype)) for f in ctx.catalog.get("back").schema().fields]
    return (n, schema, run(ctx, "SELECT * FROM back ORDER BY column1"),
            run(ctx, "SELECT count(*) AS n, count(column2) AS c2, "
                     "max(column1) AS m FROM back"))

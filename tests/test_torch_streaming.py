"""Streaming tables and execute_stream of the port (catalog.StreamingTable,
SessionContext.register_streaming_table, DataFrame.execute_stream, the
chunked executor's limit, symmetric join and boundedness check) on
device="cpu": the cases of tests/test_streaming.py, each held against the
JAX package on the same batches (the same rows, or the same error)."""
import itertools

import jax
import pytest

from datafusion_tpu.common import types as JT
from datafusion_tpu.common.errors import PlanError as JaxPlanError
from datafusion_tpu.common.schema import Field as JField
from datafusion_tpu.common.schema import Schema as JSchema
from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.common.errors import PlanError
from datafusion_tpu_torch.common.schema import Field, Schema

SCHEMA = {"k": T.INT64, "v": T.FLOAT64}
JSCHEMA = {"k": JT.INT64, "v": JT.FLOAT64}


@pytest.fixture(scope="module", autouse=True)
def _fast_reference():
    """The reference's per-chunk programs compile without XLA's
    optimizations, which would cost more than these small runs save."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


def bounded_batches():
    yield {"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]}
    yield {"k": [4, 5], "v": [4.0, 5.0]}


def infinite_batches():
    for i in itertools.count():
        yield {"k": list(range(i * 10, i * 10 + 10)),
               "v": [float(x) for x in range(10)]}


def _both(batches, unbounded=False, **tables):
    """(port session, JAX session), each with the stream `s` and `tables`."""
    port, ref = PortSession(device="cpu"), JaxSession()
    port.register_streaming_table("s", batches, SCHEMA, unbounded=unbounded)
    ref.register_streaming_table("s", batches, JSCHEMA, unbounded=unbounded)
    for name, t in tables.items():
        port.register_table(name, t)
        ref.register_table(name, t)
    return port, ref


@pytest.mark.parametrize("sql", ["SELECT k, v FROM s ORDER BY k",
                                 "SELECT count(*) n, sum(v) sv FROM s",
                                 "SELECT k FROM s WHERE v > 2 ORDER BY k DESC LIMIT 2"])
def test_bounded_stream_full_query(sql):
    port, ref = _both(bounded_batches)
    df = port.sql(sql)
    assert df.to_pydict() == ref.sql(sql).to_pydict()
    assert getattr(df, "_cq", None) is None  # a bounded stream runs resident
    if sql.endswith("ORDER BY k"):
        assert df.to_pydict()["k"] == [1, 2, 3, 4, 5]


def test_unbounded_limit_early_stops():
    """A LIMIT over an endless stream answers after the batches it needs."""
    pulled = []

    def counted():
        for b in infinite_batches():
            pulled.append(1)
            yield b

    port, ref = _both(counted, unbounded=True)
    sql = "SELECT k FROM s WHERE k % 2 = 0 LIMIT 4"
    out = port.sql(sql).to_pydict()
    assert out == ref.sql(sql).to_pydict() == {"k": [0, 2, 4, 6]}
    assert len(pulled) <= 2


@pytest.mark.parametrize("sql,match", [
    ("SELECT * FROM s", "unbounded"),
    ("SELECT k, count(*) FROM s GROUP BY k", "pipeline breaker|unbounded"),
    ("SELECT k FROM s ORDER BY k", "pipeline breaker|unbounded")])
def test_unbounded_without_limit_rejected(sql, match):
    port, ref = _both(infinite_batches, unbounded=True)
    with pytest.raises(PlanError, match=match):
        port.sql(sql).collect()
    with pytest.raises(JaxPlanError, match=match):
        ref.sql(sql).collect()


def test_execute_stream_incremental():
    port, ref = _both(infinite_batches, unbounded=True)
    got = {}
    for name, ctx in (("port", port), ("jax", ref)):
        rows = []
        for t in ctx.sql("SELECT k FROM s WHERE k < 25").execute_stream(chunk_rows=8):
            rows.extend(t.to_pydict()["k"])
            if len(rows) >= 25:
                break  # the consumer decides when to stop an unbounded stream
        got[name] = rows[:25]
    assert got["port"] == got["jax"] == list(range(25))


def test_execute_stream_yields_chunks_equal_to_collect():
    """Over a bounded table, execute_stream yields more than one table and
    their rows together are collect()'s."""
    ctx = PortSession(device="cpu")
    ctx.register_table("t", {"k": list(range(1000)), "v": [i % 7 for i in range(1000)]})
    df = ctx.sql("SELECT k, v FROM t WHERE v < 5")
    parts = list(df.execute_stream(chunk_rows=128))
    assert len(parts) > 1
    rows = sorted(r for t in parts for r in zip(*t.to_pydict().values()))
    assert rows == sorted(zip(*df.to_pydict().values()))


def test_stream_joins_against_bounded_table():
    dim = {"k": [2, 4], "name": ["two", "four"]}
    port, ref = _both(bounded_batches, dim=dim)
    sql = "SELECT s.k, name FROM s JOIN dim ON s.k = dim.k ORDER BY s.k"
    assert port.sql(sql).to_pydict() == ref.sql(sql).to_pydict() \
        == {"k": [2, 4], "name": ["two", "four"]}


def test_unbounded_build_side_rejected():
    port, ref = _both(infinite_batches, unbounded=True, dim={"k": [2, 4]})
    sql = "SELECT dim.k FROM dim JOIN s ON dim.k = s.k"
    with pytest.raises(PlanError, match="unbounded|build side"):
        port.sql(sql).collect()
    with pytest.raises(JaxPlanError, match="unbounded|build side"):
        ref.sql(sql).collect()


def _two_streams():
    def left_batches():
        for i in range(5):
            yield {"k": [i, i + 1, i + 2], "a": [10 * i, 10 * i + 1, 10 * i + 2]}

    def right_batches():
        for j in range(4):
            yield {"k2": [j, j + 5], "b": [100 * j, 100 * j + 5]}

    port, ref = PortSession(device="cpu"), JaxSession()
    for ctx, F, S, TT in ((port, Field, Schema, T), (ref, JField, JSchema, JT)):
        ctx.register_streaming_table("l", left_batches,
                                     S([F("k", TT.INT64), F("a", TT.INT64)]),
                                     unbounded=True)
        ctx.register_streaming_table("r", right_batches,
                                     S([F("k2", TT.INT64), F("b", TT.INT64)]),
                                     unbounded=True)
    return port, ref


def test_symmetric_stream_stream_join():
    """An INNER join of two unbounded streams runs incrementally (the
    symmetric join): every matching pair once, as the JAX package and the
    pairs themselves say."""
    port, ref = _two_streams()
    sql = "SELECT k, a, b FROM l JOIN r ON l.k = r.k2"
    got = {}
    for name, ctx in (("port", port), ("jax", ref)):
        rows = []
        for t in ctx.sql(sql).execute_stream(chunk_rows=4):
            d = t.to_pydict()
            rows.extend(zip(d["k"], d["a"], d["b"]))
        got[name] = sorted(rows)
    left = [(i + d, 10 * i + d) for i in range(5) for d in range(3)]
    right = [(j, 100 * j) for j in range(4)] + [(j + 5, 100 * j + 5) for j in range(4)]
    want = sorted((k, a, b) for k, a in left for k2, b in right if k == k2)
    assert got["port"] == got["jax"] == want
    limited = port.sql("SELECT k FROM l JOIN r ON l.k = r.k2 LIMIT 3").to_pydict()
    assert len(limited["k"]) == 3


def test_unbounded_outer_join_still_rejected():
    def batches():
        while True:
            yield {"k": [1, 2]}

    port, ref = PortSession(device="cpu"), JaxSession()
    for ctx, F, S, TT in ((port, Field, Schema, T), (ref, JField, JSchema, JT)):
        for name in ("l", "r"):
            ctx.register_streaming_table(name, batches, S([F("k", TT.INT64)]),
                                         unbounded=True)
    sql = "SELECT l.k FROM l LEFT JOIN r ON l.k = r.k"
    with pytest.raises(PlanError, match="unbounded"):
        list(port.sql(sql).execute_stream(chunk_rows=4))
    with pytest.raises(JaxPlanError, match="unbounded"):
        list(ref.sql(sql).execute_stream(chunk_rows=4))


def _varied_batches():
    """Six batches whose key ranges and string sets differ: each uploads with
    its own bounds and its own dictionary."""
    import numpy as np

    rng = np.random.default_rng(0)
    words = np.array(["ab", "cd", "ef", "gh", "ij", "kl"], dtype=object)
    out = []
    for i in range(6):
        n = 300
        out.append({"k": rng.integers(i * 3, i * 3 + 6, n).tolist(),
                    "s": rng.choice(words[i % 3:i % 3 + 3], n).tolist(),
                    "v": rng.integers(-50, 50, n).tolist()})
    return out


@pytest.mark.parametrize("sql", [
    "SELECT k, count(*) c, sum(v) sv FROM st GROUP BY k ORDER BY k",
    "SELECT s, count(*) c, sum(v) sv, min(v) mn FROM st GROUP BY s ORDER BY s",
    "SELECT count(*) n, sum(v) sv, min(s) ms, max(s) xs, min(k) mk FROM st",
    "SELECT s, k, max(v) mv FROM st GROUP BY s, k ORDER BY s, k"])
def test_chunked_aggregate_over_batches_with_their_own_metadata(sql):
    """A bounded stream under execution.out_of_core=on: its batches carry
    different dictionaries and bounds, so no dense slot or elementwise merge
    may be decided from the first one; the chunked answer equals the
    port's resident answer."""
    batches = _varied_batches()
    schema = {"k": T.INT64, "s": T.STRING, "v": T.INT64}
    out = []
    for mode in ("on", "off"):
        ctx = PortSession(device="cpu", config={"execution.out_of_core": mode,
                                                "execution.chunk_rows": 128})
        ctx.register_streaming_table("st", lambda: iter(batches), schema)
        df = ctx.sql(sql)
        out.append(df.to_pydict())
        if mode == "on":
            assert df._cq is not None and df._cq.chunks == 18
    assert out[0] == out[1]

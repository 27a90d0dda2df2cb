"""Out-of-core execution of the port (physical/chunked.py, runtime/spill.py,
runtime/memory.py, parallel/aggsplit.py, the chunked scans of
catalog/catalog.py) on device="cpu", held against the JAX package:

- `hash64` bit for bit over int64, float64, bool and validity columns at
  the int64 extremes; `merge_run_indices` and `host_sort_indices` against
  the JAX package's; `build_state_plan` + `finalize` of every decomposable
  aggregate on the same states; a SpillManager round trip through the disk
  tier; FairSpillPool shares.
- The sixteen queries of tests/test_outofcore.py and its grace join, spill,
  distinct and hive-Parquet cases: the port's chunked answer against the
  JAX package's chunked answer (floats to atol 1e-9, the rest exact).
- The session's routing (`execution.out_of_core` auto/on/off under a
  memory limit), the dense aggregation kernel once per chunk, chunked scans
  that leave the tables' device caches empty, and TPC-H Q1, Q3, Q4, Q5, Q6,
  Q10, Q12, Q13, Q18 and Q19 at SF 0.005, chunked against the port's
  resident answer and the pandas oracle.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.data import device as JD
from datafusion_tpu.ops import groupby as JG
from datafusion_tpu.ops import kernels as JK
from datafusion_tpu.parallel import aggsplit as JAS
from datafusion_tpu.physical import chunked as JC
from datafusion_tpu.runtime import memory as JM
from datafusion_tpu.runtime import spill as JS
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.common.errors import ResourceExhausted
from datafusion_tpu_torch.data import device as PD
from datafusion_tpu_torch.data.table import Table
from datafusion_tpu_torch.models.tpch.compare import LIMIT_QUERIES, frames_diff
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch
from datafusion_tpu_torch.models.tpch.queries import query
from datafusion_tpu_torch.models.tpch.queries_ref import ref_query
from datafusion_tpu_torch.ops import dense_agg as DA
from datafusion_tpu_torch.ops import groupby as PG
from datafusion_tpu_torch.ops import kernels as PK
from datafusion_tpu_torch.parallel import aggsplit as PAS
from datafusion_tpu_torch.physical import chunked as PC
from datafusion_tpu_torch.runtime import memory as PM
from datafusion_tpu_torch.runtime import spill as PS

I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module", autouse=True)
def _fast_reference():
    """The reference's per-chunk programs compile without XLA's
    optimizations, which would cost more than these small runs save."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


def _same(got: pd.DataFrame, want: pd.DataFrame, ordered: bool) -> None:
    """Equal frames, floats to atol 1e-9 and the rest exact; as multisets
    unless `ordered`."""
    if not ordered and len(want):
        cols = list(want.columns)
        want = want.sort_values(cols).reset_index(drop=True)
        got = got.sort_values(cols).reset_index(drop=True)
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True),
                                  check_dtype=False, atol=1e-9)


# ---------------------------------------------------------------------------
# hash64, the host merge, the aggregate states, spill, pools
# ---------------------------------------------------------------------------

HASH_COLUMNS = {
    "int64": np.array([0, 1, -1, I64.max, I64.min, 12345678901234, -7], np.int64),
    "int32": np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 77, -7], np.int32),
    "float64": np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25e300]),
    "float32": np.array([0.0, -0.0, np.nan, np.inf, -1.5, 3.25, 1e30], np.float32),
    "bool": np.array([True, False, True, True, False, False, True]),
    "validity": np.array([True, True, False, True, False, True, True]),
}


@pytest.mark.parametrize("cols,seed", [
    (("int64",), 0), (("float64",), 0), (("bool",), 0), (("int32",), 0),
    (("float32",), 0), (("int64", "validity"), 0),
    (("int64", "validity", "float64", "validity", "bool"), 0),
    (("float64", "int64"), 9), (("int64",), 2 ** 63 + 5)])
def test_hash64_is_bit_identical(cols, seed):
    """uint64 `>>` raises on the CPU in torch: the port shifts int64 bit
    patterns and masks off the sign bits; every row's 64 bits must equal
    the reference's."""
    ref = np.asarray(JK.hash64([jnp.asarray(HASH_COLUMNS[c]) for c in cols],
                               seed=seed))
    ours = PK.hash64([torch.from_numpy(HASH_COLUMNS[c].copy()) for c in cols],
                     seed=seed)
    assert ours.dtype is torch.int64
    assert np.array_equal(ours.numpy().view(np.uint64), ref)




def _runs(rng, nruns, key_fn):
    """Presorted runs of (data, validity) under one key order, and their
    lengths."""
    datas, valids, lens = [], [], []
    for _ in range(nruns):
        n = int(rng.integers(0, 40))
        d, v = key_fn(n)
        order = JC.host_sort_indices([(d, v, False, False)])
        datas.append(d[order])
        valids.append(v[order])
        lens.append(n)
    return np.concatenate(datas), np.concatenate(valids), lens


@pytest.mark.parametrize("kind", ["int64", "float64", "bool", "int64-extremes"])
def test_merge_run_indices_matches_the_reference(kind):
    """Keys that pack into one int64 and keys that need the structured
    composite (int64 extremes) merge to the reference's indices."""
    rng = np.random.default_rng(3)

    def key(n):
        if kind == "int64":
            d = rng.integers(-50, 50, n).astype(np.int64)
        elif kind == "int64-extremes":
            d = rng.choice(np.array([I64.min, -1, 0, 3, I64.max]), n)
        elif kind == "float64":
            d = rng.choice([-0.0, 0.0, 1.5, -2.0, np.inf, -np.inf], n)
        else:
            d = rng.random(n) > 0.5
        return d, rng.random(n) > 0.2

    data, valid, lens = _runs(rng, 7, key)
    packed = PC.pack_key_rows([(data, valid, False, False)])
    if kind.startswith("int64"):
        assert (packed.dtype == np.int64) == (kind == "int64")
    ours = PC.merge_run_indices(packed, lens)
    ref = JC.merge_run_indices(JC.pack_key_rows([(data, valid, False, False)]), lens)
    assert np.array_equal(ours, ref)
    assert np.array_equal(packed[ours], np.sort(packed, kind="stable"))


@pytest.mark.parametrize("desc,nulls_first", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_host_sort_indices_matches_the_reference(desc, nulls_first):
    rng = np.random.default_rng(11)
    n = 300
    keys = [(rng.integers(0, 5, n).astype(np.int64), rng.random(n) > 0.1, desc,
             nulls_first),
            (rng.normal(size=n), None, not desc, nulls_first),
            (np.array([I64.min, I64.max, 0] * 100, np.int64), None, desc, False)]
    assert np.array_equal(PC.host_sort_indices(keys), JC.host_sort_indices(keys))


def _state_inputs(fname):
    """Argument columns (x with NULLs, y with NULLs), group ids and the
    aggregate's output type name for one decomposable aggregate."""
    rng = np.random.default_rng(5)
    n = 64
    boolean = fname.startswith("bool_")
    if boolean:
        x = rng.random(n) > 0.5
    elif fname.startswith("bit_"):
        x = rng.integers(0, 1 << 20, n).astype(np.int64)
    else:
        x = rng.integers(-500, 500, n).astype(np.int64)
    # bitwise states are global here: the grouped ones need sorted runs
    ngroups = 1 if fname.startswith("bit_") else 4
    seg = rng.integers(0, ngroups, n).astype(np.int32)
    seg[:ngroups] = np.arange(ngroups)
    arg_type = "BOOL" if boolean else "INT64"
    out = {"count": "INT64", "count_star": "INT64", "regr_count": "INT64",
           "sum": "INT64", "min": arg_type, "max": arg_type, "bool_and": "BOOL",
           "bool_or": "BOOL", "bit_and": "INT64", "bit_or": "INT64",
           "bit_xor": "INT64"}.get(fname, "FLOAT64")
    return (x, rng.random(n) > 0.2, rng.normal(size=n), rng.random(n) > 0.1,
            seg, ngroups, arg_type, out)


def _partial_states(pkg, fname):
    """(state plan, per-half partial state arrays, plan layout) of one
    package: the same rows split in two halves by their selection masks."""
    from datafusion_tpu.common import types as JT

    x, xv, y, yv, seg, ngroups, arg_type, out = _state_inputs(fname)
    n = len(x)
    arg = None if fname == "count_star" else 0
    if pkg == "port":
        Tm, AS, Gm, K_, D = T, PAS, PG, PK, PD
        arr = lambda a: torch.from_numpy(np.array(a))
    else:
        Tm, AS, Gm, K_, D = JT, JAS, JG, JK, JD
        arr = jnp.asarray
    cols = [D.DeviceColumn(arr(x), arr(xv), getattr(Tm, arg_type)),
            D.DeviceColumn(arr(y), arr(yv), Tm.FLOAT64)]
    spec = Gm.AggSpec(fname, arg, False, getattr(Tm, out), cols[0].dtype)
    sp = AS.build_state_plan([spec], cols)
    parts = []
    for half in (slice(0, n // 2), slice(n // 2, n)):
        sel = np.zeros(n, bool)
        sel[half] = True
        s, sg = arr(sel), arr(seg)
        cnt = K_.segment_count(sg, s, ngroups)
        parts.append([np.asarray(Gm._reduce_one(
            ss, sp.state_args, [], s, sg, arr(np.zeros(n, bool)), None, ngroups,
            cnt, arr(np.ones(ngroups, bool))).data) for ss in sp.state_specs])
    layout = ([(st.fname, repr(st.out_dtype)) for st in sp.state_specs],
              list(sp.merge_kinds), [(f.kind, f.slots) for f in sp.finals])
    return sp, parts, layout


_NP_MERGE = {"sum": np.add, "min": np.minimum, "max": np.maximum,
             "bit_and": np.bitwise_and, "bit_or": np.bitwise_or,
             "bit_xor": np.bitwise_xor}


@pytest.mark.parametrize("fname", sorted(PAS._DECOMPOSABLE))
def test_state_plan_and_finalize_match_the_reference(fname):
    """Each decomposable aggregate over two halves of the same rows: both
    packages' state layouts agree, their partial states agree, and the
    merged states finalize to the same column (floats to 1e-12)."""
    psp, pparts, playout = _partial_states("port", fname)
    jsp, jparts, jlayout = _partial_states("jax", fname)
    assert playout == jlayout
    for a, b in zip(pparts, jparts):
        for x_, y_ in zip(a, b):
            np.testing.assert_allclose(x_.astype(np.float64), y_.astype(np.float64),
                                       rtol=1e-12, atol=1e-12)
    merged = []
    for i, (kind, m) in enumerate(zip(psp.merge_kinds, psp.merge_specs)):
        op = _NP_MERGE[m.fname if kind == "bitop" else kind]
        a, b = pparts[0][i], pparts[1][i]
        merged.append(op(a, b))
    ng = len(merged[0])
    pout = PAS.finalize(psp, [PD.DeviceColumn(torch.from_numpy(m.copy()), None,
                                              st.out_dtype)
                              for m, st in zip(merged, psp.state_specs)],
                        torch.ones(ng, dtype=torch.bool))
    jout = JAS.finalize(jsp, [JD.DeviceColumn(jnp.asarray(m), None, st.out_dtype)
                              for m, st in zip(merged, jsp.state_specs)],
                        jnp.ones(ng, dtype=bool))
    assert len(pout) == len(jout) == 1
    p_, j_ = pout[0], jout[0]
    pv = np.ones(ng, bool) if p_.validity is None else p_.validity.numpy()
    jv = np.ones(ng, bool) if j_.validity is None else np.asarray(j_.validity)
    assert np.array_equal(pv, jv)
    np.testing.assert_allclose(p_.data.numpy()[pv].astype(np.float64),
                               np.asarray(j_.data)[jv].astype(np.float64),
                               rtol=1e-12, atol=1e-12, equal_nan=True)


def test_decomposable_matches_the_reference():
    specs = [PG.AggSpec("sum", 0, False, T.INT64), PG.AggSpec("median", 0, False, T.FLOAT64)]
    assert PAS.decomposable(specs[:1]) and not PAS.decomposable(specs)
    assert not PAS.decomposable([PG.AggSpec("sum", 0, True, T.INT64)])
    assert PAS._DECOMPOSABLE == JAS._DECOMPOSABLE


def _spill_table():
    return Table.from_pydict(
        {"v": list(range(4096)), "s": ["a", None, "c", "d"] * 1024,
         "f": [0.5 * i if i % 7 else None for i in range(4096)]},
        {"v": T.INT64, "s": T.STRING, "f": T.FLOAT64})


@pytest.mark.parametrize("compress", [False, True])
def test_spill_manager_round_trip_through_disk(tmp_path, compress):
    """Spilled relations past the host budget demote to .npz files; a
    restore reads them back (read-only arrays, copied) onto the given device
    and equals the relation spilled, as the JAX package's does."""
    table = _spill_table()
    rel = PD.to_device(table, device="cpu")
    mgr = PS.SpillManager(str(tmp_path), max_host_bytes=rel.sel.numel(),
                          compress=compress)
    spilled = [mgr.spill(rel) for _ in range(4)]
    assert mgr.disk_spill_count >= 2 and list(tmp_path.glob("*.npz"))
    demoted = next(s for s in spilled if s.path is not None)
    back = demoted.restore(torch.device("cpu"))
    assert back.device == torch.device("cpu")
    back.columns[0].data += 0  # restored tensors are writable
    got = PD.to_host(back).to_pydict()
    assert got == table.to_pydict()
    # the JAX package's round trip of the same table
    from datafusion_tpu.common import types as JT
    from datafusion_tpu.data.table import Table as JTable

    jtab = JTable.from_pydict(table.to_pydict(), {"v": JT.INT64, "s": JT.STRING,
                                                  "f": JT.FLOAT64})
    jmgr = JS.SpillManager(str(tmp_path), max_host_bytes=1, compress=compress)
    js = jmgr.spill(JD.to_device(jtab))
    assert js.path is not None  # demoted at once: its host budget is 1 byte
    assert JD.to_host(js.restore()).to_pydict() == got
    for s in spilled:
        s.release()
    js.release()
    assert not list(tmp_path.glob("*.npz"))


def test_fair_spill_pool_shares_match_the_reference():
    """The same sequence of grows and shrinks on both packages' pools: the
    same shares, headrooms and refusals."""
    def trace(M):
        pool = M.FairSpillPool(1000)
        out = []
        pool.register("sortA", True)
        pool.register("sortB", True)
        pool.try_grow("pins", 200)  # unspillable
        out += [pool._fair_share(), pool.headroom_for("sortA"), pool.headroom()]
        pool.try_grow("sortA", 400)
        try:
            pool.try_grow("sortA", 1)  # over its share: sortB's is protected
            out.append("grew")
        except Exception as e:  # noqa: BLE001 -- the class is compared
            out.append(type(e).__name__)
        pool.try_grow("sortB", 400)
        pool.shrink("sortA", 400)
        out += [pool.headroom_for("sortA"), pool.headroom_for("pins")]
        pool.shrink("pins", 200)
        out += [pool._fair_share(), pool.reserved, pool.peak]
        with M.MemoryReservation(pool, "res") as r:
            r.grow(100)
            r.resize(50)
            out.append(pool.by_consumer["res"])
        out.append(pool.by_consumer["res"])
        return out

    assert trace(PM) == trace(JM)
    assert trace(PM)[3] == "ResourceExhausted"


def test_greedy_pool_headroom():
    pool = PM.GreedyMemoryPool(100)
    assert pool.bounded and pool.headroom() == 100
    pool.try_grow("a", 60)
    assert pool.headroom_for("a") == 40
    with pytest.raises(ResourceExhausted, match="top consumers: a=0MB"):
        pool.try_grow("b", 41)
    assert not PM.MemoryPool().bounded


# ---------------------------------------------------------------------------
# the JAX package's out-of-core queries, port chunked against JAX chunked
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    n = 6000
    return {
        "k": rng.integers(0, 80, n).tolist(),
        "s": rng.choice(["aa", "bb", "cc", None], n).tolist(),
        "v": np.round(rng.normal(10, 3, n), 3).tolist(),
        "d": np.round(rng.uniform(0, 100, n), 2).tolist(),
    }


@pytest.fixture(scope="module")
def dim():
    return {"k": list(range(0, 80, 3)), "name": [f"n{i:02d}" for i in range(0, 80, 3)]}


QUERIES = [
    # pipeline + grouped aggregation (sorted path: int keys)
    "SELECT k, count(*) c, sum(v) sv, min(v), max(v), avg(d) FROM t GROUP BY k ORDER BY k",
    # dense path (dictionary string keys), NULL group
    "SELECT s, count(*) c, sum(v) sv FROM t GROUP BY s ORDER BY s",
    # global aggregation
    "SELECT count(*), sum(v), avg(d), min(k), max(k) FROM t WHERE v > 10",
    # global over empty input
    "SELECT count(*), sum(v) FROM t WHERE v > 1e9",
    # top-k streaming
    "SELECT k, v FROM t ORDER BY v DESC, k LIMIT 17",
    # external sort (top-level full ORDER BY)
    "SELECT s, v FROM t WHERE k < 9 ORDER BY s NULLS FIRST, v DESC",
    # limit + offset streaming
    "SELECT k, v FROM t ORDER BY v, k LIMIT 10 OFFSET 4",
    # joins: build side materialized, probe streamed
    "SELECT dm.name, sum(t.v) sv FROM t JOIN dm ON t.k = dm.k GROUP BY dm.name ORDER BY dm.name",
    "SELECT t.k, t.v, dm.name FROM t LEFT JOIN dm ON t.k = dm.k WHERE t.k BETWEEN 5 AND 12",
    "SELECT k FROM t WHERE k IN (SELECT k FROM dm) AND v < 8",
    "SELECT k FROM t WHERE k NOT IN (SELECT k FROM dm) AND v < 6",
    # DISTINCT (host-merged at top level)
    "SELECT DISTINCT k, s FROM t",
    # DISTINCT aggregates + order statistics (materialized fallback)
    "SELECT count(DISTINCT k) cd, median(v) md FROM t",
    "SELECT s, count(DISTINCT k) cd FROM t GROUP BY s ORDER BY s",
    # window (materialized fallback)
    "SELECT k, v, sum(v) OVER (PARTITION BY k ORDER BY v) rs FROM t WHERE k < 4",
    # union all of streams
    "SELECT k FROM t WHERE k < 5 UNION ALL SELECT k FROM dm",
]


def _chunked_pair(data, dim, chunk_rows=512, **extra):
    cfg = {"execution.out_of_core": "on", "execution.chunk_rows": chunk_rows, **extra}
    port, ref = PortSession(device="cpu", config=cfg), JaxSession(config=cfg)
    for c in (port, ref):
        c.register_table("t", data)
        c.register_table("dm", dim)
    return port, ref


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_chunked_matches_the_reference_chunked(data, dim, qi):
    q = QUERIES[qi]
    port, ref = _chunked_pair(data, dim)
    df = port.sql(q)
    got = df.to_pandas()
    assert df._cq is not None and df._cq.chunks >= 12  # 6000 rows, 512 a chunk
    ordered = "ORDER BY" in q and "GROUP BY" not in q.split("ORDER BY")[-1]
    _same(got, ref.sql(q).to_pandas(), ordered)


def test_memory_limited_aggregation_streams_under_auto():
    """A grouped aggregation whose scan passes the budget streams under
    `auto` (partial states merge under pressure) and equals the JAX
    package's answer; with `off` the same session raises ResourceExhausted,
    as the JAX package does."""
    rng = np.random.default_rng(3)
    n = 200_000
    big = {"g": rng.integers(0, 500, n).tolist(), "x": rng.normal(0, 1, n).tolist()}
    sql = "SELECT g, count(*) c, sum(x) s FROM b GROUP BY g ORDER BY g"
    cfg = {"execution.out_of_core": "auto", "execution.memory_limit_bytes": 1 << 20,
           "execution.chunk_rows": 16384}
    port, ref = PortSession(device="cpu", config=cfg), JaxSession(config=cfg)
    for c in (port, ref):
        c.register_table("b", big)
    df = port.sql(sql)
    _same(df.to_pandas(), ref.sql(sql).to_pandas(), True)
    assert df._cq is not None and df._cq.chunks == 13
    port.sql("SET execution.out_of_core = off")
    with pytest.raises(ResourceExhausted):  # the filter's output passes 1 MiB
        port.sql("SELECT g, x FROM b WHERE x > -10").collect()


def test_fair_spill_pool_query_end_to_end():
    rng = np.random.default_rng(5)
    n = 100_000
    big = {"g": rng.integers(0, 200, n).tolist(), "x": rng.normal(0, 1, n).tolist()}
    sql = "SELECT g, count(*) c, sum(x) s FROM b GROUP BY g ORDER BY g"
    port = PortSession(device="cpu", config={
        "execution.out_of_core": "auto", "execution.memory_limit_bytes": 1 << 20,
        "execution.memory_pool": "fair_spill", "execution.chunk_rows": 16384})
    ref = JaxSession(config={"execution.out_of_core": "off"})
    for c in (port, ref):
        c.register_table("b", big)
    assert isinstance(port.exec_context().memory_pool, PM.FairSpillPool)
    _same(port.sql(sql).to_pandas(), ref.sql(sql).to_pandas(), True)


def _spill_session(pkg, sql):
    rng = np.random.default_rng(4)
    n = 120_000
    big = {"a": rng.permutation(n).tolist(), "b": rng.integers(0, 5, n).tolist()}
    cfg = {"execution.out_of_core": "on", "execution.memory_limit_bytes": 600_000,
           "execution.chunk_rows": 8192}
    ctx = (PortSession(device="cpu", config=cfg) if pkg == "port"
           else JaxSession(config=cfg))
    ctx.register_table("t", big)
    df = ctx.sql(sql)
    ec = ctx.exec_context()
    return df._chunked_query(ec).collect(ec), ec


@pytest.mark.parametrize("sql", ["SELECT a, b FROM t ORDER BY a DESC",
                                 "SELECT DISTINCT a, b FROM t"])
def test_memory_limited_sort_and_distinct_spill(sql):
    """ORDER BY and DISTINCT over more than the budget: chunks leave the
    card for the host tier and the answer equals the JAX package's."""
    ours, ec = _spill_session("port", sql)
    ref, _ = _spill_session("jax", sql)
    assert ours.num_rows == 120_000
    assert ec.spill_manager.spill_count > 0, "expected device->host spills"
    assert ours.to_pydict() == ref.to_pydict()


def test_spilled_accumulator_restores_onto_the_session_device(monkeypatch):
    """A SpillableAccumulator short of headroom merges what it holds, then
    spills it to the host; once the headroom is back, fold() restores the
    spilled run onto the session's device and merges every run."""
    from datafusion_tpu_torch.runtime.context import ExecContext

    seen = []
    real = PS.SpilledRelation.restore

    def spy(self, device):
        seen.append(device)
        return real(self, device)

    monkeypatch.setattr(PS.SpilledRelation, "restore", spy)
    ctx = ExecContext({"execution.memory_limit_bytes": 100_000}, device="cpu")
    pool = ctx.memory_pool
    pool.try_grow("pins", 60_000)  # another consumer holds most of the budget
    schema = Table.from_pydict({"v": [1]}).schema
    rels = [PD.to_device(Table.from_pydict({"v": list(range(i * 2048, (i + 1) * 2048))}),
                         device="cpu") for i in range(3)]
    acc = PC.SpillableAccumulator(ctx, "test",
                                  merge_fn=lambda rs: PC._concat(rs, schema))
    for r in rels:
        acc.add(r)
    assert acc.spill_count == 1 and ctx.spill_manager.spill_count == 1
    pool.shrink("pins", 60_000)
    out = acc.fold()
    assert seen == [torch.device("cpu")]
    got = sorted(PD.to_host(out).to_pydict()["v"])
    assert got == list(range(3 * 2048))
    assert pool.reserved == PM.relation_bytes(out)
    acc.release()
    assert pool.reserved == 0


def test_grace_join_build_exceeds_budget(monkeypatch):
    """A join whose build side does not fit the budget degrades to a grace
    hash join in both packages (spied), with the same answer."""
    from datafusion_tpu.physical.chunked import ChunkedQuery as JaxChunked

    rng = np.random.default_rng(8)
    n = 50_000
    pk = rng.integers(0, 20_000, n).tolist()
    pv = rng.normal(size=n).tolist()
    bw = rng.normal(size=20_000).tolist()
    bs = [f"name_{i % 97}" for i in range(20_000)]
    q = ("SELECT b.s, count(*) AS c, sum(p.v*b.w) AS sv FROM probe p "
         "JOIN build b ON p.k = b.k GROUP BY b.s ORDER BY c DESC, s LIMIT 5")
    calls = []
    for cls in (PC.ChunkedQuery, JaxChunked):
        orig = cls._grace_join

        def spy(self, *a, _orig=orig, _cls=cls, **kw):
            calls.append(_cls)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(cls, "_grace_join", spy)
    cfg = {"execution.out_of_core": "on", "execution.chunk_rows": 4096,
           "execution.memory_limit_bytes": 400_000}
    out = []
    for ctx in (PortSession(device="cpu", config=cfg), JaxSession(config=cfg)):
        ctx.register_table("probe", {"k": pk, "v": pv})
        ctx.register_table("build", {"k": list(range(20_000)), "w": bw, "s": bs})
        df = ctx.sql(q)
        out.append(df.to_pandas())
    assert PC.ChunkedQuery in calls and JaxChunked in calls
    assert df is not None
    _same(out[0], out[1], True)
    resident = PortSession(device="cpu")
    resident.register_table("probe", {"k": pk, "v": pv})
    resident.register_table("build", {"k": list(range(20_000)), "w": bw, "s": bs})
    _same(out[0], resident.sql(q).to_pandas(), True)


def test_grace_join_exact_when_every_key_collides(monkeypatch):
    """With hash64 giving every row the same hash, every row of both sides
    lands in one grace partition; that bucket's join still matches keys by
    value, so the answer equals the resident one."""
    rng = np.random.default_rng(9)
    n, m = 30_000, 20_000
    probe = {"k": rng.integers(0, m, n).tolist(), "v": rng.normal(size=n).tolist()}
    build = {"k": list(range(m)), "w": rng.normal(size=m).tolist(),
             "s": [f"name_{i % 31}" for i in range(m)]}
    q = ("SELECT b.s, count(*) AS c, sum(p.v*b.w) AS sv FROM probe p "
         "JOIN build b ON p.k = b.k GROUP BY b.s ORDER BY s")
    monkeypatch.setattr(PK, "hash64", lambda cols, seed=0: torch.zeros(
        cols[0].shape[0], dtype=torch.int64, device=cols[0].device))
    buckets = []
    real = PC.ChunkedQuery._partition_to_host

    def spy(self, *a, **kw):
        parts = real(self, *a, **kw)
        buckets.append([i for i, p in enumerate(parts) if p])
        return parts

    monkeypatch.setattr(PC.ChunkedQuery, "_partition_to_host", spy)
    out = []
    for cfg in ({"execution.out_of_core": "on", "execution.chunk_rows": 4096,
                 "execution.memory_limit_bytes": 400_000}, {}):
        ctx = PortSession(device="cpu", config=cfg)
        ctx.register_table("probe", probe)
        ctx.register_table("build", build)
        out.append(ctx.sql(q).to_pandas())
    assert buckets == [[0], [0]]  # build side, then probe side: one bucket
    _same(out[0], out[1], True)


@pytest.mark.parametrize("sql", [
    "SELECT s, f, count(*) c, sum(v) sv, max(v) mx FROM t GROUP BY s, f",
    "SELECT k, s, count(*) c, min(f) mf FROM t GROUP BY k, s"])
def test_sorted_merge_by_key_partitions(sql):
    """A sorted aggregate merge whose working set would pass the budget
    merges key partition by key partition; NULL keys, 0.0 and -0.0, and
    NaN keys each stay in one partition, so the answer equals the resident
    one."""
    rng = np.random.default_rng(1)
    n = 60_000
    f = rng.choice([0.0, -0.0, np.nan, 1.5, -2.5, np.inf], n)
    data = {"k": rng.integers(0, 15_000, n).tolist(),
            "s": [None if i % 13 == 0 else f"w{x}"
                  for i, x in enumerate(rng.integers(0, 40, n))],
            "f": [None if i % 17 == 0 else float(x) for i, x in enumerate(f)],
            "v": rng.integers(-100, 100, n).tolist()}
    out = []
    for cfg in ({"execution.out_of_core": "on", "execution.chunk_rows": 4096,
                 "execution.memory_limit_bytes": 4_000_000}, {}):
        ctx = PortSession(device="cpu", config=cfg)
        ctx.register_table("t", data)
        df = ctx.sql(sql)
        out.append(df.to_pandas())
        if cfg:
            assert df._cq.agg_splits > 1
    _same(out[0], out[1], False)


def test_sorted_partial_of_a_large_join_output_in_row_slices(monkeypatch):
    """A join's output can pass the scan's chunk; when its sorted partial
    would not fit the budget it runs in row slices, whose partial states
    merge like other runs, and the answer equals the resident one."""
    rng = np.random.default_rng(2)
    keys = rng.choice(np.arange(0, 10 ** 7, 7), 3000, replace=False)
    a = {"k": keys.tolist(), "w": rng.integers(0, 9, 3000).tolist()}
    b = {"k": rng.choice(keys, 60_000).tolist(),
         "x": rng.integers(-5, 5, 60_000).tolist()}
    q = "SELECT a.k, count(b.x) c, sum(b.x) s FROM a LEFT JOIN b ON a.k = b.k GROUP BY a.k"
    starts = []
    real = PC._rows

    def spy(rel, start, stop):
        starts.append(start)
        return real(rel, start, stop)

    monkeypatch.setattr(PC, "_rows", spy)
    out = []
    for cfg in ({"execution.out_of_core": "on", "execution.chunk_rows": 4096,
                 "execution.memory_limit_bytes": 6_000_000}, {}):
        ctx = PortSession(device="cpu", config=cfg)
        ctx.register_table("a", a)
        ctx.register_table("b", b)
        df = ctx.sql(q)
        out.append(df.to_pandas())
        if cfg:
            assert df._cq.agg_splits > 1 and max(starts) > 0
    _same(out[0], out[1], False)


def test_grace_partitions_bucket_by_value_across_dictionaries():
    """Both sides of a grace join bucket string keys by value: two
    dictionaries holding the same words in other positions give the same
    buckets."""
    a = Table.from_pydict({"s": ["x", "y", "z", "w"]}, {"s": T.STRING})
    b = Table.from_pydict({"s": ["z", "w", "q", "y", "x"]}, {"s": T.STRING})
    from datafusion_tpu_torch.expr import nodes as E

    fn = PC.ChunkedQuery._hash_bucket_fn((E.Column("s"),), 8)
    ba = dict(zip(a.to_pydict()["s"], fn(PD.to_device(a, device="cpu")).tolist()))
    bb = dict(zip(b.to_pydict()["s"], fn(PD.to_device(b, device="cpu")).tolist()))
    assert all(ba[w] == bb[w] for w in ba)


def test_chunked_parquet_hive_partitions(tmp_path):
    """Chunked Parquet scans: row-group batches stream from disk on
    dataset-wide dictionaries; hive partition columns and pruning survive
    chunking; the answers equal the JAX package's; nothing is left in the
    provider's uploaded-scan cache."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(6)
    for yr in (2023, 2024):
        sub = tmp_path / f"year={yr}"
        sub.mkdir()
        m = 3000
        pdf = pd.DataFrame({
            "id": np.arange(m) + yr * 10000,
            "cat": rng.choice([f"c{i}" for i in range(20)], m),
            "val": np.round(rng.normal(0, 1, m), 3),
        })
        pq.write_table(pa.Table.from_pandas(pdf), str(sub / "part.parquet"),
                       row_group_size=500)
    cfg = {"execution.out_of_core": "on", "execution.chunk_rows": 700}
    port, ref = PortSession(device="cpu", config=cfg), JaxSession(config=cfg)
    for c in (port, ref):
        c.register_parquet("p", str(tmp_path))
    for q in ("SELECT year, cat, count(*) c, sum(val) s FROM p WHERE val > -0.5 "
              "GROUP BY year, cat ORDER BY year, cat",
              "SELECT count(*) FROM p WHERE year = 2024",
              "SELECT cat, id FROM p WHERE id < 20100 ORDER BY id LIMIT 7"):
        _same(port.sql(q).to_pandas(), ref.sql(q).to_pandas(), True)
    prov = port.catalog.get("p")
    assert not prov._device and prov._chunk_dicts["cat"] is not None


# ---------------------------------------------------------------------------
# the session's route, the kernel per chunk, TPC-H
# ---------------------------------------------------------------------------

SF = 0.005
TPCH_CHUNKED = (1, 3, 4, 5, 6, 10, 12, 13, 18, 19)


@pytest.fixture(scope="module")
def tpch():
    tables = generate_tpch(SF)
    frames = {name: t.to_pandas() for name, t in tables.items()}
    return tables, frames


def _tpch_session(tables, **cfg):
    ctx = PortSession(device="cpu", config=cfg)
    for name, t in tables.items():
        ctx.register_table(name, t)
    return ctx


@pytest.mark.parametrize("qid", TPCH_CHUNKED)
def test_tpch_chunked_matches_resident_and_oracle(tpch, qid):
    tables, frames = tpch
    sql = query(qid, SF)
    chunked = _tpch_session(tables, **{"execution.out_of_core": "on",
                                       "execution.chunk_rows": 1024})
    df = chunked.sql(sql)
    got = df.to_pandas()
    assert df._cq is not None and df._cq.chunks > 1
    want = _tpch_session(tables).sql(sql).to_pandas()
    pd.testing.assert_frame_equal(got, want, check_dtype=False, atol=1e-6)
    oracle = ref_query(qid, frames, SF)
    if qid == 19 and oracle.iloc[0, 0] == 0:
        # at SF 0.005 no row passes Q19's predicate: SQL's SUM over no rows
        # is NULL, pandas' is 0
        assert len(got) == 1 and pd.isna(got.iloc[0, 0])
    else:
        assert frames_diff(got, oracle, ordered=qid in LIMIT_QUERIES) is None
    # the chunked scans went through neither of the tables' device caches
    assert all(not chunked.catalog.get(n)._device for n in tables)


def test_q1_launches_the_kernel_once_per_chunk(tpch, monkeypatch):
    """Chunked Q1's dense aggregate sends every chunk's exact SUM and COUNT
    states through dense_groupby_sums (on a CPU tensor its plain version),
    one call per chunk with Q1's 7 pairs, as the resident plan's one call."""
    tables, _ = tpch
    calls = []
    real = DA.dense_groupby_sums

    def spy(seg, mask, pairs, G):
        calls.append((int(seg.shape[0]), G, len(pairs)))
        return real(seg, mask, pairs, G)

    monkeypatch.setattr(DA, "dense_groupby_sums", spy)
    _tpch_session(tables).sql(query(1, SF)).collect()
    assert [c[1:] for c in calls] == [(6, 7)]
    calls.clear()
    df = _tpch_session(tables, **{"execution.out_of_core": "on",
                                  "execution.chunk_rows": 4096}).sql(query(1, SF))
    df.collect()
    n = tables["lineitem"].num_rows
    assert len(calls) == df._cq.chunks == -(-n // 4096)
    assert all(c == (4096, 6, 7) for c in calls)


def test_auto_routes_by_the_memory_limit(tpch):
    """`auto` streams a query whose scans pass half the limit and leaves a
    small one resident; `off` raises ResourceExhausted over the limit; `on`
    streams without a limit."""
    tables, frames = tpch
    sql = query(1, SF)
    lim = {"execution.memory_limit_bytes": 1 << 20, "execution.chunk_rows": 4096}
    df = _tpch_session(tables, **lim).sql(sql)
    got = df.to_pandas()
    assert df._cq is not None
    assert frames_diff(got, ref_query(1, frames, SF), ordered=True) is None
    small = _tpch_session(tables, **lim).sql("SELECT count(*) FROM region")
    assert small.to_pydict() == {"count(*)": [5]}
    assert getattr(small, "_cq", None) is None
    with pytest.raises(ResourceExhausted, match="top consumers"):
        _tpch_session(tables, **lim, **{"execution.out_of_core": "off"}).sql(sql).collect()
    on = _tpch_session(tables, **{"execution.out_of_core": "on"}).sql(sql)
    on.collect()
    assert on._cq is not None and on._cq.chunks == 1


def test_chunk_scans_share_capacity_dictionaries_and_bounds(tpch):
    tables, _ = tpch
    ctx = _tpch_session(tables)
    prov = ctx.catalog.get("lineitem")
    chunks = list(prov.scan_chunks(ctx.exec_context(),
                                   projection=["l_orderkey", "l_returnflag"],
                                   chunk_rows=5000))
    n = tables["lineitem"].num_rows
    assert len(chunks) == -(-n // 8192)
    assert {c.capacity for c in chunks} == {8192}
    assert len({id(c.columns[1].dictionary) for c in chunks}) == 1
    assert len({c.columns[0].bounds for c in chunks}) == 1
    assert sum(int(c.sel.sum()) for c in chunks) == n
    assert not prov._device  # the resident cache stays empty

"""The port's distributed engine (parallel/distributed.py, parallel/engine.py,
the cross-device half of parallel/aggsplit.py, ops/hll.py) on the CPU, over
meshes of "cpu" shards (8 by default, as the JAX tests' virtual devices).

Against the JAX package on the same numpy inputs from a seed, on the 8
virtual devices tests/conftest.py makes: `hash_mod` and `shard_rows` shard
by shard; `exchange_by_key` under a `shard_map`, slot for slot with its
dropped count, at the default slot count and at one that overflows;
`distributed_query_step`; the HLL registers and estimates; `dist_of` and
the join modes of the 22 TPC-H plans on the capacities discovery records
(Q3 and Q12 discovered by both packages, the capacities compared too); and
the per-shard rows of one grouped aggregate without a final sort. Integers,
decimals and HLL registers compare exactly.

The port's distributed answers against its single-device engine and the
pandas oracle at TPC-H SF 0.01: all 22 queries with the default options and
all 22 with every equi-join partitioned (PARTITIONED_QUERY_IDS are the
reference's own list), FULL OUTER joins, UNION with a window, DISTINCT
aggregates through the row exchange, the skew ladder, NULL group keys, the
HLL estimate's error and its mesh-size invariance, Q1's dense kernel once
per shard, and that make_mesh() raises without a device. Floats compare
through frames_diff."""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.data.device import to_host as jax_to_host
from datafusion_tpu.models.tpch.datagen import generate_tpch as jax_generate
from datafusion_tpu.ops import hll as jax_hll
from datafusion_tpu.ops import kernels as JK
from datafusion_tpu.parallel import distributed as JD
from datafusion_tpu.parallel import engine as JE
from datafusion_tpu.physical import plan as JP
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.data.device import to_host
from datafusion_tpu_torch.models.tpch.compare import LIMIT_QUERIES, frames_diff
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch as port_generate
from datafusion_tpu_torch.models.tpch.queries import query
from datafusion_tpu_torch.models.tpch.queries_ref import ref_query
from datafusion_tpu_torch.ops import dense_agg as DA
from datafusion_tpu_torch.ops import hll
from datafusion_tpu_torch.ops import kernels as K
from datafusion_tpu_torch.parallel import distributed as D
from datafusion_tpu_torch.parallel import engine as EN
from datafusion_tpu_torch.physical import plan as PP

SF = 0.01
N = 8
PARTITIONED_QUERY_IDS = [3, 5, 10, 18, 21]
HLL_ON = {"execution.approx_distinct_hll": True}


@pytest.fixture(scope="module")
def mesh():
    return D.make_mesh(N, devices=["cpu"])


@pytest.fixture(scope="module")
def tpch():
    tables = port_generate(SF)
    ctx = PortSession(device="cpu")
    for name, t in tables.items():
        ctx.register_table(name, t)
    return ctx, {name: t.to_pandas() for name, t in tables.items()}


@pytest.fixture(scope="module")
def jax_opt():
    """The reference's programs compile without XLA's optimizations, which
    would cost more than these small runs save."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


@pytest.fixture(scope="module")
def jax_tpch(jax_opt):
    ctx = JaxSession()
    for name, t in jax_generate(SF).items():
        ctx.register_table(name, t)
    return ctx


def _distributed(ctx, sql, mesh, options=None):
    df = ctx.sql(sql)
    dq = EN.DistributedQuery(df.physical_plan(), mesh, options=options)
    return dq, to_host(dq.execute(ctx.exec_context())).to_pandas()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 7, 8])
def test_hash_mod_equals_the_unsigned_remainder(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(-2 ** 62, 2 ** 62, 4096)
    bits = np.asarray(JK.hash64([jnp.asarray(keys)]))          # uint64
    want = np.asarray(jnp.asarray(bits) % np.uint64(n)).astype(np.int64)
    h = K.hash64([torch.from_numpy(keys)])
    assert np.array_equal(h.numpy().view(np.uint64), bits)
    assert (h < 0).any()
    assert np.array_equal(K.hash_mod(h, n).numpy(), want)


def test_shard_rows_equals_the_reference_shard_by_shard():
    rng = np.random.default_rng(3)
    key = rng.integers(0, 10 ** 9, 3000).astype(np.int64)
    arrays = {"v": rng.integers(-50, 50, 3000).astype(np.int64), "k": key}
    jdev, jsel = JD.shard_rows(arrays, key, JD.make_mesh(N))
    pdev, psel = D.shard_rows(arrays, key, D.make_mesh(N, devices=["cpu"]))
    js = np.asarray(jsel).reshape(N, -1)
    assert [s.numpy().tolist() for s in psel] == js.tolist()
    for name in arrays:
        j = np.asarray(jdev[name]).reshape(N, -1)
        assert [t.numpy().tolist() for t in pdev[name]] == j.tolist()


def _exchange_inputs(seed):
    rng = np.random.default_rng(seed)
    cap = 128
    vals = rng.integers(0, 1000, N * cap).astype(np.int64)
    keys = rng.integers(-(2 ** 62), 2 ** 62, N * cap).astype(np.int64)
    keys[: N * cap // 3] = 7  # a hot key: one destination receives a third
    sel = rng.random(N * cap) < 0.8
    planes = rng.integers(0, 30, (N * cap, 4)).astype(np.int32)  # trailing dims
    return cap, vals, keys, sel, planes


@pytest.mark.parametrize("slot_cap", [None, 64])
def test_exchange_by_key_equals_the_reference_slot_for_slot(jax_opt, slot_cap):
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    cap, vals, keys, sel, planes = _exchange_inputs(11)
    jmesh = JD.make_mesh(N)
    sh = NamedSharding(jmesh, P("dp"))

    def f(v, k, s, pl):
        h = JK.hash64([k])
        (ov, opl), osel, dropped = JD.exchange_by_key([v, pl], h, s,
                                                      slot_cap=slot_cap)
        return ov, opl, osel, dropped[None]

    g = shard_map(f, mesh=jmesh, in_specs=(P("dp"),) * 4, out_specs=(P("dp"),) * 4)
    jv, jpl, jsel, jdrop = [np.asarray(a) for a in jax.jit(g)(
        *[jax.device_put(a, sh) for a in (vals, keys, sel, planes)])]

    pmesh = D.make_mesh(N, devices=["cpu"])

    def split(a):
        return [torch.from_numpy(np.ascontiguousarray(x)) for x in np.split(a, N)]

    hs = [K.hash64([k]) for k in split(keys)]
    (pv, ppl), psel, pdrop = D.exchange_by_key(
        [split(vals), split(planes)], hs, split(sel), pmesh, slot_cap=slot_cap)
    assert [int(d) for d in pdrop] == jdrop.tolist()
    if slot_cap is not None:
        assert jdrop.sum() > 0  # the hot key overflows its 64 slots
    for i in range(N):
        s = psel[i].numpy()
        assert s.tolist() == np.split(jsel, N)[i].tolist()
        # live slots hold the same rows; the others are zeros in both
        assert pv[i].numpy().tolist() == np.split(jv, N)[i].tolist()
        assert ppl[i].numpy().tolist() == np.split(jpl, N)[i].tolist()


def test_distributed_query_step_equals_the_reference(jax_opt):
    from jax.sharding import NamedSharding, PartitionSpec as P

    cap = 128
    rng = np.random.default_rng(1)
    total = N * cap
    qty = rng.integers(100, 5100, total).astype(np.int64)
    price = rng.integers(90_000, 200_000, total).astype(np.int64)
    disc = rng.integers(0, 1100, total).astype(np.int64)
    gkey = rng.integers(0, 8, total).astype(np.int64)
    jkey = rng.integers(0, 80, total).astype(np.int64)  # some miss the dim
    sel = rng.random(total) < 0.9
    dim_key = rng.permutation(64 * N)[: 8 * N].astype(np.int64)
    dim_factor = rng.integers(1, 5, 8 * N).astype(np.int64)
    args = (qty, price, disc, gkey, jkey, sel, dim_key, dim_factor)

    jmesh = JD.make_mesh(N)
    sh = NamedSharding(jmesh, P("dp"))
    jout = jax.jit(JD.distributed_query_step(jmesh))(
        *[jax.device_put(a, sh) for a in args])
    jsum, jcnt, jrows, jdrop = [np.asarray(a) for a in jout]

    pmesh = D.make_mesh(N, devices=["cpu"])
    split = [[torch.from_numpy(np.ascontiguousarray(x)) for x in np.split(a, N)]
             for a in args]
    psum, pcnt, prows, pdrop = D.distributed_query_step(pmesh)(*split)
    assert [t.numpy().tolist() for t in psum] == jsum.reshape(N, -1).tolist()
    assert [t.numpy().tolist() for t in pcnt] == jcnt.reshape(N, -1).tolist()
    assert all(int(r) == int(jrows) for r in prows)
    assert [int(d) for d in pdrop] == jdrop.tolist()
    assert jsum.sum() > 0


@pytest.mark.parametrize("ndv", [100, 5_000, 200_000])
def test_hll_registers_and_estimate_equal_the_reference(ndv):
    rng = np.random.default_rng(ndv)
    vals = rng.integers(-(2 ** 40), 2 ** 40, ndv + ndv // 3)
    seg = rng.integers(0, 3, vals.size).astype(np.int32)
    mask = rng.random(vals.size) < 0.9
    jregs = jax_hll.build_registers(JK.hash64([jnp.asarray(vals)]), jnp.asarray(seg),
                                    jnp.asarray(mask), 3)
    h = K.hash64([torch.from_numpy(vals)])
    pregs = hll.build_registers(h, torch.from_numpy(seg), torch.from_numpy(mask), 3)
    assert np.array_equal(pregs.numpy(), np.asarray(jregs))
    assert np.array_equal(hll.estimate(pregs).numpy(),
                          np.asarray(jax_hll.estimate(jregs)))
    # the union of two halves' sketches is the whole's sketch
    half = torch.from_numpy(np.arange(vals.size) % 2 == 0)
    m = torch.from_numpy(mask)
    parts = [hll.build_registers(h, torch.from_numpy(seg), m & side, 3)
             for side in (half, ~half)]
    assert torch.equal(hll.merge_registers(*parts), pregs)
    # a uniform set of ndv values: the estimate within 5%
    one = hll.build_registers(K.hash64([torch.arange(ndv)]),
                              torch.zeros(ndv, dtype=torch.int32),
                              torch.ones(ndv, dtype=torch.bool), 1)
    assert abs(int(hll.estimate(one)[0]) - ndv) / ndv < 0.05


def _preorder(plan):
    out, stack = [], [plan]
    while stack:
        p = stack.pop()
        out.append(p)
        stack.extend(reversed(p.children()))
    return out


def _dists(plan, dist_of, options):
    memo = {}
    dist_of(plan, memo, options)
    return [(type(p).__name__, memo.get(id(p))) for p in _preorder(plan)]


@pytest.fixture(scope="module")
def discovered(tpch, jax_tpch):
    """The 22 TPC-H plans of both packages, the port's discovered: the join
    input capacities its discovery records, planted in the reference's plan
    of the same query (the same operators in pre-order)."""
    ctx, _ = tpch
    out = {}
    for qid in range(1, 23):
        pplan = ctx.sql(query(qid, SF)).physical_plan()
        pplan.execute(ctx.exec_context())
        jplan = jax_tpch.sql(query(qid, SF)).physical_plan()
        pnodes, jnodes = _preorder(pplan), _preorder(jplan)
        assert [type(p).__name__ for p in pnodes] == \
            [type(p).__name__ for p in jnodes], qid
        for p, j in zip(pnodes, jnodes):
            if isinstance(p, PP.JoinExec):
                j._last_input_caps = p._last_input_caps
        out[qid] = (pplan, jplan)
    return out


@pytest.mark.parametrize("options", [{}, {"broadcast_cap": 512},
                                     {"join_mode": "partitioned"}])
def test_dist_of_22_plans_equals_the_reference(discovered, options):
    """Both packages' dist_of give every node of each plan the same
    distribution, and every join the same mode."""
    for qid, (pplan, jplan) in discovered.items():
        assert _dists(pplan, EN.dist_of, options) == \
            _dists(jplan, JE.dist_of, options), qid
        pmodes = [EN._join_mode(p, options) for p in _preorder(pplan)
                  if isinstance(p, PP.JoinExec)]
        jmodes = [JE._join_mode(j, options) for j in _preorder(jplan)
                  if isinstance(j, JP.JoinExec)]
        assert pmodes == jmodes, qid
        if options.get("broadcast_cap") and qid in PARTITIONED_QUERY_IDS:
            assert "partitioned" in pmodes, qid


def test_discovered_join_capacities_equal_the_reference(tpch, jax_tpch):
    """Q3 discovered by both packages: the same join input capacities."""
    ctx, _ = tpch
    pplan = ctx.sql(query(3, SF)).physical_plan()
    pplan.execute(ctx.exec_context())
    jplan = jax_tpch.sql(query(3, SF)).physical_plan()
    jplan.execute(jax_tpch.exec_context())
    pcaps = [p._last_input_caps for p in _preorder(pplan) if isinstance(p, PP.JoinExec)]
    jcaps = [j._last_input_caps for j in _preorder(jplan) if isinstance(j, JP.JoinExec)]
    assert pcaps == jcaps and len(pcaps) == 3


def test_grouped_aggregate_shards_equal_the_reference(tpch, jax_tpch, mesh):
    """One grouped aggregate without a final sort: the sorted Partial/Final
    split sends each group to the shard its key hashes to, in both
    packages; each shard's live rows are the same, in the same order."""
    sql = ("SELECT l_orderkey, count(*) c, sum(l_quantity) q FROM lineitem "
           "WHERE l_shipmode = 'MAIL' GROUP BY l_orderkey")
    ctx, _ = tpch
    dq, _ = _distributed(ctx, sql, mesh)
    assert dq.out_dist == "part"
    jdq = JE.DistributedQuery(jax_tpch.sql(sql).physical_plan(), JD.make_mesh(N))
    jrel = jdq.execute(jax_tpch.exec_context())
    jcap = jrel.capacity // N
    for i, rel in enumerate(dq.shards):
        got = to_host(rel).to_pandas()
        want = jax_to_host(jax.tree.map(lambda a: a[i * jcap:(i + 1) * jcap], jrel))
        assert rel.capacity == jcap
        assert got.to_dict("list") == want.to_pandas().to_dict("list"), i
        assert len(got) > 0


# ---------------------------------------------------------------------------
# the port's distributed engine against its single-device engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def answers(tpch):
    """{qid: (the single-device answer, the oracle's)}, made on first use."""
    ctx, frames = tpch
    cache = {}

    def get(qid):
        if qid not in cache:
            cache[qid] = (ctx.sql(query(qid, SF)).to_pandas(),
                          ref_query(qid, frames, SF))
        return cache[qid]

    return get


@pytest.mark.parametrize("mode", ["default", "partitioned"])
@pytest.mark.parametrize("qid", range(1, 23))
def test_tpch_distributed_matches_single_device_and_oracle(tpch, answers, mesh,
                                                            qid, mode):
    ctx, _ = tpch
    options = {"join_mode": "partitioned"} if mode == "partitioned" else {}
    ref, oracle = answers(qid)
    dq, ours = _distributed(ctx, query(qid, SF), mesh, options)
    ordered = qid in LIMIT_QUERIES
    assert frames_diff(ours, ref, ordered=ordered) is None
    assert frames_diff(ours, oracle, ordered=ordered) is None
    if mode == "partitioned" and qid in PARTITIONED_QUERY_IDS:
        assert set(dq.join_modes()) == {"partitioned"}
        assert dq.trace_stats["exchanges"] > 0


def test_q1_launches_the_dense_kernel_once_per_shard(tpch, mesh, monkeypatch):
    ctx, _ = tpch
    calls = []
    orig = DA.dense_groupby_sums

    def counting(seg, mask, pairs, G):
        calls.append((seg.shape[0], G))
        return orig(seg, mask, pairs, G)

    df = ctx.sql(query(1, SF))
    dq = EN.DistributedQuery(df.physical_plan(), mesh)
    dq.execute(ctx.exec_context())  # discovery (one single-device call) + walk
    monkeypatch.setattr(DA, "dense_groupby_sums", counting)
    calls.clear()
    rel = dq.execute(ctx.exec_context())
    assert len(calls) == N
    assert len(set(calls)) == 1  # one shape: each shard's slice of lineitem
    assert frames_diff(to_host(rel).to_pandas(), df.to_pandas(), ordered=True) is None


def test_tpch_topk_gathers_only_n_fetch_rows(tpch, mesh):
    ctx, _ = tpch
    dq, ours = _distributed(ctx, query(18, SF), mesh, {"join_mode": "partitioned"})
    assert frames_diff(ours, ctx.sql(query(18, SF)).to_pandas(), ordered=True) is None
    # lineitem's capacity is 65536 here, 8192 a shard: nothing the
    # collectives make approaches the replicated whole
    assert dq.trace_stats["max_capacity"] <= 4 * 8192


def test_partitioned_join_chosen_on_a_large_build_side(tpch, mesh):
    ctx, _ = tpch
    dq, ours = _distributed(ctx, query(3, SF), mesh, {"broadcast_cap": 512})
    assert frames_diff(ours, ctx.sql(query(3, SF)).to_pandas(), ordered=True) is None
    assert "partitioned" in dq.join_modes()


@pytest.mark.parametrize("mode", ["default", "partitioned"])
def test_full_outer_joins(mesh, mode):
    ctx = PortSession(device="cpu")
    n = 200
    ctx.register_table("a", {"k": [i % 60 for i in range(n)],
                             "x": [float(i) for i in range(n)]})
    ctx.register_table("b", {"k": [i % 90 + 30 for i in range(n)],
                             "y": [float(i * 2) for i in range(n)]})
    ctx.register_table("c", {"k": [1, 2, None], "z": [1.0, 2.0, 3.0]})
    options = {"join_mode": "partitioned"} if mode == "partitioned" else {}
    for sql in ("SELECT a.k, b.k, x, y FROM a FULL JOIN b ON a.k = b.k",
                "SELECT a.k, c.k, x, z FROM a FULL OUTER JOIN c ON a.k = c.k"):
        _, ours = _distributed(ctx, sql, mesh, options)
        assert frames_diff(ours, ctx.sql(sql).to_pandas(), ordered=False) is None


def test_union_with_a_window(mesh):
    ctx = PortSession(device="cpu")
    ctx.register_table("t", {"g": [i % 5 for i in range(300)],
                             "v": [float(i * 7 % 31) for i in range(300)]})
    sql = ("SELECT g, v, sum(v) OVER (PARTITION BY g ORDER BY v) rs FROM t "
           "UNION ALL SELECT g, v, v FROM t")
    dq, ours = _distributed(ctx, sql, mesh)
    assert dq.out_dist == "part" and dq.trace_stats["exchanges"] == 1
    assert frames_diff(ours, ctx.sql(sql).to_pandas(), ordered=False) is None


def test_partial_final_split_is_used(mesh, monkeypatch):
    """Decomposable aggregates go through the Partial/Final state split,
    never the row exchange: sorted (integer keys) and dense (a dictionary
    key, psum-merged, owned round-robin)."""
    def boom(*a, **k):
        raise AssertionError("row exchange used for decomposable aggregates")

    monkeypatch.setattr(EN, "_exchange_by_group", boom)
    ctx = PortSession(device="cpu")
    n = 64
    ctx.register_table("t", {"k": [i % 7 for i in range(n)],
                             "g": ["ab"[i % 2] for i in range(n)],
                             "x": [float(i) for i in range(n)],
                             "y": [float(i * i % 11) for i in range(n)],
                             "b": [i % 3 == 0 for i in range(n)]})
    for sql in ("SELECT k, count(*) c, sum(x) sx, avg(x) ax, min(x) mn, max(x) mx, "
                "var_samp(x) v, stddev(x) sd, corr(x, y) r, bool_or(b) bo "
                "FROM t GROUP BY k",
                "SELECT g, sum(x) s, count(*) c, avg(y) a, min(y) m, bool_and(b) ba "
                "FROM t GROUP BY g"):
        _, ours = _distributed(ctx, sql, mesh)
        assert frames_diff(ours, ctx.sql(sql).to_pandas(), ordered=False) is None


def test_count_distinct_through_the_row_exchange(mesh):
    ctx = PortSession(device="cpu")
    ctx.register_table("t", {"k": [i % 5 for i in range(400)],
                             "v": [i % 3 for i in range(400)]})
    sql = "SELECT k, count(DISTINCT v) cd, median(v) m FROM t GROUP BY k"
    dq, ours = _distributed(ctx, sql, mesh)
    assert dq.trace_stats["exchanges"] == 1
    assert frames_diff(ours, ctx.sql(sql).to_pandas(), ordered=False) is None


def test_exchange_skew_ladder(mesh):
    """A third of the rows share one group key: the even-split exchange
    slots (factor 2) overflow, the walk doubles the factor and runs again,
    and the answer is exact without the n-fold worst-case buffers."""
    ctx = PortSession(device="cpu")
    n = 4096
    ctx.register_table("t", {"k": [0 if i % 9 < 3 else i % 97 for i in range(n)],
                             "v": [i % 23 for i in range(n)]})
    sql = "SELECT k, count(DISTINCT v) c, median(v) m FROM t GROUP BY k"
    dq, ours = _distributed(ctx, sql, mesh)
    assert frames_diff(ours, ctx.sql(sql).to_pandas(), ordered=False) is None
    assert 2 < dq.slot_factor < N


def test_exchange_overflow_at_the_bound_raises():
    """A factor of n is overflow-proof: with two shards every exchange
    starts there, so skew cannot raise; the ladder's bound raises only when
    the walk's flag fires at it (a forced flag here)."""
    from datafusion_tpu_torch.common.errors import ExecutionError

    ctx = PortSession(device="cpu")
    ctx.register_table("t", {"k": [0] * 1000, "v": list(range(1000))})
    sql = "SELECT k, count(DISTINCT v) c FROM t GROUP BY k"
    dq = EN.DistributedQuery(ctx.sql(sql).physical_plan(),
                             D.make_mesh(4, devices=["cpu"]), options={"slot_factor": 4})
    assert to_host(dq.execute(ctx.exec_context())).to_pydict()["c"] == [1000]
    walk = dq._walk
    dq._walk = lambda inputs: walk(inputs)[:2] + (torch.tensor(True),)
    with pytest.raises(ExecutionError, match="overflow-proof"):
        dq.execute(ctx.exec_context())


def test_null_group_keys_land_together(mesh):
    ctx = PortSession(device="cpu")
    ctx.register_table("t", {"k": [None if i % 3 == 0 else i % 5 for i in range(160)],
                             "v": [i % 7 for i in range(160)]})
    for sql in ("SELECT k, count(DISTINCT v) c FROM t GROUP BY k",
                "SELECT k, sum(v) s, count(*) c FROM t GROUP BY k"):
        _, ours = _distributed(ctx, sql, mesh)
        assert ours["k"].isna().sum() == 1
        assert frames_diff(ours, ctx.sql(sql).to_pandas(), ordered=False) is None


@pytest.fixture(scope="module")
def hll_data():
    rng = np.random.default_rng(7)
    n = 100_000
    g = rng.integers(0, 8, n)
    v = rng.integers(0, 1_000_000, n)
    ctx = PortSession(device="cpu")
    ctx.register_table("t", {"g": g.tolist(), "v": v.tolist()})
    truth = pd.DataFrame({"g": g, "v": v}).groupby("g")["v"].nunique() \
        .sort_index().to_numpy()
    return ctx, truth


def _hll_run(ctx, mesh, options=None, sql=None):
    sql = sql or ("SELECT g, approx_distinct(v) ad, count(*) c FROM t "
                  "GROUP BY g ORDER BY g")
    _, out = _distributed(ctx, sql, mesh, options)
    return out.sort_values(out.columns[0])


def test_hll_estimates_within_error_and_mesh_size_invariant(hll_data):
    ctx, truth = hll_data
    runs = {n: _hll_run(ctx, D.make_mesh(n, devices=["cpu"]), HLL_ON)
            for n in (1, 2, 8)}
    est = runs[8]["ad"].to_numpy()
    assert (np.abs(est - truth) / truth).max() < 0.05
    assert (est != truth).any()  # the sketch really ran
    for n in (1, 2):
        assert (runs[n]["ad"].to_numpy() == est).all(), n
    assert runs[8]["c"].sum() == 100_000


def test_hll_on_the_sorted_split(hll_data, mesh):
    """Group keys without a small domain take the sorted split: the register
    planes ride the exchange and the final sort as 2-D payload rows."""
    ctx, truth = hll_data
    sql = ("SELECT g * 1000003 gg, approx_distinct(v) ad FROM t "
           "GROUP BY g * 1000003 ORDER BY gg")
    a = _hll_run(ctx, mesh, HLL_ON, sql)["ad"].to_numpy()
    b = _hll_run(ctx, D.make_mesh(2, devices=["cpu"]), HLL_ON, sql)["ad"].to_numpy()
    assert (a == b).all()
    assert (np.abs(a - truth) / truth).max() < 0.05


def test_approx_distinct_stays_exact_without_the_option(hll_data, mesh):
    ctx, truth = hll_data
    assert (_hll_run(ctx, mesh)["ad"].to_numpy() == truth).all()


def test_replicated_relations_are_held_once_per_device(tpch, mesh):
    """Eight shards on one device share one gathered build side and one
    replicated result."""
    ctx, _ = tpch
    dq, _ = _distributed(ctx, query(3, SF), mesh)
    assert dq.out_dist == "repl"
    assert all(r is dq.shards[0] for r in dq.shards)


def test_make_mesh_without_a_device_raises(monkeypatch):
    from datafusion_tpu_torch.common.errors import ExecutionError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ExecutionError, match="no CUDA device"):
        D.make_mesh()
    with pytest.raises(ExecutionError, match="no CUDA device"):
        EN.DistributedQuery(EN.PP.EmptyExec(None))
    m = D.make_mesh(8, devices=["cpu"])
    assert m.shape == {"dp": 8} and {str(d) for d in m.shard_devices} == {"cpu"}


def test_dryrun_multichip_on_cpu_shards():
    EN.dryrun_multichip(N, devices=["cpu"])

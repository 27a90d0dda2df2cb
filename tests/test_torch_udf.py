"""User-defined functions in the port (expr/udf.py evaluation, the UDAF
branch of ops/groupby.py, the UDWF branch of physical/window.py, the
host-function steady state of physical/fused.py, register_udf/udaf/udwf/
async_udf/udtf/plugin, interrupt()) against the JAX package on the CPU, on
the same inputs.

Every user function is written twice: with torch for the port
(datafusion_tpu_torch/testing/udf_cases.py, which chip_smoke.py runs on
the card too) and with jax.numpy here for the JAX package. Integers,
dates, decimals and strings are compared exactly, elementwise floats to
rtol 1e-12, and the monoid scans (UDAFs, UDWFs: a Hillis-Steele scan in the
port, XLA's associative_scan in the JAX package, which add in other
orders) to rtol 1e-9. On the card, tests/test_torch_fused.py captures each
family under torch.cuda.set_sync_debug_mode("error")."""
import asyncio
import math
import os
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.common import types as JT
from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.common.errors import PlanError, QueryCancelled
from datafusion_tpu_torch.expr import nodes as E
from datafusion_tpu_torch.expr import udf as U
from datafusion_tpu_torch.physical import fused as FQ
from datafusion_tpu_torch.testing import udf_cases as UC

ELEMENTWISE = 1e-12
SCAN = 1e-9
# cases whose floats come out of a monoid scan or a sum
SCANNED = {"scalar_two_args", "in_where", "udaf_grouped", "udaf_global",
           "udaf_empty_group", "udaf_tuple_state", "udaf_with_builtins",
           "udaf_global_filtered", "udaf_string_key", "udaf_window",
           "udaf_window_whole_partition", "udwf", "udwf_peers", "udwf_no_partition",
           "async_plain"}


@pytest.fixture(scope="module", autouse=True)
def fast_reference():
    """The reference compiled with its optimizations off, for this module."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


def register_jax(ctx) -> None:
    """The jax.numpy half of every user function of udf_cases.register."""
    ctx.register_udf("plus_one", lambda a: a + 1.0, JT.FLOAT64)
    ctx.register_udf("hyp", lambda a, b: jnp.sqrt(a * a + b * b), JT.FLOAT64)
    ctx.register_udf("safe_log", lambda a: (jnp.log(jnp.maximum(a, 1e-300)), a > 0),
                     JT.FLOAT64)
    ctx.register_udf("dbl", lambda a: a * 2.0, JT.FLOAT64)
    ctx.register_udf("sq", lambda a: a * a, JT.FLOAT64)
    ctx.register_udf("is_big", lambda a: a > 500, JT.BOOL)
    ctx.register_udf("next_week", lambda d: d + 7, JT.DATE32)
    ctx.register_udf("half", lambda a: a / 2.0, JT.decimal(12, 3))
    ctx.register_udf("keep_row", lambda q: q > 0, JT.BOOL)
    ctx.register_udf("scaled", lambda a: a / float(jnp.abs(a).max()), JT.FLOAT64)
    ctx.register_udaf(
        "geomean",
        state=lambda x: {"logsum": jnp.log(jnp.maximum(jnp.abs(x.astype(jnp.float64)),
                                                       1e-300)),
                         "n": jnp.ones_like(x, dtype=jnp.float64)},
        combine=lambda a, b: {"logsum": a["logsum"] + b["logsum"], "n": a["n"] + b["n"]},
        identity={"logsum": 0.0, "n": 0.0},
        finalize=lambda s: jnp.exp(s["logsum"] / jnp.maximum(s["n"], 1.0)),
        return_type=JT.FLOAT64)
    ctx.register_udaf(
        "bit_or_agg", state=lambda x: x.astype(jnp.int64), combine=lambda a, b: a | b,
        identity=0, finalize=lambda s: s, return_type=JT.INT64, nullable=False)
    ctx.register_udaf(
        "spread", state=lambda x: (x.astype(jnp.float64), x.astype(jnp.float64)),
        combine=lambda a, b: (jnp.minimum(a[0], b[0]), jnp.maximum(a[1], b[1])),
        identity=(float("inf"), float("-inf")), finalize=lambda s: s[1] - s[0],
        return_type=JT.FLOAT64)
    ctx.register_udwf(
        "run_prod", state=lambda x: x.astype(jnp.float64), combine=lambda a, b: a * b,
        identity=1.0, finalize=lambda s: s, return_type=JT.FLOAT64)
    ctx.register_udwf(
        "run_sum", state=lambda x: x.astype(jnp.float64), combine=lambda a, b: a + b,
        identity=0.0, finalize=lambda s: s, return_type=JT.FLOAT64)
    ctx.register_async_udf("remote_score", UC.remote_score, JT.FLOAT64)
    ctx.register_async_udf("twice", lambda xs: xs * 2, JT.FLOAT64)
    ctx.register_udtf("fib", lambda n: {"f": [1, 1, 2, 3, 5, 8, 13][:int(n)]})


def _sessions():
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    for name, cols in UC.tables().items():
        jctx.register_table(name, cols)
        pctx.register_table(name, cols)
    register_jax(jctx)
    UC.register(pctx)
    return jctx, pctx


@pytest.fixture(scope="module")
def sessions():
    return _sessions()


def _same(a, b, rtol) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=rtol, abs_tol=rtol)
    return a == b


def _same_dict(got: dict, want: dict, rtol: float) -> bool:
    return list(got) == list(want) and all(
        len(got[k]) == len(want[k]) and all(_same(x, y, rtol) for x, y in zip(got[k], want[k]))
        for k in want)


def _port_three(ctx, sql, rtol):
    """Three collect()s of one DataFrame (discovery, the steady state's
    build, a steady-state run), which must agree."""
    df = ctx.sql(sql)
    outs = [df.collect().to_pydict() for _ in range(3)]
    for later in outs[1:]:
        assert _same_dict(later, outs[0], rtol), sql
    return outs[0]


# ---------------------------------------------------------------------------
# the case table through SQL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(UC.CASES))
def test_case_matches_jax(sessions, name):
    jctx, pctx = sessions
    rtol = SCAN if name in SCANNED else ELEMENTWISE
    got = _port_three(pctx, UC.CASES[name], rtol)
    want = jctx.sql(UC.CASES[name]).collect().to_pydict()
    assert _same_dict(got, want, rtol), (name, got, want)


@pytest.mark.parametrize("name", sorted(UC.ERRORS))
def test_rejected_like_jax(sessions, name):
    def raised(ctx):
        try:
            ctx.sql(UC.ERRORS[name]).collect()
        except Exception as e:  # noqa: BLE001 -- compared with the reference's
            return type(e).__name__
        return None

    jctx, pctx = sessions
    assert raised(pctx) == raised(jctx) == "PlanError"


@pytest.mark.parametrize("name", sorted(UC.FAMILIES))
def test_family_query_answers_alike_on_every_collect(sessions, name):
    """The families chip_smoke.py captures on the card: three collect()s on
    the CPU agree with the JAX package, with rows in every column."""
    jctx, pctx = sessions
    got = _port_three(pctx, UC.FAMILIES[name], SCAN)
    assert _same_dict(got, jctx.sql(UC.FAMILIES[name]).collect().to_pydict(), SCAN)
    assert all(len(v) > 0 for v in got.values())


def test_scalar_udf_through_the_dataframe_api(sessions):
    """register_udf's function called from a DataFrame's select()."""
    from datafusion_tpu.expr import nodes as JE

    jctx, pctx = sessions
    got = pctx.table("t").select(E.ScalarFunction("sq", (E.col("x"),)).alias("s")).to_pydict()
    want = jctx.table("t").select(JE.ScalarFunction("sq", (JE.col("x"),)).alias("s")).to_pydict()
    assert got == want == {"s": [4.0, 9.0, 4.0, 25.0, 25.0, 1.0, 0.0, 1.0, 16.0]}


def test_udf_is_session_scoped(sessions):
    other_p, other_j = PortSession(device="cpu"), JaxSession()
    for ctx in (other_p, other_j):
        ctx.register_table("t", {"x": [1.0]})
    for ctx in (other_p, other_j):
        with pytest.raises(Exception) as info:
            ctx.sql("SELECT plus_one(x) FROM t").collect()
        assert type(info.value).__name__ == "PlanError"


def test_syncing_udf_raises_in_the_reference():
    """A UDF that reads a device value on the host (`.item()` in the torch
    half, float() of a traced array in the jax.numpy half) is a tracer error
    in the JAX package; on the card the port refuses it when capturing
    (test_families_capture_on_the_card), on the CPU it runs eagerly."""
    jctx, pctx = _sessions()
    with pytest.raises(Exception):
        jctx.sql(UC.SYNCING).collect()
    got = _port_three(pctx, UC.SYNCING, ELEMENTWISE)
    a = np.asarray(UC.tables()["r"]["a"])
    np.testing.assert_allclose(got["s"], a / np.abs(a).max(), rtol=ELEMENTWISE)


# ---------------------------------------------------------------------------
# the evaluation helpers, slot by slot
# ---------------------------------------------------------------------------

def _pairs(n=64, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, n)
    mask = rng.random(n) < 0.8
    flags = rng.random(n) < 0.2
    flags[0] = True
    return x, mask, flags


@pytest.mark.parametrize("n", [1, 3, 17, 100])
def test_running_monoid_scan_matches_jax(n):
    """A two-leaf state, flagged segment restarts, masked rows."""
    from datafusion_tpu.expr import udf as JU

    x, mask, flags = _pairs(n)
    peer = np.minimum(np.arange(n) + (np.arange(n) % 3 == 0), n - 1).astype(np.int32)
    tspec = U.WindowUDF("s2", lambda v: (v, v * v), lambda a, b: (a[0] + b[0], a[1] + b[1]),
                        (0.0, 0.0), lambda s: s[1] - s[0], T.FLOAT64)
    jspec = JU.WindowUDF("s2", lambda v: (v, v * v), lambda a, b: (a[0] + b[0], a[1] + b[1]),
                         (0.0, 0.0), lambda s: s[1] - s[0], JT.FLOAT64)
    got = U.running_monoid_scan(tspec, torch.tensor(x), torch.tensor(mask),
                                torch.tensor(flags), torch.tensor(peer))
    want = jax.jit(lambda *a: JU.running_monoid_scan(jspec, *a))(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(flags), jnp.asarray(peer))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN, atol=SCAN)


def test_segmented_monoid_reduce_integer_exact():
    from datafusion_tpu.expr import udf as JU

    rng = np.random.default_rng(7)
    n = 50
    x = rng.integers(-(1 << 40), 1 << 40, n)
    mask = rng.random(n) < 0.7
    flags = np.zeros(n, bool)
    flags[[0, 7, 8, 30]] = True
    ends = np.array([6, 7, 29, 49], np.int32)
    tspec = U.AggregateUDF("x", lambda v: {"o": v, "a": v}, lambda a, b: {
        "o": a["o"] | b["o"], "a": a["a"] & b["a"]}, {"o": 0, "a": -1},
        lambda s: s["o"] ^ s["a"], T.INT64)
    jspec = JU.AggregateUDF("x", lambda v: {"o": v, "a": v}, lambda a, b: {
        "o": a["o"] | b["o"], "a": a["a"] & b["a"]}, {"o": 0, "a": -1},
        lambda s: s["o"] ^ s["a"], JT.INT64)
    got = U.segmented_monoid_reduce(tspec, torch.tensor(x), torch.tensor(mask),
                                    torch.tensor(flags), torch.tensor(ends))
    want = jax.jit(lambda *a: JU.segmented_monoid_reduce(jspec, *a))(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(flags), jnp.asarray(ends))
    assert got.tolist() == np.asarray(want).tolist()


def test_identity_structure_mismatch_raises_like_jax():
    from datafusion_tpu.expr import udf as JU

    x, mask, flags = _pairs(8)
    t = U.AggregateUDF("bad", lambda v: (v, v), lambda a, b: a, 0.0, lambda s: s[0],
                       T.FLOAT64)
    j = JU.AggregateUDF("bad", lambda v: (v, v), lambda a, b: a, 0.0, lambda s: s[0],
                        JT.FLOAT64)
    ends = np.array([7], np.int32)
    with pytest.raises(PlanError, match="identity structure"):
        U.segmented_monoid_reduce(t, torch.tensor(x), torch.tensor(mask),
                                  torch.tensor(flags), torch.tensor(ends))
    from datafusion_tpu.common.errors import PlanError as JPlanError

    with pytest.raises(JPlanError, match="identity structure"):
        JU.segmented_monoid_reduce(j, jnp.asarray(x), jnp.asarray(mask),
                                   jnp.asarray(flags), jnp.asarray(ends))


def test_tree_flatten_round_trips():
    tree = {"b": (1, [2, {"z": 3, "a": 4}]), "a": None, "c": 5}
    leaves, structure = U.tree_flatten(tree)
    assert leaves == [1, 2, 4, 3, 5]  # dict keys sorted, None no leaf
    assert U.tree_unflatten(structure, leaves) == tree


def test_eval_scalar_udf_matches_jax_on_decimals_and_validity():
    """Decimal arguments arrive descaled; the decimal result is re-scaled
    (half to even); validities are ANDed."""
    from datafusion_tpu.data.device import DeviceColumn as JCol
    from datafusion_tpu.expr import udf as JU
    from datafusion_tpu_torch.data.device import DeviceColumn

    rng = np.random.default_rng(3)
    a = rng.integers(-10**6, 10**6, 32)
    b = rng.integers(-10**3, 10**3, 32)
    va, vb = rng.random(32) < 0.8, rng.random(32) < 0.8
    dt, jdt = T.decimal(12, 2), JT.decimal(12, 2)
    tu = U.ScalarUDF("f", lambda x, y: x * 3.0 + y, T.decimal(14, 1))
    ju = JU.ScalarUDF("f", lambda x, y: x * 3.0 + y, JT.decimal(14, 1))
    got = U.eval_scalar_udf(tu, [DeviceColumn(torch.tensor(a), torch.tensor(va), dt),
                                 DeviceColumn(torch.tensor(b), torch.tensor(vb), T.INT64)])
    want = JU.eval_scalar_udf(ju, [JCol(jnp.asarray(a), jnp.asarray(va), jdt),
                                   JCol(jnp.asarray(b), jnp.asarray(vb), JT.INT64)])
    assert got.data.tolist() == np.asarray(want.data).tolist()
    assert got.validity.tolist() == np.asarray(want.validity).tolist()


# ---------------------------------------------------------------------------
# host functions, plugins, out of core, interrupt
# ---------------------------------------------------------------------------

def test_host_function_plan_is_marked_and_others_are_not(sessions):
    """The walker's mark: a plan calling an async UDF (a HostCall) is not
    captured; any other user function is."""
    _, pctx = sessions
    for name, sql in UC.CASES.items():
        df = pctx.sql(sql)
        with U.activate(pctx.functions):
            assert FQ.calls_host(df.physical_plan()) == (name in UC.HOST_CASES), name


def test_async_udf_sees_numpy_batches_and_answers_on_the_session_device():
    seen = []

    def f(xs):
        seen.append((type(xs), xs.dtype, len(xs)))
        return xs + 0.5

    ctx = PortSession(device="cpu")
    ctx.register_table("t", {"x": [1.0, 2.0, 3.0]})
    ctx.register_async_udf("f", f, T.FLOAT64)
    df = ctx.sql("SELECT f(x) AS y FROM t")
    assert [df.to_pydict() for _ in range(3)] == [{"y": [1.5, 2.5, 3.5]}] * 3
    assert isinstance(df._fused_query()._fused, FQ._Eager)
    assert all(t is np.ndarray and d == np.float64 for t, d, _ in seen)


@pytest.fixture(scope="module")
def plugin_so(tmp_path_factory):
    """The port's copy of native/example_plugin.cpp, built with g++."""
    src = os.path.join(os.path.dirname(U.__file__), "..", "native", "example_plugin.cpp")
    out = str(tmp_path_factory.mktemp("plugin") / "example_plugin.so")
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", out],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        pytest.skip(f"cannot build example plugin: {e}")
    return out


@pytest.mark.parametrize("sql", [
    "SELECT count(*) AS n, sum(id) AS s, max(val) AS m FROM plugin_numbers",
    "SELECT name FROM plugin_numbers WHERE id = 42",
    "SELECT p.id, p.val * l.w AS x FROM plugin_numbers p JOIN local l ON p.id = l.id "
    "ORDER BY p.id",
    "SELECT plugin_hypot(a, b) AS h FROM t",
    "SELECT sum(plugin_hypot(a, b) + 1) AS s FROM t",
])
def test_plugin_matches_jax(plugin_so, sql):
    outs = []
    for ctx in (PortSession(device="cpu"), JaxSession()):
        names = ctx.register_plugin(plugin_so)
        assert names == {"tables": ["plugin_numbers"], "scalars": ["plugin_hypot"]}
        ctx.register_table("local", {"id": [1, 2, 3], "w": [10.0, 20.0, 30.0]})
        ctx.register_table("t", {"a": [3.0, 5.0, 8.0], "b": [4.0, 12.0, 15.0]})
        outs.append(ctx.sql(sql).collect().to_pydict())
    assert _same_dict(outs[0], outs[1], ELEMENTWISE)


def test_plugin_without_entry_point_raises(tmp_path):
    src = tmp_path / "empty.cpp"
    src.write_text("extern \"C\" int unrelated() { return 0; }\n")
    out = str(tmp_path / "empty.so")
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", str(src), "-o", out],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        pytest.skip(f"no toolchain: {e}")
    with pytest.raises(PlanError, match="dft_plugin_init"):
        PortSession(device="cpu").register_plugin(out)


@pytest.mark.parametrize("sql", [
    "SELECT k, geomean(b) AS gm, spread(a) AS sp FROM r GROUP BY k ORDER BY k",
    "SELECT geomean(b) AS gm FROM r",
])
def test_udaf_out_of_core_matches_jax(sql):
    """Under execution.out_of_core a UDAF is not decomposable: both packages
    aggregate the materialized chunks in one pass."""
    cfg = {"execution.out_of_core": "on", "execution.chunk_rows": 64}
    jctx, pctx = JaxSession(config=dict(cfg)), PortSession(config=dict(cfg), device="cpu")
    for ctx in (jctx, pctx):
        ctx.register_table("r", UC.tables()["r"])
    register_jax(jctx)
    UC.register(pctx)
    df = pctx.sql(sql)
    got = df.collect().to_pydict()
    assert df._cq is not None and df._cq.chunks > 1
    assert _same_dict(got, jctx.sql(sql).collect().to_pydict(), SCAN)


def test_interrupt_cancels_the_running_query():
    """interrupt() from inside the query (a UDF calling it) stops it at the
    next operator, in both packages; the next query runs."""
    outs = []
    for ctx, mod in ((PortSession(device="cpu"), torch), (JaxSession(), None)):
        ctx.register_table("t", {"k": [1, 2, 3], "x": [1.0, 2.0, 3.0]})

        def stop(a, ctx=ctx):
            ctx.interrupt()
            return a

        ctx.register_udf("stop", stop, T.FLOAT64 if mod else JT.FLOAT64)
        with pytest.raises(Exception) as info:
            ctx.sql("SELECT k, sum(stop(x)) AS s FROM t GROUP BY k").collect()
        outs.append(type(info.value).__name__)
        assert ctx.sql("SELECT 1 + 1 AS x").collect().to_pydict() == {"x": [2]}
    assert outs == ["QueryCancelled", "QueryCancelled"]


def test_interrupt_from_another_thread():
    """A query over a stream that never ends until interrupted."""
    import itertools

    ctx = PortSession(device="cpu")

    def batches():
        for i in itertools.count():
            yield {"v": [i] * 8}

    ctx.register_streaming_table("s", batches, {"v": T.INT64}, unbounded=True)
    timer = threading.Timer(0.2, ctx.interrupt)
    timer.start()
    try:
        with pytest.raises(QueryCancelled, match="interrupt"):
            for _ in ctx.sql("SELECT v FROM s WHERE v >= 0").execute_stream(chunk_rows=8):
                pass
    finally:
        timer.cancel()


def test_stale_interrupt_does_not_poison_the_next_query():
    ctx = PortSession(device="cpu")
    ctx.interrupt()
    assert ctx.sql("SELECT 1 + 1 AS x").collect().to_pydict() == {"x": [2]}

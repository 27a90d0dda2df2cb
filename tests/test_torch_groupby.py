"""The port's sort-based grouping (ops/groupby.py and the grouping half of
ops/kernels.py) against the JAX package's ops/groupby.py on the same numpy
inputs, made from a seed. Integer, decimal, bool and string results are
compared exactly; floats to rtol 1e-9 / atol 1e-9 (summation order
differs). Every aggregate runs on the sorted path, on the dense-id path
(where the dense path takes it) and as a global aggregate, with NULLs,
FILTER, DISTINCT, groups left empty by NULLs or a FILTER, dead rows, NaN,
-0.0/+0.0 and int64 extremes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.data import device as JD
from datafusion_tpu.data.column import Dictionary as JDict
from datafusion_tpu.ops import groupby as JG
from datafusion_tpu.ops import kernels as JK
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.common.schema import Field, Schema
from datafusion_tpu_torch.data import device as TD
from datafusion_tpu_torch.data.column import Dictionary as TDict
from datafusion_tpu_torch.expr import nodes as E
from datafusion_tpu_torch.expr.typing import infer
from datafusion_tpu_torch.ops import groupby as TG
from datafusion_tpu_torch.ops import kernels as TK

N = 512
I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max


def _np(x):
    return None if x is None else (x.numpy() if isinstance(x, torch.Tensor)
                                   else np.asarray(x))


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9,
                                   equal_nan=True, err_msg=what)
    else:
        assert np.array_equal(got, want), what


# ---------------------------------------------------------------------------
# one relation, two packages
# ---------------------------------------------------------------------------


def _relation(seed=0):
    """Group keys k1 (nullable int64, bounds 0..5) and k2 (string codes),
    argument columns, two filters and a live mask with dead rows that hold
    values. Rows with k1 == 5 have NULL i and b (a group with no non-NULL
    argument); filter 0 drops every row with k2 == 'c'."""
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, 6, N).astype(np.int64)
    k1v = rng.random(N) < 0.9
    k1 = np.where(k1v, k1, 0)
    k2 = rng.integers(0, 3, N).astype(np.int32)
    sel = rng.random(N) < 0.85
    i = rng.integers(-50, 50, N).astype(np.int64)
    i[rng.random(N) < 0.05] = I64_MIN
    i[rng.random(N) < 0.05] = I64_MAX
    iv = (rng.random(N) < 0.85) & (k1 != 5)
    f = rng.normal(0, 10, N).round(2)
    f[rng.random(N) < 0.05] = np.nan
    f[rng.random(N) < 0.05] = -0.0
    f[rng.random(N) < 0.05] = 0.0
    fv = rng.random(N) < 0.9
    g = rng.normal(0, 100, N).round(3)
    g[rng.random(N) < 0.05] = -0.0
    g2 = 0.5 * g + rng.normal(0, 20, N).round(3)
    g2v = rng.random(N) < 0.9
    d = rng.integers(-100_000, 100_000, N).astype(np.int64)  # decimal(12, 2)
    b = rng.random(N) < 0.6
    bv = (rng.random(N) < 0.9) & (k1 != 5)
    s = rng.integers(0, 4, N).astype(np.int32)
    o = rng.integers(0, 1000, N).astype(np.int64)  # an ORDER BY key
    j = rng.integers(-50, 50, N).astype(np.int64)
    jv = rng.random(N) < 0.8
    for col, v in ((i, iv), (f, fv), (g2, g2v), (j, jv)):
        col[~v] = 0
    b = b & bv
    filters = [k2 != 2, rng.random(N) < 0.5]
    groups = [("k1", T.INT64, k1, k1v, None, (0, 5)),
              ("k2", T.STRING, k2, None, ["a", "b", "c"], None)]
    args = [("i", T.INT64, i, iv, None, None),
            ("f", T.FLOAT64, f, fv, None, None),
            ("g", T.FLOAT64, g, None, None, None),
            ("g2", T.FLOAT64, g2, g2v, None, None),
            ("d", T.decimal(12, 2), d, None, None, (-100_000, 100_000)),
            ("b", T.BOOL, b, bv, None, None),
            ("s", T.STRING, s, None, ["p", "q", "r", "s"], None),
            ("o", T.INT64, o, None, None, (0, 999)),
            ("j", T.INT64, j, jv, None, (-50, 50))]
    return groups, args, filters, sel


ARG = {name: j for j, (name, *_) in enumerate(_relation()[1])}
SCHEMA = Schema([Field(name, dt, nullable=True)
                 for name, dt, *_ in _relation()[1]])


def _columns(cols, pkg):
    out = []
    for name, dt, data, validity, dvals, bounds in cols:
        if pkg == "jax":
            out.append(JD.DeviceColumn(
                jnp.asarray(data), None if validity is None else jnp.asarray(validity),
                dt, None if dvals is None else JDict(np.array(dvals, object)), bounds))
        else:
            out.append(TD.DeviceColumn(
                torch.from_numpy(data.copy()),
                None if validity is None else torch.from_numpy(validity.copy()),
                dt, None if dvals is None else TDict(np.array(dvals, object)), bounds))
    return out


def _inputs(pkg, seed=0, bounds=True):
    groups, args, filters, sel = _relation(seed)
    if not bounds:
        groups = [g[:5] + (None,) for g in groups]
    conv = jnp.asarray if pkg == "jax" else (lambda a: torch.from_numpy(a.copy()))
    return (_columns(groups, pkg), _columns(args, pkg), [conv(m) for m in filters],
            conv(sel))


def _spec(pkg, fname, arg=None, distinct=False, filt=None, extra=None,
          order=None, second=None):
    """An AggSpec of each package; the output type comes from the port's
    copy of expr/typing.infer."""
    args = () if arg is None else (E.Column(arg),) + (
        (E.Column(second),) if second else ())
    out_dtype, _ = infer(E.AggregateFunction(fname if fname != "count_star"
                                             else "count", args, distinct),
                         SCHEMA)
    mod = JG if pkg == "jax" else TG
    order_arg, desc = (None, False) if order is None else (ARG[order[0]], order[1])
    return mod.AggSpec(fname, None if arg is None else ARG[arg], distinct,
                       out_dtype, None, filt, extra, order_arg, desc)


# (id, fname, arg, kwargs): every aggregate the port evaluates
CASES = [
    ("count_star", "count_star", None, {}),
    ("count_star_filter", "count_star", None, {"filt": 0}),
    ("count_i", "count", "i", {}),
    ("count_distinct_f", "count", "f", {"distinct": True}),
    ("count_distinct_s_filter", "count", "s", {"distinct": True, "filt": 1}),
    ("sum_i", "sum", "i", {}),
    ("sum_i_filter", "sum", "i", {"filt": 0}),
    ("sum_distinct_i", "sum", "i", {"distinct": True}),
    ("sum_g", "sum", "g", {}),
    ("sum_d", "sum", "d", {}),
    ("avg_g_filter", "avg", "g", {"filt": 1}),
    ("avg_d", "avg", "d", {}),
    ("avg_distinct_j_filter", "avg", "j", {"distinct": True, "filt": 1}),
    ("min_i", "min", "i", {}),
    ("max_i", "max", "i", {}),
    ("min_f", "min", "f", {}),
    ("max_f_filter", "max", "f", {"filt": 0}),
    ("min_s", "min", "s", {}),
    ("max_s", "max", "s", {}),
    ("max_distinct_i", "max", "i", {"distinct": True}),
    ("var_g", "var", "g", {}),
    ("var_samp_d", "var_samp", "d", {}),
    ("var_pop_g2", "var_pop", "g2", {}),
    ("stddev_g_filter", "stddev", "g", {"filt": 0}),
    ("stddev_samp_g2", "stddev_samp", "g2", {}),
    ("stddev_pop_g", "stddev_pop", "g", {}),
    ("median_f", "median", "f", {}),
    ("median_i", "median", "i", {}),
    ("median_d", "median", "d", {}),
    ("approx_median_g", "approx_median", "g", {}),
    ("percentile_cont_g", "percentile_cont", "g", {"extra": 0.25}),
    ("approx_percentile_cont_f", "approx_percentile_cont", "f", {"extra": 0.9}),
    ("corr", "corr", "g", {"second": "g2"}),
    ("covar", "covar", "g", {"second": "g2"}),
    ("covar_pop_filter", "covar_pop", "g", {"second": "g2", "filt": 1}),
    ("covar_samp", "covar_samp", "g", {"second": "g2"}),
    ("regr_slope", "regr_slope", "g", {"second": "g2"}),
    ("regr_intercept", "regr_intercept", "g", {"second": "g2"}),
    ("regr_count", "regr_count", "g", {"second": "g2"}),
    ("regr_r2", "regr_r2", "g", {"second": "g2"}),
    ("regr_avgx", "regr_avgx", "g", {"second": "g2"}),
    ("regr_avgy", "regr_avgy", "g", {"second": "g2"}),
    ("regr_sxx", "regr_sxx", "g", {"second": "g2"}),
    ("regr_syy", "regr_syy", "g", {"second": "g2"}),
    ("regr_sxy", "regr_sxy", "g", {"second": "g2"}),
    ("first_value_i", "first_value", "i", {}),
    ("last_value_f", "last_value", "f", {}),
    ("any_value_s", "any_value", "s", {}),
    ("first_value_order_desc", "first_value", "i", {"order": ("o", True)}),
    ("last_value_order_asc_filter", "last_value", "f",
     {"order": ("o", False), "filt": 1}),
    ("bool_and", "bool_and", "b", {}),
    ("bool_or_filter", "bool_or", "b", {"filt": 0}),
    ("bit_and", "bit_and", "i", {}),
    ("bit_or_filter", "bit_or", "i", {"filt": 1}),
    ("bit_xor", "bit_xor", "i", {}),
    ("bit_xor_distinct", "bit_xor", "i", {"distinct": True}),
    ("nth_value_2", "nth_value", "i", {"extra": 2.0}),
    ("nth_value_last", "nth_value", "f", {"extra": -1.0}),
]
IDS = [c[0] for c in CASES]


def _specs(pkg):
    return [_spec(pkg, fname, arg, **kw) for _, fname, arg, kw in CASES]


def _dense_ok(spec) -> bool:
    return not (spec.distinct or spec.fname in TG._ORDER_SENSITIVE
                or spec.fname in TG.DENSE_UNSUPPORTED or spec.order_arg is not None)


def _jit(pkg, fn, *static):
    """The reference runs jitted (as its operators do); the port eagerly."""
    return jax.jit(fn, static_argnums=static) if pkg == "jax" else fn


def _sorted_path(pkg):
    gcols, args, filters, sel = _inputs(pkg)
    mod = JG if pkg == "jax" else TG
    specs = _specs(pkg)
    states = _jit(pkg, lambda *a: mod.phase_sort_multi(*a, specs))(
        gcols, args, filters, sel)
    G = TD.bucket_capacity(max(int(states[0][-1]), 1))
    keys, aggs, out_sel = _jit(pkg, lambda st: mod.phase_reduce_multi(st, specs, G))(
        states)
    return keys, aggs, out_sel, states


def _dense_path(pkg):
    """Dense group ids k1 * 3 + k2 (NULL k1 -> its own id 18), dead rows
    out of range: the dense path's _reduce_one (no SortedSegments)."""
    gcols, args, filters, sel = _inputs(pkg)
    mod, K = (JG, JK) if pkg == "jax" else (TG, TK)
    k1, k2 = gcols
    if pkg == "jax":
        ids = jnp.where(k1.validity, k1.data * 3 + k2.data, 18)
        seg = jnp.where(sel, ids, 19).astype(jnp.int32)
        is_start = jnp.zeros(N, bool)
    else:
        ids = torch.where(k1.validity, k1.data * 3 + k2.data, 18)
        seg = torch.where(sel, ids, 19).to(torch.int32)
        is_start = torch.zeros(N, dtype=torch.bool)
    specs = [s for s in _specs(pkg) if _dense_ok(s)]

    def reduce(args, filters, sel, seg, is_start):
        counts = K.segment_count(seg, sel, 19)
        out_sel = counts > 0
        return [mod._reduce_one(s, args, filters, sel, seg, is_start, None, 19,
                                counts, out_sel) for s in specs], out_sel

    outs, out_sel = _jit(pkg, reduce)(args, filters, sel, seg, is_start)
    it = iter(outs)
    return [next(it) if _dense_ok(s) else None for s in _specs(pkg)], out_sel


def _global_path(pkg):
    _, args, filters, sel = _inputs(pkg)
    mod = JG if pkg == "jax" else TG
    specs = _specs(pkg)
    return _jit(pkg, lambda *a: mod.global_aggregate(*a, specs, 128))(
        args, filters, sel)


@pytest.fixture(autouse=True, scope="module")
def quick_reference_compiles():
    """The reference's programs are compiled once each: XLA's optimizations
    would cost more than these 512-row runs save."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


@pytest.fixture(scope="module")
def paths():
    return {name: (fn("jax"), fn("torch")) for name, fn in
            (("sorted", _sorted_path), ("dense", _dense_path),
             ("global", _global_path))}


def _cmp_column(got, want, live, what):
    live = _np(live)
    gv = live if got.validity is None else _np(got.validity) & live
    wv = live if want.validity is None else _np(want.validity) & live
    assert np.array_equal(gv, wv), f"{what}: validity"
    assert repr(got.dtype) == repr(want.dtype), what
    _close(_np(got.data)[wv], _np(want.data)[wv], what)


@pytest.mark.parametrize("case", IDS)
def test_reduce_one_sorted_path(paths, case):
    (jk, ja, jsel, _), (tk, ta, tsel, _) = paths["sorted"]
    assert np.array_equal(_np(tsel), _np(jsel))
    i = IDS.index(case)
    _cmp_column(ta[i], ja[i], jsel, case)


@pytest.mark.parametrize("case", [c for c in IDS
                                  if _dense_ok(_spec("torch", *CASES[IDS.index(c)][1:3],
                                                     **CASES[IDS.index(c)][3]))])
def test_reduce_one_dense_path(paths, case):
    (ja, jsel), (ta, tsel) = paths["dense"]
    assert np.array_equal(_np(tsel), _np(jsel))
    i = IDS.index(case)
    _cmp_column(ta[i], ja[i], jsel, case)


@pytest.mark.parametrize("case", IDS)
def test_global_aggregate(paths, case):
    (ja, jsel), (ta, tsel) = paths["global"]
    assert np.array_equal(_np(tsel), _np(jsel))
    i = IDS.index(case)
    _cmp_column(ta[i], ja[i], jsel, case)


def test_sorted_path_group_keys(paths):
    (jk, _, jsel, jstates), (tk, _, tsel, tstates) = paths["sorted"]
    assert len(tstates) == len(jstates) > 2  # input-order + value buckets
    for t, j in zip(tk, jk):
        _cmp_column(t, j, jsel, "group key")


# ---------------------------------------------------------------------------
# the building blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bounds", [True, False], ids=["packed", "fallback"])
@pytest.mark.parametrize("bucket", [None, "f", ("o", True)],
                         ids=["keys", "distinct_float", "order_desc"])
def test_phase_sort(bounds, bucket):
    """Sorted payload, segments, distinct-run starts and the group count,
    slot by slot: group keys packed into one int64 key, or (no bounds) the
    multi-pass stable sort; plus a float distinct argument (never packed)
    and an ORDER BY ... DESC argument."""
    b = bucket if not isinstance(bucket, tuple) else (ARG[bucket[0]], bucket[1])
    b = ARG[b] if isinstance(b, str) else b
    j = JG.phase_sort(*_inputs("jax", seed=1, bounds=bounds), b)
    t = TG.phase_sort(*_inputs("torch", seed=1, bounds=bounds), b)
    sg, sa, sf, ssel, seg, is_start, dstart, ng = range(8)
    for k in (ssel, seg, is_start, ng):
        _close(t[k], j[k], f"field {k}")
    assert (t[dstart] is None) == (bucket is None)
    if bucket is not None:
        _close(t[dstart], j[dstart], "distinct_start")
    for tc, jc in zip(t[sg] + t[sa], j[sg] + j[sa]):
        assert tc.data.numpy().dtype == np.asarray(jc.data).dtype
        _close(tc.data, jc.data)
        if jc.validity is not None:
            _close(tc.validity, jc.validity)
    for tf, jf in zip(t[sf], j[sf]):
        _close(tf, jf)


def test_packed_sort_takes_one_pass_and_fallback_several(monkeypatch):
    """The bounds-proven keys pack into one int64 key (one torch.sort); a key
    without bounds sends the sort to one pass per key operand."""
    calls = []
    real = torch.sort

    def count(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(torch, "sort", count)
    TG.phase_sort(*_inputs("torch", bounds=True), None)
    packed = len(calls)
    calls.clear()
    TG.phase_sort(*_inputs("torch", bounds=False), None)
    # liveness, k1 validity, k1, k2
    assert (packed, len(calls)) == (1, 4)


@pytest.mark.parametrize("seed", range(3))
def test_segments_from_sorted_keys(seed):
    rng = np.random.default_rng(seed)
    n = 300
    live = int(rng.integers(0, n))
    sel = np.arange(n) < live
    k1 = np.sort(rng.integers(0, 5, n)).astype(np.int64)
    v1 = rng.random(n) < 0.8
    k2 = rng.integers(0, 2, n).astype(np.int32)
    k2.sort()
    j = JK.segments_from_sorted_keys([jnp.asarray(k1), jnp.asarray(k2)],
                                     [jnp.asarray(v1), None], jnp.asarray(sel))
    t = TK.segments_from_sorted_keys([torch.from_numpy(k1), torch.from_numpy(k2)],
                                     [torch.from_numpy(v1), None],
                                     torch.from_numpy(sel))
    for a, b in zip(t, j):
        _close(a, b)
    assert t[0].dtype == torch.int32


EXTREME_INPUTS = {
    "float_nan_zero": np.array([1.0, np.nan, 2.0, -0.0, 0.0, 0.0, -0.0, 3.0,
                                np.inf, -np.inf, 7.5, np.nan]),
    "int64_extremes": np.array([I64_MIN, I64_MAX, 0, -1, I64_MAX, I64_MIN, 5,
                                3, I64_MIN, 2, 1, I64_MAX], dtype=np.int64),
    "int32": np.array([-7, 3, 9, 2 ** 31 - 1, -(2 ** 31), 0, 1, 1, 2, 3, 4, 5],
                      dtype=np.int32),
    "bool": np.array([True, False, True, True, False, False, True, False,
                      True, True, False, True]),
}


@pytest.mark.parametrize("num_segments", [1, 6])
@pytest.mark.parametrize("kind", list(EXTREME_INPUTS))
@pytest.mark.parametrize("which", ["min", "max"])
def test_segment_min_max(which, kind, num_segments):
    """Identity in empty segments (segment 4 gets no live row), NaN
    propagation, int64 and int32 extremes, bools; ids -1 and 6 are dropped.
    -0.0 and +0.0 compare equal: their sign is not pinned (the reference's
    own scan and scatter lowerings disagree on it)."""
    x = EXTREME_INPUTS[kind]
    seg = np.array([0, 0, 1, 1, 1, 2, 2, 3, -1, 6, 5, 5], dtype=np.int32)
    mask = np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0], dtype=bool)
    jfn = JK.segment_min if which == "min" else JK.segment_max
    tfn = TK.segment_min if which == "min" else TK.segment_max
    want = jfn(jnp.asarray(x), jnp.asarray(seg), jnp.asarray(mask), num_segments)
    got = tfn(torch.from_numpy(x.copy()), torch.from_numpy(seg),
              torch.from_numpy(mask), num_segments)
    assert got.numpy().dtype == np.asarray(want).dtype
    _close(got, want)


@pytest.mark.parametrize("filtered", [False, True])
def test_distinct_marker(filtered):
    rng = np.random.default_rng(4)
    n = 200
    mask = rng.random(n) < (0.5 if filtered else 1.0)
    dstart = rng.random(n) < 0.2
    dstart[0] = True
    want = JG._distinct_marker(jnp.asarray(mask), jnp.asarray(dstart))
    got = TG._distinct_marker(torch.from_numpy(mask), torch.from_numpy(dstart))
    _close(got, want)


def _segments_out(mod, state):
    """SortedSegments' starts, ends, counts and live flags, and its sums,
    counts and min/max of the int and float arguments."""
    _, sa, _, ssel, seg, is_start, _, _ = state
    ss = mod.SortedSegments(seg, ssel, is_start, 128)
    i, g = sa[ARG["i"]], sa[ARG["g"]]
    m = ssel & i.validity
    return (ss.live, ss.starts, ss.ends, ss.count_all, ss.sum(i.data, m),
            ss.count(m), ss.sum(g.data, ssel), ss.min(i.data, m), ss.max(i.data, m),
            ss.min(g.data, ssel), ss.max(g.data, ssel))


def test_sorted_segments_match():
    """Per live group: starts, ends and counts, then integer sums, counts,
    float sums and min/max, against the reference's SortedSegments."""
    want = jax.jit(lambda *a: _segments_out(JG, JG.phase_sort(*a, None)))(
        *_inputs("jax", seed=2))
    got = _segments_out(TG, TG.phase_sort(*_inputs("torch", seed=2), None))
    live = np.asarray(want[0])
    _close(got[0], live, "live")
    for k, (a, b) in enumerate(zip(got[1:], want[1:])):
        _close(_np(a)[live], _np(b)[live], f"output {k + 1}")


def test_phase_reduce_single_bucket():
    """phase_reduce on one bucket: keys, out_sel and a mixed spec list."""
    def run(mod, pkg, *inputs):
        specs = [_spec(pkg, "sum", "i"), _spec(pkg, "max", "f"),
                 _spec(pkg, "count", "j")]
        return mod.phase_reduce(*mod.phase_sort(*inputs, None)[:7], specs, 128)

    jk, ja, jsel = jax.jit(lambda *a: run(JG, "jax", *a))(*_inputs("jax", seed=3))
    tk, ta, tsel = run(TG, "torch", *_inputs("torch", seed=3))
    assert np.array_equal(tsel.numpy(), np.asarray(jsel))
    for a, b in zip(tk + ta, jk + ja):
        _cmp_column(a, b, jsel, "phase_reduce")


def test_float_sums_are_per_segment():
    """Float sums on the sorted path are per-segment reductions: a NaN or
    an infinity spoils its own group only. (The reference subtracts prefix
    sums, so one NaN row turns every later group's sum into NaN too.)"""
    x = np.array([1.0, 2.0, np.nan, 4.0, np.inf, 1.5, 2.5, 0.25])
    seg = np.array([0, 0, 1, 1, 2, 3, 3, 4], dtype=np.int32)
    is_start = np.array([1, 0, 1, 0, 1, 1, 0, 1], dtype=bool)
    sel = np.ones(8, dtype=bool)
    ss = TG.SortedSegments(torch.from_numpy(seg), torch.from_numpy(sel),
                           torch.from_numpy(is_start), 8)
    got = ss.sum(torch.from_numpy(x), torch.from_numpy(sel)).numpy()
    _close(got[:5], np.array([3.0, np.nan, np.inf, 4.0, 0.25]))


@pytest.mark.parametrize("fname", ["array_agg", "string_agg", "approx_distinct"])
def test_unported_aggregates_raise(fname):
    """array_agg and string_agg (the nested types) and approx_distinct (the
    exact count by sorted runs) are ported: each equals the JAX package's
    global_aggregate, array_agg's list slot by slot, string_agg's joined
    words."""
    _, jargs, jfilters, jsel = _inputs("jax")
    gcols, args, filters, sel = _inputs("torch")
    width = 1 << (int(np.asarray(jsel).sum()) - 1).bit_length()
    extra = {"array_agg": width, "string_agg": (";", width)}.get(fname)
    arg = "s" if fname == "string_agg" else "i"
    spec = TG.AggSpec(fname, ARG[arg], False, T.INT64, extra=extra)
    jspec = JG.AggSpec(fname, ARG[arg], False, T.INT64, extra=extra)
    (want,), _ = jax.jit(lambda a, f, s: JG.global_aggregate(a, f, s, [jspec], 128))(
        jargs, jfilters, jsel)
    (got,), _ = TG.global_aggregate(args, filters, sel, [spec], 128)
    if fname == "approx_distinct":
        assert int(got.data[0]) == int(want.data[0]) > 1
        return
    n = int(want.list_lengths()[0])
    assert n == int(got.lengths[0]) > 1 and got.meta == want.meta
    ev = np.asarray(want.slot_valid())[0, :n]
    assert np.array_equal(got.elem_valid[0, :n].numpy(), ev)
    assert np.array_equal(got.data[0, :n].numpy()[ev], np.asarray(want.data)[0, :n][ev])

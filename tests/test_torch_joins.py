"""The port's join layer against the JAX package's: the join half of
ops/kernels.py and ops/joinimpl.py function by function on seeded numpy
inputs (NULL keys, dead rows, duplicate build keys, empty sides, int64
extremes, two-key composites, string keys from different dictionaries), ids
and counts exactly, (probe row, build row) pairs in output order; then
JoinExec through SQL on small tables, one case per join type with and
without a residual, with frames_diff."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu.common.types as JT
from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.data import column as JCol
from datafusion_tpu.data import device as JD
from datafusion_tpu.logical import plan as JL
from datafusion_tpu.ops import joinimpl as JJ
from datafusion_tpu.ops import kernels as JK
from datafusion_tpu.physical import expr_compiler as JX
from datafusion_tpu.physical.planner import create_physical_plan as jax_physical
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.data import column as PCol
from datafusion_tpu_torch.data import device as TD
from datafusion_tpu_torch.logical import plan as PL
from datafusion_tpu_torch.models.tpch.compare import frames_diff
from datafusion_tpu_torch.ops import joinimpl as PJ
from datafusion_tpu_torch.ops import kernels as PK
from datafusion_tpu_torch.physical import expr_compiler as PX
from datafusion_tpu_torch.physical import plan as PP
from datafusion_tpu_torch.physical.planner import create_physical_plan as port_physical

I64_MIN, I64_MAX = -(2 ** 63), 2 ** 63 - 1
# probe rows, build rows and expansion slots: one shape for every case, so
# that the reference compiles each of its operations once
NP, NB, CAP = 200, 150, 8192


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    """The reference's programs are compiled once each: XLA's optimizations
    would cost more than these small runs save."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


class Key:
    """One key column as numpy leaves, built into both packages' columns."""

    def __init__(self, data, validity=None, words=None, bounded=True):
        self.data, self.validity, self.words = data, validity, words
        self.bounds = None
        if bounded and words is None:
            self.bounds = (min(int(data.min(initial=0)), 0), max(int(data.max(initial=0)), 0))

    def jax(self):
        if self.words is not None:
            return JD.DeviceColumn(jnp.asarray(self.data), _jv(self.validity), JT.STRING,
                                   JCol.Dictionary(np.array(self.words, dtype=object)))
        dt = JT.INT64 if self.data.dtype == np.int64 else JT.INT32
        return JD.DeviceColumn(jnp.asarray(self.data), _jv(self.validity), dt,
                               bounds=self.bounds)

    def port(self):
        v = None if self.validity is None else torch.from_numpy(self.validity.copy())
        if self.words is not None:
            return TD.DeviceColumn(torch.from_numpy(self.data.copy()), v, T.STRING,
                                   PCol.Dictionary(np.array(self.words, dtype=object)))
        dt = T.INT64 if self.data.dtype == np.int64 else T.INT32
        return TD.DeviceColumn(torch.from_numpy(self.data.copy()), v, dt, bounds=self.bounds)


def _jv(v):
    return None if v is None else jnp.asarray(v)


def _case(name):
    """(probe keys, build keys, probe sel, build sel) for one input shape."""
    rng = np.random.default_rng(sum(map(ord, name)))
    npr, nb = NP, NB

    def ints(n, lo, hi, dtype=np.int64):
        return rng.integers(lo, hi, n).astype(dtype)

    def nulls(n, share=0.1):
        return rng.random(n) >= share

    def sel(n, share=0.8):
        return rng.random(n) < share

    if name == "nulls_dead":
        return ([Key(ints(npr, 0, 40), nulls(npr))], [Key(ints(nb, 0, 40), nulls(nb))],
                sel(npr), sel(nb))
    if name == "unique_build":
        return ([Key(ints(npr, -5, 300))], [Key(rng.permutation(nb).astype(np.int64) * 2)],
                sel(npr), sel(nb))
    if name == "empty_build":
        return ([Key(ints(npr, 0, 40))], [Key(ints(nb, 0, 40))],
                sel(npr), np.zeros(nb, bool))
    if name == "empty_probe":
        return ([Key(ints(npr, 0, 40))], [Key(ints(nb, 0, 40), nulls(nb))],
                np.zeros(npr, bool), sel(nb))
    if name == "int64_extremes":
        vals = np.array([I64_MIN, I64_MIN + 1, -1, 0, 1, I64_MAX - 1, I64_MAX], np.int64)
        return ([Key(rng.choice(vals, npr), nulls(npr), bounded=False)],
                [Key(rng.choice(vals, nb), bounded=False)], sel(npr), sel(nb))
    if name == "two_keys":
        return ([Key(ints(npr, 0, 8, np.int32), nulls(npr)), Key(ints(npr, -2, 5, np.int32))],
                [Key(ints(nb, 0, 8, np.int32)), Key(ints(nb, -2, 5, np.int32), nulls(nb))],
                sel(npr), sel(nb))
    if name == "two_wide_keys":
        big = np.array([I64_MIN, -3, 0, 7, I64_MAX], np.int64)
        return ([Key(rng.choice(big, npr), bounded=False), Key(ints(npr, 0, 4), nulls(npr))],
                [Key(rng.choice(big, nb), nulls(nb), bounded=False), Key(ints(nb, 0, 4))],
                sel(npr), sel(nb))
    if name == "strings":
        pw, bw = ["apple", "kiwi", "pear", "plum"], ["kiwi", "lime", "pear", "zz"]
        return ([Key(ints(npr, 0, 4, np.int32), nulls(npr), words=pw)],
                [Key(ints(nb, 0, 4, np.int32), nulls(nb), words=bw)], sel(npr), sel(nb))
    raise ValueError(name)


CASES = ["nulls_dead", "unique_build", "empty_build", "empty_probe", "int64_extremes",
         "two_keys", "two_wide_keys", "strings"]
BOUNDED = ["nulls_dead", "unique_build", "empty_build", "empty_probe", "two_keys", "strings"]


def _both(name):
    """Each package's (probe cols, build cols, probe sel, build sel), string
    keys unified onto one dictionary as JoinExec does."""
    pk, bk, ps, bs = _case(name)
    j = [[k.jax() for k in pk], [k.jax() for k in bk], jnp.asarray(ps), jnp.asarray(bs)]
    p = [[k.port() for k in pk], [k.port() for k in bk], torch.from_numpy(ps),
         torch.from_numpy(bs)]
    for cols, X in ((j, JX), (p, PX)):
        for i in range(len(cols[0])):
            if cols[0][i].dtype.is_string:
                cols[0][i], cols[1][i] = X.unify_string_columns(cols[0][i], cols[1][i])
    return j, p


def _pairs(cols):
    return [(c.data, c.validity) for c in cols]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _expanded(K, perm, lo, cnt, total, cap):
    probe, build, valid = K.join_expand(perm, lo, cnt, cap)
    v = _np(valid)
    return list(zip(_np(probe)[v].tolist(), _np(build)[v].tolist()))


@pytest.mark.parametrize("name", CASES)
def test_canonical_ids_two_sided(name):
    j, p = _both(name)
    want = JK.canonical_ids_two_sided(_pairs(j[0]), _pairs(j[1]), j[2], j[3])
    got = PK.canonical_ids_two_sided(_pairs(p[0]), _pairs(p[1]), p[2], p[3])
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), _np(w))


@pytest.mark.parametrize("name", CASES)
def test_pack_join_keys(name):
    j, p = _both(name)
    for side in (0, 1):
        want = JK.pack_join_keys(_pairs(j[side]), j[2 + side])
        got = PK.pack_join_keys(_pairs(p[side]), p[2 + side])
        assert (got is None) == (want is None)
        if want is not None:
            assert np.array_equal(got[0].numpy(), _np(want[0]))
            assert np.array_equal(got[1].numpy(), _np(want[1]))


@pytest.mark.parametrize("route", ["phase1", "canonical"])
@pytest.mark.parametrize("name", CASES)
def test_match_counts_and_expand(name, route):
    """join_phase1 (bounded -> join_match_counts_small, packable ->
    join_match_counts on raw ids, else canonical ids) and join_match_counts
    over canonical ids, then join_expand: counts exactly, pairs in order."""
    j, p = _both(name)
    if route == "phase1":
        want = JJ.join_phase1(j[0], j[1], j[2], j[3])
        got = PJ.join_phase1(p[0], p[1], p[2], p[3])
    else:
        def counts(K, c):
            lids, rids = K.canonical_ids_two_sided(_pairs(c[0]), _pairs(c[1]), c[2], c[3])
            return K.join_match_counts(rids, c[3] & (rids >= 0), lids, c[2] & (lids >= 0))
        want, got = counts(JK, j), counts(PK, p)
    assert np.array_equal(got[2].numpy(), _np(want[2]))
    total = int(want[3])
    assert int(got[3]) == total
    assert (total == 0) == name.startswith("empty") and total <= CAP
    assert _expanded(PK, *got, CAP) == _expanded(JK, *want, CAP)


@pytest.mark.parametrize("name", BOUNDED)
def test_direct_lookup_and_exists(name):
    j, p = _both(name)
    info = PJ.direct_domain(p[0], p[1], 1 << 26)
    assert info == JJ.direct_domain(j[0], j[1], 1 << 26)
    spans, domain = info
    want = JJ.join_direct_lookup(j[0], j[1], j[2], j[3], spans, domain)
    got = PJ.join_direct_lookup(p[0], p[1], p[2], p[3], spans, domain)
    assert bool(got[2]) == bool(want[2])
    assert bool(got[2]) == (name not in ("unique_build", "empty_build"))
    if not bool(want[2]):
        m = _np(want[1])
        assert np.array_equal(got[1].numpy(), m)
        assert np.array_equal(got[0].numpy()[m], _np(want[0])[m])
    assert np.array_equal(PJ.join_direct_exists(p[0], p[1], p[2], p[3], spans, domain).numpy(),
                          _np(JJ.join_direct_exists(j[0], j[1], j[2], j[3], spans, domain)))


def _value_cols(kind, n_probe, n_build, seed):
    """A probe and a build value column for the residual comparison: int64
    with NULLs and bounds, or float64."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (n_probe, n_build):
        if kind == "int":
            d = rng.integers(-20, 20, n).astype(np.int64)
            v = rng.random(n) >= 0.15
            out.append((JD.DeviceColumn(jnp.asarray(d), jnp.asarray(v), JT.INT64,
                                        bounds=(-20, 20)),
                        TD.DeviceColumn(torch.from_numpy(d), torch.from_numpy(v), T.INT64,
                                        bounds=(-20, 20))))
        else:
            d = np.round(rng.normal(size=n), 1)
            out.append((JD.DeviceColumn(jnp.asarray(d), None, JT.FLOAT64),
                        TD.DeviceColumn(torch.from_numpy(d), None, T.FLOAT64)))
    return out


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "neq"])
def test_exists_minmax(op, kind):
    j, p = _both("nulls_dead")
    (jpc, ppc), (jbc, pbc) = _value_cols(kind, NP, NB, 7)
    spans, domain = PJ.direct_domain(p[0], p[1], 1 << 26)
    want = JJ.join_exists_minmax(j[0], j[1], j[2], j[3], spans, domain, jpc, jbc, op)
    got = PJ.join_exists_minmax(p[0], p[1], p[2], p[3], spans, domain, ppc, pbc, op)
    assert np.array_equal(got.numpy(), _np(want))
    assert 0 < int(got.sum()) < int(p[2].sum())


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge"])
def test_range_join_phase1(op, kind):
    (jpc, ppc), (jbc, pbc) = _value_cols(kind, NP, NB, 11)
    rng = np.random.default_rng(3)
    psel, bsel = rng.random(NP) < 0.5, rng.random(NB) < 0.5
    want = JJ.range_join_phase1(jpc, jbc, op, jnp.asarray(psel), jnp.asarray(bsel))
    got = PJ.range_join_phase1(ppc, pbc, op, torch.from_numpy(psel), torch.from_numpy(bsel))
    assert np.array_equal(got[2].numpy(), _np(want[2]))
    total = int(want[3])
    assert int(got[3]) == total and 0 < total <= CAP
    assert _expanded(PK, *got, CAP) == _expanded(JK, *want, CAP)


def test_int64_extremes_join_only_live_rows():
    """A live key at INT64_MAX or INT64_MIN matches its equal, and a dead
    build row holding the same value matches nothing: no sentinel."""
    b = torch.tensor([I64_MAX, I64_MIN, I64_MAX, 5, I64_MIN])
    blive = torch.tensor([True, True, False, True, False])
    q = torch.tensor([I64_MAX, I64_MIN, 5, 4, I64_MAX])
    qlive = torch.tensor([True, True, True, True, False])
    perm, lo, cnt, total = PK.join_match_counts(b, blive, q, qlive)
    assert cnt.tolist() == [1, 1, 1, 0, 0] and int(total) == 3
    probe, build, valid = PK.join_expand(perm, lo, cnt, 128)
    assert list(zip(probe[valid].tolist(), build[valid].tolist())) == [(0, 0), (1, 1), (2, 3)]


# ---------------------------------------------------------------------------
# randomized shapes against a brute-force nested loop
# ---------------------------------------------------------------------------


def _random_side(rng, n, span, extremes):
    """(keys, validity, sel) of one side: keys in [-span, span) (plus the
    int64 extremes), about a tenth NULL, about a fifth dead."""
    keys = rng.integers(-span, span, n).astype(np.int64)
    if extremes:
        pick = rng.random(n) < 0.2
        keys[pick] = rng.choice(np.array([I64_MIN, I64_MAX], np.int64), int(pick.sum()))
    return keys, rng.random(n) >= rng.uniform(0, 0.3), rng.random(n) < rng.uniform(0.5, 1)


def _brute_pairs(pk, pv, ps, bk, bv, bs, match):
    """(probe row, build row) for every live, non-NULL pair that matches:
    probe rows in order, each one's build rows ascending by key, then row."""
    build = sorted((int(bk[j]), j) for j in range(len(bk)) if bv[j] and bs[j])
    return [(i, j) for i in range(len(pk)) if pv[i] and ps[i]
            for k, j in build if match(int(pk[i]), k)]


def _col(keys, valid, bounded):
    b = (min(int(keys.min()), 0), max(int(keys.max()), 0)) if bounded else None
    return TD.DeviceColumn(torch.from_numpy(keys), torch.from_numpy(valid), T.INT64, bounds=b)


@pytest.mark.parametrize("seed", range(48))
def test_equi_join_matches_brute_force(seed):
    """join_phase1 + join_expand on random sides: sizes 1-399, key spans
    from 3 (many duplicates) to 1e6 (few), int64 extremes in every fourth
    case, bounds given in every other (the dense-domain route); then the
    direct-address lookup and existence bitmap where the domain is dense."""
    rng = np.random.default_rng(1000 + seed)
    span = int(rng.choice([3, 50, 10 ** 6]))
    extremes = seed % 4 == 0
    (pk, pv, ps), (bk, bv, bs) = (_random_side(rng, int(rng.integers(1, 400)), span, extremes)
                                  for _ in range(2))
    bounded = seed % 2 == 1 and not extremes
    pcol, bcol = _col(pk, pv, bounded), _col(bk, bv, bounded)
    psel, bsel = torch.from_numpy(ps), torch.from_numpy(bs)
    perm, lo, cnt, total = PJ.join_phase1([pcol], [bcol], psel, bsel)
    want = _brute_pairs(pk, pv, ps, bk, bv, bs, lambda a, b: a == b)
    assert int(total) == len(want)
    assert _expanded(PK, perm, lo, cnt, total, TD.bucket_capacity(max(len(want), 1))) == want
    info = PJ.direct_domain([pcol], [bcol], 1 << 26)
    assert (info is not None) == bounded
    if bounded:
        spans, domain = info
        exists = PJ.join_direct_exists([pcol], [bcol], psel, bsel, spans, domain)
        assert exists.tolist() == (cnt > 0).tolist()
        brow, matched, dup = PJ.join_direct_lookup([pcol], [bcol], psel, bsel, spans, domain)
        live_keys = bk[bv & bs]
        assert bool(dup) == (len(np.unique(live_keys)) < len(live_keys))
        if not bool(dup):
            assert list(zip(*np.nonzero(matched.numpy()), brow[matched].tolist())) == want


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge"])
@pytest.mark.parametrize("seed", range(12))
def test_range_join_matches_brute_force(seed, op):
    """range_join_phase1 + join_expand on random sides against the nested
    loop: each probe's matches are a prefix or suffix of the live build
    rows sorted by value, ties in row order."""
    rng = np.random.default_rng(2000 + seed)
    (pk, pv, ps), (bk, bv, bs) = (_random_side(rng, int(rng.integers(1, 120)), 20, seed % 4 == 0)
                                  for _ in range(2))
    cmp = {"lt": np.less, "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal}[op]
    got = PJ.range_join_phase1(_col(pk, pv, False), _col(bk, bv, False), op,
                               torch.from_numpy(ps), torch.from_numpy(bs))
    want = _brute_pairs(pk, pv, ps, bk, bv, bs, lambda a, b: bool(cmp(a, b)))
    assert int(got[3]) == len(want)
    assert _expanded(PK, *got, TD.bucket_capacity(max(len(want), 1))) == want


# ---------------------------------------------------------------------------
# JoinExec through SQL
# ---------------------------------------------------------------------------

T1 = {"k": [1, 2, None, 4, 2, 9, 4, 6], "a": [5, 6, 7, 8, 9, 1, 2, 3],
      "s": ["x", "y", "z", "x", None, "w", "y", "q"]}
T2 = {"k": [2, 2, 4, None, 7, 4, 9], "b": [1, 9, 3, 4, 5, 10, -1],
      "s2": ["y", "w", "x", "q", "z", "v", "x"]}
T3 = {"k": [1, 2, 4, 6, 8], "c": [10, 20, 40, None, 80]}  # unique keys


@pytest.fixture(scope="module")
def join_sessions():
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    for name, data in (("t1", T1), ("t2", T2), ("t3", T3)):
        jctx.register_table(name, data)
        pctx.register_table(name, data)
    return jctx, pctx


def _join_paths(plan):
    out, stack = [], [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, PP.JoinExec):
            out.append(p.path)
        stack.extend(p.children())
    return out


SEMI = "select * from t1 where {} (select 1 from t2 where t2.k = t1.k{})"


@pytest.mark.parametrize("sql,path", [
    ("select * from t1 join t2 on t1.k = t2.k", "direct-dup,sort-merge"),
    ("select * from t1 join t2 on t1.k = t2.k and t1.a < t2.b", "direct-dup,sort-merge"),
    ("select * from t1 join t3 on t1.k = t3.k", "direct"),
    ("select * from t1 join t3 on t1.k = t3.k and t1.a + t3.c > 25", "direct"),
    ("select * from t1 left join t2 on t1.k = t2.k", "direct-dup,sort-merge"),
    ("select * from t1 left join t2 on t1.k = t2.k and t2.b > t1.a", "direct-dup,sort-merge"),
    ("select * from t1 left join t3 on t1.k = t3.k and t3.c < 30", "direct"),
    ("select * from t2 right join t1 on t1.k = t2.k", "direct-dup,sort-merge"),
    ("select * from t1 right join t2 on t1.k = t2.k and t1.a > 5", "direct-dup,sort-merge"),
    ("select * from t1 full join t2 on t1.k = t2.k", "sort-merge"),
    ("select * from t1 full join t2 on t1.k = t2.k and t1.a < t2.b", "sort-merge"),
    ("select * from t1 join t2 on t1.s = t2.s2", "direct-dup,sort-merge"),
    (SEMI.format("exists", ""), "semi-direct"),
    (SEMI.format("exists", " and t2.b > t1.a"), "minmax"),
    (SEMI.format("exists", " and t2.b + t1.a > 8"), "sort-merge"),
    (SEMI.format("not exists", ""), "semi-direct"),
    (SEMI.format("not exists", " and t2.b <> t1.a"), "minmax"),
    (SEMI.format("not exists", " and t2.b * t1.a > 8"), "sort-merge"),
    ("select k, a from t1 where a > (select avg(b) from t2)", "direct"),
    ("select t1.k, t2.k from t1, t2 where t1.a < t2.b", "range"),
])
def test_join_exec_matches_jax(join_sessions, sql, path):
    jctx, pctx = join_sessions
    df = pctx.sql(sql)
    ours = df.to_pandas()
    assert frames_diff(ours, jctx.sql(sql).to_pandas(), ordered=False) is None
    assert path in _join_paths(df.physical_plan())


def _mirrored(ctx, L, physical, to_host, sql, jt):
    """The query's LEFT SEMI/ANTI join rebuilt as its RIGHT mirror, run."""
    node = ctx.sql(sql).optimized_plan()
    while not isinstance(node, L.Join):
        node = node.children()[0]
    m = L.Join(node.right, node.left, [(r, l) for l, r in node.on], jt, node.filter)
    return to_host(physical(m).execute(ctx.exec_context())).to_pandas()


@pytest.mark.parametrize("sql,jt", [
    (SEMI.format("exists", ""), "RIGHT_SEMI"),
    (SEMI.format("exists", " and t2.b > t1.a"), "RIGHT_SEMI"),
    (SEMI.format("not exists", ""), "RIGHT_ANTI"),
    (SEMI.format("not exists", " and t2.b > t1.a"), "RIGHT_ANTI"),
])
def test_right_semi_and_anti_match_jax(join_sessions, sql, jt):
    jctx, pctx = join_sessions
    ours = _mirrored(pctx, PL, port_physical, TD.to_host, sql, PL.JoinType[jt])
    want = _mirrored(jctx, JL, jax_physical, JD.to_host, sql, JL.JoinType[jt])
    assert len(ours) > 0
    assert frames_diff(ours, want, ordered=False) is None

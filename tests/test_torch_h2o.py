"""The h2o.ai db-benchmark groupby suite through the port's
SessionContext(device="cpu") against the JAX package's SessionContext and a
pandas oracle, at N = 20 000 rows, K = 25 (integers exact, floats to
rtol 1e-9 / atol 1e-9, as tests/test_h2o.py). Each query runs on the port's
own path choice and again with the dense path switched off, so that every
query also goes through sort-based grouping. q8 (the two largest v3 per
id6, a window top-k) is held against both too."""
import jax
import numpy as np
import pandas as pd
import pytest

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.models.h2o.datagen import generate_groupby as jax_generate
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.models.h2o.datagen import generate_groupby
from datafusion_tpu_torch.models.h2o.queries import GROUPBY_QUERIES
from datafusion_tpu_torch.physical import plan as P

N, K = 20_000, 25


def _r2(g):
    c = np.corrcoef(g["v1"], g["v2"])[0, 1]
    return c * c


def oracle(qid: int, x: pd.DataFrame) -> pd.DataFrame:
    """h2o groupby query `qid` (1-based) in pandas."""
    if qid == 1:
        return x.groupby("id1", as_index=False).agg(v1=("v1", "sum"))
    if qid == 2:
        return x.groupby(["id1", "id2"], as_index=False).agg(v1=("v1", "sum"))
    if qid == 3:
        return x.groupby("id3", as_index=False).agg(v1=("v1", "sum"),
                                                    v3=("v3", "mean"))
    if qid == 4:
        return x.groupby("id4", as_index=False).agg(
            v1=("v1", "mean"), v2=("v2", "mean"), v3=("v3", "mean"))
    if qid == 5:
        return x.groupby("id6", as_index=False).agg(
            v1=("v1", "sum"), v2=("v2", "sum"), v3=("v3", "sum"))
    if qid == 6:
        return x.groupby(["id4", "id5"], as_index=False).agg(
            median_v3=("v3", "median"), sd_v3=("v3", "std"))
    if qid == 7:
        ref = x.groupby("id3", as_index=False).agg(mx=("v1", "max"),
                                                   mn=("v2", "min"))
        ref["range_v1_v2"] = ref.pop("mx") - ref.pop("mn")
        return ref
    if qid == 9:
        return (x.groupby(["id2", "id4"]).apply(_r2, include_groups=False)
                .reset_index(name="r2"))
    if qid == 10:
        return x.groupby(["id1", "id2", "id3", "id4", "id5", "id6"],
                         as_index=False).agg(v3=("v3", "sum"), cnt=("v1", "size"))
    if qid == 8:
        return (x.sort_values("v3", ascending=False).groupby("id6").head(2)
                [["id6", "v3"]].rename(columns={"v3": "largest2_v3"}))
    raise ValueError(qid)


def assert_same(ours: pd.DataFrame, ref: pd.DataFrame) -> None:
    """Multiset equality: floats to rtol 1e-9 / atol 1e-9, the rest exact."""
    assert list(ours.columns) == list(ref.columns)
    ours = ours.sort_values(list(ours.columns)).reset_index(drop=True)
    ref = ref.sort_values(list(ref.columns)).reset_index(drop=True)
    assert len(ours) == len(ref), (len(ours), len(ref))
    for c in ref.columns:
        a, b = ours[c].to_numpy(), ref[c].to_numpy()
        if isinstance(b.dtype, np.dtype) and np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a.astype(float), b, rtol=1e-9, atol=1e-9)
        else:
            assert (a == b).all(), c


@pytest.fixture(autouse=True, scope="module")
def quick_reference_compiles():
    """Each reference query is compiled once: XLA's optimizations would cost
    more than these 20 000-row runs save."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


@pytest.fixture(scope="module")
def h2o():
    port_table = generate_groupby(N, k=K)
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    jctx.register_table("x", jax_generate(N, k=K))
    pctx.register_table("x", port_table)
    x = port_table.to_pandas()
    jax_answers = {}

    def jax_answer(qid):
        if qid not in jax_answers:
            jax_answers[qid] = jctx.sql(GROUPBY_QUERIES[qid - 1]).to_pandas()
        return jax_answers[qid]

    return jax_answer, pctx, x


@pytest.mark.parametrize("route", ["chosen", "sorted"])
@pytest.mark.parametrize("qid", [1, 2, 3, 4, 5, 6, 7, 9, 10])
def test_groupby_query_matches_jax_and_pandas(h2o, qid, route, monkeypatch):
    jax_answer, pctx, x = h2o
    if route == "sorted":
        monkeypatch.setattr(P.AggregateExec, "DENSE_LIMIT", 0)
    sql = GROUPBY_QUERIES[qid - 1]
    ours = pctx.sql(sql).to_pandas()
    assert_same(ours, oracle(qid, x))
    assert_same(ours, jax_answer(qid))


def test_routes_at_this_scale(h2o, monkeypatch):
    """Which aggregate path each query takes at N = 20 000, K = 25: the
    small-domain keys go dense (q1/q2/q4 through the kernel, q3/q4/q5/q9
    with _reduce_one beside it), median and the six keys sort."""
    _, pctx, _ = h2o
    taken = {}
    for name in ("_dense_transform", "_sorted"):
        real = getattr(P.AggregateExec, name)

        def spy(self, rel, *a, _real=real, _name=name):
            taken[self._qid] = _name
            return _real(self, rel, *a)

        monkeypatch.setattr(P.AggregateExec, name, spy)
    for qid in (1, 2, 3, 4, 5, 6, 7, 9, 10):
        df = pctx.sql(GROUPBY_QUERIES[qid - 1])
        plan = df.physical_plan()
        stack = [plan]
        while stack:
            p = stack.pop()
            if isinstance(p, P.AggregateExec):
                p._qid = qid
            stack.extend(p.children())
        plan.execute(pctx.exec_context())
    assert {q for q, n in taken.items() if n == "_sorted"} == {6, 10}


def test_window_query_raises(h2o):
    """q8 plans as a window top-k and equals the reference and pandas (as a
    multiset: ties in v3 may pick either row, with equal values)."""
    from datafusion_tpu_torch.physical.window import WindowTopKExec

    jax_answer, pctx, x = h2o
    df = pctx.sql(GROUPBY_QUERIES[7])
    stack = [df.physical_plan()]
    kinds = set()
    while stack:
        p = stack.pop()
        kinds.add(type(p))
        stack.extend(p.children())
    assert WindowTopKExec in kinds
    ours = df.to_pandas()
    assert_same(ours, oracle(8, x))
    assert_same(ours, jax_answer(8))

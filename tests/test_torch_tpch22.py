"""All 22 TPC-H queries through the port's SessionContext(device="cpu") at
SF 0.01: each against the pandas oracle (models/tpch/queries_ref.py) with
frames_diff (LIMIT queries in order), and the nine that take every join
path and every new expression (Q3, Q4, Q8, Q13, Q14, Q16, Q18, Q21, Q22)
against the JAX package too. tests/test_tpch.py holds the JAX package to
the same oracle on the same data. The dense aggregation kernel's wrapper is
called in Q4, Q11, Q15 and Q17, where the reference calls its Pallas kernel
at this scale."""
import jax
import pytest

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.models.tpch.datagen import generate_tpch as jax_generate
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.models.tpch.compare import LIMIT_QUERIES, frames_diff
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch as port_generate
from datafusion_tpu_torch.models.tpch.queries import query
from datafusion_tpu_torch.models.tpch.queries_ref import ref_query
from datafusion_tpu_torch.ops import dense_agg as DA
from datafusion_tpu_torch.physical import plan as PP

SF = 0.01
AGAINST_JAX = [3, 4, 8, 13, 14, 16, 18, 21, 22]


@pytest.fixture(scope="module")
def port():
    tables = port_generate(SF)
    ctx = PortSession(device="cpu")
    for name, t in tables.items():
        ctx.register_table(name, t)
    return ctx, {name: t.to_pandas() for name, t in tables.items()}


@pytest.fixture(scope="module")
def jax_ctx():
    """The reference session; its programs compile without XLA's
    optimizations, which would cost more than these small runs save."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    ctx = JaxSession()
    for name, t in jax_generate(SF).items():
        ctx.register_table(name, t)
    yield ctx
    jax.config.update("jax_disable_most_optimizations", opt)


def _join_paths(plan):
    out, stack = [], [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, PP.JoinExec):
            out.append(p.path)
        stack.extend(p.children())
    return out


@pytest.mark.parametrize("qid", range(1, 23))
def test_query_matches_oracle(port, qid):
    ctx, frames = port
    df = ctx.sql(query(qid, SF))
    ours = df.to_pandas()
    diff = frames_diff(ours, ref_query(qid, frames, SF), ordered=qid in LIMIT_QUERIES)
    assert diff is None, diff
    assert all(_join_paths(df.physical_plan()))  # every join ran and kept its path


@pytest.mark.parametrize("qid", AGAINST_JAX)
def test_query_matches_jax(port, jax_ctx, qid):
    sql = query(qid, SF)
    ours = port[0].sql(sql).to_pandas()
    assert frames_diff(ours, jax_ctx.sql(sql).to_pandas(),
                       ordered=qid in LIMIT_QUERIES) is None


def test_the_nine_take_every_join_path(port):
    paths = set()
    for qid in AGAINST_JAX:
        df = port[0].sql(query(qid, SF))
        df.collect()
        for p in _join_paths(df.physical_plan()):
            paths.update(p.split(","))
    assert paths == {"direct", "direct-dup", "sort-merge", "semi-direct", "minmax"}


def test_kernel_runs_where_the_reference_calls_pallas(port, monkeypatch):
    calls = []
    real = DA.dense_groupby_sums

    def spy(seg, mask, pairs, G):
        calls.append(G)
        return real(seg, mask, pairs, G)

    monkeypatch.setattr(DA, "dense_groupby_sums", spy)
    for qid in (4, 11, 15, 17):
        calls.clear()
        port[0].sql(query(qid, SF)).collect()
        assert calls, f"Q{qid} made no dense_groupby_sums call"

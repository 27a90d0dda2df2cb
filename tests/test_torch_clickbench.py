"""ClickBench through the port's SessionContext(device="cpu"): the 43
queries of models/clickbench/queries.py over the synthetic `hits` table
(models/clickbench/datagen.py, 20,000 rows, seed 7). Every query runs; the
38 that sqlite can run equal a sqlite copy of the table
(sqlite_oracle.frames_match, as tests/test_clickbench.py holds the JAX
package); the four that need this package's scalar functions (q18
extract(minute) of a TIMESTAMP, q27 length, q28 regexp_replace, q42
date_trunc) and two more (q21's MIN(URL) over a LIKE, q12's top-10) equal
the JAX package on the same table, in the order the query gives them. q42
is empty at this size (its CounterID = 62 rows end before its OFFSET 1000),
so its date_trunc('minute') grouping is also compared without that filter
and offset."""
import sqlite3

import jax
import pandas as pd
import pytest

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.models.clickbench.datagen import generate_hits as jax_hits
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.models.clickbench.datagen import generate_hits
from datafusion_tpu_torch.models.clickbench.queries import QUERIES, query
from datafusion_tpu_torch.models.tpcds.sqlite_oracle import frames_match, run_sqlite

N_ROWS = 20_000
# sqlite cannot run 18 (extract minute), 28 (regexp_replace), 42
# (date_trunc); 36/37 cut ties at their LIMIT, where either engine's rows
# are a right answer (as tests/test_clickbench.py)
SQLITE_SKIP = {18, 28, 36, 37, 42}
AGAINST_JAX = {f"q{q}": query(q, N_ROWS) for q in (12, 18, 21, 27, 28, 42)}
AGAINST_JAX["q42_all_counters"] = (query(42, N_ROWS).replace("CounterID = 62 AND ", "")
                                   .replace(" OFFSET 1000", ""))


@pytest.fixture(scope="module")
def port():
    ctx = PortSession(device="cpu")
    t = generate_hits(N_ROWS)
    ctx.register_table("hits", t)
    return ctx, t.to_pandas()


@pytest.fixture(scope="module")
def jax_ctx():
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    ctx = JaxSession()
    ctx.register_table("hits", jax_hits(N_ROWS))
    yield ctx
    jax.config.update("jax_disable_most_optimizations", opt)


@pytest.fixture(scope="module")
def lite(port):
    _, df = port
    conn = sqlite3.connect(":memory:")
    conn.create_function("length", 1, lambda s: len(s) if s is not None else None)
    df = df.copy()
    for c in df.columns:
        if pd.api.types.is_datetime64_any_dtype(df[c].dtype):
            fmt = ("%Y-%m-%d %H:%M:%S"
                   if (df[c].dt.hour.fillna(0) != 0).any() else "%Y-%m-%d")
            df[c] = df[c].dt.strftime(fmt).where(df[c].notna(), None)
    df.to_sql("hits", conn, index=False)
    yield conn
    conn.close()


@pytest.mark.parametrize("qid", range(len(QUERIES)))
def test_clickbench_query_matches_sqlite(port, lite, qid):
    ctx, _ = port
    df = ctx.sql(query(qid, N_ROWS))
    ours = df.to_pandas()
    assert df.to_pandas().equals(ours)  # the steady state gives discovery's answer
    if qid in SQLITE_SKIP:
        return
    mismatch = frames_match(ours, run_sqlite(lite, query(qid, N_ROWS)), ordered=False)
    assert mismatch is None, f"q{qid}: {mismatch}"


@pytest.mark.parametrize("name", sorted(AGAINST_JAX))
def test_clickbench_query_matches_jax(port, jax_ctx, name):
    ctx, _ = port
    sql = AGAINST_JAX[name]
    ours = ctx.sql(sql).to_pandas()
    assert len(ours) > 0 or name == "q42", f"{name} is empty at {N_ROWS} rows"
    diff = frames_match(ours, jax_ctx.sql(sql).to_pandas(), ordered=True)
    assert diff is None, f"{name}: {diff}"


def test_sums_past_the_kernels_pairs_launch_in_chunks(port, monkeypatch):
    """q29 sums 90 columns; dense_groupby_sums takes at most MAX_PAIRS (16)
    factor pairs a launch, so the dense aggregate calls it once per chunk."""
    from datafusion_tpu_torch.ops import dense_agg as DA

    ctx, frame = port
    calls, orig = [], DA.dense_groupby_sums

    def recording(seg, mask, pairs, G):
        calls.append(len(pairs))
        return orig(seg, mask, pairs, G)

    monkeypatch.setattr(DA, "dense_groupby_sums", recording)
    out = ctx.sql(query(29, N_ROWS)).to_pandas()
    assert calls == [DA.MAX_PAIRS] * 5 + [90 - 5 * DA.MAX_PAIRS]
    want = [int((frame.ResolutionWidth + k).sum()) for k in range(90)]
    assert [int(v) for v in out.iloc[0]] == want

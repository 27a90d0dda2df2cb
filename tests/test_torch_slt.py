"""The golden SQL files tests/slt/functions.slt, datetime.slt and
nulls_strings.slt, record by record, through the port's copy of
testing/slt.py on SessionContext(device="cpu") and through the JAX
package's on its SessionContext. Each record's outcome must be the same on
both: a statement succeeds or fails on both, a query fails on both or
renders the same rows. The JAX package misses some of functions.slt's
golden rows (tests/test_sqllogic.py), so the port is held to the JAX
package, not to the golden file."""
import dataclasses
import pathlib

import jax
import pytest

from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.testing import slt as jax_slt
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.testing import slt as port_slt

SLT = pathlib.Path(__file__).resolve().parent / "slt"
FILES = ["functions.slt", "datetime.slt", "nulls_strings.slt"]
RECORDS = {name: port_slt.parse_slt((SLT / name).read_text()) for name in FILES}
CASES = [(name, i) for name in FILES for i in range(len(RECORDS[name]))]


def _outcome(slt, ctx, rec):
    try:
        table = ctx.sql(rec.sql).collect()
    except Exception:  # noqa: BLE001 -- an error is an outcome
        return ("error",)
    if rec.kind == "query":
        return ("rows", tuple(slt.format_rows(table, rec.types, rec.sort_mode)))
    return ("ok",)


@pytest.fixture(scope="module")
def outcomes():
    """Every record of each file, in order, on a fresh session of each
    package: {file: [(port outcome, JAX outcome), ...]}."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    out = {}
    try:
        for name in FILES:
            pctx, jctx = PortSession(device="cpu"), JaxSession()
            out[name] = [(_outcome(port_slt, pctx, rec), _outcome(jax_slt, jctx, rec))
                         for rec in RECORDS[name]]
    finally:
        jax.config.update("jax_disable_most_optimizations", opt)
    return out


def test_the_copy_parses_like_the_original():
    for name in FILES:
        text = (SLT / name).read_text()
        assert [dataclasses.astuple(r) for r in port_slt.parse_slt(text)] == \
            [dataclasses.astuple(r) for r in jax_slt.parse_slt(text)]


@pytest.mark.parametrize("name,i", CASES,
                         ids=[f"{n}:{RECORDS[n][i].line}" for n, i in CASES])
def test_record_outcome_matches_jax(outcomes, name, i):
    port, ref = outcomes[name][i]
    assert port == ref, f"{name}:{RECORDS[name][i].line} {RECORDS[name][i].sql}"


@pytest.mark.parametrize("sql", [
    "CREATE TABLE e(a INT, b VARCHAR); SELECT count(*) AS n FROM e",
    "CREATE TABLE c AS SELECT 1 AS x, 'a' AS y; CREATE TABLE IF NOT EXISTS c AS "
    "SELECT 2 AS x, 'b' AS y; SELECT * FROM c",
    "CREATE TABLE r AS SELECT 1 AS x; CREATE OR REPLACE TABLE r AS SELECT 5 AS x; "
    "SELECT x FROM r",
    "CREATE TABLE d AS SELECT 1 AS x; CREATE TABLE d AS SELECT 2 AS x",
])
def test_create_table_matches_jax(sql):
    """CREATE TABLE ... AS SELECT and CREATE TABLE t(...), as the SLT files
    use them: the same rows, or the same error class."""
    def run(ctx):
        try:
            return ctx.sql(sql).to_pydict()
        except Exception as e:  # noqa: BLE001 -- compared with the reference's
            return type(e).__name__

    assert run(PortSession(device="cpu")) == run(JaxSession())

"""A tiny run of each cell on the CPU against its reference; the same run
with the timed path broken underneath, which must come out not correct; and
the control (the reference one precision lower), which the comparison must
reject."""
import io
import json
import time

import pytest

from dfbench import cell, manifest

# the cells' configurations at sizes a test run holds
SMALL = {"tpch-sf1.report": {"scale_factor": 0.01},
         "h2o-g1-1e7.groupby": {"rows": 10_000}}
CELLS = sorted(SMALL)


def test_every_cell_has_a_small_size():
    assert set(SMALL) == {w["name"] for w in manifest.read_manifest()["workloads"]}


def run_cpu(name: str, seed: int, trace: bool = False, seconds: float = 0.3):
    out, err = io.StringIO(), io.StringIO()
    rc = cell.run(name, seed, seconds, trace, time.perf_counter(), device="cpu",
                  out=out, err=err, sizes=SMALL[name])
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), err.getvalue()


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct(name):
    rc, result, err = run_cpu(name, 2**31 + 77)
    assert rc == 0
    assert result["correct"] is True, err
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == {m.name for m in manifest.cell(name).end_to_end}
    assert err.strip().splitlines()[-1].startswith("failed_queries 0 limit 0")


@pytest.mark.parametrize("name", CELLS)
def test_tiny_traced_run_is_correct(name):
    rc, result, _ = run_cpu(name, 5, trace=True)
    assert rc == 0 and result["correct"] is True
    # the CPU run reads no device trace; only the plan spans
    expect = {"plan_ms_per_query"} if manifest.cell(name).traffic["plan"] == "per_query" else set()
    assert set(result["metrics"]) == expect


def _broken(monkeypatch, fault: str):
    """Breaks the copy of every result to the host, where the answer is
    produced: half of the rows left out, or one value altered."""
    import numpy as np

    from datafusion_tpu_torch import Table
    from datafusion_tpu_torch import context as C
    from datafusion_tpu_torch.data.column import HostColumn

    orig = C.to_host

    def to_host(rel):
        t = orig(rel)
        if t.num_rows == 0:
            return t
        if fault == "half_rows":
            keep = np.arange(0, t.num_rows, 2)
            return Table(t.schema, [c.take(keep) for c in t.columns])
        cols = list(t.columns)
        c = cols[-1]
        data = np.array(c.data, copy=True)
        data[0] = data[0] + (1 if c.dictionary is None else (1 if data[0] == 0 else -1))
        cols[-1] = HostColumn(c.dtype, data, c.validity, c.dictionary)
        return Table(t.schema, cols)

    monkeypatch.setattr(C, "to_host", to_host)


@pytest.mark.parametrize("fault", ["half_rows", "altered_value"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _broken(monkeypatch, fault)
    rc, result, err = run_cpu(name, 11)
    assert rc == 0
    assert result["correct"] is False
    assert result["compared"]["mismatched_answers"][0] > 0


def test_failing_query_is_not_correct(monkeypatch):
    from datafusion_tpu_torch import context as C

    calls = {"n": 0}
    orig = C.to_host
    WARM = manifest.cell("tpch-sf1.report").traffic["warm_passes"]

    def to_host(rel):
        calls["n"] += 1
        if calls["n"] == WARM * 22 + 2:  # in the window, after the warm passes
            raise RuntimeError("lost")
        return orig(rel)

    monkeypatch.setattr(C, "to_host", to_host)
    rc, result, _ = run_cpu("tpch-sf1.report", 3, seconds=1.0)
    assert result["failed"] == 1 and result["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_comparison(name):
    import control

    for seed in (1, 2, 3):
        r = control.readings(name, seed, SMALL[name])
        assert r["control_passes"] is False
        assert r["float_gap"] > manifest.cell(name).config["limits"]["float_gap"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out, err = io.StringIO(), io.StringIO()
    rc = cell.run("h2o-g1-1e7.groupby", 1, 0.2, False, time.perf_counter(), device="cpu",
                  out=out, err=err, sizes=SMALL["h2o-g1-1e7.groupby"])
    assert rc != 0 and out.getvalue() == ""
    assert "jax" in err.getvalue()

"""The metric arithmetic on synthetic samples."""
import pytest

from dfbench import cell, manifest
from dfbench import trace as TR


def test_rate_is_all_queries_over_all_time():
    # 9 fast queries and one slow one; the window also holds the client's
    # time between queries, which the rate must not leave out
    lat = [0.01] * 9 + [0.5]
    got = cell.window_metrics(lat, 2.0)
    assert got["queries"] == 10
    assert got["queries_per_s"] == pytest.approx(5.0)


def test_p95_is_over_every_query():
    lat = [0.001 * i for i in range(1, 101)]
    got = cell.window_metrics(lat, 10.0)
    # statistics.quantiles inclusive: 95.05 ms, not a median of passes
    assert got["query_p95_ms"] == pytest.approx(95.05)
    assert got["query_median_ms"] == pytest.approx(50.5)
    passes = [lat[i:i + 10] for i in range(0, 100, 10)]
    medians = sorted(sorted(p)[5] for p in passes)
    assert got["query_p95_ms"] != pytest.approx(medians[-1])


def test_roofline_bytes_come_from_shapes():
    read = manifest.metric_reader("dense_groupby_sums_roofline")
    mod = manifest.load_file_module(
        f"{manifest.HERE}/metrics/dense_groupby_sums_roofline.py",
        "bench_metrics_dense_groupby_sums_roofline")
    call = {"n_extent": 1000, "n_true": 600, "mask_bytes": 1, "row_bytes": 4 + 8 + 8,
            "out_bytes": 6 * (2 + 1) * 8}
    assert mod.launch_bytes(call) == 1000 + 600 * 20 + 144
    nbytes = mod.launch_bytes(call)
    # two executions of one query with one launch each, both profiled
    trace = {"kernel_calls": {"q1": [call]},
             "summary": {"dgs_launches": 2, "dgs_s": 2 * nbytes / mod.HBM_BYTES_PER_S * 2,
                         "executions": {"q1": 2}}}
    assert read(trace) == pytest.approx(50.0)
    # the profiler saw one launch of two: the bytes of one
    trace["summary"]["dgs_launches"] = 1
    assert read(trace) == pytest.approx(25.0)
    assert read({"kernel_calls": {}, "summary": None}) is None


def test_trace_summary_busy_union_and_idle_spans():
    got = {"window": (0.0, 100.0),
           "device": [("dgs_registers", 10.0, 10.0), ("Memcpy DtoH (Device -> Pinned)", 15.0, 10.0),
                      ("vectorized_gather_kernel", 60.0, 20.0)],
           "spans": [("bench.collect.q1", 5.0, 30.0), ("bench.collect.q2", 40.0, 45.0),
                     ("bench.to_host.q2", 80.0, 5.0)],
           "attempts": 1}
    s = TR.summarize(got)
    assert s["busy_s"] == pytest.approx(35e-6)  # 10-25 and 60-80
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["dgs_launches"] == 1 and s["dgs_s"] == pytest.approx(10e-6)
    assert s["dtoh_s"] == pytest.approx(10e-6)
    assert s["device_s_by_family"]["gather"] == pytest.approx(20e-6)
    idle = s["idle_s_by_span"]
    # idle: 0-10, 25-60, 80-100, each piece named by the innermost open span
    assert idle["between_queries"] == pytest.approx(25e-6)  # 0-5, 35-40, 85-100
    assert idle["collect.q1"] == pytest.approx(15e-6)  # 5-10, 25-35
    assert idle["collect.q2"] == pytest.approx(20e-6)  # 40-60
    assert idle["to_host.q2"] == pytest.approx(5e-6)  # 80-85
    assert sum(idle.values()) == pytest.approx(65e-6)


def test_share_readers_find_nothing_without_a_profile():
    for name in ("scatter_share", "device_idle_share", "dtoh_ms_per_query",
                 "host_syncs_per_query", "plan_ms_per_query"):
        assert manifest.metric_reader(name)({}) is None


def test_share_readers_on_a_profile():
    summary = {"busy_s": 2.0, "window_s": 4.0, "queries": 10, "dtoh_s": 0.01,
               "device_s_by_family": {"scatter": 0.5}}
    trace = {"summary": summary, "syncs": 19, "sync_queries": 10, "plan_s": [0.002, 0.004]}
    assert manifest.metric_reader("scatter_share")(trace) == pytest.approx(0.25)
    assert manifest.metric_reader("device_idle_share")(trace) == pytest.approx(0.5)
    assert manifest.metric_reader("dtoh_ms_per_query")(trace) == pytest.approx(1.0)
    assert manifest.metric_reader("host_syncs_per_query")(trace) == pytest.approx(1.9)
    assert manifest.metric_reader("plan_ms_per_query")(trace) == pytest.approx(3.0)

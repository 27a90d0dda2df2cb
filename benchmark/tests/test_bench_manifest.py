"""BENCHMARK.json against the benchmark's contract, and the discovery of
each cell's files by name."""
import json
import os
import re

import pytest

from dfbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def m():
    return manifest.read_manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) for p in m["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert os.path.getsize(manifest.MANIFEST) <= 64 * 1024


def test_names_units_and_sources(m):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in m[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    assert len(set(names)) == len(names)
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES
    for metric in m["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}
    e2e = {x["name"] for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in e2e and _line(metric["layer"])
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def test_configs_and_cells(m):
    configs = {c["name"]: c for c in m["configs"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert set(c["reduced"]) == set(conf.get("reduced", {}))
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len([w for w in m["workloads"] if w["chips"] == 4]) <= max(1, len(m["workloads"]) // 4)
    used = {w["config"] for w in m["workloads"]}
    assert used == set(configs)


def test_run_length_fits_a_full_check(m):
    # 2 + 14 x 24 runs, each run_seconds + 60 s, 2 x 90 s a cell, 1200 s spare
    cells = 24
    total = (2 + 14 * cells) * (m["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("name", [w["name"] for w in manifest.read_manifest()["workloads"]])
def test_each_cell_finds_its_files_by_name(name):
    cell = manifest.cell(name)
    ds = manifest.dataset(cell.config["dataset"])
    ref = manifest.reference(cell.config["dataset"])
    stream = ds.STREAMS[cell.traffic.get("stream", "default")]
    assert set(stream) <= set(ds.queries(cell.config))
    assert callable(ref.answers)
    assert cell.traffic["plan"] in ("held", "per_query")
    assert {x.name for x in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for metric in cell.per_layer:
        assert callable(manifest.metric_reader(metric.name))
    assert set(cell.config["limits"]) == {"mismatched_answers", "float_gap"}


@pytest.mark.parametrize("change", [{"clients": 4}, {"loop": "open"}])
def test_a_mix_the_client_cannot_send_is_refused(m, tmp_path, monkeypatch, change):
    w = m["workloads"][0]
    with open(os.path.join(manifest.HERE, "traffic", f"{w['traffic']}.json")) as f:
        mix = {**json.load(f), **change}
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "other.json").write_text(json.dumps(mix))
    monkeypatch.setattr(manifest, "HERE", str(tmp_path))
    bad = {**m, "workloads": [{**w, "traffic": "other"}]}
    with pytest.raises(ValueError, match="one closed loop"):
        manifest.cell(w["name"], bad)


def test_warm_up_fills_the_keeper():
    """Every cell warms up for more passes than its keeper keeps answers of
    one query, so that the window allocates no pinned host memory."""
    for w in manifest.read_manifest()["workloads"]:
        c = manifest.cell(w["name"])
        caps = c.config.get("answers_kept", {}).values()
        assert int(c.traffic["warm_passes"]) >= max(caps, default=0) + 1, w["name"]

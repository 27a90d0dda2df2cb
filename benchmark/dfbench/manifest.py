"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix. The configuration's file
(`configs/<config>.json`, the path in BENCHMARK.json's `file`) names its
dataset; `datasets/<dataset>.py` makes the tables and gives the queries and
their stream order, and `reference/<dataset>.py` answers them. The traffic
mix is `traffic/<traffic>.json`. Each per-layer metric is read by
`metrics/<name>.py`. Adding a cell, a configuration, a mix or a metric adds
files; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import List, NamedTuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)  # the checkout
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


def load_file_module(path: str, name: str):
    """Import the Python file at `path` as module `name` (cached)."""
    if name in sys.modules:
        return sys.modules[name]
    if not os.path.exists(path):
        raise FileNotFoundError(f"benchmark: no {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def sibling(file: str, stem: str):
    """The module `<stem>.py` in the directory of `file`."""
    folder = os.path.basename(os.path.dirname(os.path.abspath(file)))
    return load_file_module(os.path.join(os.path.dirname(os.path.abspath(file)),
                                         f"{stem}.py"), f"bench_{folder}_{stem}")


def dataset(name: str):
    return load_file_module(os.path.join(HERE, "datasets", f"{name}.py"),
                            f"bench_datasets_{name}")


def reference(name: str):
    return load_file_module(os.path.join(HERE, "reference", f"{name}.py"),
                            f"bench_reference_{name}")


def metric_reader(name: str):
    """The reader of per-layer metric `name`: metrics/<name>.py's `read`."""
    return load_file_module(os.path.join(HERE, "metrics", f"{name}.py"),
                            f"bench_metrics_{name}").read


class Metric(NamedTuple):
    name: str
    unit: str


class Cell(NamedTuple):
    name: str
    config: dict  # the configuration's file
    traffic: dict  # traffic/<traffic>.json
    chips: int
    end_to_end: List[Metric]  # the cell's, in BENCHMARK.json's order
    per_layer: List[Metric]


def read_manifest(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, manifest: dict = None) -> Cell:
    """The cell `name` of BENCHMARK.json, with its files read."""
    m = manifest if manifest is not None else read_manifest()
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"benchmark: no workload {name!r}; "
                       f"BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError(f"benchmark: mix {w['traffic']!r} asks for a {traffic.get('loop')} "
                         f"loop of {traffic.get('clients')} clients; the client is one closed loop")
    e2e =[Metric(x["name"], x["unit"]) for x in m["end_to_end"]
           if not x.get("workloads") or name in x["workloads"]]
    reported = {x.name for x in e2e}
    # a per-layer metric without `workloads` is reported wherever its
    # end-to-end metric is
    per_layer = [Metric(x["name"], x["unit"]) for x in m["per_layer"]
                 if (name in x["workloads"] if x.get("workloads")
                     else x["moves"] in reported)]
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer)

"""What the benchmark's processes load: after a run, no module whose
top-level name (the part before the first dot, compared whole) is jax,
jaxlib, flax or datafusion_tpu; the plain references and generators load
nothing of the program at all. And a run without a card fails."""
import ast
import os
import subprocess
import sys

from dfbench import manifest

BENCH = manifest.HERE
ROOT = manifest.ROOT

RUN_TINY = """
import sys, time, io
sys.path[:0] = [{bench!r}, {root!r}]
from dfbench import cell
for name, sizes in (("tpch-sf1.report", {{"scale_factor": 0.01}}),
                    ("h2o-g1-1e7.groupby", {{"rows": 10000}})):
    cell.run(name, 9, 0.2, False, time.perf_counter(), device="cpu",
             out=io.StringIO(), err=io.StringIO(), sizes=sizes)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE_ONLY = """
import sys
sys.path[:0] = [{bench!r}]
from dfbench import manifest
for name, sizes in (("tpch-sf1.report", {{"scale_factor": 0.01}}),
                    ("h2o-g1-1e7.groupby", {{"rows": 10000}})):
    c = manifest.cell(name)
    conf = {{**c.config, **sizes}}
    ds = manifest.dataset(conf["dataset"])
    ref = manifest.reference(conf["dataset"])
    tables = ds.generate(conf, 4)
    ref.answers(tables, conf, ds.STREAMS["default"])
    ref.answers(tables, conf, ds.STREAMS["default"], precision="control")
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level_modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(bench=BENCH, root=ROOT)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    mods = _top_level_modules(RUN_TINY)
    assert "datafusion_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "datafusion_tpu"}


def test_references_and_generators_load_nothing_of_the_program():
    mods = _top_level_modules(REFERENCE_ONLY)
    assert not mods & {"jax", "jaxlib", "flax", "datafusion_tpu", "datafusion_tpu_torch", "torch"}


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for folder, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(folder, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "datafusion_tpu"), \
                        f"{f} imports {n}"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tpch-sf1.report",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_refuses_cells_it_does_not_have():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "nope",
                          "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""

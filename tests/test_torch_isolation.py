"""The port stands alone: datafusion_tpu_torch imports neither jax nor the
datafusion_tpu package, its host-only modules are verbatim copies of their
originals (apart from a one-line header naming the original), and its
SessionContext runs on the CUDA card unless asked for the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "datafusion_tpu_torch"

VERBATIM = [
    "common/errors.py", "common/types.py", "common/schema.py", "common/stats.py",
    "common/config.py", "expr/nodes.py", "expr/typing.py", "sql/lexer.py",
    "sql/ast.py", "sql/parser.py", "sql/planner.py", "logical/plan.py",
    "optimizer/cleanup.py", "optimizer/cost.py", "optimizer/decorrelate.py",
    "optimizer/dedup.py", "optimizer/latemat.py", "optimizer/optimizer.py",
    "optimizer/pushdown.py", "optimizer/simplify.py", "data/column.py",
    "data/table.py", "models/tpch/datagen.py", "models/tpch/queries.py",
    "models/tpch/queries_ref.py", "models/tpch/compare.py",
    "models/h2o/datagen.py", "models/h2o/queries.py", "native/__init__.py",
    "native/dictenc.cpp", "models/tpcds/__init__.py", "models/tpcds/schema.py",
    "models/tpcds/datagen.py", "models/tpcds/sqlite_oracle.py",
    "sql/unparser.py", "models/clickbench/__init__.py",
    "models/clickbench/datagen.py", "models/clickbench/queries.py",
    "testing/__init__.py", "testing/slt.py", "io/__init__.py",
    "io/object_store.py", "runtime/cache.py", "io/pageindex.py", "io/bloom.py",
    "io/parquet.py", "io/avro.py", "spark/javafmt.py", "interchange/ffi.py",
    "native/plugin.h", "native/example_plugin.cpp", "logical/serde.py",
    "interchange/substrait.py", "interchange/dfproto.py", "testing/port_slt.py",
]
# copied byte for byte, without a header
VERBATIM_DATA = sorted(str(p.relative_to(ROOT / "datafusion_tpu"))
                       for p in (ROOT / "datafusion_tpu" / "models" / "tpcds"
                                 / "queries").glob("*.sql"))

_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|datafusion_tpu\b(?!_torch)"
                     r"|datafusion_pb2|datafusion_common_pb2)\b", re.M)
# the generated protobuf bindings: byte for byte, but datafusion_pb2.py's
# import of its sibling, which is package-relative in the port
PROTO = ["interchange/proto/" + f for f in (
    "datafusion.proto", "datafusion_common.proto", "regen.sh", "README.md",
    "datafusion_common_pb2.py", "datafusion_pb2.py")]
PROTO_IMPORT = ("import datafusion_common_pb2 as datafusion__common__pb2",
                "from . import datafusion_common_pb2 as datafusion__common__pb2")


def _modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_pulls_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'datafusion_tpu' or m.startswith('datafusion_tpu.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_source_imports_jax_or_the_jax_package(path):
    hits = _IMPORT.findall((ROOT / path).read_text())
    assert not hits, f"{path} imports {hits}"


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copy_equals_original(path):
    header, body = (PORT / path).read_text().split("\n", 1)
    comment = "//" if path.endswith((".cpp", ".h")) else "#"
    assert header == (f"{comment} Verbatim copy of datafusion_tpu/{path}; host-only, "
                      "kept in step with the original.")
    assert body == (ROOT / "datafusion_tpu" / path).read_text()


def test_verbatim_data_files_equal_their_originals():
    assert len(VERBATIM_DATA) == 99
    copies = sorted(str(p.relative_to(PORT)) for p in
                    (PORT / "models" / "tpcds" / "queries").glob("*.sql"))
    assert copies == VERBATIM_DATA
    for path in VERBATIM_DATA:
        assert (PORT / path).read_bytes() == (ROOT / "datafusion_tpu" / path).read_bytes(), path


@pytest.mark.parametrize("path", PROTO)
def test_proto_copy_equals_original(path):
    ours = (PORT / path).read_bytes().decode()
    original = (ROOT / "datafusion_tpu" / path).read_bytes().decode()
    if path.endswith("datafusion_pb2.py"):
        assert ours.splitlines()[13] == PROTO_IMPORT[1]
        assert original.splitlines()[13] == PROTO_IMPORT[0]
        original = original.replace(PROTO_IMPORT[0], PROTO_IMPORT[1], 1)
    assert ours == original


def test_port_bindings_load_beside_the_reference_ones():
    """Loaded after the JAX package's bindings (which put their directory on
    sys.path and load as top-level modules), the port's are its own
    modules, and no top-level binding module comes from the port."""
    code = ("import sys\n"
            "from datafusion_tpu.interchange.proto import plan_pb2 as J\n"
            "from datafusion_tpu_torch.interchange.proto import plan_pb2, common_pb2\n"
            "from datafusion_tpu_torch.interchange import dfproto\n"
            "assert plan_pb2.__name__ == 'datafusion_tpu_torch.interchange.proto.datafusion_pb2'\n"
            "assert common_pb2.__name__ == "
            "'datafusion_tpu_torch.interchange.proto.datafusion_common_pb2'\n"
            "assert dfproto.P is plan_pb2 and dfproto.C is common_pb2\n"
            "assert plan_pb2.__file__.startswith(sys.argv[1])\n"
            "for name in ('datafusion_pb2', 'datafusion_common_pb2'):\n"
            "    top = sys.modules.get(name)\n"
            "    assert top is None or 'datafusion_tpu_torch' not in top.__file__, top\n"
            "p = plan_pb2.LogicalPlanNode(); p.empty_relation.produce_one_row = True\n"
            "assert J.LogicalPlanNode.FromString(p.SerializeToString()) == "
            "J.LogicalPlanNode.FromString(p.SerializeToString())\n")
    out = subprocess.run([sys.executable, "-c", code, str(PORT)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_session_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from datafusion_tpu_torch import SessionContext

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionContext()
    ctx = SessionContext(device="cpu")
    assert ctx.device == torch.device("cpu")
    ctx.register_table("t", {"k": [1, 2]})
    assert ctx.catalog.get("t").scan_device(ctx.exec_context()).device == torch.device("cpu")


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    """`python -m datafusion_tpu_torch.cli -c ...` raises without a card,
    runs with --cpu, and never imports jax."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from datafusion_tpu_torch import cli\n"
            "try:\n"
            "    cli.main(['-c', 'SELECT 1 AS x'])\n"
            "    print('NO-RAISE')\n"
            "except RuntimeError as e:\n"
            "    print('RAISED', 'CUDA' in str(e))\n"
            "assert cli.main(['--cpu', '-c', 'SELECT 1 AS x']) == 0\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'datafusion_tpu' or m.startswith('datafusion_tpu.'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[:3] == ["RAISED True", " x", " 1"], out.stdout
    assert lines[3].startswith("1 row(s)"), out.stdout
    if not torch.cuda.is_available():
        run = subprocess.run([sys.executable, "-m", "datafusion_tpu_torch.cli", "-c",
                              "SELECT 1"], cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
        assert run.returncode != 0 and "CUDA" in run.stderr


# the out-of-core slice: its modules, each imported alone in a fresh process
OUT_OF_CORE = ["datafusion_tpu_torch.physical.chunked", "datafusion_tpu_torch.runtime.spill",
               "datafusion_tpu_torch.runtime.memory", "datafusion_tpu_torch.parallel.aggsplit",
               "datafusion_tpu_torch.catalog.catalog"]


@pytest.mark.parametrize("module", OUT_OF_CORE)
def test_out_of_core_modules_import_no_jax(module):
    code = ("import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'datafusion_tpu' or m.startswith('datafusion_tpu.'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the slice of user-defined functions, the Spark library and the DataFrame
# API: its modules, each imported alone in a fresh process
UDF_SLICE = ["datafusion_tpu_torch.expr.udf", "datafusion_tpu_torch.spark",
             "datafusion_tpu_torch.spark.functions", "datafusion_tpu_torch.spark.javafmt",
             "datafusion_tpu_torch.interchange", "datafusion_tpu_torch.interchange.ffi",
             "datafusion_tpu_torch.testing.udf_cases", "datafusion_tpu_torch.context",
             "chip_smoke"]


@pytest.mark.parametrize("module", UDF_SLICE)
def test_udf_slice_modules_import_no_jax(module):
    code = ("import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'datafusion_tpu' or m.startswith('datafusion_tpu.'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the slice of recursive queries and plan interchange: its modules, each
# imported alone in a fresh process, with no top-level protobuf binding
INTERCHANGE_SLICE = ["datafusion_tpu_torch.interchange.substrait",
                     "datafusion_tpu_torch.interchange.dfproto",
                     "datafusion_tpu_torch.interchange.dfproto_physical",
                     "datafusion_tpu_torch.interchange.proto",
                     "datafusion_tpu_torch.logical.serde",
                     "datafusion_tpu_torch.testing.port_slt",
                     "datafusion_tpu_torch.testing.recursive_cases"]


@pytest.mark.parametrize("module", INTERCHANGE_SLICE)
def test_interchange_slice_modules_import_no_jax(module):
    code = ("import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'datafusion_tpu' or m.startswith('datafusion_tpu.')\n"
            "             or m in ('datafusion_pb2', 'datafusion_common_pb2'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the distributed slice and the profile reader: their modules, each imported
# alone in a fresh process
DISTRIBUTED_SLICE = ["datafusion_tpu_torch.parallel.distributed",
                     "datafusion_tpu_torch.parallel.engine",
                     "datafusion_tpu_torch.parallel.aggsplit",
                     "datafusion_tpu_torch.ops.hll",
                     "datafusion_tpu_torch.utils.xplane"]


@pytest.mark.parametrize("module", DISTRIBUTED_SLICE)
def test_distributed_slice_modules_import_no_jax(module):
    code = ("import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'datafusion_tpu' or m.startswith('datafusion_tpu.'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr

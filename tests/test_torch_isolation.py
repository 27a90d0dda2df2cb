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
    "models/h2o/datagen.py", "models/h2o/queries.py",
]

_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|datafusion_tpu)\b(?!_torch)", re.M)


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
    assert header == (f"# Verbatim copy of datafusion_tpu/{path}; host-only, "
                      "kept in step with the original.")
    assert body == (ROOT / "datafusion_tpu" / path).read_text()


def test_session_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from datafusion_tpu_torch import SessionContext

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionContext()
    ctx = SessionContext(device="cpu")
    assert ctx.device == torch.device("cpu")
    ctx.register_table("t", {"k": [1, 2]})
    assert ctx.catalog.get("t").scan_device(ctx.exec_context()).device == torch.device("cpu")

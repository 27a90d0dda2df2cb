"""The reference's SQL files of file tables and statements, ported under
tests/slt/ported/, through the port's copy of testing/slt.py on
SessionContext(device="cpu") against their golden rows (the JAX package
passes the same files in tests/test_sqllogic.py). No record may answer
wrongly; a record may fail only by raising NotImplementedError that names a
ROADMAP item still open, and such records are listed in NOT_PORTED by
file:line."""
import pathlib

import pytest

from datafusion_tpu_torch import SessionContext
from datafusion_tpu_torch.testing.slt import parse_slt, run_slt_file

PORTED = pathlib.Path(__file__).resolve().parent / "slt" / "ported"
FILES = ["ddl", "insert", "dml_delete", "dml_update", "copy",
         "create_external_table", "csv_files", "parquet", "avro", "arrow_files",
         "json", "prepare", "dynamic_row_group_pruning", "insert_to_external"]
# "file:line" -> the ROADMAP item its NotImplementedError names; every
# record of these files runs through the port
NOT_PORTED: dict = {}


@pytest.mark.parametrize("name", FILES)
def test_file_matches_its_golden_rows(name):
    path = PORTED / f"{name}.slt"
    assert parse_slt(path.read_text()), path
    failures = run_slt_file(str(path), ctx=SessionContext(device="cpu"))
    unexpected = [f for f in failures
                  if f"{name}:{f.line}" not in NOT_PORTED
                  or NOT_PORTED[f"{name}:{f.line}"] not in f.message]
    assert not unexpected, "\n".join(str(f) for f in unexpected)

"""The cells on the card at the test sizes (`cuda`: skipped without a card)."""
import io
import json
import time

import pytest

from dfbench import cell
from test_bench_cells import CELLS, SMALL


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_on_the_card(card, name, trace):
    out, err = io.StringIO(), io.StringIO()
    rc = cell.run(name, 2**31 + 9, 0.5, trace, time.perf_counter(), out=out, err=err,
                  sizes=SMALL[name])
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is True, err.getvalue()
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]

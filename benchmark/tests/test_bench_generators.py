"""The benchmark's frozen generators make the same tables from the same
seed as the program's generators they were copied from, except the TPC-H
keys that the copy draws as the specification does."""
import numpy as np
import pytest

from dfbench import manifest, port

# the copy's keys that follow TPC-H v3.0.1 4.2.3 where the program's do not
SPEC_KEYS = {"o_orderkey", "o_custkey", "l_orderkey"}


def _same_table(ours, theirs, skip=()):
    assert [f.name for f in ours.schema.fields] == [f.name for f in theirs.schema.fields]
    for f, a, b in zip(ours.schema.fields, ours.columns, theirs.columns):
        assert a.dtype == b.dtype, f.name
        if f.name in skip:
            continue
        assert np.array_equal(a.data, b.data), f.name
        assert (a.validity is None) == (b.validity is None), f.name
        if b.dictionary is not None:
            assert list(a.dictionary.values) == list(b.dictionary.values), f.name


@pytest.mark.parametrize("seed", [42, 2**31 + 3])
def test_tpch_copy_matches_the_program_generator(seed):
    from datafusion_tpu_torch.models.tpch.datagen import _generate_tpch

    ours = manifest.dataset("tpch").generate_tpch(0.01, seed)
    theirs = _generate_tpch(0.01, seed)
    assert set(ours) == set(theirs)
    for name in theirs:
        _same_table(port.port_table(ours[name]), theirs[name], SPEC_KEYS)


@pytest.mark.parametrize("seed", [42, 2**31 + 3])
def test_tpch_keys_follow_the_specification(seed):
    tables = manifest.dataset("tpch").generate_tpch(0.01, seed)
    okey = tables["orders"]["o_orderkey"].data.astype(np.int64)
    i = np.arange(len(okey))
    assert np.array_equal(okey, (i // 8) * 32 + i % 8 + 1)
    assert set(tables["lineitem"]["l_orderkey"].data.tolist()) == set(okey.tolist())
    cust = tables["orders"]["o_custkey"].data.astype(np.int64)
    n_cust = len(tables["customer"]["c_custkey"].data)
    assert cust.min() >= 1 and cust.max() <= n_cust
    assert not (cust % 3 == 0).any()
    # every customer whose key is not a multiple of 3 may have orders
    assert len(np.unique(cust)) > 0.99 * (n_cust - n_cust // 3)


@pytest.mark.parametrize("seed", [42, 2**31 + 3])
def test_h2o_copy_matches_the_program_generator(seed):
    from datafusion_tpu_torch.models.h2o.datagen import generate_groupby

    conf = {"rows": 20_000, "k": 100, "na_share": 0, "sorted": False}
    ours = manifest.dataset("h2o").generate(conf, seed)["x"]
    _same_table(port.port_table(ours), generate_groupby(20_000, 100, 0.0, seed))


def test_tpch_queries_match_the_program_queries():
    from datafusion_tpu_torch.models.tpch.queries import query

    ours = manifest.dataset("tpch").queries({"scale_factor": 1})
    assert ours == {f"q{n}": query(n, 1.0) for n in range(1, 23)}


def test_h2o_queries_match_the_program_queries():
    from datafusion_tpu_torch.models.h2o.queries import GROUPBY_QUERIES

    assert list(manifest.dataset("h2o").queries({}).values()) == GROUPBY_QUERIES

"""The port's device layer (datafusion_tpu_torch/data/device.py) against the
JAX package's: the copied TPC-H generator gives the same arrays, and
to_device / to_host give the same capacity, slots, masks, bounds and
dictionaries for every TPC-H table at SF 0.01."""
import numpy as np
import pytest
import torch

from datafusion_tpu.data import device as JD
from datafusion_tpu.models.tpch.datagen import generate_tpch as jax_generate
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.data import device as TD
from datafusion_tpu_torch.models.tpch.datagen import TABLE_NAMES
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch as port_generate


@pytest.fixture(scope="module")
def tables():
    return jax_generate(0.01), port_generate(0.01)


def _same_values(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool(np.all(a == b))


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_copied_datagen_equals_jax(tables, name):
    jt, pt = tables[0][name], tables[1][name]
    assert [f.name for f in jt.schema.fields] == [f.name for f in pt.schema.fields]
    assert [repr(f.dtype) for f in jt.schema.fields] == \
        [repr(f.dtype) for f in pt.schema.fields]
    for jc, pc in zip(jt.columns, pt.columns):
        assert _same_values(jc.data, pc.data)
        assert (jc.validity is None) == (pc.validity is None)
        if jc.validity is not None:
            assert _same_values(jc.validity, pc.validity)
        assert (jc.dictionary is None) == (pc.dictionary is None)
        if jc.dictionary is not None:
            assert _same_values(jc.dictionary.values, pc.dictionary.values)


def _leaf(x):
    return None if x is None else (x.numpy() if isinstance(x, torch.Tensor)
                                   else np.asarray(x))


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_to_device_matches_jax(tables, name):
    jrel = JD.to_device(tables[0][name])
    prel = TD.to_device(tables[1][name], device="cpu")
    assert prel.capacity == jrel.capacity == JD.bucket_capacity(tables[0][name].num_rows)
    assert prel.device == torch.device("cpu")
    assert _same_values(_leaf(prel.sel), _leaf(jrel.sel))
    for jc, pc, hc in zip(jrel.columns, prel.columns, tables[1][name].columns):
        assert _same_values(_leaf(pc.data), _leaf(jc.data))
        assert (pc.validity is None) == (jc.validity is None)
        if jc.validity is not None:
            assert _same_values(_leaf(pc.validity), _leaf(jc.validity))
        assert pc.bounds == jc.bounds
        assert pc.sort_bounds() == jc.sort_bounds()
        assert pc.fits_i32() == jc.fits_i32()
        assert pc.dictionary is hc.dictionary  # the host dictionary, shared


@pytest.mark.parametrize("name", ["lineitem", "orders", "nation"])
def test_to_host_round_trip_matches_jax(tables, name):
    """A filtered relation downloads its live rows in capacity order, as the
    JAX package's to_host does."""
    jrel = JD.to_device(tables[0][name])
    prel = TD.to_device(tables[1][name], device="cpu")
    keep = np.arange(jrel.capacity) % 3 != 1
    jt = JD.to_host(jrel.with_sel(jrel.sel & keep))
    pt = TD.to_host(prel.with_sel(prel.sel & torch.from_numpy(keep)))
    assert pt.num_rows == jt.num_rows
    for jc, pc in zip(jt.columns, pt.columns):
        assert _same_values(pc.data, jc.data)
        assert _same_values(pc.validity, jc.validity) if jc.validity is not None \
            else pc.validity is None
    full = TD.to_host(prel)
    for hc, pc in zip(tables[1][name].columns, full.columns):
        assert _same_values(pc.data, hc.data)


def test_relation_from_numpy_takes_jax_leaves(tables):
    """A JAX relation's numpy leaves rebuild the port's relation slot for slot
    (the bridge the differential tests use)."""
    jrel = JD.to_device(tables[0]["lineitem"])
    schema = tables[1]["lineitem"].schema
    leaves = [(np.asarray(c.data), None if c.validity is None else np.asarray(c.validity),
               None if c.dictionary is None else c.dictionary.values, c.bounds)
              for c in jrel.columns]
    rel = TD.relation_from_numpy(schema, leaves, np.asarray(jrel.sel), device="cpu")
    ref = TD.to_device(tables[1]["lineitem"], device="cpu")
    assert rel.capacity == ref.capacity
    for a, b in zip(rel.columns, ref.columns):
        assert torch.equal(a.data, b.data) and a.bounds == b.bounds
        if b.dictionary is not None:
            assert _same_values(a.dictionary.values, b.dictionary.values)


def test_table_from_numpy_and_empty_relation():
    t = TD.table_from_numpy(
        [("k", T.INT64), ("s", T.STRING), ("d", T.decimal(12, 2))],
        [np.array([3, -1, 7]), np.array([1, 0, 1], np.int32), np.array([150, -25, 0])],
        validity=[None, None, np.array([True, False, True])],
        dictionaries=[None, np.array(["a", "b"], dtype=object), None])
    rel = TD.to_device(t, device="cpu")
    assert rel.capacity == 128
    assert rel.columns[0].bounds == (-1, 7)
    assert rel.columns[2].bounds == (0, 150)  # the NULL slot is not a value
    assert TD.to_host(rel).to_pydict() == {"k": [3, -1, 7], "s": ["b", "a", "b"],
                                           "d": [1.5, None, 0.0]}
    e = TD.empty_relation(t.schema, device="cpu")
    assert e.capacity == 128 and int(e.num_rows()) == 0
    assert [c.bounds for c in e.columns] == [(0, 0), None, (0, 0)]


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TD.resolve_device(None)
    assert TD.resolve_device("cpu") == torch.device("cpu")

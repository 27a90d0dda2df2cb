"""Nested types in the port (physical/nested.py, UnnestExec, array_agg and
string_agg) against the JAX package on the CPU, on the same inputs.

Lists, NULL elements, NULL lists and empty lists are compared exactly; the
few float results to rtol 1e-12. The layers:
  * every case of the shared table (datafusion_tpu_torch/testing/
    nested_cases.py: the cases of tests/test_nested.py and
    tests/test_struct_map.py), each through SQL on both packages, three
    collect()s of one DataFrame on the port (discovery, the steady state's
    build, a steady-state run); the rejected queries raise the same class;
  * nested.eval_nested_function, family by family, slot by slot against
    the JAX function on seeded numpy columns;
  * ops/groupby's array_agg / string_agg on the grouped and global paths,
    DISTINCT and FILTER included, and UnnestExec, slot by slot;
  * the queries N1-N8 over TPC-H at SF 0.01;
  * a width overflow sending a steady state back to discovery;
  * SQL files of the reference's corpus, record by record through the
    port's copy of testing/slt.py: unnest.slt and map.slt against the JAX
    package's outcome on each record, array__array_has.slt,
    array__array_element.slt, array__array_union.slt and
    array__string_to_array.slt against each query's golden block (the JAX
    package passes those blocks in tests/test_sqllogic.py).
The `cuda`-marked tests capture N1, N3 and N6 on the card under
torch.cuda.set_sync_debug_mode("error")."""
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.common import types as JT
from datafusion_tpu.common.schema import Field as JField
from datafusion_tpu.common.schema import Schema as JSchema
from datafusion_tpu.context import SessionContext as JaxSession
from datafusion_tpu.data import device as JD
from datafusion_tpu.data.column import Dictionary as JDict
from datafusion_tpu.data.table import Table as JTable
from datafusion_tpu.expr import nodes as JE
from datafusion_tpu.models.tpch.datagen import generate_tpch as jax_generate
from datafusion_tpu.ops import groupby as JG
from datafusion_tpu.physical import nested as JN
from datafusion_tpu.physical import plan as JP
from datafusion_tpu.testing import slt as jax_slt
from datafusion_tpu_torch import SessionContext as PortSession
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.common.schema import Field, Schema
from datafusion_tpu_torch.data import device as TD
from datafusion_tpu_torch.data.column import Dictionary as TDict
from datafusion_tpu_torch.data.table import Table as PTable
from datafusion_tpu_torch.expr import nodes as E
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch as port_generate
from datafusion_tpu_torch.ops import groupby as TG
from datafusion_tpu_torch.physical import fused as FQ
from datafusion_tpu_torch.physical import nested as TN
from datafusion_tpu_torch.physical import plan as TP
from datafusion_tpu_torch.testing import slt as port_slt
from datafusion_tpu_torch.testing.nested_cases import (CASES, ERRORS, FAMILIES, TPCH,
                                                       tables)

RTOL = 1e-12
SF = 0.01
SLT = pathlib.Path(__file__).resolve().parent / "slt" / "ported"


@pytest.fixture(scope="module", autouse=True)
def fast_reference():
    """The reference compiled with its optimizations off, for this module."""
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", opt)


@pytest.fixture(scope="module")
def sessions():
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    for name, cols in tables().items():
        jctx.register_table(name, cols)
        pctx.register_table(name, cols)
    return jctx, pctx


def _same(a, b) -> bool:
    """Equal values: lists element by element, floats to RTOL."""
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=RTOL, abs_tol=RTOL)
    return a == b


def _same_dict(got: dict, want: dict) -> bool:
    return list(got) == list(want) and all(_same(got[k], want[k]) for k in want)


def _port_three(ctx, sql):
    """Three collect()s of one DataFrame, which must agree."""
    df = ctx.sql(sql)
    outs = [df.collect().to_pydict() for _ in range(3)]
    for later in outs[1:]:
        assert _same_dict(later, outs[0]), sql
    return outs[0]


# ---------------------------------------------------------------------------
# the case table through SQL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_jax(sessions, name):
    jctx, pctx = sessions
    got = _port_three(pctx, CASES[name])
    assert _same_dict(got, jctx.sql(CASES[name]).collect().to_pydict()), (name, got)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_query_answers_alike_on_every_collect(sessions, name):
    """The families chip_smoke.py captures on the card: three collect()s on
    the CPU agree, with rows in every column."""
    _, pctx = sessions
    got = _port_three(pctx, FAMILIES[name])
    assert all(len(v) > 0 for v in got.values())


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_rejected_like_jax(sessions, name):
    def raised(ctx):
        try:
            ctx.sql(ERRORS[name]).collect()
        except Exception as e:  # noqa: BLE001 -- compared with the reference's
            return type(e).__name__
        return None

    jctx, pctx = sessions
    assert raised(pctx) == raised(jctx) == "PlanError"


def test_arrow_struct_and_map_columns_match_jax():
    import pyarrow as pa

    at = pa.table({"s": [{"a": 1}, {"a": 2}],
                   "m": pa.array([[("k", 1)], None],
                                 type=pa.map_(pa.string(), pa.int64()))})
    sql = "SELECT s['a'] a, m['k'] k, map_keys(m) mk, s FROM x"
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    jctx.register_table("x", JTable.from_arrow(at))
    pctx.register_table("x", PTable.from_arrow(at))
    assert _same_dict(_port_three(pctx, sql), jctx.sql(sql).collect().to_pydict())


def test_list_of_lists_upload_and_download_match_jax():
    rows = [[[1, 2], [3]], None, [], [[4, None, 6], None, [7]]]
    sql = "SELECT k, ll, array_length(ll) n FROM x"
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    for ctx in (jctx, pctx):
        ctx.register_table("x", {"k": [1, 2, 3, 4], "ll": rows})
    assert _same_dict(_port_three(pctx, sql), jctx.sql(sql).collect().to_pydict())


# ---------------------------------------------------------------------------
# eval_nested_function, slot by slot
# ---------------------------------------------------------------------------

CAP, W = 16, 5


def _inputs():
    """name -> (dtype name, data, validity, dictionary values, lengths,
    elem_valid): int64 lists with duplicates, NULL elements, empty and NULL
    lists; a second list; scalars; string lists on two dictionaries."""
    rng = np.random.default_rng(11)
    lengths = rng.integers(0, W + 1, CAP).astype(np.int32)
    lengths[0], lengths[1] = 0, W
    within = np.arange(W)[None, :] < lengths[:, None]
    ev = within & (rng.random((CAP, W)) < 0.85)
    lv = np.ones(CAP, bool)
    lv[3] = False
    data = np.where(ev, rng.integers(0, 6, (CAP, W)), 0).astype(np.int64)
    l2len = rng.integers(0, 5, CAP).astype(np.int32)
    l2ev = np.arange(4)[None, :] < l2len[:, None]
    l2 = np.where(l2ev, rng.integers(0, 6, (CAP, 4)), 0).astype(np.int64)
    fdata = np.where(ev, rng.normal(0, 10, (CAP, W)).round(3), 0.0)
    v = rng.integers(0, 6, CAP).astype(np.int64)
    vv = rng.random(CAP) < 0.85
    v = np.where(vv, v, 0)
    idx = rng.integers(-6, 7, CAP).astype(np.int64)
    sdata = rng.integers(0, 4, CAP).astype(np.int32)
    sl = np.where(ev, rng.integers(0, 4, (CAP, W)), 0).astype(np.int32)
    sl2 = np.where(l2ev, rng.integers(0, 3, (CAP, 4)), 0).astype(np.int32)
    sv = rng.integers(0, 2, CAP).astype(np.int32)
    return {
        "L": ("list_i64", data, lv, None, lengths, ev),
        "L2": ("list_i64", l2, None, None, l2len, l2ev),
        "F": ("list_f64", fdata, lv, None, lengths, ev),
        "v": ("i64", v, vv, None, None, None),
        "idx": ("i64", idx, None, None, None, None),
        "S": ("str", sdata, None, ["a,b", "", "c,,d", "x"], None, None),
        "SL": ("list_str", sl, lv, ["p", "q", "r", "s"], lengths, ev),
        "SL2": ("list_str", sl2, None, ["q", "s", "t"], l2len, l2ev),
        "sv": ("str", sv, None, ["q", "z"], None, None),
    }


def _dtype(types, name):
    return {"list_i64": types.list_of(types.INT64), "list_f64": types.list_of(types.FLOAT64),
            "list_str": types.list_of(types.STRING), "i64": types.INT64,
            "str": types.STRING}[name]


def _column(pkg, spec):
    kind, data, validity, dvals, lengths, ev = spec
    if pkg == "jax":
        arr, types, Col, Dict = jnp.asarray, JT, JD.DeviceColumn, JDict
    else:
        arr, types, Col, Dict = (lambda a: torch.from_numpy(np.array(a))), T, \
            TD.DeviceColumn, TDict
    return Col(arr(data), None if validity is None else arr(validity), _dtype(types, kind),
               None if dvals is None else Dict(np.array(dvals, dtype=object)), None,
               None if lengths is None else arr(lengths), None if ev is None else arr(ev))


# (function, argument names or Python literals)
NESTED_CALLS = [
    ("array_element", ("L", "idx")), ("array_length", ("L",)), ("empty", ("L",)),
    ("array_ndims", ("L",)), ("array_dims", ("L",)),
    ("array_has", ("L", "v")), ("array_has_all", ("L", "L2")),
    ("array_has_any", ("L", "L2")), ("array_position", ("L", "v")),
    ("array_positions", ("L", "v")), ("array_append", ("L", "v")),
    ("array_prepend", ("v", "L")), ("array_concat", ("L", "L2")),
    ("array_slice", ("L", 2, -1)), ("array_reverse", ("L",)),
    ("array_pop_back", ("L",)), ("array_pop_front", ("L",)),
    ("array_sort", ("L",)), ("array_sort", ("L", "desc")),
    ("array_distinct", ("L",)), ("array_union", ("L", "L2")),
    ("array_intersect", ("L", "L2")), ("array_except", ("L", "L2")),
    ("array_remove", ("L", "v")), ("array_remove_n", ("L", "v", 2)),
    ("array_remove_all", ("L", "v")), ("array_repeat", ("v", 3)),
    ("array_resize", ("L", 7, "v")), ("array_any_value", ("L",)),
    ("array_max", ("L",)), ("array_min", ("L",)), ("array_sum", ("L",)),
    ("array_mean", ("L",)), ("array_sum", ("F",)), ("array_max", ("F",)),
    ("range", (1, 9, 2)), ("make_array", ("v", "idx")),
    ("string_to_array", ("S", ",")), ("make_array", ("S", "sv")),
    ("array_has", ("SL", "sv")), ("array_position", ("SL", "sv")),
    ("array_distinct", ("SL",)), ("array_sort", ("SL", "desc")),
    ("array_union", ("SL", "SL2")), ("array_intersect", ("SL", "SL2")),
    ("array_has_all", ("SL", "SL2")), ("array_append", ("SL", "sv")),
    ("array_remove", ("SL", "sv")), ("array_concat", ("SL", "SL2")),
]


def _call(pkg, fname, argspec):
    types, nodes, mod = (JT, JE, JN) if pkg == "jax" else (T, E, TN)
    Fld, Sch = (JField, JSchema) if pkg == "jax" else (Field, Schema)
    inputs = _inputs()
    fields, cols, exprs = [], [], []
    for a in argspec:
        if isinstance(a, str) and a in inputs:
            col = _column(pkg, inputs[a])
            cols.append(col)
            fields.append(Fld(a, col.dtype, nullable=True))
            exprs.append(nodes.Column(a))
            continue
        lit = nodes.Literal(a, types.STRING if isinstance(a, str) else types.INT64)
        exprs.append(lit)
        if pkg == "jax":
            cols.append(JD.DeviceColumn(
                jnp.full(CAP, 0 if isinstance(a, str) else a, jnp.int32 if isinstance(a, str)
                         else jnp.int64), None,
                lit.dtype, JDict(np.array([a], object)) if isinstance(a, str) else None))
        else:
            from datafusion_tpu_torch.physical.expr_compiler import _literal_column

            cols.append(_literal_column(lit, CAP, torch.device("cpu")))
    e = nodes.ScalarFunction(fname, tuple(exprs))
    out_t, _ = mod.nested_function_type(e, Sch(fields))
    if pkg == "jax":  # one program: faster than op by op
        fn = jax.jit(lambda cols: mod.eval_nested_function(fname, cols, e.args, out_t, CAP))
        return fn(cols), out_t
    return mod.eval_nested_function(fname, cols, e.args, out_t, CAP, torch.device("cpu")), out_t


def _values(c):
    """A column's cells: per row None (NULL) or the value; a list as its
    slots, each None or the value; strings decoded."""
    data = np.asarray(c.data)
    cap = data.shape[0]
    valid = np.asarray(c.validity) if c.validity is not None else np.ones(cap, bool)
    words = None if c.dictionary is None else list(c.dictionary.values)

    def dec(x):
        x = x.item()
        return words[x] if words is not None else x

    if data.ndim == 1:
        return [dec(data[r]) if valid[r] else None for r in range(cap)]
    lengths, ev = np.asarray(c.list_lengths()), np.asarray(c.slot_valid())
    return [[dec(data[r, j]) if ev[r, j] else None for j in range(int(lengths[r]))]
            if valid[r] else None for r in range(cap)]


@pytest.mark.parametrize("fname,args", NESTED_CALLS,
                         ids=[f"{f}{a}" for f, a in NESTED_CALLS])
def test_eval_nested_function_matches_jax(fname, args):
    want, want_t = _call("jax", fname, args)
    got, got_t = _call("torch", fname, args)
    assert repr(got_t) == repr(want_t)
    assert got.data.ndim == want.data.ndim
    assert _same(_values(got), _values(want))


def test_lambda_functions_match_jax_on_columns(sessions):
    jctx, pctx = sessions
    sql = ("SELECT k, array_transform(arr, (x, i) -> x * k + i) t, "
           "array_filter(strs, s -> s <> 'y') f, "
           "array_all_match(arr, x -> x > 10) a FROM t")
    assert _same_dict(_port_three(pctx, sql), jctx.sql(sql).collect().to_pydict())


# ---------------------------------------------------------------------------
# array_agg / string_agg in ops/groupby.py, grouped and global
# ---------------------------------------------------------------------------

N = 300


def _agg_relation():
    """Group key k (0..9), int64 v with NULLs, string s, a FILTER mask and a
    live mask with dead rows."""
    rng = np.random.default_rng(5)
    k = rng.integers(0, 10, N).astype(np.int64)
    v = rng.integers(-20, 20, N).astype(np.int64)
    vv = rng.random(N) < 0.85
    v = np.where(vv, v, 0)
    s = rng.integers(0, 5, N).astype(np.int32)
    sv = rng.random(N) < 0.9
    s = np.where(sv, s, 0)
    filt = rng.random(N) < 0.6
    sel = rng.random(N) < 0.9
    return k, (v, vv), (s, sv), filt, sel


def _agg_columns(pkg):
    k, (v, vv), (s, sv), filt, sel = _agg_relation()
    words = np.array(["ant", "bee", "cat", "dog", "eel"], dtype=object)
    if pkg == "jax":
        a, types, Col, Dict = jnp.asarray, JT, JD.DeviceColumn, JDict
    else:
        a, types, Col, Dict = (lambda x: torch.from_numpy(np.array(x))), T, \
            TD.DeviceColumn, TDict
    keys = [Col(a(k), None, types.INT64, None, (0, 9))]
    args = [Col(a(v), a(vv), types.INT64), Col(a(s), a(sv), types.STRING, Dict(words))]
    return keys, args, [a(filt)], a(sel)


def _agg_specs(pkg, width):
    G, types = (JG, JT) if pkg == "jax" else (TG, T)
    lt = types.list_of(types.INT64)
    return [G.AggSpec("array_agg", 0, False, lt, types.INT64, None, width),
            G.AggSpec("array_agg", 1, False, types.list_of(types.STRING), types.STRING,
                      None, width),
            G.AggSpec("string_agg", 1, False, types.STRING, types.STRING, None,
                      (",", width)),
            G.AggSpec("string_agg", 1, True, types.STRING, types.STRING, None,
                      ("|", width)),
            G.AggSpec("string_agg", 1, False, types.STRING, types.STRING, 0,
                      (";", width)),
            G.AggSpec("string_agg", 1, True, types.STRING, types.STRING, 0,
                      ("/", width)),
            G.AggSpec("count_star", None, False, types.INT64)]


def _agg_cells(cols, out_sel):
    """Per column: the live rows' values (string_agg's joined)."""
    sel = np.asarray(out_sel)
    out = []
    for c in cols:
        vals = _values(c)
        if c.meta is not None:  # string_agg: its words joined with the delimiter
            vals = [None if x is None else c.meta[1].join(x) for x in vals]
        out.append([x for x, live in zip(vals, sel) if live])
    return out


def test_array_agg_and_string_agg_grouped_match_jax():
    k, _, _, _, sel = _agg_relation()
    groups = np.bincount(k[sel])
    cap = TD.bucket_capacity(int((groups > 0).sum()))
    width = 1 << (int(groups.max()) - 1).bit_length()
    outs = {}
    for pkg, G in (("jax", JG), ("torch", TG)):
        keys, args, filters, sel_t = _agg_columns(pkg)
        specs = _agg_specs(pkg, width)

        def run(keys, args, filters, sel_t, G=G, specs=specs):
            states = G.phase_sort_multi(keys, args, filters, sel_t, specs)
            return states, G.phase_reduce_multi(states, specs, cap)

        if pkg == "jax":  # one program: faster than op by op
            run = jax.jit(run)
        states, (k_out, a_out, out_sel) = run(keys, args, filters, sel_t)
        if pkg == "torch":
            assert int(TG.max_group_size(states[0], cap)) == int(groups.max())
        outs[pkg] = _agg_cells(list(k_out) + list(a_out), out_sel)
    assert _same(outs["torch"], outs["jax"])
    assert len(outs["torch"][0]) == int((groups > 0).sum())


def test_array_agg_and_string_agg_global_match_jax():
    outs = {}
    for pkg, G in (("jax", JG), ("torch", TG)):
        _, args, filters, sel = _agg_columns(pkg)
        width = int(np.asarray(sel).sum())
        specs = _agg_specs(pkg, 1 << (width - 1).bit_length())

        def run(args, filters, sel, G=G, specs=specs):
            return G.global_aggregate(args, filters, sel, specs, 128)

        cols, out_sel = (jax.jit(run) if pkg == "jax" else run)(args, filters, sel)
        outs[pkg] = _agg_cells(cols, out_sel)
    assert _same(outs["torch"], outs["jax"])
    assert len(outs["torch"][0][0]) == int(_agg_relation()[-1].sum())


def test_string_agg_order_by_with_nulls_is_compacted():
    """string_agg(x ORDER BY y) skips the NULL x rows wherever y sorts them
    (the reference reads them there; see ops/groupby.py)."""
    ctx = PortSession(device="cpu")
    ctx.register_table("g", {"k": [1, 1, 1, 2], "x": ["a", None, "c", "d"],
                             "y": [3, 2, 1, 1]})
    got = _port_three(ctx, "SELECT k, string_agg(x, ',' ORDER BY y) s FROM g "
                           "GROUP BY k ORDER BY k")
    assert got == {"k": [1, 2], "s": ["c,a", "d"]}


# ---------------------------------------------------------------------------
# UnnestExec
# ---------------------------------------------------------------------------


def test_unnest_exec_matches_jax():
    inputs = _inputs()
    outs = {}
    for pkg in ("jax", "torch"):
        types, nodes, P = (JT, JE, JP) if pkg == "jax" else (T, E, TP)
        Fld, Sch = (JField, JSchema) if pkg == "jax" else (Field, Schema)
        names = ["v", "L", "SL2"]
        cols = [_column(pkg, inputs[n]) for n in names]
        schema = Sch([Fld(n, c.dtype, nullable=True) for n, c in zip(names, cols)])
        sel = np.random.default_rng(3).random(CAP) < 0.8
        sel_t = jnp.asarray(sel) if pkg == "jax" else torch.from_numpy(sel)
        Rel = JD.DeviceRelation if pkg == "jax" else TD.DeviceRelation
        rel = Rel(schema, cols, sel_t)
        out_schema = Sch(list(schema.fields) + [Fld("u1", types.INT64, nullable=True),
                                                Fld("u2", types.STRING, nullable=True)])
        ex = P.UnnestExec(None, [nodes.Column("L"), nodes.Column("SL2")], out_schema)
        out = ex._transform(rel)
        osel = np.asarray(out.sel)
        cap = len(osel)
        cells = [[x for x, live in zip(_values(c), osel) if live] for c in out.columns]
        outs[pkg] = (cap, cells)
    assert outs["torch"][0] == outs["jax"][0]
    assert _same(outs["torch"][1], outs["jax"][1])
    assert len(outs["torch"][1][0]) > CAP  # rows repeat


# ---------------------------------------------------------------------------
# N1-N8 over TPC-H
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch():
    jctx, pctx = JaxSession(), PortSession(device="cpu")
    for name, t in jax_generate(SF).items():
        jctx.register_table(name, t)
    for name, t in port_generate(SF).items():
        pctx.register_table(name, t)
    return jctx, pctx


@pytest.mark.parametrize("name", sorted(TPCH))
def test_tpch_nested_query_matches_jax(tpch, name):
    jctx, pctx = tpch
    got = _port_three(pctx, TPCH[name])
    assert _same_dict(got, jctx.sql(TPCH[name]).collect().to_pydict())
    assert len(next(iter(got.values()))) > 20


def test_width_overflow_goes_back_to_discovery():
    """A steady state whose largest group outgrows the discovered list
    width raises its flag; discovery runs again with a wider list."""
    ctx = PortSession(device="cpu")
    ctx.register_table("w", {"k": [1, 1, 2, 3], "v": [10, 20, 30, 40]})
    df = ctx.sql("SELECT k, array_agg(v) vs FROM w GROUP BY k ORDER BY k")
    want = {"k": [1, 2, 3], "vs": [[10, 20], [30], [40]]}
    assert [df.collect().to_pydict() for _ in range(3)] == [want] * 3
    fq = df._fused_query()
    agg = [p for p in fq._nodes_preorder() if isinstance(p, TP.AggregateExec)][0]
    assert agg._last_width == 2 and fq._fused is not None
    ctx.catalog.get("w")._device["cpu"]["k"].data[3] = 1  # group 1 now has 3
    assert df.collect().to_pydict() == {"k": [1, 2], "vs": [[10, 20, 40], [30]]}
    assert fq._fused is None and agg._last_width == 4  # rediscovered


# ---------------------------------------------------------------------------
# the reference's SQL files
# ---------------------------------------------------------------------------

JAX_HELD = ["unnest.slt", "map.slt"]
GOLDEN_HELD = ["array__array_has.slt", "array__array_element.slt",
               "array__array_union.slt", "array__string_to_array.slt"]
RECORDS = {name: port_slt.parse_slt((SLT / name).read_text())
           for name in JAX_HELD + GOLDEN_HELD}
JAX_CASES = [(n, i) for n in JAX_HELD for i in range(len(RECORDS[n]))]
GOLDEN_CASES = [(n, i) for n in GOLDEN_HELD for i, r in enumerate(RECORDS[n])
                if r.kind == "query"]


def _outcome(slt, ctx, rec):
    try:
        table = ctx.sql(rec.sql).collect()
    except Exception:  # noqa: BLE001 -- an error is an outcome
        return ("error",)
    if rec.kind == "query":
        return ("rows", tuple(slt.format_rows(table, rec.types, rec.sort_mode)))
    return ("ok",)


@pytest.fixture(scope="module")
def slt_outcomes():
    """Every record of each file, in order, on a fresh session per file:
    {file: [port outcome, ...]}, and the JAX package's for JAX_HELD."""
    port, ref = {}, {}
    for name, recs in RECORDS.items():
        pctx = PortSession(device="cpu")
        port[name] = [_outcome(port_slt, pctx, r) for r in recs]
    for name in JAX_HELD:
        jctx = JaxSession()
        ref[name] = [_outcome(jax_slt, jctx, r) for r in RECORDS[name]]
    return port, ref


@pytest.mark.parametrize("name,i", JAX_CASES,
                         ids=[f"{n}:{RECORDS[n][i].line}" for n, i in JAX_CASES])
def test_slt_record_matches_jax(slt_outcomes, name, i):
    rec = RECORDS[name][i]
    port, ref = slt_outcomes
    assert port[name][i] == ref[name][i], f"{name}:{rec.line} {rec.sql}"


@pytest.mark.parametrize("name,i", GOLDEN_CASES,
                         ids=[f"{n}:{RECORDS[n][i].line}" for n, i in GOLDEN_CASES])
def test_slt_query_matches_golden_block(slt_outcomes, name, i):
    rec = RECORDS[name][i]
    port, _ = slt_outcomes
    assert port[name][i] == ("rows", rec.expected), f"{name}:{rec.line} {rec.sql}"


# ---------------------------------------------------------------------------
# on the card: N1, N3 and N6 captured with no host sync
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["N1", "N3", "N6"])
def test_tpch_nested_capture_without_host_sync(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graph capture has no CPU mode)")
    card, cpu = PortSession(), PortSession(device="cpu")
    for ctx in (card, cpu):
        for tname, t in port_generate(SF).items():
            ctx.register_table(tname, t)
    want = cpu.sql(TPCH[name]).collect().to_pydict()
    df = card.sql(TPCH[name])
    assert _same_dict(df.collect().to_pydict(), want)
    fq = df._fused_query()
    inputs = tuple(leaf.execute(card.exec_context()) for leaf in fq.leaves)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph = FQ._Graph(fq._steady_fn(), inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for _ in range(2):
        rel, overflow = graph.run()
        assert not overflow
        assert _same_dict(TD.to_host(rel).to_pydict(), want)

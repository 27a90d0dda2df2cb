# Written from chip_smoke.h2o_oracle (the pandas oracle of the h2o groupby
# questions in chip_smoke.py and tests/test_torch_h2o.py), rewritten in plain
# NumPy. It imports nothing of the program.
"""The plain reference of the ten h2o.ai groupby questions over table x
(dfbench.columns.Col). Integer sums and counts are exact; a float result
comes from float64 sums in row order (averages, sums), the sorted values of
its group (median), two passes (sample standard deviation) or exact integer
moments (corr(v1, v2)**2). String keys are answered as codes of the input's
sorted dictionaries.

`precision="control"` computes every float result in float32: the control
that the comparison must reject."""
from __future__ import annotations

from typing import Dict

import numpy as np

from dfbench.answers import Answer, RefCol
from dfbench.columns import bounded_unique

PRESENCE_MAX = 1 << 28


def _exact_int_sum(gid, v, G):
    """Per-group sums of int64 values, exact: two halves of bits, each
    summed exactly in float64."""
    hi, lo = v >> 26, v & ((1 << 26) - 1)
    return (np.rint(np.bincount(gid, weights=hi, minlength=G)).astype(np.int64) << 26) \
        + np.rint(np.bincount(gid, weights=lo, minlength=G)).astype(np.int64)


class _Grouping:
    """Rows grouped on key columns: group ids in ascending key order, a row
    of each group, each group's size."""

    def __init__(self, keys, bounds):
        n = len(keys[0])
        packed = np.zeros(n, dtype=np.int64)
        span = 1
        for k, b in zip(keys, bounds):
            packed = packed * b + k
            span *= b
        if span <= PRESENCE_MAX:
            uniq, self.gid = bounded_unique(packed, span)
        else:
            uniq, inv = np.unique(packed, return_inverse=True)
            self.gid = inv.reshape(-1)
        self.G = len(uniq)
        self.rep = np.empty(self.G, dtype=np.int64)
        self.rep[self.gid] = np.arange(n)
        self.size = np.bincount(self.gid, minlength=self.G).astype(np.int64)
        self.start = np.concatenate([[0], np.cumsum(self.size)[:-1]])
        self._order = None

    def sum(self, v: np.ndarray) -> np.ndarray:
        """Per-group sums: exact for integers, in row order in the float
        dtype of v otherwise."""
        if v.dtype.kind in "iu":
            return _exact_int_sum(self.gid, v.astype(np.int64), self.G)
        if v.dtype == np.float64:
            return np.bincount(self.gid, weights=v, minlength=self.G)
        if self._order is None:
            self._order = np.argsort(self.gid, kind="stable")
        return np.add.reduceat(v[self._order], self.start)

    def extreme(self, v: np.ndarray, largest: bool) -> np.ndarray:
        """Per-group max (or min) of a column of few distinct integers."""
        levels = np.unique(v)
        out = np.zeros(self.G, dtype=np.int64)
        done = np.zeros(self.G, dtype=bool)
        for level in (levels[::-1] if largest else levels):
            hit = (np.bincount(self.gid, weights=v == level, minlength=self.G) > 0) & ~done
            out[hit] = level
            done |= hit
        return out


def _v3_units(v3: np.ndarray) -> np.ndarray:
    """v3 (rounded to 6 decimals) as exact integer millionths."""
    return np.rint(v3 * 1e6).astype(np.int64)


V3_BITS = 27  # v3 < 100, so its millionths < 2**27


def answers(tables, config: dict, names, precision: str = "exact") -> Dict[str, Answer]:
    if precision not in ("exact", "control"):
        raise ValueError(precision)
    x = tables["x"]
    k, n = int(config["k"]), int(config["rows"])
    hi = max(n // k, 1)
    f = np.float64 if precision == "exact" else np.float32
    v1, v2 = x["v1"].data, x["v2"].data
    v3 = x["v3"].data.astype(f)
    bound = {"id1": len(x["id1"].dictionary), "id2": len(x["id2"].dictionary),
             "id3": len(x["id3"].dictionary), "id4": k + 1, "id5": k + 1, "id6": hi + 1}
    groupings = {}

    def by(*cols) -> _Grouping:
        if cols not in groupings:
            groupings[cols] = _Grouping([x[c].data for c in cols], [bound[c] for c in cols])
        return groupings[cols]

    def key(g: _Grouping, c: str) -> RefCol:
        col = x[c]
        if col.kind == "string":
            return RefCol(c, "string", col.data[g.rep].astype(np.int64), 0, col.dictionary)
        return RefCol(c, "int", col.data[g.rep].astype(np.int64))

    def fl(name, values) -> RefCol:
        return RefCol(name, "float", np.asarray(values).astype(np.float64))

    def mean(g, v):
        s = g.sum(v.astype(f) if v.dtype.kind == "f" else v)
        return s.astype(f) / g.size.astype(f)

    def q1():
        g = by("id1")
        return [key(g, "id1"), RefCol("v1", "int", g.sum(v1))]

    def q2():
        g = by("id1", "id2")
        return [key(g, "id1"), key(g, "id2"), RefCol("v1", "int", g.sum(v1))]

    def q3():
        g = by("id3")
        return [key(g, "id3"), RefCol("v1", "int", g.sum(v1)), fl("v3", mean(g, v3))]

    def q4():
        g = by("id4")
        return [key(g, "id4"), fl("v1", mean(g, v1)), fl("v2", mean(g, v2)),
                fl("v3", mean(g, v3))]

    def q5():
        g = by("id6")
        return [key(g, "id6"), RefCol("v1", "int", g.sum(v1)),
                RefCol("v2", "int", g.sum(v2)), fl("v3", g.sum(v3))]

    def q6():
        g = by("id4", "id5")
        # the values sorted within their groups: one sort of (group, v3)
        s = np.sort((g.gid << V3_BITS) | _v3_units(x["v3"].data)) & ((1 << V3_BITS) - 1)
        s = (s / 1e6).astype(f)
        med = (s[g.start + (g.size - 1) // 2] + s[g.start + g.size // 2]) / f(2)
        mu = mean(g, v3)
        dev = v3 - mu[g.gid]
        with np.errstate(invalid="ignore", divide="ignore"):
            sd = np.sqrt(g.sum(dev * dev) / (g.size - 1).astype(f))
        return [key(g, "id4"), key(g, "id5"), fl("median_v3", med),
                fl("sd_v3", np.where(g.size > 1, sd, np.nan))]

    def q7():
        g = by("id3")
        return [key(g, "id3"), RefCol("range_v1_v2", "int",
                                      g.extreme(v1, True) - g.extreme(v2, False))]

    def q8():
        # descending v3 within id6: one sort of (id6, -v3)
        top = (1 << V3_BITS) - 1
        s = np.sort((x["id6"].data << V3_BITS) | (top - _v3_units(x["v3"].data)))
        id6 = s >> V3_BITS
        first = np.r_[True, id6[1:] != id6[:-1]]
        second = np.r_[False, first[:-1]] & ~first
        keep = first | second
        return [RefCol("id6", "int", id6[keep]),
                RefCol("largest2_v3", "float", (top - (s[keep] & top)) / 1e6, exact=True)]

    def q9():
        g = by("id2", "id4")
        if precision == "exact":
            nn = g.size
            sx, sy = g.sum(v1), g.sum(v2)
            num = (nn * g.sum(v1 * v2) - sx * sy).astype(np.float64)
            dx = (nn * g.sum(v1 * v1) - sx * sx).astype(np.float64)
            dy = (nn * g.sum(v2 * v2) - sy * sy).astype(np.float64)
        else:
            a, b = v1.astype(f), v2.astype(f)
            nn = g.size.astype(f)
            sx, sy = g.sum(a), g.sum(b)
            num = nn * g.sum(a * b) - sx * sy
            dx = nn * g.sum(a * a) - sx * sx
            dy = nn * g.sum(b * b) - sy * sy
        with np.errstate(invalid="ignore", divide="ignore"):
            r2 = num * num / (dx * dy)
        return [key(g, "id2"), key(g, "id4"), fl("r2", r2)]

    def q10():
        g = by("id1", "id2", "id3", "id4", "id5", "id6")
        return [key(g, c) for c in ("id1", "id2", "id3", "id4", "id5", "id6")] + [
            fl("v3", g.sum(v3)), RefCol("cnt", "int", g.size)]

    fns = {f"q{i}": fn for i, fn in enumerate(
        (q1, q2, q3, q4, q5, q6, q7, q8, q9, q10), start=1)}
    return {name: Answer(fns[name](), order=[]) for name in names}

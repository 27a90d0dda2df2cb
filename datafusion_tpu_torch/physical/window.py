"""Window functions.

Port of datafusion_tpu/physical/window.py to eager torch ops: one multi-key
sort per distinct (PARTITION BY, ORDER BY, frame) window, segment ids for
partitions, peer-run ids for RANGE frames, segmented prefix scans for running
aggregates, then an inverse-permutation gather back to the input row order
(a window keeps its input's rows and order).

Where the reference reduces over partitions with a scatter, this port uses a
scan wherever the rows are sorted by partition: a partition's first row is
the last position at or before a row that starts one, and its row count is
the distance to the next start (no atomics over the sorted rows). The
reference finds such positions with cummax/cummin of positions; here they
come from a cumsum of the marks and a table of the marked positions. The
reference's `jax.lax.associative_scan` (segmented running min/max) becomes
a log-step doubling scan of torch ops, exact for min and max (NaN
propagates as torch.maximum/minimum propagate it, as jnp.maximum/minimum
do).

WindowTopKExec fuses a rank filter over a single ranking window into one sort,
a segmented rank, and one compaction of the survivors; its survivor capacity
is discovered with one host read and guarded by an overflow flag in a steady
state (physical/fused.py).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..common import types as T
from ..common.errors import PlanError
from ..common.schema import Schema
from ..data.device import DeviceColumn, DeviceRelation, bucket_capacity, torch_dtype
from ..expr import nodes as E
from ..expr.typing import infer
from ..ops import kernels as K
from .expr_compiler import eval_expr, eval_predicate, unify_string_columns
from .plan import PhysicalPlan, _column_leaves, _with_leaves


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _first_row_mask(n: int, device) -> torch.Tensor:
    """[True, False, ...]: made on the device (a host scalar copied in would
    be a sync a CUDA graph capture refuses)."""
    return _iota(n, device) == 0


def _marks(mark: torch.Tensor):
    """(c, pos): c[i] = marks at or before position i (inclusive count);
    pos[r] = position of the r-th mark, for r below the mark count (the
    other slots are never read). A cumsum and a scatter to unique slots:
    torch.cummax/cummin take several ms per 2^21 rows on an H100."""
    n = mark.shape[0]
    iota = _iota(n, mark.device)
    c = torch.cumsum(mark, 0, dtype=torch.int64)
    slot = torch.where(mark, c - 1, n)  # unmarked rows park on slot n
    pos = torch.zeros(n + 1, dtype=torch.int64, device=mark.device).scatter_(0, slot, iota)
    return c, pos


def _last_at_or_before(mark: torch.Tensor, none: int) -> torch.Tensor:
    """For each position, the last position <= it where `mark` holds, or
    `none` (int64): the reference's cummax(where(mark, iota, none))."""
    c, pos = _marks(mark)
    r = c - 1
    return torch.where(r >= 0, pos[torch.clamp(r, min=0)], none)


def _next_at_or_after(mark: torch.Tensor, none: int) -> torch.Tensor:
    """For each position, the first position >= it where `mark` holds, or
    `none` (int64): the reference's reversed cummin."""
    n = mark.shape[0]
    c, pos = _marks(mark)
    r = c - mark.to(torch.int64)  # marks strictly before: the next one's rank
    return torch.where(r < c[-1], pos[torch.clamp(r, max=n - 1)], none)


def _seg_cumsum(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum resetting at segment starts."""
    cs = torch.cumsum(x, 0, dtype=x.dtype if x.dtype.is_floating_point else torch.int64)
    excl = cs - x
    return cs - excl[_last_at_or_before(seg_start, 0)]


def _range_reduce(x: torch.Tensor, fs: torch.Tensor, fe: torch.Tensor,
                  empty: torch.Tensor, is_min: bool, ident) -> torch.Tensor:
    """Per-row min/max over arbitrary index ranges [fs, fe]: binary
    decomposition over doubling levels (level_b[i] reduces [i, i + 2^b));
    each row consumes bit b of its range length, walking its cursor
    forward. O(n log n) work, O(n) memory live."""
    cap = x.shape[0]
    op = torch.minimum if is_min else torch.maximum
    iota = _iota(cap, x.device)
    level = x
    acc = torch.full_like(x, ident)
    cur = fs
    length = torch.where(empty, 0, fe - fs + 1)
    for b in range(max(1, cap.bit_length())):
        take = ((length >> b) & 1) == 1
        val = level[torch.clamp(cur, 0, cap - 1)]
        acc = torch.where(take, op(acc, val), acc)
        cur = torch.where(take, cur + (1 << b), cur)
        if (1 << (b + 1)) > cap:
            break
        nxt = iota + (1 << b)
        shifted = torch.where(nxt < cap, level[torch.clamp(nxt, 0, cap - 1)],
                              torch.full_like(level, ident))
        level = op(level, shifted)
    return acc


def _first_where(k: torch.Tensor, target: torch.Tensor, lo0: torch.Tensor,
                 hi0: torch.Tensor, op: str) -> torch.Tensor:
    """Vectorized per-row binary search: the first index j in [lo0, hi0)
    where `k[j] <op> target` holds, the predicate being monotone false ->
    true over the range (k sorted). hi0 when it never holds."""
    cap = k.shape[0]
    cmp = {"ge": torch.ge, "gt": torch.gt, "le": torch.le, "lt": torch.lt}[op]
    lo, hi = lo0, hi0
    for _ in range(cap.bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        cond = cmp(k[torch.clamp(mid, 0, cap - 1)], target)
        hi = torch.where(active & cond, mid, hi)
        lo = torch.where(active & ~cond, mid + 1, lo)
    return lo


def _sort_keys(pcols, ocols, order_by):
    keys = [(c.data, c.validity, False, False, c.sort_bounds()) for c in pcols]
    keys += [(c.data, c.validity, not s.asc, s.nulls_first, c.sort_bounds())
             for c, s in zip(ocols, order_by)]
    return keys


def _sorted_keys(rel: DeviceRelation, pcols, ocols, perm):
    """(sorted sel, sorted partition columns, sorted order columns)."""
    flat = [rel.sel]
    for c in pcols + ocols:
        flat.append(c.data)
        if c.validity is not None:
            flat.append(c.validity)
    flat = K.gather_rows(flat, perm)
    ssel, flat = flat[0], flat[1:]
    sp, so, j = [], [], 0
    for c in pcols + ocols:
        data = flat[j]
        j += 1
        validity = None
        if c.validity is not None:
            validity = flat[j]
            j += 1
        (sp if len(sp) < len(pcols) else so).append(
            DeviceColumn(data, validity, c.dtype, c.dictionary))
    return ssel, sp, so


def _avg_column(s, c, argc: DeviceColumn, out_t: T.DataType, ssel) -> DeviceColumn:
    cntf = torch.clamp(c, min=1).to(torch.float64)
    if argc.dtype.is_decimal and out_t.is_decimal:
        num = s.to(torch.float64) * (10.0 ** (out_t.scale - argc.dtype.scale))
        return DeviceColumn(torch.trunc(num / cntf).to(torch.int64), (c > 0) & ssel, out_t)
    arg_scale = 10.0 ** argc.dtype.scale if argc.dtype.is_decimal else 1.0
    a = (s.to(torch.float64) / arg_scale) / cntf
    return DeviceColumn(a, (c > 0) & ssel, T.FLOAT64)


class WindowExec(PhysicalPlan):
    def __init__(self, input: PhysicalPlan, window_exprs: Sequence[E.Expr], schema: Schema):
        self.input = input
        self.window_exprs = tuple(window_exprs)
        self.schema = schema

    def children(self):
        return (self.input,)

    def execute(self, ctx):
        return self._timed(ctx, self._transform, self.input.execute(ctx))

    def _line(self):
        return f"WindowExec: {[e.name() for e in self.window_exprs]}"

    # ------------------------------------------------------------------
    def _transform(self, rel: DeviceRelation) -> DeviceRelation:
        # group window exprs by (partition_by, order_by, frame)
        groups: Dict[Tuple, List[Tuple[int, E.WindowFunction]]] = {}
        for i, e in enumerate(self.window_exprs):
            w = e.expr if isinstance(e, E.Alias) else e
            if not isinstance(w, E.WindowFunction):
                raise PlanError(f"not a window function: {e!r}")
            key = (w.partition_by, w.order_by, _norm_frame(w.frame))
            groups.setdefault(key, []).append((i, w))

        results: Dict[int, DeviceColumn] = {}
        for (partition_by, order_by, frame), members in groups.items():
            results.update(self._eval_window_group(rel, partition_by, order_by,
                                                   frame, members))
        cols = list(rel.columns) + [results[i] for i in range(len(self.window_exprs))]
        return DeviceRelation(self.schema, tuple(cols), rel.sel)

    def _eval_window_group(self, rel, partition_by, order_by, frame, members):
        cap = rel.capacity
        dev = rel.device
        pcols = [eval_expr(p, rel) for p in partition_by]
        ocols = [eval_expr(s.expr, rel) for s in order_by]
        perm = K.sort_permutation(_sort_keys(pcols, ocols, order_by), rel.sel)
        iota = _iota(cap, dev)
        # the inverse permutation: a scatter with unique indices
        inv = torch.empty_like(perm).scatter_(0, perm, iota)
        ssel, sp, so = _sorted_keys(rel, pcols, ocols, perm)

        if sp:
            seg, seg_start, _ = K.segments_from_sorted_keys(
                [c.data for c in sp], [c.validity for c in sp], ssel)
        else:
            seg = torch.where(ssel, 0, cap - 1).to(torch.int32)
            seg_start = _first_row_mask(cap, dev)
        # peer runs: equal on partition + order keys
        if so:
            _, peer_start, _ = K.segments_from_sorted_keys(
                [c.data for c in sp] + [c.data for c in so],
                [c.validity for c in sp] + [c.validity for c in so], ssel)
        else:
            peer_start = seg_start

        # partition first row and row count, by scans over the sorted rows
        # (live rows first, partitions contiguous): the last partition start
        # at or before a row, and the next start (or the first dead row) after it
        my_first = _last_at_or_before(seg_start, 0)
        nxt = _next_at_or_after(seg_start | ~ssel, cap)
        part_end = torch.cat([nxt[1:], nxt.new_full((1,), cap)])
        my_count = torch.where(ssel, part_end - my_first, 0)
        row_in_part = iota - my_first

        # rank support: position of the current peer-run start
        last_peer_start = _last_at_or_before(peer_start, 0)
        rank_sorted = last_peer_start - my_first + 1
        dense_sorted = _seg_cumsum(peer_start.to(torch.int64), seg_start)

        # peer-run end position (RANGE ... CURRENT ROW frames). A live row is
        # a peer end when the next row starts a new peer run or is dead: dead
        # rows never carry peer_start, so without the liveness term the last
        # live peer run would end at the dead slot cap-1
        ones = torch.ones(1, dtype=torch.bool, device=dev)
        nxt_start = torch.cat([peer_start[1:], ones])
        nxt_live = torch.cat([ssel[1:], ~ones])
        is_peer_end = ssel & (nxt_start | ~nxt_live)
        peer_end = _next_at_or_after(is_peer_end, cap + 1)

        fs = fe = fempty = None
        if frame is not None:
            fs, fe, fempty = self._frame_bounds(
                frame, so, order_by, ssel, peer_start, last_peer_start, peer_end,
                iota, my_first, my_count, cap)

        out: Dict[int, DeviceColumn] = {}
        for idx, w in members:
            col = self._one_fn(w, rel, perm, ssel, seg, seg_start, peer_start, peer_end,
                               row_in_part, my_count, rank_sorted, dense_sorted, cap,
                               fs, fe, fempty)
            validity = None if col.validity is None else col.validity[inv]
            out[idx] = DeviceColumn(col.data[inv], validity, col.dtype, col.dictionary)
        return out

    def _frame_bounds(self, frame, so, order_by, ssel, peer_start,
                      last_peer_start, peer_end, iota, my_first, my_count, cap):
        """Per-row frame bounds [fs, fe] as sorted positions, plus an
        empty-frame mask. ROWS = index arithmetic; GROUPS = peer-run id
        lookups; RANGE offsets = vectorized binary search on the sorted
        order key."""
        part_first = my_first
        part_last = part_first + my_count - 1
        u = frame.units

        if u == "rows":
            def bound(kind, off, is_start):
                if kind == "unbounded_preceding":
                    return part_first
                if kind == "unbounded_following":
                    return part_last
                if kind == "current_row":
                    return iota
                n = int(off)
                return iota - n if kind == "preceding" else iota + n
        elif u == "groups":
            rid = torch.cumsum(peer_start, 0, dtype=torch.int64) - 1
            i32 = iota.to(torch.int32)
            run_start = K.segment_min(i32, rid, ssel, cap)
            run_end = K.segment_max(i32, rid, ssel, cap)
            rid_first = rid[torch.clamp(part_first, 0, cap - 1)]
            rid_last = rid[torch.clamp(part_last, 0, cap - 1)]

            def bound(kind, off, is_start):
                if kind == "unbounded_preceding":
                    return part_first
                if kind == "unbounded_following":
                    return part_last
                if kind == "current_row":
                    return last_peer_start if is_start else peer_end
                n = int(off)
                tgt = rid - n if kind == "preceding" else rid + n
                arr = run_start if is_start else run_end
                pos = arr[torch.clamp(tgt, 0, cap - 1)].to(torch.int64)
                # target run before the partition: clamp (start) / empty (end)
                pos = torch.where(tgt < rid_first,
                                  part_first if is_start else part_first - 1, pos)
                # target run after the partition: empty (start) / clamp (end)
                pos = torch.where(tgt > rid_last,
                                  part_last + 1 if is_start else part_last, pos)
                return pos
        else:  # range
            def bound(kind, off, is_start):
                if kind == "unbounded_preceding":
                    return part_first
                if kind == "unbounded_following":
                    return part_last
                if kind == "current_row":
                    return last_peer_start if is_start else peer_end
                if len(order_by) != 1:
                    raise PlanError(
                        "RANGE frame with offset requires exactly one ORDER BY key")
                c = so[0]
                spec = order_by[0]
                if c.dtype.is_decimal:
                    n = int(round(float(off) * (10.0 ** c.dtype.scale)))
                else:
                    n = float(off) if isinstance(off, float) else int(off)
                k = c.data
                if isinstance(n, float) and not k.dtype.is_floating_point:
                    k = k.to(torch.float64)
                valid = c.validity
                asc, nf = spec.asc, spec.nulls_first
                if valid is not None:
                    # park null keys at the end they sort to, so the key stays
                    # monotone within each partition
                    null_low = (asc and nf) or (not asc and not nf)
                    if k.dtype.is_floating_point:
                        sent = -float("inf") if null_low else float("inf")
                    else:
                        info = torch.iinfo(k.dtype)
                        sent = info.min if null_low else info.max
                    k = torch.where(valid, k, torch.full_like(k, sent))
                if asc:
                    tgt = k + (n if kind == "following" else -n)
                    op = "ge" if is_start else "gt"
                else:
                    tgt = k + (n if kind == "preceding" else -n)
                    op = "le" if is_start else "lt"
                pos = _first_where(k, tgt, part_first, part_last + 1, op)
                if not is_start:
                    pos = pos - 1
                if valid is not None:
                    # a NULL current row's RANGE frame is its peer (null) run
                    pos = torch.where(valid, pos,
                                      last_peer_start if is_start else peer_end)
                return pos

        fs = torch.maximum(bound(frame.start_kind, frame.start_offset, True), part_first)
        fe = torch.minimum(bound(frame.end_kind, frame.end_offset, False), part_last)
        fempty = (fs > fe) | ~ssel
        return fs, fe, fempty

    def _one_fn(self, w, rel, perm, ssel, seg, seg_start, peer_start, peer_end,
                row_in_part, my_count, rank_sorted, dense_sorted, G,
                fs=None, fe=None, fempty=None):
        cap = rel.capacity
        f = w.fname
        out_t, _ = infer(w, rel.schema)
        iota = _iota(cap, rel.device)

        wfilter = getattr(w, "filter", None)
        if wfilter is not None and f in (
                "row_number", "rank", "dense_rank", "percent_rank",
                "cume_dist", "ntile", "lead", "lag", "nth_value",
                "first_value", "last_value"):
            raise PlanError(
                f"FILTER (WHERE ...) is not allowed for window function {f!r}")

        if f == "row_number":
            return DeviceColumn(row_in_part + 1, None, T.INT64)
        if f == "rank":
            return DeviceColumn(rank_sorted, None, T.INT64)
        if f == "dense_rank":
            return DeviceColumn(dense_sorted, None, T.INT64)
        if f == "percent_rank":
            d = torch.clamp(my_count - 1, min=1).to(torch.float64)
            return DeviceColumn((rank_sorted - 1).to(torch.float64) / d, None, T.FLOAT64)
        if f == "cume_dist":
            covered = (peer_end - (iota - row_in_part) + 1).to(torch.float64)
            return DeviceColumn(covered / torch.clamp(my_count, min=1).to(torch.float64),
                                None, T.FLOAT64)
        if f == "ntile":
            n = int(_lit(w.args[0]))
            cnt = torch.clamp(my_count, min=1)
            size = cnt // n          # small-bucket size
            big = cnt % n            # the first `big` buckets hold size+1 rows
            cut = big * (size + 1)
            bucket = torch.where(
                row_in_part < cut,
                row_in_part // torch.clamp(size + 1, min=1),
                big + (row_in_part - cut) // torch.clamp(size, min=1)) + 1
            return DeviceColumn(bucket, None, T.INT64)

        def _valid_lookup(ok):
            """Sorted-order lookup of valid rows (IGNORE NULLS): W[g] = row
            index of the g-th valid row; B = valids before this partition;
            ca = valids at or before each row within its partition; total =
            valids per partition."""
            okl = ok.to(torch.int64)
            g_incl = torch.cumsum(okl, 0)
            gi = torch.where(ok, g_incl - 1, cap)
            # slot cap takes every invalid row (the reference drops them)
            W = torch.zeros(cap + 1, dtype=torch.int64, device=ok.device
                            ).scatter_(0, gi, iota)[:cap]
            part_first = torch.clamp(iota - row_in_part, 0, cap - 1)
            B = (g_incl - okl)[part_first]
            ca = g_incl - B
            last = torch.clamp(part_first + torch.clamp(my_count, min=1) - 1, 0, cap - 1)
            total = g_incl[last] - B
            return W, B, ca, total

        if f in ("lead", "lag"):
            argc = eval_expr(w.args[0], rel)
            sdata = argc.data[perm]
            svalid = argc.valid()[perm]
            off = int(_lit(w.args[1])) if len(w.args) > 1 else 1
            if getattr(w, "ignore_nulls", False):
                ok = svalid & ssel
                W, B, ca, total = _valid_lookup(ok)
                if f == "lag":
                    local = (ca - ok.to(torch.int64)) - off
                    hit = (local >= 0) & ssel
                else:
                    local = ca + off - 1
                    hit = (local < total) & ssel
                row = W[torch.clamp(B + local, 0, cap - 1)]
                rowc = torch.clamp(row, 0, cap - 1)
                data = torch.where(hit, sdata[rowc], torch.zeros_like(sdata))
                valid = hit & ssel
                dictionary = argc.dictionary
                if len(w.args) > 2:
                    dc = eval_expr(w.args[2], rel)
                    if argc.dtype.is_string or dc.dtype.is_string:
                        uc, dc = unify_string_columns(argc, dc)
                        sdata = uc.data[perm]
                        data = torch.where(hit, sdata[rowc], torch.zeros_like(sdata))
                        dictionary = uc.dictionary
                    dflt = dc.data[perm]
                    data = torch.where(hit, data, dflt.to(data.dtype))
                    valid = torch.where(hit, True, dc.valid()[perm]) & ssel
                return DeviceColumn(data, valid, argc.dtype, dictionary)
            src = iota + (off if f == "lead" else -off)
            in_range = (src >= 0) & (src < cap)
            srcc = torch.clamp(src, 0, cap - 1)
            same_part = seg[srcc] == seg
            valid = in_range & same_part & svalid[srcc] & ssel
            data = torch.where(in_range, sdata[srcc], torch.zeros_like(sdata))
            dictionary = argc.dictionary
            if len(w.args) > 2:  # default value (may be NULL or a string)
                dc = eval_expr(w.args[2], rel)
                if argc.dtype.is_string or dc.dtype.is_string:
                    uc, dc = unify_string_columns(argc, dc)
                    sdata = uc.data[perm]
                    svalid = uc.valid()[perm]
                    data = torch.where(in_range, sdata[srcc], torch.zeros_like(sdata))
                    dictionary = uc.dictionary
                dflt = dc.data[perm]
                dvalid = dc.valid()[perm]
                hit = in_range & same_part
                data = torch.where(hit, data, dflt.to(data.dtype))
                valid = torch.where(hit, svalid[srcc], dvalid) & ssel
            return DeviceColumn(data, valid, argc.dtype, dictionary)

        # aggregates over the window
        argc = eval_expr(w.args[0], rel) if w.args else None
        has_order = len(w.order_by) > 0

        if f == "count" and argc is None:
            x = ssel.to(torch.int64)
        elif argc is not None:
            x = argc.data[perm]
        else:
            raise PlanError(f"window function {f} needs an argument")
        avalid = (argc.valid()[perm] & ssel) if argc is not None else ssel
        if wfilter is not None:
            # FILTER (WHERE pred): rows where pred is not TRUE contribute
            # nothing (NULL-argument semantics), but still receive output
            avalid = avalid & eval_predicate(wfilter, rel)[perm]

        if getattr(w, "ignore_nulls", False) and f in ("first_value", "last_value"):
            # first/last NON-NULL within [partition start, last peer]
            if fs is not None:
                raise PlanError(
                    f"IGNORE NULLS with an explicit frame is not supported for {f!r}")
            W, B, ca, total = _valid_lookup(avalid)
            ca_pe = ca[torch.clamp(peer_end, 0, cap - 1)]
            hit = (ca_pe > 0) & ssel
            local = torch.zeros_like(ca_pe) if f == "first_value" else ca_pe - 1
            row = W[torch.clamp(B + local, 0, cap - 1)]
            data = torch.where(hit, x[torch.clamp(row, 0, cap - 1)], torch.zeros_like(x))
            return DeviceColumn(data, hit, argc.dtype, argc.dictionary)
        if getattr(w, "ignore_nulls", False):
            raise PlanError(f"IGNORE NULLS is not supported for {f!r}")

        if f == "nth_value" and fs is None:
            # default frame: partition start .. last peer of the current row
            fs = iota - row_in_part
            fe = peer_end
            fempty = ~ssel
        if fs is not None:
            return self._frame_agg(f, w, argc, x, avalid, ssel, fs, fe, fempty, out_t)

        if f == "first_value":
            # the frame starts at the partition's first row; its value
            # counts even when NULL (default-frame semantics)
            my = torch.clamp(iota - row_in_part, 0, cap - 1)
            return DeviceColumn(x[my], avalid[my] & ssel, argc.dtype, argc.dictionary)
        if f == "last_value":
            # default frame: up to the last peer of the current row
            idx = torch.clamp(peer_end, 0, cap - 1)
            return DeviceColumn(x[idx], avalid[idx] & ssel, argc.dtype, argc.dictionary)

        pe = torch.clamp(peer_end, 0, cap - 1)
        segc = torch.clamp(seg.to(torch.int64), 0, G - 1)
        if f in ("sum", "avg", "count", "min", "max"):
            if f in ("min", "max"):
                ident = K._max_ident(x.dtype) if f == "min" else K._min_ident(x.dtype)
                xm = torch.where(avalid, x, torch.full_like(x, ident))
                if has_order:
                    op = torch.minimum if f == "min" else torch.maximum
                    vals = K.segmented_scan(lambda a, b: [op(a[0], b[0])],
                                            seg_start, [xm])[0][pe]
                    nonzero = _seg_cumsum(avalid.to(torch.int64), seg_start)[pe] > 0
                else:
                    red = K.segment_min if f == "min" else K.segment_max
                    vals = red(x, seg, avalid, G)[segc]
                    nonzero = K.segment_count(seg, avalid, G)[segc] > 0
                return DeviceColumn(vals, nonzero & ssel, argc.dtype, argc.dictionary)
            acc = torch.where(avalid, x, torch.zeros_like(x))
            if acc.dtype is torch.bool:
                acc = acc.to(torch.int64)
            if has_order:
                s = _seg_cumsum(acc, seg_start)[pe]
                c = _seg_cumsum(avalid.to(torch.int64), seg_start)[pe]
            else:
                s = K.segment_sum(acc, seg, avalid, G)[segc]
                c = K.segment_count(seg, avalid, G)[segc]
            if f == "count":
                return DeviceColumn(c.to(torch.int64), None, T.INT64)
            if f == "avg":
                return _avg_column(s, c, argc, out_t, ssel)
            return DeviceColumn(s.to(torch_dtype(out_t)), (c > 0) & ssel, out_t)

        from ..expr.udf import active_registry, running_monoid_scan, udf_input_array

        reg = active_registry()
        udwf = reg.window(f) or reg.aggregate(f)
        if udwf is not None:
            xin = udf_input_array(
                DeviceColumn(x, None, argc.dtype, argc.dictionary)
                if argc is not None else DeviceColumn(x, None, T.INT64))
            # the default frame: the partition's start to the current row's
            # last peer (RANGE), or to the partition's end without ORDER BY
            idx = pe if has_order else torch.clamp(
                iota - row_in_part + my_count - 1, 0, cap - 1)
            vals = running_monoid_scan(udwf, xin, avalid, seg_start, idx)
            nonzero = _seg_cumsum(avalid.to(torch.int64), seg_start)[idx] > 0
            validity = (nonzero & ssel) if udwf.nullable else None
            return DeviceColumn(vals.to(torch_dtype(udwf.return_type)), validity,
                                udwf.return_type)
        raise PlanError(f"window function {f!r} not implemented")

    def _frame_agg(self, f, w, argc, x, avalid, ssel, fs, fe, fempty, out_t):
        """Aggregate over explicit per-row frames [fs, fe] (sorted positions):
        sum/count/avg by inclusive prefix-sum differences (frames never cross
        partitions, so one cumsum serves), min/max by _range_reduce,
        first/last/nth_value by direct indexing."""
        cap = x.shape[0]
        live = ~fempty
        fsc = torch.clamp(fs, 0, cap - 1)
        fec = torch.clamp(fe, 0, cap - 1)
        iota = _iota(cap, x.device)

        av = avalid.to(torch.int64)
        cnt_cs = torch.cumsum(av, 0)
        c = torch.where(live, cnt_cs[fec] - cnt_cs[fsc] + av[fsc], 0)

        if f in ("sum", "avg", "count"):
            acc = torch.where(avalid, x, torch.zeros_like(x))
            if acc.dtype is torch.bool:
                acc = acc.to(torch.int64)
            cs = torch.cumsum(acc, 0, dtype=acc.dtype if acc.dtype.is_floating_point
                              else torch.int64)
            s = torch.where(live, cs[fec] - cs[fsc] + acc[fsc], torch.zeros_like(cs))
            if f == "count":
                return DeviceColumn(c, None, T.INT64)
            if f == "avg":
                return _avg_column(s, c, argc, out_t, ssel)
            return DeviceColumn(s.to(torch_dtype(out_t)), (c > 0) & ssel, out_t)

        if f in ("min", "max"):
            ident = K._max_ident(x.dtype) if f == "min" else K._min_ident(x.dtype)
            xm = torch.where(avalid, x, torch.full_like(x, ident))
            vals = _range_reduce(xm, fs, fe, fempty, f == "min", ident)
            return DeviceColumn(vals, (c > 0) & ssel, argc.dtype, argc.dictionary)

        if f in ("first_value", "last_value"):
            # first/last *valid* value inside the frame (NaN/NULL arguments
            # are skipped, as on the default-frame path)
            if f == "first_value":
                idx = _next_at_or_after(avalid, cap + 1)[fsc]
                ok = live & (idx <= fe)
            else:
                idx = _last_at_or_before(avalid, -1)[fec]
                ok = live & (idx >= fs)
            idxc = torch.clamp(idx, 0, cap - 1)
            return DeviceColumn(x[idxc], ok & ssel, argc.dtype, argc.dictionary)

        if f == "nth_value":
            n = int(_lit(w.args[1]))
            idx = fs + (n - 1)
            ok = live & (idx <= fe)
            idxc = torch.clamp(idx, 0, cap - 1)
            return DeviceColumn(x[idxc], ok & avalid[idxc] & ssel,
                                argc.dtype, argc.dictionary)

        raise PlanError(f"window function {f!r} not supported with an explicit frame")


def _norm_frame(frame):
    """Fold a frame equal to the SQL default (RANGE UNBOUNDED PRECEDING ..
    CURRENT ROW) to None so it shares the default path."""
    if frame is not None and (frame.units, frame.start_kind, frame.end_kind) == (
            "range", "unbounded_preceding", "current_row"):
        return None
    return frame


def _lit(e: E.Expr):
    if isinstance(e, E.Literal):
        return e.value
    raise PlanError("expected literal window argument")


class WindowTopKExec(PhysicalPlan):
    """Per-group top-k: Filter(rank predicate) over Window(one rank
    function), fused into one sort, a segmented rank and one compaction of
    the survivors, which come out sorted by (partition, order).

    Discovery records the survivor capacity (`_last_cap`, one host read); a
    steady state applies it and flags more survivors than it holds."""

    RANK_FNS = ("row_number", "rank", "dense_rank")

    def __init__(self, input: PhysicalPlan, wexpr: E.Expr, op: E.Op, k: int,
                 schema: Schema):
        self.input = input
        self.wexpr = wexpr  # Alias(WindowFunction) | WindowFunction
        self.op = op        # E.Op.LE / LT / EQ over the rank value
        self.k = int(k)
        self.schema = schema
        self._last_cap = None

    def children(self):
        return (self.input,)

    @property
    def wfn(self) -> E.WindowFunction:
        return self.wexpr.expr if isinstance(self.wexpr, E.Alias) else self.wexpr

    def _line(self):
        return (f"WindowTopKExec: {self.wfn.fname} {self.op.value} {self.k} "
                f"cap={self._last_cap}")

    def _phase1(self, rel: DeviceRelation):
        """(perm, rank in sorted order, survivor mask in sorted order); perm
        maps a sorted position to its input row."""
        w = self.wfn
        cap = rel.capacity
        pcols = [eval_expr(p, rel) for p in w.partition_by]
        ocols = [eval_expr(s.expr, rel) for s in w.order_by]
        perm = K.sort_permutation(_sort_keys(pcols, ocols, w.order_by), rel.sel)
        ssel, sp, so = _sorted_keys(rel, pcols, ocols, perm)
        if sp:
            _, seg_start, _ = K.segments_from_sorted_keys(
                [c.data for c in sp], [c.validity for c in sp], ssel)
        else:
            seg_start = _first_row_mask(cap, rel.device)
        iota = _iota(cap, rel.device)
        if w.fname == "row_number":
            rank = _seg_cumsum(torch.ones(cap, dtype=torch.int64, device=rel.device),
                               seg_start)
        else:
            if so:
                _, peer_start, _ = K.segments_from_sorted_keys(
                    [c.data for c in sp + so], [c.validity for c in sp + so], ssel)
            else:
                peer_start = seg_start
            if w.fname == "dense_rank":
                rank = _seg_cumsum(peer_start.to(torch.int64), seg_start)
            else:  # rank
                last_seg = _last_at_or_before(seg_start, 0)
                last_peer = _last_at_or_before(peer_start, 0)
                rank = last_peer - last_seg + 1
        if self.op is E.Op.LE:
            keep = rank <= self.k
        elif self.op is E.Op.LT:
            keep = rank < self.k
        else:
            keep = rank == self.k
        return perm, rank, keep & ssel

    def _apply(self, rel: DeviceRelation, perm, rank, keep, cap: int) -> DeviceRelation:
        """The first `cap` survivors (in sorted order) gathered from the
        input, with their rank as the last column; survivors past `cap` are
        dropped (a steady state flags them)."""
        idx, total = K.compaction_indices(keep, cap)
        src = perm[idx]  # the input row of each survivor
        cols = [_with_leaves(c, {k: v[src] for k, v in _column_leaves(c).items()})
                for c in rel.columns]
        cols.append(DeviceColumn(rank[idx], None, T.INT64))
        sel = torch.arange(cap, device=rel.device) < torch.clamp(total, max=cap)
        return DeviceRelation(self.schema, tuple(cols), sel)

    def execute(self, ctx) -> DeviceRelation:
        rel = self.input.execute(ctx)
        perm, rank, keep = self._phase1(rel)
        live = int(keep.sum())  # one host read sizes the output
        cap = bucket_capacity(max(live, 1))
        if self._last_cap is not None:
            cap = max(cap, self._last_cap)
        cap = min(cap, rel.capacity)
        self._last_cap = cap
        return self._timed(ctx, self._apply, rel, perm, rank, keep, cap)


def rewrite_window_topk(filter_exec):
    """FilterExec(rank comparison) over [Alias/Projection...] over WindowExec
    (one rank function) -> the same chain over WindowTopKExec. The predicate
    column must trace to the window's rank output through column renames
    only. None when the pattern does not apply."""
    from . import plan as P
    from .planner import AliasExec

    pred = filter_exec.predicate
    if not isinstance(pred, E.BinaryOp) or not pred.op.is_comparison:
        return None
    left, right, op = pred.left, pred.right, pred.op
    flip = {E.Op.GT: E.Op.LT, E.Op.GE: E.Op.LE, E.Op.LT: E.Op.GT,
            E.Op.LE: E.Op.GE, E.Op.EQ: E.Op.EQ}
    if isinstance(right, E.Column) and isinstance(left, E.Literal):
        left, right, op = right, left, flip[op]
    if not (isinstance(left, E.Column) and isinstance(right, E.Literal)):
        return None
    if not isinstance(right.value, int) or isinstance(right.value, bool):
        return None
    k = int(right.value)
    if op is E.Op.EQ and k != 1:
        # rank = k keeps a non-prefix slice; only the k=1 form is a top-k
        return None
    if op not in (E.Op.LE, E.Op.LT, E.Op.EQ):
        return None

    # trace the predicate column down through rename-only layers
    node = filter_exec.input
    try:
        idx = node.schema.find(left.flat_name)
        if idx is None:
            idx = node.schema.find(left.cname)
    except PlanError:
        idx = None
    if idx is None:
        return None
    chain = []  # outermost-first rename layers to re-apply above the top-k
    while True:
        if isinstance(node, AliasExec):
            chain.append(node)
            node = node.input
            continue
        if isinstance(node, P.ProjectionExec):
            e = node.exprs[idx]
            base = e.expr if isinstance(e, E.Alias) else e
            if not isinstance(base, E.Column):
                return None
            try:
                nidx = node.input.schema.find(base.flat_name)
                if nidx is None:
                    nidx = node.input.schema.find(base.cname)
            except PlanError:
                return None
            if nidx is None:
                return None
            chain.append(node)
            node, idx = node.input, nidx
            continue
        break
    w = node
    if not isinstance(w, WindowExec) or len(w.window_exprs) != 1:
        return None
    if idx != len(w.schema) - 1:
        return None  # the filtered column is not the window output
    wexpr = w.window_exprs[0]
    wf = wexpr.expr if isinstance(wexpr, E.Alias) else wexpr
    if not isinstance(wf, E.WindowFunction) or wf.fname not in WindowTopKExec.RANK_FNS:
        return None
    if _norm_frame(wf.frame) is not None:
        return None
    cur = WindowTopKExec(w.input, wexpr, op, k, w.schema)
    for n in reversed(chain):
        if isinstance(n, AliasExec):
            cur = AliasExec(cur, n.schema)
        else:
            cur = P.ProjectionExec(cur, n.exprs, n.schema)
    return cur

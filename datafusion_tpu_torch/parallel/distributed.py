"""Distributed execution over a mesh of shards.

Port of datafusion_tpu/parallel/distributed.py (the reference's exchange
parallelism: RepartitionExec, physical-plan/src/repartition/mod.rs:1196, and
the Partial/Final aggregate split, aggregates/mod.rs:282). The JAX package
runs one `shard_map` program over a `jax.sharding.Mesh`; here one process
drives `n` shards, shard i living on `mesh.shard_devices[i]`, and every
per-shard value is a list of n tensors. The collectives are explicit tensor
moves and reductions over those lists:

* `all_to_all` -- the shuffle: shard j receives block j of every source's
  send buffer, in source order;
* `all_gather` -- every shard's tensor concatenated in shard-major order (the
  CollectLeft broadcast of a build side), made once per distinct device;
* `psum` / `pmin` / `pmax` -- elementwise reductions over the shards, made
  once per distinct device.

A move between shards on one device makes no copy; on several cards it is a
peer copy (`Tensor.to(device, non_blocking=True)`).

`exchange_by_key` routes rows to shard `hash % n` through bucketed send
buffers (seed-compatible with ops/kernels.hash64, so repartitioned data never
needs rehashing). `distributed_query_step` is the representative step the
reference dry-runs: filter -> broadcast join -> partial aggregate -> hash
exchange -> final aggregate -> global count.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.errors import ExecutionError
from ..ops import kernels as K


class Mesh:
    """n shards over a list of torch devices: shard i lives on
    devices[i % len(devices)]."""

    def __init__(self, devices: Sequence, n_shards: int, axis: str = "dp"):
        if not devices or n_shards < 1:
            raise ExecutionError("a mesh needs at least one device and one shard")
        self.devices = [torch.device(d) for d in devices]
        self.axis = axis
        self.shape = {axis: int(n_shards)}
        self.shard_devices = [self.devices[i % len(self.devices)]
                              for i in range(n_shards)]

    @property
    def n(self) -> int:
        return self.shape[self.axis]

    def __repr__(self) -> str:
        return f"Mesh({self.axis}={self.n}, devices={[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of n_devices shards (default: one per device). Without
    `devices` it takes the visible CUDA devices and raises when there is
    none; pass devices (e.g. ["cpu"], or [cuda:0] * 8 for eight shards on one
    card) to choose them."""
    if devices is None:
        if not torch.cuda.is_available():
            raise ExecutionError(
                "make_mesh: no CUDA device (torch.cuda.is_available() is "
                "False); pass devices=[...] (e.g. [\"cpu\"]) to build a mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = int(n_devices or len(devices))
    return Mesh(devices[:n] if n <= len(devices) else devices, n, axis)


def per_device(mesh: Mesh, fn, *shard_lists) -> list:
    """fn over the shards' items, called once per distinct device (the
    items of shards on one device must be the same replicated value); the
    result is a per-shard list whose entries repeat per device."""
    done: Dict[str, object] = {}
    out = []
    for i, d in enumerate(mesh.shard_devices):
        k = str(d)
        if k not in done:
            done[k] = fn(*(lst[i] for lst in shard_lists))
        out.append(done[k])
    return out


def all_to_all(bufs: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """bufs[i]: source i's send buffer [n, slot, ...]; returns, per
    destination j, the [n * slot, ...] concatenation of block j of every
    source in source order (jax.lax.all_to_all, split_axis=concat_axis=0)."""
    n = mesh.n
    devs = {str(d) for d in mesh.shard_devices}
    if len(devs) == 1:
        # one device: one transpose copy makes every destination's buffer
        t = torch.stack(list(bufs)).transpose(0, 1).contiguous()
        return list(t.reshape((n, n * t.shape[2]) + tuple(t.shape[3:])).unbind(0))
    out = []
    for j, d in enumerate(mesh.shard_devices):
        out.append(torch.cat([b[j].to(d, non_blocking=True) for b in bufs]))
    return out


def all_gather(ts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Every shard's tensor concatenated along dim 0 in shard-major order
    (jax.lax.all_gather, tiled), made once per distinct device."""
    return per_device(mesh, lambda t0: torch.cat(
        [t.to(t0.device, non_blocking=True) for t in ts]), list(ts))


def _reduce(ts: Sequence[torch.Tensor], mesh: Mesh, op) -> List[torch.Tensor]:
    return per_device(mesh, lambda t0: op(torch.stack(
        [t.to(t0.device, non_blocking=True) for t in ts]), 0), list(ts))


def psum(ts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    return _reduce(ts, mesh, lambda s, d: s.sum(d, dtype=s.dtype))


def pmin(ts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    return _reduce(ts, mesh, torch.amin)


def pmax(ts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    return _reduce(ts, mesh, torch.amax)


_PARTS = ("data", "validity", "lengths", "elem_valid")


def column_tensors(cols) -> List[torch.Tensor]:
    """The tensors of DeviceColumns, in order (the reference's pytree
    leaves of a column: data, validity, lengths, elem_valid when present)."""
    return [t for c in cols for t in (getattr(c, a) for a in _PARTS) if t is not None]


def columns_like(template, tensors: Sequence[torch.Tensor], cover_zero: bool = False):
    """DeviceColumns shaped as `template` over `tensors` (column_tensors'
    order). With cover_zero, integer bounds widen to take 0: a receive
    buffer zero-fills its unoccupied slots, and bounds promise that every
    physical slot lies in the interval (the packed-sort-key contract)."""
    from ..data.device import DeviceColumn

    it = iter(tensors)
    out = []
    for c in template:
        parts = [None if getattr(c, a) is None else next(it) for a in _PARTS]
        b = c.bounds
        if cover_zero and b is not None:
            b = (min(int(b[0]), 0), max(int(b[1]), 0))
        out.append(DeviceColumn(parts[0], parts[1], c.dtype, c.dictionary, b,
                                parts[2], parts[3], c.meta))
    return out


def shard_rows(arrays: Dict[str, np.ndarray], key: np.ndarray, mesh: Mesh,
               axis: str = "dp") -> Tuple[Dict[str, List[torch.Tensor]],
                                          List[torch.Tensor]]:
    """Hash-partition host rows by key across the mesh: per column, one
    [cap_local] tensor per shard on its device, and the per-shard row
    selection masks. The host mirror of ops/kernels.hash64 routes each row."""
    n = mesh.shape[axis]
    x = key.astype(np.uint64)
    M1 = np.uint64(0xFF51AFD7ED558CCD)
    M2 = np.uint64(0xC4CEB9FE1A85EC53)

    def mix(v):
        v = v ^ (v >> np.uint64(33))
        v = v * M1
        v = v ^ (v >> np.uint64(33))
        v = v * M2
        return v ^ (v >> np.uint64(33))

    h = mix(mix(x) ^ M1)
    part = (h % np.uint64(n)).astype(np.int64)
    counts = np.bincount(part, minlength=n)
    cap = int(max(128, 1 << int(np.ceil(np.log2(max(counts.max(), 1))))))
    sel = np.zeros((n, cap), dtype=bool)
    out = {name: np.zeros((n, cap), dtype=a.dtype) for name, a in arrays.items()}
    for p in range(n):
        idx = np.nonzero(part == p)[0]
        sel[p, : len(idx)] = True
        for name, a in arrays.items():
            out[name][p, : len(idx)] = a[idx]
    devs = mesh.shard_devices
    dev = {name: [torch.from_numpy(a[p].copy()).to(devs[p]) for p in range(n)]
           for name, a in out.items()}
    return dev, [torch.from_numpy(sel[p].copy()).to(devs[p]) for p in range(n)]


def _send_slots(key_hash: torch.Tensor, sel: torch.Tensor, n: int, slot_cap: int):
    """One source shard's routing: (the stable order of its rows by target
    shard, each sorted row's send slot -- the dump slot n * slot_cap for dead
    and overflow rows --, which sorted rows are sent, the overflow count)."""
    cap = sel.shape[0]
    dev = sel.device
    target = torch.where(sel, K.hash_mod(key_hash, n), n)  # dead rows: target n
    st, order = torch.sort(target, stable=True)
    # each row's position inside its target's run: its index less the run's
    # first index (an exclusive cumsum of the per-target counts)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, st, torch.ones(cap, dtype=torch.int64, device=dev))
    first = torch.cumsum(counts, 0) - counts
    pos = torch.arange(cap, dtype=torch.int64, device=dev) - first[st]
    live = st < n
    ok = live & (pos < slot_cap)
    dropped = (live & (pos >= slot_cap)).sum()
    slot = torch.where(ok, st * slot_cap + torch.clamp(pos, 0, slot_cap - 1),
                       n * slot_cap)
    return order, slot, ok, dropped


def _scatter_send(rows: torch.Tensor, slot, n: int, slot_cap: int) -> torch.Tensor:
    """Rows (in routing order) at their send slots, as the [n, slot_cap,
    ...] send buffer; unoccupied slots hold zeros. The dump slot, where
    dead and overflow rows land in any order, is cut off."""
    buf = torch.zeros((n * slot_cap + 1,) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=rows.device)
    buf.index_copy_(0, slot, rows)
    return buf[:-1].reshape((n, slot_cap) + tuple(rows.shape[1:]))


def exchange_by_key(arrays: Sequence[Sequence[torch.Tensor]],
                    key_hash: Sequence[torch.Tensor],
                    sel: Sequence[torch.Tensor], mesh: Mesh,
                    slot_cap: Optional[int] = None):
    """Route each live row of every shard to shard `hash % n`.

    arrays: per column, the per-shard tensors ([cap, ...]: trailing
    dimensions such as list widths or HLL register planes ride along);
    key_hash and sel: per-shard [cap] hashes (ops/kernels.hash64) and live
    masks. Each (source, destination) pair has slot_cap receive slots
    (default cap // n, the even split; slot_cap = cap is overflow-proof), so
    each shard receives n * slot_cap rows in source order. Rows past
    slot_cap are dropped and counted. Returns (per column the received
    per-shard tensors, the received per-shard masks, the per-shard 0-d
    dropped counts, left on the device)."""
    n = mesh.n
    cap = sel[0].shape[0]
    if slot_cap is None:
        slot_cap = cap // n
    routes = [_send_slots(h, s, n, slot_cap) for h, s in zip(key_hash, sel)]
    outs = []
    for col in arrays:
        bufs = [_scatter_send(a[order], slot, n, slot_cap)
                for a, (order, slot, _, _) in zip(col, routes)]
        outs.append(all_to_all(bufs, mesh))
    sel_bufs = [_scatter_send(ok, slot, n, slot_cap) for (_, slot, ok, _) in routes]
    new_sel = all_to_all(sel_bufs, mesh)
    return outs, new_sel, [r[3] for r in routes]


def broadcast_dim(arrays: Sequence[Sequence[torch.Tensor]], mesh: Mesh):
    """all_gather a sharded dimension table so that every shard holds the
    whole build side (the CollectLeft analog)."""
    return [all_gather(a, mesh) for a in arrays]


def distributed_query_step(mesh: Mesh):
    """The representative distributed step, over per-shard lists:

      lineitem-like fact (qty, price, disc, gkey, jkey, sel), sharded by row
      dim table (dim_key -> dim_factor), sharded by row

      1. local filter                        (FilterExec)
      2. all_gather dim + searchsorted join  (CollectLeft HashJoinExec)
      3. local partial aggregate by group    (AggregateMode::Partial)
      4. exchange on hash(group)             (RepartitionExec::Hash)
      5. final aggregate                     (AggregateMode::FinalPartitioned)
      6. psum of the global row count        (tree reduction)

    Returns step(...) -> (per-shard final sums [G], per-shard final counts
    [G], the global live-row count per shard, per-shard dropped counts)."""
    G = 8  # group-key domain (dictionary codes)
    n = mesh.n

    def local(qty, price, disc, gkey, jkey, sel, dk_all, df_all):
        keep = sel & (qty < 2400) & (disc > 0)
        dk_sorted, order = torch.sort(dk_all, stable=True)
        df_sorted = df_all[order]
        pos = torch.searchsorted(dk_sorted, jkey.contiguous())
        pos = torch.clamp(pos, 0, dk_sorted.shape[0] - 1)
        matched = dk_sorted[pos] == jkey
        factor = torch.where(matched, df_sorted[pos], 0)
        keep = keep & matched
        revenue = price * (10000 - disc) // 10000 * factor
        seg = torch.clamp(gkey, 0, G - 1).to(torch.int32)
        part_sum = K.segment_sum(revenue, seg, keep, G)
        part_cnt = K.segment_count(seg, keep, G)
        return keep, part_sum, part_cnt

    def pad(a):
        out = torch.zeros(G * n, dtype=a.dtype, device=a.device)
        out[:G] = a
        return out

    def step(qty, price, disc, gkey, jkey, sel, dim_key, dim_factor):
        dk_all = all_gather(dim_key, mesh)
        df_all = all_gather(dim_factor, mesh)
        parts = [local(*args) for args in zip(qty, price, disc, gkey, jkey, sel,
                                              dk_all, df_all)]
        hs, sums, cnts, gids, live = [], [], [], [], []
        for (keep, part_sum, part_cnt), d in zip(parts, mesh.shard_devices):
            g = torch.arange(G, dtype=torch.int64, device=d)
            hs.append(pad(K.hash64([g])))
            sums.append(pad(part_sum))
            cnts.append(pad(part_cnt))
            gids.append(pad(g))
            live.append(pad(torch.ones(G, dtype=torch.bool, device=d)))
        (rsum, rcnt, rgid), ex_sel, dropped = exchange_by_key(
            [sums, cnts, gids], hs, live, mesh)
        final_sum, final_cnt = [], []
        for s, c, g, es in zip(rsum, rcnt, rgid, ex_sel):
            gid = torch.where(es, g, G).to(torch.int32)
            final_sum.append(K.segment_sum(s, gid, es, G))
            final_cnt.append(K.segment_sum(c, gid, es, G))
        total_rows = psum([keep.sum(dtype=torch.int64) for keep, _, _ in parts], mesh)
        return final_sum, final_cnt, total_rows, dropped

    return step

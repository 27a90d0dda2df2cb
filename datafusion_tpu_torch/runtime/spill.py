"""Spill: device -> host (RAM, then disk) offload of relations.

Port of datafusion_tpu/runtime/spill.py (reference: SpillManager,
physical-plan/src/spill/spill_manager.rs:40, and DiskManager,
execution/src/disk_manager.rs:192). The first spill tier is host RAM: a
relation leaves the card in one batched copy into pinned host memory
(data/device._download); an optional disk tier keeps numpy .npz files once
the host tier passes its budget."""
from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional

import numpy as np

from ..common.schema import Schema
from ..data.device import DeviceColumn, DeviceRelation, _download, _tensor

_PARTS = ("data", "validity", "lengths", "elem_valid")


class SpilledRelation:
    """A relation moved off the device: host arrays, or a disk file."""

    def __init__(self, schema: Schema, arrays: Dict[str, np.ndarray],
                 meta: List[tuple], path: Optional[str] = None):
        self.schema = schema
        self.arrays = arrays
        # (dtype, dictionary, bounds, meta) per column
        self.meta = meta
        self.path = path

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays.values())

    def to_disk(self, directory: Optional[str] = None,
                compress: bool = False) -> str:
        fd, path = tempfile.mkstemp(suffix=".npz", dir=directory)
        os.close(fd)
        # compression trades CPU for disk bandwidth (reference:
        # spill_compression, spill/mod.rs:240-256)
        (np.savez_compressed if compress else np.savez)(path, **self.arrays)
        self.arrays = {}
        self.path = path
        return path

    def _load(self) -> Dict[str, np.ndarray]:
        if self.path is not None and not self.arrays:
            with np.load(self.path) as z:
                self.arrays = {k: z[k] for k in z.files}
        return self.arrays

    def restore(self, device) -> DeviceRelation:
        """The relation again, on `device` (the session's device: a spill
        goes back where its query runs, never to a default card). Arrays
        read from disk are read-only; _tensor copies them."""
        arrays = self._load()
        cols = []
        for i, (dtype, dictionary, bounds, meta) in enumerate(self.meta):
            parts = {p: _tensor(arrays.get(f"{p}{i}"), device) for p in _PARTS}
            cols.append(DeviceColumn(parts["data"], parts["validity"], dtype,
                                     dictionary, bounds, parts["lengths"],
                                     parts["elem_valid"], meta))
        return DeviceRelation(self.schema, tuple(cols),
                              _tensor(arrays["sel"], device))

    def release(self):
        self.arrays = {}
        if self.path and os.path.exists(self.path):
            os.unlink(self.path)


class SpillManager:
    def __init__(self, directory: Optional[str] = None,
                 max_host_bytes: int = 0, compress: bool = False):
        self.directory = directory
        self.max_host_bytes = int(max_host_bytes or 0)
        self.compress = bool(compress)
        self.spilled: List[SpilledRelation] = []
        self.spill_count = 0
        self.spilled_bytes = 0
        self.disk_spill_count = 0

    def _enforce_host_budget(self) -> None:
        """Demote the oldest host-RAM spills to disk once the host tier
        exceeds its budget (the disk rung of the device->host->disk
        ladder)."""
        if not self.max_host_bytes or not self.directory:
            return
        host = sum(s.nbytes for s in self.spilled if s.path is None)
        for s in self.spilled:
            if host <= self.max_host_bytes:
                break
            if s.path is None:
                n = s.nbytes
                s.to_disk(self.directory, compress=self.compress)
                self.disk_spill_count += 1
                host -= n

    def record_offload(self, nbytes: int) -> None:
        """Account a device->host offload whose host copy the caller keeps
        (external sort and host-distinct runs: the chunk leaves the card to
        be merged on the host later, as a host Table, not an .npz)."""
        self.spill_count += 1
        self.spilled_bytes += int(nbytes)

    def spill(self, rel: DeviceRelation) -> SpilledRelation:
        names, tensors = ["sel"], [rel.sel]
        meta = []
        for i, c in enumerate(rel.columns):
            for p in _PARTS:
                t = getattr(c, p)
                if t is not None:
                    names.append(f"{p}{i}")
                    tensors.append(t)
            meta.append((c.dtype, c.dictionary, c.bounds, c.meta))
        host, fresh = _download(tensors)
        # on the CPU the arrays are views of the relation's own tensors
        arrays = {n: (a if fresh else a.copy()) for n, a in zip(names, host)}
        s = SpilledRelation(rel.schema, arrays, meta)
        self.spilled.append(s)
        self.spill_count += 1
        self.spilled_bytes += s.nbytes
        self._enforce_host_budget()
        return s

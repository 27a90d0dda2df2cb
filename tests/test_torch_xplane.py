"""utils/xplane.py of the port against the JAX package's: the same device
events, written as an XSpace protobuf for the reference's reader and as a
torch.profiler Chrome trace for the port's, give the same per-op summary
and the same table. A profile object's key_averages() is read too (device
events only: a CPU-only profile has none)."""
import json
import types

import pytest
import torch

from datafusion_tpu.utils import xplane as jax_xplane
from datafusion_tpu_torch.utils import xplane

# (op name, durations in microseconds of its events)
EVENTS = [("dgs_register_kernel<2>", [120.5, 118.25, 119.0]),
          ("Memcpy DtoD (Device -> Device)", [40.0, 2.5]),
          ("void at::native::radixSortKVInPlace", [310.75]),
          ("Memset (Device)", [1.25, 1.0, 0.75, 0.5]),
          ("index_elementwise_kernel", [12.0] * 6)]


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(fnum: int, value) -> bytes:
    if isinstance(value, int):
        return _varint(fnum << 3) + _varint(value)
    data = value.encode() if isinstance(value, str) else value
    return _varint((fnum << 3) | 2) + _varint(len(data)) + data


def _xspace(plane_name: str) -> bytes:
    """An XSpace holding one plane: event metadata id -> name, and one line
    with every event (duration in picoseconds)."""
    plane = _field(2, plane_name)
    events = b""
    for mid, (name, durs) in enumerate(EVENTS, start=1):
        plane += _field(4, _field(1, mid) + _field(2, _field(2, name)))
        for us in durs:
            events += _field(4, _field(1, mid) + _field(3, int(round(us * 1e6))))
    plane += _field(3, events)
    return _field(1, plane)


def _chrome(path):
    trace = [{"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 0, "dur": 999.0}]
    ts = 0
    for name, durs in EVENTS:
        cat = ("gpu_memcpy" if "Memcpy" in name else
               "gpu_memset" if "Memset" in name else "kernel")
        for us in durs:
            trace.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": us})
            ts += 1000
    path.write_text(json.dumps({"traceEvents": trace}))


def test_chrome_trace_summary_equals_the_reference(tmp_path):
    (tmp_path / "host.xplane.pb").write_bytes(_xspace("/device:TPU:0"))
    _chrome(tmp_path / "trace.json")
    want = jax_xplane.plane_op_times(str(tmp_path / "host.xplane.pb"))
    got = xplane.plane_op_times(str(tmp_path / "trace.json"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k][1] == want[k][1]
        assert got[k][0] == pytest.approx(want[k][0], rel=1e-12)
    assert xplane.top_ops(str(tmp_path / "trace.json"), n=3) == \
        jax_xplane.top_ops(str(tmp_path / "host.xplane.pb"), n=3)
    assert xplane.copy_ms(got) == pytest.approx(42.5e-3 + 3.5e-3)


def test_a_directory_of_traces_aggregates(tmp_path):
    (tmp_path / "a").mkdir()
    _chrome(tmp_path / "a" / "one.pt.trace.json")
    _chrome(tmp_path / "two.pt.trace.json")
    one = xplane.plane_op_times(str(tmp_path / "a" / "one.pt.trace.json"))
    both = xplane.plane_op_times(str(tmp_path))
    assert {k: v[1] * 2 for k, v in one.items()} == {k: v[1] for k, v in both.items()}
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no Chrome trace"):
        xplane.plane_op_times(str(tmp_path / "empty"))


def test_key_averages_device_events_only():
    from torch.autograd import DeviceType

    def ev(key, dev, us, count):
        return types.SimpleNamespace(key=key, device_type=dev,
                                     self_device_time_total=us, count=count)

    prof = types.SimpleNamespace(key_averages=lambda: [
        ev("dgs_register_kernel<2>", DeviceType.CUDA, 357.75, 3),
        ev("aten::sort", DeviceType.CPU, 0.0, 5),
        ev("ProfilerStep#1", DeviceType.CUDA, 5000.0, 1),
        ev("Memcpy DtoD (Device -> Device)", DeviceType.CUDA, 42.5, 2)])
    got = xplane.plane_op_times(prof)
    assert got == {"dgs_register_kernel<2>": (0.35775, 3),
                   "Memcpy DtoD (Device -> Device)": (0.0425, 2)}
    assert xplane.top_ops(prof).splitlines()[2].split()[:2] == ["0.358", "3"]


def test_a_cpu_profile_has_no_device_time(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.sort(torch.arange(1000).flip(0))
    assert xplane.plane_op_times(prof) == {}
    prof.export_chrome_trace(str(tmp_path / "cpu.json"))
    assert xplane.plane_op_times(str(tmp_path / "cpu.json")) == {}
    assert xplane.top_ops(prof).endswith("0.000  total device time")

"""dtoh_ms_per_query: the host copy (data/device.py, to_host): device
milliseconds of Memcpy DtoH per query in the profiled passes."""


def read(trace):
    s = trace.get("summary")
    if not s or not s.get("queries"):
        return None
    return s["dtoh_s"] / s["queries"] * 1e3

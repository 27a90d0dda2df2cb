"""device_idle_share: 1 - busy / wall over the profiled passes, busy being
the union of the device events' intervals. The profiler's own host cost
is in the wall."""


def read(trace):
    s = trace.get("summary")
    if not s or s["window_s"] <= 0:
        return None
    return 1.0 - s["busy_s"] / s["window_s"]

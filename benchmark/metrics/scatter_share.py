"""scatter_share: the operators' scatters (physical/plan.py, ops/groupby.py,
ops/joinimpl.py, ops/kernels.py): the scatter family's device time
(dfbench.trace.OP_FAMILIES) over the device's busy time in the profiled
passes."""


def read(trace):
    s = trace.get("summary")
    if not s or s["busy_s"] <= 0:
        return None
    return s["device_s_by_family"].get("scatter", 0.0) / s["busy_s"]

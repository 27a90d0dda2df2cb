"""dense_groupby_sums_roofline: the dense aggregation kernel
(csrc/dense_groupby_sums.cu via ops/dense_agg.py), as a share in % of its
bytes roofline on an H100 (3.35 TB/s, NVIDIA's data sheet, SXM).

The least bytes of a launch come from its inputs, by the benchmark's own
arithmetic, whatever implementation runs: the mask of every row up to the
last live one (n_extent), the segment id and each distinct factor column
of every live row (n_true: in range and masked in), and G x (pairs + 1)
int64 outputs. The shapes are recorded from outside at the first pass of
set-up (dfbench.port.kernel_launches); the profiled passes give the kernel's
device time (events whose name holds "dgs_") and its launch count, by which
the recorded bytes per launch are scaled. Nothing to read where no launch
was profiled."""

HBM_BYTES_PER_S = 3.35e12


def launch_bytes(call: dict) -> int:
    return (call["n_extent"] * call["mask_bytes"] + call["n_true"] * call["row_bytes"]
            + call["out_bytes"])


def read(trace):
    s = trace.get("summary")
    calls = trace.get("kernel_calls") or {}
    if not s or not s.get("dgs_launches") or s.get("dgs_s", 0) <= 0:
        return None
    launches = sum(n * len(calls.get(q, [])) for q, n in s["executions"].items())
    nbytes = sum(n * sum(launch_bytes(c) for c in calls.get(q, []))
                 for q, n in s["executions"].items())
    if not launches:
        return None
    least_s = nbytes * s["dgs_launches"] / launches / HBM_BYTES_PER_S
    return 100.0 * least_s / s["dgs_s"]

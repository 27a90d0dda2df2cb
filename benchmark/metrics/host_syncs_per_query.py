"""host_syncs_per_query: host synchronisations per query, counted by
torch.cuda.set_sync_debug_mode("warn") over whole passes: the steady
state's flag read and copy (physical/fused.py) in held plans, and every host
read of the operators in discovery."""


def read(trace):
    if not trace.get("sync_queries"):
        return None
    return trace["syncs"] / trace["sync_queries"]

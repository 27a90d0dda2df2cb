"""plan_ms_per_query: the SQL front end (context.py, sql/, optimizer/,
physical/planner.py). Host-clock milliseconds of ctx.sql(text) plus
df.physical_plan(), per query, over the traced run's span passes. Nothing
to read where the traffic plans every query in set-up."""


def read(trace):
    plan_s = trace.get("plan_s") or []
    if not plan_s:
        return None
    return sum(plan_s) / len(plan_s) * 1e3

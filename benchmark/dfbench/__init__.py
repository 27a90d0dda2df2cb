"""The benchmark's own code: the manifest, the closed-loop client, the
comparison with the plain references, and the readers of spans, sync counts
and profiler traces. Nothing here imports the program under test at module
level; `dfbench.port` is the one module that reaches it, and only when the
benchmark runs a cell."""

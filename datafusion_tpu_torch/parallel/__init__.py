"""Partial/Final aggregation states (aggsplit.py) and distributed execution
over a mesh of shards (distributed.py: the mesh and its collectives;
engine.py: DistributedQuery)."""

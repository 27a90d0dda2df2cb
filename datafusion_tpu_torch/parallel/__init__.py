"""Partial/Final aggregation states (aggsplit.py). The distributed engine
of the reference (mesh exchanges, the cross-device merges) is not ported
yet: ROADMAP queue 1, item 11."""

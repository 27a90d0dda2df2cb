"""Recursive queries over a hierarchy, shared by the differential tests
(tests/test_torch_recursive.py, on the CPU) and chip_smoke.py's interchange
phase (on the card).

hierarchy(n, seed) is a random recursive tree of n nodes: node i >= 1 takes
a parent uniform over the nodes before it, and the edge into it carries an
int64 weight in [1, 100] (an org chart or a bill of materials; its height
grows as ln n: 30 levels at n = 2^20 with seed 0). R1 walks it from the root and
counts the nodes at each depth; R2 carries the path weight down the tree.
oracle() answers both level by level in numpy, without the engine. RUNAWAY
never stops, so it must hit the iteration cap. The work table is named
without an alias: `FROM sub s` loses s's other columns to the copied
optimizer's projection pruning in both packages (a PlanError)."""
import numpy as np

R1 = ("WITH RECURSIVE sub(node, depth) AS ("
      "SELECT 0 AS node, 0 AS depth "
      "UNION ALL "
      "SELECT e.child, sub.depth + 1 FROM sub JOIN edges e ON e.parent = sub.node) "
      "SELECT depth, count(*) AS n FROM sub GROUP BY depth ORDER BY depth")

R2 = ("WITH RECURSIVE sub(node, depth, total) AS ("
      "SELECT 0 AS node, 0 AS depth, CAST(0 AS BIGINT) AS total "
      "UNION ALL "
      "SELECT e.child, sub.depth + 1, sub.total + e.w "
      "FROM sub JOIN edges e ON e.parent = sub.node) "
      "SELECT count(*) AS n, sum(total) AS total, max(depth) AS depth FROM sub")

RUNAWAY = ("WITH RECURSIVE s(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM s) "
           "SELECT count(*) AS c FROM s")


def hierarchy(n: int, seed: int) -> dict:
    """The edges of the tree as columns: parent, child (1..n-1) and w."""
    rng = np.random.default_rng(seed)
    child = np.arange(1, n, dtype=np.int64)
    parent = np.floor(rng.random(n - 1) * child).astype(np.int64)
    w = rng.integers(1, 101, n - 1, dtype=np.int64)
    return {"parent": parent, "child": child, "w": w}


def oracle(edges: dict) -> dict:
    """R1's and R2's answers, the tree walked level by level: the nodes of a
    level are the children of the level before; also the iterations the
    recursion takes (one per level below the root, then one that finds no
    row)."""
    parent, child, w = edges["parent"], edges["child"], edges["w"]
    n = len(child) + 1
    depth = np.zeros(n, dtype=np.int64)
    total = np.zeros(n, dtype=np.int64)
    frontier = np.zeros(n, dtype=bool)
    frontier[0] = True
    level = 0
    while frontier.any():
        level += 1
        kids = frontier[parent]
        nodes = child[kids]
        depth[nodes] = level
        total[nodes] = total[parent[kids]] + w[kids]
        frontier = np.zeros(n, dtype=bool)
        frontier[nodes] = True
    counts = np.bincount(depth)
    return {"R1": {"depth": list(range(len(counts))), "n": counts.tolist()},
            "R2": {"n": [n], "total": [int(total.sum())],
                   "depth": [int(depth.max())]},
            "iterations": level}

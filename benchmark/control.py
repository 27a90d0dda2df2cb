"""The control of a cell's comparison: the plain reference computed one
precision below what the configuration states (reference/<dataset>.py,
precision="control"), put in the program's place and judged by the same
comparison (dfbench.answers.judge) as a run's answers. The benchmark's own
runs do not run it.

    python benchmark/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed with the compared numbers and whether the
cell's limits would pass them (they must not). NumPy only: it imports
nothing of the program."""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def readings(cell_name: str, seed: int, sizes=None) -> dict:
    """The control's compared numbers on `seed`; `sizes` overrides sizes
    of the configuration's file (the tests' small cells)."""
    from dfbench import manifest
    from dfbench.answers import as_table, judge

    cell = manifest.cell(cell_name)
    conf = {**cell.config, **(sizes or {})}
    ds = manifest.dataset(conf["dataset"])
    ref = manifest.reference(conf["dataset"])
    stream = ds.STREAMS[cell.traffic.get("stream", "default")]
    t = time.perf_counter()
    tables = ds.generate(conf, seed)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    exact = ref.answers(tables, conf, stream)
    control = ref.answers(tables, conf, stream, precision="control")
    ref_s = time.perf_counter() - t
    mismatched, gap, by_query = 0, 0.0, {}
    for name in stream:
        v = judge(as_table(control[name]), exact[name])
        by_query[name] = v.mismatch if v.mismatch else v.float_gap
        mismatched += v.mismatch is not None
        gap = max(gap, v.float_gap)
    limits = conf["limits"]
    passes = mismatched <= limits["mismatched_answers"] and gap <= limits["float_gap"]
    return {"cell": cell_name, "seed": seed, "mismatched_answers": mismatched,
            "float_gap": gap, "control_passes": passes, "by_query": by_query,
            "datagen_s": gen_s, "reference_s": ref_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE]
    all_rejected = True
    for seed in args.seeds:
        r = readings(args.workload, seed)
        print(json.dumps(r), flush=True)
        all_rejected = all_rejected and not r["control_passes"]
    return 0 if all_rejected else 1


if __name__ == "__main__":
    sys.exit(main())

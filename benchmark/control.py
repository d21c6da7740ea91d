"""Readings of the comparison that decides ``correct``, for setting limits.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--out FILE]

For each of ``--seeds``: the cell's inputs made from that seed (one input
set), one job of the timed path on them at the cell's own size, and each
number compared against the plain reference (the lower readings, of sound
runs).  For each of ``--control-seeds``: the control in the program's
place, the plain reference computed with the guarantee it breaks (the
spectrum keyed by 32 bits; segments placed by their first seed hit), and
the same numbers (the upper readings).  Prints one JSON line a reading and
a last line with the largest lower and the least upper reading of each
number beside the cell's limit.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(bench, cell_name, seeds, control_seeds, device="cuda",
             config_override=None, emit=print):
    """The lower and upper readings of each number; emit() gets a dict a
    reading."""
    from benchmark import harness

    cell = harness.Cell(bench, cell_name)
    config = (cell.config if config_override is None
              else config_override(cell.config))
    mix = dict(cell.mix, distinct_inputs=1)
    lower, upper = {}, {}
    warm = True
    for kind, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            jobs = cell.jobs_mod.Jobs(config, mix, seed, device)
            if kind == "program":
                if warm:
                    jobs.job(0)
                    warm = False
                ans = jobs.answer(jobs.job(0))
            else:
                ans = jobs.control(0)
            ref = jobs.reference(0)
            off = jobs.compare(ans, ref)
            for k, v in off.items():
                if kind == "program":
                    lower[k] = max(lower.get(k, v), v)
                else:
                    upper[k] = min(upper.get(k, v), v)
            emit(dict(kind=kind, seed=seed, readings=off,
                      seconds=time.perf_counter() - t0))
            del jobs
    return lower, upper, cell.jobs_mod.LIMITS


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == os.path.join(
            ROOT, "benchmark"):
        sys.path[0] = ROOT
    else:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        sys.exit("control: no card; the readings are taken on the card")
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    lines = []

    def emit(d):
        lines.append(d)
        print(json.dumps(d), flush=True)

    lower, upper, limits = readings(
        bench, args.workload,
        [int(s) for s in args.seeds.split(",")],
        [int(s) for s in args.control_seeds.split(",")], emit=emit)
    last = dict(workload=args.workload,
                device=torch.cuda.get_device_name(0),
                numbers={k: dict(lower=lower.get(k), upper=upper.get(k),
                                 limit=limits[k]) for k in limits})
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(readings=lines, **last), fh, indent=1)
    print(json.dumps(last), flush=True)


if __name__ == "__main__":
    main()

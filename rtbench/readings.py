"""The readings that a cell's limits are set from, many seeds in one
process: sound runs of the program, the control (the program at a lower
precision) and planted faults.

    python3 -m rtbench.readings --workload pt.d2 --seeds 1,2,3 \\
        --seconds 3 [--precision default] [--fault half]

One JSON line a seed: the check's numbers and ``correct``. A window only
needs to hold the frames a check compares; the numbers do not depend on
its length.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from rtbench import faults, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--precision", default=None,
                   help="run the program at this precision (the control)")
    p.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    bench = run.load_bench()
    cell = run.find_cell(bench, args.workload)
    overrides = ({"config": {"configuration": {"precision": args.precision}}}
                 if args.precision else None)
    kind = (f"precision={args.precision}" if args.precision
            else f"fault={args.fault}" if args.fault else "sound")
    for seed in (int(s) for s in args.seeds.split(",")):
        result, numbers = run.run_cell(
            bench, cell, seed, args.seconds, False, torch.device("cuda", 0),
            time.perf_counter(), overrides, log=lambda obj: None,
            after_setup=faults.FAULTS.get(args.fault))
        found = run.forbidden_modules()
        if found:
            print("loaded in this process: " + ", ".join(found),
                  file=sys.stderr)
            return 4
        print(json.dumps({"cell": cell["name"], "seed": seed, "kind": kind,
                          "correct": result["correct"],
                          "frames": result["attempted"],
                          "check": {k: v["value"] for k, v in numbers.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

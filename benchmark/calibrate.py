#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <name> --first-seed <n> --seeds 12 \\
        --control-seeds 3 --fault half_batch --fault-seeds 3

For each seed the system's run up to its comparison, without the timed
window (training: set-up and the warm-up call, whose first steps are the
compared ones; rendering: set-up, warm-up and a few frames), and its
compared numbers against the reference; then the control
(the reference at fp8 in the system's place) on ``--control-seeds`` seeds,
and each ``--fault`` planted under the timed path on ``--fault-seeds``
seeds. Prints one JSON line a reading and a summary: the largest reading of
the system (the lower end of each limit) and the smallest of the control
and of each fault (the upper end). The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402
from benchmark.run import make_run  # noqa: E402


def reading(cell, seed: int, device, faults=(), control: str = "", sizes=None) -> dict:
    """The compared numbers of one seed: the system's (with ``faults``
    planted), or the control's at ``control`` precision."""
    from benchmark.drivers import train

    if cell.traffic["driver"] == "train" and control:
        return train.reference_readings(cell, seed, device, control, sizes)
    run = make_run(cell, seed, device, faults=faults, sizes=sizes)
    run.setup()
    run.warm_up()
    if cell.traffic["driver"] == "render":
        run.window(0, frames=2 * int(run.traffic["checked_frames"]))
    run.release()
    return run.readings(control) if control else run.readings()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sizes", default="", help="JSON of sizes to cut the cell to (tests)")
    p.add_argument("--out", default="", help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    cell = spec.find_cell(args.workload)
    sizes = json.loads(args.sizes) if args.sizes else None
    rows = []

    def emit(kind, seed, numbers, t0):
        row = {"workload": cell.name, "kind": kind, "seed": seed,
               "seconds": time.perf_counter() - t0, **numbers}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    base = args.first_seed
    for i in range(args.seeds):
        t0 = time.perf_counter()
        emit("system", base + i, reading(cell, base + i, args.device, sizes=sizes), t0)
    for i in range(args.control_seeds):
        seed = base + 1000 + i
        t0 = time.perf_counter()
        emit("control_fp8", seed, reading(cell, seed, args.device, control="fp8", sizes=sizes), t0)
    for fault in args.fault:
        for i in range(args.fault_seeds):
            seed = base + 2000 + i
            t0 = time.perf_counter()
            emit(f"fault_{fault}", seed,
                 reading(cell, seed, args.device, faults=(fault,), sizes=sizes), t0)
    numbers = [k for k, v in rows[0].items()
               if isinstance(v, float) and k != "seconds"]
    summary = {"workload": cell.name, "summary": True}
    for kind in sorted({r["kind"] for r in rows}):
        pick = max if kind == "system" else min
        summary[kind] = {k: pick(r[k] for r in rows if r["kind"] == kind) for k in numbers}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The card's time and idle of one cell by the port's spans.

    python3 benchmark/phases.py --workload <name> --seed <n> [--seconds <s>] [--out <file>]

From the root of a checkout, on the card. Runs the cell as ``run.py`` does
(set-up, warm-up, a window of ``--seconds``, then the same traced stretch),
keeps the Chrome trace of the traced stretch and splits it by the spans of
``nerf_tpu_torch.utils.profiling`` (``harness/spans.py``): for a training
cell the step's four phases, the field evaluations inside the forward
apart; for a render cell the service, the renderer and the fields. Each
part gets the card's time of the operations launched in it and the idle
time in it, in ms a step or frame, its launches and its operations by
name; ``outside`` is what falls in no part. The last line of standard
output is the result as JSON, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import spans as sp  # noqa: E402
from benchmark.harness import spec, trace as tr  # noqa: E402
from nerf_tpu_torch.utils import profiling as p  # noqa: E402


@contextlib.contextmanager
def keeping_chrome():
    """Within: each Chrome trace that ``harness.trace`` reads is also kept
    in the yielded list (its recording removes the file)."""
    kept = []
    parse = tr.from_chrome

    def keep(chrome):
        kept.append(chrome)
        return parse(chrome)

    tr.from_chrome = keep
    try:
        yield kept
    finally:
        tr.from_chrome = parse


def parts(ph: sp.Phased, driver: str):
    """The partition of the traced window by the port's spans."""
    if driver == "train":
        return {p.TRAIN_DRAW: sp.region(ph, [p.TRAIN_DRAW]),
                f"{p.TRAIN_FORWARD} less {p.RENDER_FIELD}":
                    sp.region(ph, [p.TRAIN_FORWARD], [p.RENDER_FIELD]),
                p.RENDER_FIELD: sp.region(ph, [p.RENDER_FIELD]),
                p.TRAIN_BACKWARD: sp.region(ph, [p.TRAIN_BACKWARD]),
                p.TRAIN_UPDATE: sp.region(ph, [p.TRAIN_UPDATE])}
    return {f"{p.SERVE_REQUEST} less {p.RENDER_IMAGE}":
                sp.region(ph, [p.SERVE_REQUEST], [p.RENDER_IMAGE]),
            f"{p.RENDER_IMAGE} less {p.RENDER_FIELD}":
                sp.region(ph, [p.RENDER_IMAGE], [p.RENDER_FIELD]),
            p.RENDER_FIELD: sp.region(ph, [p.RENDER_FIELD])}


def phase_split(cell, seed: int, seconds: float, device, sizes=None, log=print) -> dict:
    run = bench_run.make_run(cell, seed, device, sizes=sizes)
    run.setup()
    run.warm_up()
    window = run.window(seconds)
    with keeping_chrome() as kept:
        traced = run.traced()
    key = "steps" if "steps" in traced else "frames"
    units = traced[key]
    ph = sp.from_chrome(kept[-1])
    t = ph.trace
    untraced = window[key] / window["seconds"]
    log(f"[trace] {units} {key} under the profiler in {t.window_s} s against "
        f"{untraced} a second untraced (tracing costs "
        f"{100 * (1 - units / t.window_s / untraced)}%)")
    run.release()
    return {"workload": cell.name, "seed": seed, key: units,
            "window_ms": 1e3 * t.window_s / units, "busy_ms": 1e3 * tr.busy_s(t) / units,
            "launches": tr.device_launches(t) / units,
            "untraced_ms": 1e3 / untraced,
            "parts": sp.split(ph, parts(ph, cell.traffic["driver"]), units)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    result = phase_split(cell, args.seed, args.seconds, "cuda:0",
                         log=lambda *a: print(*a, file=sys.stderr))
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

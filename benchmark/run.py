#!/usr/bin/env python3
"""Run one cell of the benchmark on the card this process finds.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic mix
and its per-layer metrics are looked up by name (``harness/spec.py``). Set-up
(imports, the CUDA context, the kernel library from ``build/`` in the
checkout, the data, the weights and the warm-up) counts from the process's
start to the first timed call. Then the window runs for ``--seconds``;
with ``--trace 1``, or where an end-to-end metric is read from the
device's trace, one more stretch of the same traffic follows under the
profiler. Once the system's state is freed, what the window produced is
compared with the plain reference.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each compared number with its limit.
The same numbers close standard error. Without enough CUDA devices, or with
JAX loaded, the run prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Compiler caches at fixed paths inside the checkout, whatever HOME is.
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "bench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "bench_cache" / "torch_extensions"))

from benchmark.harness import device as dv  # noqa: E402
from benchmark.harness import spec, trace as tr  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_run(cell, seed: int, device, faults=(), sizes=None):
    from benchmark.drivers.render import RenderRun
    from benchmark.drivers.train import TrainRun

    driver = {"train": TrainRun, "render": RenderRun}[cell.traffic["driver"]]
    return driver(cell, seed, device, faults=faults, sizes=sizes)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             faults=(), sizes=None, log=print) -> dict:
    """Set up, warm up, measure, optionally trace, compare: the result of
    one run as a dict (the JSON of the last line)."""
    import torch

    run = make_run(cell, seed, device, faults, sizes)
    t_imported = time.time()
    run.setup()
    t_ready = time.time()
    run.warm_up()
    setup_s = time.time() - t_start
    log(f"[setup] start and imports {t_imported - t_start} s, data, weights and state "
        f"{t_ready - t_imported} s (of which {run.phases}), warm-up "
        f"{t_start + setup_s - t_ready} s")
    window = run.window(seconds)
    # An end-to-end metric read from the device's trace needs the traced
    # stretch in every run, not only with --trace 1.
    traced = run.traced() if trace or spec.traced_end_to_end(cell) else None
    dev = run.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    forbidden = dv.forbidden_modules()
    if forbidden:
        raise RuntimeError(f"loaded after the window: {', '.join(forbidden)}")
    run.release()
    readings = run.readings()
    checks = run.checks(cell.workload["limits"], readings)
    attempted = window.get("steps", window.get("frames"))
    for k, v in window.items():
        log(f"[window] {k} {v}")
    info = dict(window=window, traced=traced, config=run.config, traffic=run.traffic,
                root=cell.root)
    if trace:
        metrics = spec.read_per_layer(cell, info, cell.root)
    else:
        metrics = spec.read_end_to_end(cell, dict(info, window=dict(window, setup_s=setup_s)),
                                       cell.root)
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in metrics]
        if missing and dev.type == "cuda":
            raise RuntimeError(f"no reading of {', '.join(missing)}")
    card = dv.card(dev.index or 0) if dev.type == "cuda" else {"kind": str(dev),
                                                                 "power_limit_w": None}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": card["kind"], "count": cell.chips, "memory_peak_bytes": int(peak),
                   "power_limit_w": card["power_limit_w"]}
    result = {"correct": bool(all(c["ok"] for c in checks) and window["failed"] == 0),
              "attempted": int(attempted), "failed": int(window["failed"]),
              "metrics": metrics, "device": device_info}
    if trace:
        t = traced["trace"]
        device_info["busy_s"] = tr.busy_s(t)
        device_info["window_s"] = t.window_s
        work = traced.get("steps", traced.get("frames"))
        base = window.get("steps", window.get("frames")) / window["seconds"]
        log(f"[trace] {work} under the profiler in {t.window_s} s: {work / t.window_s} a second "
            f"against {base} untraced (tracing costs {100 * (1 - work / t.window_s / base)}%)")
        result["breakdown"] = {"device_ops": tr.top_device_ops(t), "idle_gaps": tr.idle_by_host(t)}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"], "ok": c["ok"]}
                        for c in checks}
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    t_start = dv.process_start_time()
    try:
        cell = spec.find_cell(args.workload)
    except (KeyError, OSError) as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 2
    try:
        dv.require_cards(cell.chips)
    except dv.NoCard as e:
        print(f"[bench] no result: {e}", file=sys.stderr)
        return 2
    card = dv.card(0)
    print(f"[device] {card['kind']}, power limit {card['power_limit_w']} W", file=sys.stderr)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    except Exception:
        traceback.print_exc()
        print("[bench] no result: the run failed", file=sys.stderr)
        return 1
    forbidden = dv.forbidden_modules()
    if forbidden:
        print(f"[bench] no result: loaded in this process: {', '.join(forbidden)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']} limit {c['limit']} {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

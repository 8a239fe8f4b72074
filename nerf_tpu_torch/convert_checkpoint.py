"""Convert checkpoints between the reference torch format and the native one
(port of ``convert_checkpoint.py``). Host only: it reads and writes files
and computes nothing on a device.

Directions:
  reference .ckpt -> native .ntc   (reference training runs, pretrained models)
  native .ntc -> reference .ckpt   (runs for the reference's eval_nerf.py)

The ``.ntc`` holds the params and no optimizer state; the ``.ckpt`` gets
the ``.ntc``'s Adam moments as a ``torch.optim.Adam`` state dict when it
has them (``engine/checkpoint.reference_optimizer_state_dict``), else a
valid empty one.

Usage:
  python -m nerf_tpu_torch.convert_checkpoint --input ckpt.ckpt --output ckpt.ntc
  python -m nerf_tpu_torch.convert_checkpoint --input run.ntc --output run.ckpt \\
      [--hwf 400 400 555.5]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from .engine.checkpoint import (
    export_reference_params,
    load_checkpoint,
    load_reference_checkpoint,
    save_checkpoint,
)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--hwf", nargs=3, type=float, default=None,
                        help="Optional height width focal to embed when exporting to .ckpt "
                             "(read by reference eval_nerf.py:138-143).")
    parser.add_argument("--lr", type=float, default=5.0e-3,
                        help="Learning rate recorded in the exported optimizer_state_dict "
                             "param group (reference resume restores it).")
    args = parser.parse_args(argv)

    if args.input.endswith(".ckpt") and args.output.endswith(".ntc"):
        ckpt = load_reference_checkpoint(args.input)
        # Scalars as 0-d arrays: the JAX CLI's save_checkpoint maps every
        # leaf through np.asarray, and the files are byte-equal.
        save_checkpoint(args.output, {
            "step": np.asarray(ckpt["step"]),
            "params_coarse": ckpt["params_coarse"],
            "params_fine": ckpt["params_fine"],
            "opt_state": {},
            "loss": np.asarray(ckpt.get("loss") or 0.0),
            "psnr": np.asarray(ckpt.get("psnr") or 0.0),
        })
        print(f"torch -> native: {args.input} -> {args.output} (step {ckpt['step']})")
    elif args.input.endswith(".ntc") and args.output.endswith(".ckpt"):
        state = load_checkpoint(args.input)
        export_reference_params(
            args.output, step=int(state.get("step", 0)),
            params_coarse=state["params_coarse"], params_fine=state.get("params_fine"),
            loss=float(state.get("loss", 0.0)), psnr=float(state.get("psnr", 0.0)),
            hwf=tuple(args.hwf) if args.hwf else None, opt_state=state.get("opt_state"),
            lr=args.lr)
        print(f"native -> torch: {args.input} -> {args.output}")
    else:
        raise SystemExit("Unsupported conversion; use .ckpt -> .ntc or .ntc -> .ckpt")


if __name__ == "__main__":
    main()

"""The card a run uses, the process's start, and the guard against JAX."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List

# Top-level module names that may not be loaded in a run (``nerf_tpu`` is the
# JAX package; ``nerf_tpu_torch``, the system under test, is another name).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "nerf_tpu")


class NoCard(RuntimeError):
    """The cell needs more CUDA devices than this machine has."""


def process_start_time() -> float:
    """The ``time.time()`` at which this process started (Linux ``/proc``),
    so that set-up counts the interpreter's start and every import."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - int(fields[19]) / ticks
    return time.time() - age


def require_cards(count: int) -> None:
    """Raise ``NoCard`` unless CUDA is there with at least ``count`` devices."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < count:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell needs {count}")


def card(index: int = 0) -> Dict:
    """The card's name as torch gives it and its power limit as nvidia-smi
    reads it (None where nvidia-smi does not answer)."""
    import torch

    info = {"kind": torch.cuda.get_device_name(index), "power_limit_w": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return info


def forbidden_modules() -> List[str]:
    """The forbidden top-level names present in ``sys.modules``, compared
    whole (the part of each module name before its first dot)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))

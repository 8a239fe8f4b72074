"""The device's busy share of an untraced training step of the hash-grid
field: its time a traced step over the untraced window's seconds a step.
Low where the host's dispatch holds the card back, as it does at 1024 rays
a step; fewer launches or a CUDA graph of the step would raise it."""

from benchmark.harness.readings import untraced_busy_pct

UNIT = "%"
LAYER = "device"
MOVES = "train_step_device_ms"
SOURCE = "device_trace"


def read(info):
    return untraced_busy_pct(info, "steps")

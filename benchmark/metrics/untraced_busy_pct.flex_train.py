"""The device's busy share of an untraced training step, in a cell whose
end-to-end number is the device's time a step: that time over the
untraced window's seconds a step. Low where the host's dispatch holds the
card back; a CUDA graph of the step would raise it."""

from benchmark.harness.readings import untraced_busy_pct

UNIT = "%"
LAYER = "device"
MOVES = "train_step_device_ms"
SOURCE = "device_trace"


def read(info):
    return untraced_busy_pct(info, "steps")

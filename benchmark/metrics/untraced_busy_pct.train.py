"""The device's busy share of an untraced training step: the union of its
operations' intervals a traced step, over the untraced window's seconds a
step. The profiler lengthens the host's side of a step, not the device's
work, so this reads the step as the window runs it; a host-bound step
reads low, a device-bound one near 100."""

from benchmark.harness.readings import untraced_busy_pct

UNIT = "%"
LAYER = "device"
MOVES = "train_rays_per_s"
SOURCE = "device_trace"


def read(info):
    return untraced_busy_pct(info, "steps")

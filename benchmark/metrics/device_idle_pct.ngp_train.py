"""The share of the hash-grid field's traced training steps in which no
operation ran on the device: 100 - the union of its operations' intervals
over the traced window, the profiler's host cost included
(``untraced_busy_pct.ngp_train`` sets the busy time against the untraced
step)."""

from benchmark.harness.readings import idle_pct

UNIT = "%"
LAYER = "device"
MOVES = "train_step_device_ms"
SOURCE = "device_trace"


def read(info):
    return idle_pct(info, "steps")

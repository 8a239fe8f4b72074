"""The share of the traced training steps in which no operation ran on the
device: 100 - the union of its operations' intervals over the traced window.
Read under the profiler, whose host cost lengthens a host-bound step (by
about half for the flagship's): the idle share includes that cost.
``untraced_busy_pct.train`` sets the same busy time against the untraced
step."""

from benchmark.harness.readings import idle_pct

UNIT = "%"
LAYER = "device"
MOVES = "train_rays_per_s"
SOURCE = "device_trace"


def read(info):
    return idle_pct(info, "steps")

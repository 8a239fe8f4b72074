"""The share of the traced frames in which no operation ran on the device:
100 - the union of its operations' intervals over the window."""

from benchmark.harness.readings import idle_pct

UNIT = "%"
LAYER = "device"
MOVES = "frame_ms"
SOURCE = "device_trace"


def read(info):
    return idle_pct(info, "frames")

"""End to end: the device's busy time a training step, in ms: the union of
the card's operations' intervals over one call of ``steps_per_call`` steps
run under the profiler once the window has closed, over its steps. What a
step costs on the card; the host's speed, which drifts from run to run,
leaves it alone."""

from benchmark.harness.readings import device_ms_per_unit

UNIT = "ms"
SOURCE = "device_trace"


def read(info):
    return device_ms_per_unit(info, "steps")

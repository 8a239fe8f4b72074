"""Device operations (kernels, copies, sets) launched a training step of the
hash-grid field, in a cell whose end-to-end number is the device's time a
step: each launch costs the card its own few microseconds besides the
host's dispatch, and a fused encoding + MLP kernel would cut the field's
share of them. Read from the trace; the count repeats exactly from run to
run."""

from benchmark.harness.readings import launches_per_unit

UNIT = "launches"
LAYER = "engine.train: host dispatch of the step"
MOVES = "train_step_device_ms"
SOURCE = "device_trace"


def read(info):
    return launches_per_unit(info, "steps")

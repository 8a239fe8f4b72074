"""The whole training step's share of the card's peak on the card's own
time: the model's operations a step (3 forwards of both fields, from the
widths) over the device's busy time a traced step, over the peak at the
compute precision. It bounds the kernels' rooflines in the same cell."""

from benchmark.harness.readings import device_mfu_pct

UNIT = "%"
LAYER = "engine.train: the whole step"
MOVES = "train_step_device_ms"
SOURCE = "device_trace"


def read(info):
    return device_mfu_pct(info, training=True)

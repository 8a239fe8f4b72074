"""The whole training step's share of the card's peak: the model's
operations (3 forwards of both fields a step, counted from the widths) over
the untraced window, over the peak at the compute precision."""

from benchmark.harness.readings import mfu_pct

UNIT = "%"
LAYER = "engine.train: the whole step"
MOVES = "train_rays_per_s"
SOURCE = "host_clock"


def read(info):
    return mfu_pct(info, training=True)

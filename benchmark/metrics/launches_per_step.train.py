"""Device operations (kernels, copies, sets) launched a training step: the
host's dispatch of the step (autograd, compositing, resampling, Adam, the
schedule). Read from the trace; the count repeats exactly from run to run."""

from benchmark.harness.readings import launches_per_unit

UNIT = "launches"
LAYER = "engine.train: host dispatch of the step"
MOVES = "train_rays_per_s"
SOURCE = "device_trace"


def read(info):
    return launches_per_unit(info, "steps")

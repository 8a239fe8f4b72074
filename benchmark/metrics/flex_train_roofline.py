"""The 4x128 training pair (#8, ``kernels/flex_train``) against its roofline:
the least time of the coarse and fine fields' forward and backward of a
step over the device time of its kernels, matched by name."""

from benchmark.harness.readings import roofline_pct

UNIT = "%"
LAYER = "kernels.flex_train"
MOVES = "train_step_device_ms"
SOURCE = "device_trace"
# The pair's launches: forward, layer gradients, weight gradients, their sum
# over chunks, the per-ray direction gradient.
PATTERNS = (r"\btrain_fwd(_one)?_kernel", r"\btrain_bwd_(act|act_one|wgrad|reduce|ddc)_kernel")


def read(info):
    return roofline_pct(info, "FlexibleNeRFModel", PATTERNS, training=True)

"""The 8x256 training pair (#9, ``kernels/paper_train``) against its
roofline: the least time of the coarse and fine fields' forward and backward
of a step over the device time of its kernels, matched by name."""

from benchmark.harness.readings import roofline_pct

UNIT = "%"
LAYER = "kernels.paper_train"
MOVES = "train_rays_per_s"
SOURCE = "device_trace"
PATTERNS = (r"\btrain_fwd(_one)?_kernel", r"\btrain_bwd_(act|act_one|wgrad|reduce|ddc)_kernel")


def read(info):
    return roofline_pct(info, "PaperNeRFModel", PATTERNS, training=True)

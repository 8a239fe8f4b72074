"""The 4x128 render forward (#1, ``kernels/mlp_t``) against its roofline:
the least time of a frame's coarse and fine field evaluations over the
device time of its kernel."""

from benchmark.harness.readings import roofline_pct

UNIT = "%"
LAYER = "kernels.mlp_t"
MOVES = "frame_ms"
SOURCE = "device_trace"
PATTERNS = (r"\bmlp_t_kernel",)


def read(info):
    return roofline_pct(info, "FlexibleNeRFModel", PATTERNS, training=False)

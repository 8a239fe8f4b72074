"""The 8x256 render forward (#4, ``kernels/paper_t``) against its roofline:
the least time of a frame's coarse and fine field evaluations over the
device time of its kernel."""

from benchmark.harness.readings import roofline_pct

UNIT = "%"
LAYER = "kernels.paper_t"
MOVES = "frame_ms"
SOURCE = "device_trace"
PATTERNS = (r"\bpaper_t_kernel",)


def read(info):
    return roofline_pct(info, "PaperNeRFModel", PATTERNS, training=False)

"""The whole frame's share of the card's peak: the forward operations of
both fields a frame (from the widths) over the untraced window, over the
peak at the compute precision."""

from benchmark.harness.readings import mfu_pct

UNIT = "%"
LAYER = "serve_nerf.RenderService: the whole frame"
MOVES = "frame_ms"
SOURCE = "host_clock"


def read(info):
    return mfu_pct(info, training=False)

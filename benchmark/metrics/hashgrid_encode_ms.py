"""The hash-encoding kernel pair's device time a traced training step, in
ms: every launch of the kernels matched by name (the coarse and the fine
field's encodings, forward and backward; not the fill that zeroes the
table's gradient before the backward). Nothing where the cell's fields are
of another type or no such kernel ran."""

from benchmark.harness import trace as tr

UNIT = "ms"
LAYER = "kernels.hashgrid"
MOVES = "train_step_device_ms"
SOURCE = "device_trace"
TYPE = "HashGridNeRFModel"
PATTERNS = (r"\bhash_encode_(fwd|bwd)_kernel",)


def read(info):
    traced = info.get("traced")
    if traced is None or not traced.get("steps") or \
            info["config"]["models"]["coarse"]["type"] != TYPE:
        return None
    seconds, launched = tr.matching_seconds(traced["trace"], PATTERNS)
    if launched == 0 or seconds <= 0:
        return None
    return 1e3 * seconds / traced["steps"]

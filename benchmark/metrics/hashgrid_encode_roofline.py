"""The hash-encoding kernel pair (``kernels/hashgrid``) against its roofline:
the least time of a step's encodings (the coarse field's and the fine
field's points, forward and backward) over the device time of the kernels
matched by name. Bound by bytes at the memory rate: the points in each way,
the features out and their gradient in once, each field's table read once
forward (``encode_bytes`` of the type's plug-in; the fill that zeroes the
table's gradient is neither counted nor matched). Nothing where the cell's fields are of another type or no
such kernel ran."""

from benchmark.harness import counts, spec
from benchmark.harness import trace as tr
from benchmark.harness.readings import points, step_rays

UNIT = "%"
LAYER = "kernels.hashgrid"
MOVES = "train_step_device_ms"
SOURCE = "device_trace"
TYPE = "HashGridNeRFModel"
PATTERNS = (r"\bhash_encode_(fwd|bwd)_kernel",)


def read(info):
    traced, config = info.get("traced"), info["config"]
    model = config["models"]["coarse"]
    if traced is None or not traced.get("steps") or model["type"] != TYPE:
        return None
    seconds, launched = tr.matching_seconds(traced["trace"], PATTERNS)
    if launched == 0 or seconds <= 0:
        return None
    plugin = spec.model_type(TYPE, info.get("root", spec.ROOT)).plugin
    dtype = str(config["nerf"]["train"].get("compute_dtype", "float32"))
    least = sum(plugin.encode_bytes(model, n, True, dtype)
                for n in points(config, "train", step_rays(config))) / counts.HBM_BYTES_PER_S
    return 100.0 * least * traced["steps"] / seconds

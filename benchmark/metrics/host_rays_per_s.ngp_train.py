"""The rays of every step of the hash-grid field finished in the untraced
window over the window, by the host's clock: the training rate a user sees,
which the host's dispatch binds at 1024 rays a step. Read per layer beside
the device's time a step."""

UNIT = "rays/s"
LAYER = "engine.train: the whole step"
MOVES = "train_step_device_ms"
SOURCE = "host_clock"


def read(info):
    return info["window"].get("train_rays_per_s")

"""One driver a kind of traffic: ``train`` (ray batches from a store through
the training loop) and ``render`` (poses through the render service). A
traffic file names its driver under ``"driver"``."""

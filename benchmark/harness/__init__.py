"""The general part of the benchmark: finding cells and metrics by name,
the device, operation counts and peaks, trace reduction, the result line."""

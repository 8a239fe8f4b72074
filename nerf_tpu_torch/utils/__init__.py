"""Small host-side utilities."""

from .logging import MetricWriter, RateMeter
from .png import write_png

__all__ = ["MetricWriter", "RateMeter", "write_png"]

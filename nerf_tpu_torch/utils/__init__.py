"""Small host-side utilities."""

from .logging import MetricWriter, RateMeter
from .png import png_bytes, write_png

__all__ = ["MetricWriter", "RateMeter", "png_bytes", "write_png"]

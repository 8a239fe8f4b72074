"""Small host-side utilities."""

from .logging import MetricWriter, RateMeter
from .metrics import ScalarMetric, psnr, ssim
from .png import png_bytes, write_png

__all__ = ["MetricWriter", "RateMeter", "ScalarMetric", "png_bytes", "psnr", "ssim",
           "write_png"]

"""Small host-side utilities."""

from .png import write_png

__all__ = ["write_png"]

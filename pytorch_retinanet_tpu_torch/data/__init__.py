"""Data helpers of the port (the loader itself is ROADMAP A8)."""

from .loader import pad_targets

__all__ = ["pad_targets"]

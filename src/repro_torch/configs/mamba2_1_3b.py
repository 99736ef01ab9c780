"""Config module for --arch mamba2-1-3b (see registry.py for the spec)."""
from .registry import mamba2_1_3b as CONFIG  # noqa: F401

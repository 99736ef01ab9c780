"""Config module for --arch starcoder2-3b (see registry.py for the spec)."""
from .registry import starcoder2_3b as CONFIG  # noqa: F401

"""Config module for --arch jamba-1-5-large-398b (see registry.py for the spec)."""
from .registry import jamba_1_5_large_398b as CONFIG  # noqa: F401

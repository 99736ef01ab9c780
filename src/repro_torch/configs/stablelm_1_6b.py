"""Config module for --arch stablelm-1-6b (see registry.py for the spec)."""
from .registry import stablelm_1_6b as CONFIG  # noqa: F401

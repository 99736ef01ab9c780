"""Config module for --arch qwen2-1-5b (see registry.py for the spec)."""
from .registry import qwen2_1_5b as CONFIG  # noqa: F401

"""Config module for --arch deepseek-v2-lite-16b (see registry.py for the spec)."""
from .registry import deepseek_v2_lite_16b as CONFIG  # noqa: F401

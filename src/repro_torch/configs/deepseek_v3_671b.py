"""Config module for --arch deepseek-v3-671b (see registry.py for the spec)."""
from .registry import deepseek_v3_671b as CONFIG  # noqa: F401

"""Config module for --arch llama-3-2-vision-11b (see registry.py for the spec)."""
from .registry import llama_3_2_vision_11b as CONFIG  # noqa: F401

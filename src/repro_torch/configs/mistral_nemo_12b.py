"""Config module for --arch mistral-nemo-12b (see registry.py for the spec)."""
from .registry import mistral_nemo_12b as CONFIG  # noqa: F401

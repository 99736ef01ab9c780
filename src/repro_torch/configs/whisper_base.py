"""Config module for --arch whisper-base (see registry.py for the spec)."""
from .registry import whisper_base as CONFIG  # noqa: F401

"""Where the port's entry points run: on CUDA unless the caller asks for
the CPU. A CUDA run on a machine without CUDA raises instead of silently
carrying on on the CPU. ``meta`` (shapes and dtypes, no storage) is taken
only when asked for by name: the dry run's plan-only builds
(``launch/steps.abstract_state``); nothing falls back to it."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or 'meta'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(CLI: --device cpu) to run on the CPU")
    return dev

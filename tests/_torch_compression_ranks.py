"""What each rank of ``tests/test_torch_train_compression.py`` runs (imports
no JAX, so the spawned ranks start quickly): its own slice of the input
through ``compressed_psum`` over the default gloo group."""

from __future__ import annotations

import os

import numpy as np
import torch


def main(rank: int, x: np.ndarray) -> dict:
    os.nice(10)  # leave the suite's other workers their cores
    import torch.distributed as dist

    from repro_torch.train.compression import compressed_psum

    out = compressed_psum(torch.from_numpy(x[rank]))
    return {"out": out.numpy(), "dtype": str(out.dtype), "world": dist.get_world_size()}

"""Joining the ``torch.distributed`` job of a multi-process run.

``--executor shardmap`` runs one process per device of the bit-mesh, the
port's counterpart of the reference's virtual device count
(``XLA_FLAGS=--xla_force_host_platform_device_count``) and
``jax.devices()``. PyTorch starts such a job with ``torchrun`` (``python -m
torch.distributed.run``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT`` in
every worker. :func:`join` puts this process in that job:

* a process group that already exists (a library caller's, or one started by
  :func:`repro_torch.sim.ranks.run_ranks`) is used as it is, never a second;
* otherwise, under ``torchrun``, the group is initialised from the
  environment (``init_method="env://"``) with a bounded timeout;
* otherwise it raises :class:`LaunchError`, naming ``torchrun``.

The backend is the one asked for: ``nccl`` on CUDA and ``gloo`` on the CPU
by default. Under NCCL each local rank takes its own card,
``cuda:LOCAL_RANK``; NCCL refuses two ranks on one card ("Duplicate GPU
detected"), so that placement is refused before the group starts. Under
gloo several local ranks may share a card, ``cuda:LOCAL_RANK % cards``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")
INIT_TIMEOUT_S = 300.0  # the rendezvous, and each collective after it
NCCL_ON_CPU = ("NCCL moves CUDA tensors only: with --device cpu use --dist-backend gloo "
               "(the default there)")


class LaunchError(RuntimeError):
    """This process cannot join a process group as asked: no launcher, or a
    backend and device placement that cannot work."""


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(backend: str, device_type: str, local_rank: int, local_world: int,
                cards: int) -> torch.device:
    """The device of local rank ``local_rank`` of ``local_world`` on a host
    with ``cards`` CUDA devices. Raises :class:`LaunchError` for NCCL on
    the CPU and for NCCL with more local ranks than cards."""
    if backend == "nccl" and device_type != "cuda":
        raise LaunchError(NCCL_ON_CPU)
    if device_type == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        if local_world > cards:
            raise LaunchError(
                f"NCCL takes one rank per card, and this host runs {local_world} ranks on "
                f"{cards} card(s) (NCCL would fail with 'Duplicate GPU detected'): pass "
                "--dist-backend gloo to run several ranks on one card")
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % cards)


@dataclass
class RankContext:
    """This process's place in the job: its rank, the world size, the group's
    backend, its device, and whether :func:`join` created the group (and so
    :meth:`close` destroys it)."""

    rank: int
    world: int
    backend: str
    device: torch.device
    owns_group: bool

    def devices(self) -> List[str]:
        """Every rank's device, in rank order. A collective: every rank
        calls it."""
        from ..sim.collective import Transport

        index = -1 if self.device.type == "cpu" else self.device.index
        got = Transport(None, self.device).all_gather(np.array([index], dtype=np.int64))
        return ["cpu" if int(g[0]) < 0 else f"cuda:{int(g[0])}" for g in got]

    def close(self) -> None:
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def join(backend: Optional[str], device_type: str,
         timeout_s: float = INIT_TIMEOUT_S,
         what: str = "--executor shardmap runs one process per rank of the bit-mesh",
         example: str = "repro_torch.launch.simulate ... --executor shardmap") -> RankContext:
    """Join the job as set out in the module docstring. ``backend``:
    ``"nccl"``, ``"gloo"`` or None (the device's default); ``device_type``:
    ``"cuda"`` or ``"cpu"``; ``what`` and ``example`` word the error of a
    process started without a launcher."""
    if backend == "nccl" and device_type != "cuda":
        raise LaunchError(NCCL_ON_CPU)
    in_group = dist.is_available() and dist.is_initialized()
    missing = [v for v in TORCHRUN_VARS if v not in os.environ]
    if not in_group and missing:
        raise LaunchError(
            f"{what}, and this process "
            f"is in no process group and has no launcher's environment (no {', '.join(missing)})"
            f": start it with torchrun, e.g. `torchrun --nproc-per-node 8 -m {example}`")
    resolve_device(device_type)  # CUDA asked for and absent raises here
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if in_group:
        have = str(dist.get_backend())
        if backend is not None and backend != have:
            raise LaunchError(f"this process is in a {have} process group, not {backend}")
        rank, world = dist.get_rank(), dist.get_world_size()
        # a group started without torchrun (run_ranks) has only local ranks
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        device = rank_device(have, device_type, local_rank, local_world, cards)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return RankContext(rank, world, have, device, owns_group=False)
    backend = backend or default_backend(device_type)
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = rank_device(backend, device_type, local_rank, local_world, cards)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # before the group: NCCL binds the current card
    dist.init_process_group(backend, init_method="env://",
                            timeout=timedelta(seconds=timeout_s))
    return RankContext(dist.get_rank(), dist.get_world_size(), backend, device,
                       owns_group=True)

"""Explicit-collective distributed executor (the shardmap path):
compatibility shim.

The twin of ``repro/sim/shardmap_executor.py``. The stage loop, the
per-shard op dispatch and the remap choreography live in
:mod:`repro_torch.sim.engine` (:class:`ExecutionEngine` +
:class:`ShardMapBackend`); this module keeps the historical entry point.

One ``torch.distributed`` rank per device of the bit-mesh: rank ``d``
holds the ``2^L`` amplitudes whose non-local physical bits spell ``d``,
and runs the compiled op list on them with no communication within a
stage. The inter-stage remap is the paper's choreography:

* (A) local transpose + local flips,
* (B) one grouped all-to-all that swaps the ``m`` outgoing local bits with
  the ``m`` incoming device bits,
* (C) one permute of the residual device-bit permutation (lazy flips on
  non-local bits folded into the target rank),
* (D) a final local transpose.

Each rank sends ``(1 - 2^-m)`` of its shard in B and at most one shard in
C: the paper's Eq. 2 communication model. Every rank constructs the
executor and makes the same calls in the same order.
"""

from __future__ import annotations

import torch

from ..core.circuit import Circuit
from ..core.partition import SimulationPlan
from ..device import DeviceLike
# re-exported for backward compatibility
from .engine import (  # noqa: F401
    ExecutionEngine,
    RemapPlan,
    ShardMapBackend,
    _build_remap_plan,
)


class ShardMapExecutor:
    """Explicit-collective staged executor (shim over ExecutionEngine).

    The reference's signature, with ``use_kernels`` (the hand kernels; the
    engine's default) in place of ``use_pallas`` and an explicit
    ``device``. ``devices`` is the process group whose ranks form the
    bit-mesh (the default group when None); ``dtype`` must be the kernels'
    complex64."""

    def __init__(
        self,
        circuit: Circuit,
        plan: SimulationPlan,
        devices=None,
        dtype=torch.complex64,
        use_kernels: bool = True,
        device: DeviceLike = None,
    ):
        if dtype != torch.complex64:
            raise ValueError(f"the port runs complex64 states, not {dtype}")
        self.engine = ExecutionEngine(
            circuit, plan, use_kernels=use_kernels, device=device,
            backend=ShardMapBackend(group=devices),
        )

    def __getattr__(self, name: str):
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)

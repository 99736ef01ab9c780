"""Staged executor on one device: compatibility shim.

The twin of ``repro/sim/executor.py``. The stage loop, op dispatch and
remap logic live in :mod:`repro_torch.sim.engine` (:class:`ExecutionEngine`
with :class:`CudaBackend`); this module keeps the historical entry points,
``StagedExecutor`` and ``simulate_partitioned``.

The reference's ``mesh`` places the packed ``[2^G, 2^R, 2^L]`` state on a
device mesh and lets GSPMD lower each remap to collectives. PyTorch has no
such compiler-scheduled sharding, so the port's multi-device path is the
explicit-collective one: one ``torch.distributed`` rank per device of the
bit-mesh (:class:`repro_torch.sim.shardmap_executor.ShardMapExecutor`, or
``--executor shardmap`` of ``repro_torch.launch.simulate`` under
``torchrun``). A mesh here is refused; the run never falls back to one
device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.circuit import Circuit
from ..core.partition import SimulationPlan
from ..device import DeviceLike
# re-exported for backward compatibility
from .engine import CudaBackend, ExecutionEngine, _dep_index, apply_op, apply_remap  # noqa: F401

MESH_REFUSED = ("the port has no GSPMD mesh: run the bit-mesh as torch.distributed ranks "
                "through ShardMapExecutor (repro_torch.sim.shardmap_executor) or "
                "`torchrun ... -m repro_torch.launch.simulate --executor shardmap`")


class StagedExecutor:
    """Executes a compiled plan on one device (shim over
    ``ExecutionEngine(backend=CudaBackend())``); everything not defined here
    (``run``, ``run_packed``, ``run_batch``, ``measurement_frame``, ``cc``,
    ...) is forwarded to the engine.

    The reference's signature, with ``use_kernels`` (the hand kernels; the
    engine's default) in place of ``use_pallas`` and an explicit ``device``
    (CUDA unless asked otherwise). ``mesh`` must be None (raises
    ``ValueError`` otherwise); ``dtype`` must be the kernels' complex64."""

    def __init__(
        self,
        circuit: Circuit,
        plan: SimulationPlan,
        mesh=None,
        dtype=torch.complex64,
        use_kernels: bool = True,
        device: DeviceLike = None,
    ):
        if mesh is not None:
            raise ValueError(MESH_REFUSED)
        if dtype != torch.complex64:
            raise ValueError(f"the port runs complex64 states, not {dtype}")
        self.engine = ExecutionEngine(circuit, plan, use_kernels=use_kernels, device=device,
                                      backend=CudaBackend())

    def __getattr__(self, name: str):
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)


def simulate_partitioned(
    circuit: Circuit,
    L: int,
    R: int = 0,
    G: int = 0,
    mesh=None,
    dtype=torch.complex64,
    psi0=None,
    device: DeviceLike = None,
    **plan_kw,
) -> Tuple[torch.Tensor, SimulationPlan]:
    """Partition ``circuit`` and run it on one device: ``(state, plan)``,
    the state in logical order."""
    from ..core.partition import partition

    if mesh is not None:
        raise ValueError(MESH_REFUSED)
    plan = partition(circuit, L, R, G, **plan_kw)
    ex = StagedExecutor(circuit, plan, dtype=dtype, device=device)
    return ex.run(psi0), plan

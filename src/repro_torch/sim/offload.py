"""Host-memory offloaded execution (paper §VII-C, the QDAO comparison).

The twin of ``repro/sim/offload.py``. The streaming stage loop and the host
remaps live in :class:`repro_torch.sim.engine.OffloadBackend`; this module
keeps the two entry points the reference has:

* :class:`OffloadedExecutor` — an engine on the offload backend: the state
  lives in host memory as ``2^(R+G)`` shards of ``2^L`` amplitudes and each
  stage streams every shard through the device once, so host traffic grows
  with the number of stages, not of gates;
* :class:`PerGateOffloadExecutor` — the per-gate baseline (QDAO-style): no
  staging, every op of a one-gate-per-kernel plan is its own pass over every
  shard, through the same kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.circuit import Circuit
from ..core.kernelization import Kernel
from ..core.partition import SimulationPlan, partition
from ..device import DeviceLike
from .compile import StageProgram
from .engine import ExecutionEngine, OffloadBackend


class OffloadedExecutor:
    """Streams host-resident shards through the device, stage by stage: an
    :class:`ExecutionEngine` on the offload backend, with the reference's
    ``run(psi0, apply_final_remap)`` and the backend's ``stats``. Every
    other attribute is the engine's."""

    def __init__(self, circuit: Circuit, plan: SimulationPlan, peephole: bool = True,
                 use_kernels: bool = True, device: DeviceLike = None):
        self.engine = ExecutionEngine(circuit, plan, use_kernels, device, backend="offload",
                                      peephole=peephole)

    def run(self, psi0=None, apply_final_remap: bool = True) -> torch.Tensor:
        """The final host state in logical order, or with
        ``apply_final_remap=False`` in the last stage's physical layout
        (see ``measurement_frame``), which the streaming measurer reads in
        one pass."""
        if apply_final_remap:
            return self.engine.run(psi0)
        return self.engine.run_packed(psi0)

    @property
    def stats(self) -> Dict[str, int]:
        """The offload backend's counters (shard transfers, host remaps, ...)."""
        return self.engine.backend.stats

    def __getattr__(self, name: str):
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)


def per_gate_plan(circuit: Circuit, L: int) -> SimulationPlan:
    """Greedy staging, then every kernel split into one kernel per gate (on
    the kernel's qubits), as the reference's baseline plans."""
    plan = partition(circuit, L, circuit.n_qubits - L, 0, staging_method="greedy",
                     kernelize_method="greedy", validate=False)
    for st in plan.stages:
        st.kernels = [Kernel(kind=k.kind if k.kind == 2 else 0, qubits=k.qubits,
                             gate_ids=[gid], cost=0.0)
                      for k in st.kernels for gid in k.gate_ids]
    return plan


class PerGateOffloadExecutor:
    """QDAO-style baseline: every op of :func:`per_gate_plan`'s program is
    its own pass over every host shard (no staging of passes), through the
    offload backend's ring and the same kernels as the staged path."""

    def __init__(self, circuit: Circuit, n_local: int, use_kernels: bool = True,
                 device: DeviceLike = None):
        self.circuit = circuit
        self.L = n_local
        self.use_kernels = use_kernels
        self.device = device
        self.engine: Optional[ExecutionEngine] = None

    @property
    def stats(self) -> Dict[str, int]:
        """Shard round trips (as the reference counts them) and host remaps
        of every run so far."""
        st = self.engine.backend.stats if self.engine is not None else {}
        return {k: st.get(k, 0) for k in ("shard_transfers", "host_remaps")}

    def run(self, psi0=None) -> torch.Tensor:
        """The final host state in logical order."""
        if self.engine is None:
            # peephole off: the baseline pays one pass per GATE by construction
            self.engine = ExecutionEngine(
                self.circuit, per_gate_plan(self.circuit, self.L), self.use_kernels,
                self.device, backend="offload", peephole=False)
        be: OffloadBackend = self.engine.backend
        run = be.new_run(1)
        be.trace = []

        def per_op(state, prog):
            for op in prog.ops:
                state = be.stream_stage(state, StageProgram([op], prog.layout, None), run)
            return state

        return self.engine.stage_loop(be.prepare(psi0), per_op, be.host_remap).view(-1)

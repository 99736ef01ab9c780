"""Carry the reference's artifacts across into the port's objects.

The JAX package serializes a circuit (``Circuit.to_json()``), a plan
(``SimulationPlan.to_json()``) and an engine's op tensors (``{uid:
ndarray}``). The port's ``Circuit.from_json`` and ``SimulationPlan.from_json``
read the first two; :func:`engine_from_reference` builds a port engine from
all three, so the port runs exactly the reference's plan and tensors. It
takes JSON strings and numpy arrays only: the port never imports the JAX
package.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .core.circuit import Circuit
from .core.partition import SimulationPlan
from .device import DeviceLike
from .sim.engine import ExecutionEngine


def engine_from_reference(
    circuit_json: str,
    plan_json: str,
    tensors: Mapping[int, np.ndarray],
    *,
    use_kernels: bool = True,
    device: DeviceLike = None,
) -> ExecutionEngine:
    """A port engine on the reference's circuit and plan whose constant
    registry holds the reference's op tensors (uids and shapes must match
    the port's compiled program, which they do when both compilers see the
    same plan)."""
    eng = ExecutionEngine(Circuit.from_json(circuit_json), SimulationPlan.from_json(plan_json),
                          use_kernels=use_kernels, device=device)
    eng.load_consts({int(uid): np.asarray(t) for uid, t in tensors.items()})
    return eng

"""Carry the reference's artifacts across into the port's objects.

The JAX package serializes a circuit (``Circuit.to_json()``), a plan
(``SimulationPlan.to_json()``) and an engine's op tensors (``{uid:
ndarray}``). The port's ``Circuit.from_json`` and ``SimulationPlan.from_json``
read the first two; :func:`engine_from_reference` builds a port engine from
all three, so the port runs exactly the reference's plan and tensors. It
takes JSON strings and numpy arrays only: the port never imports the JAX
package.

:func:`lm_params_from_reference` carries an LM's weights across: the
reference's parameter tree (numpy arrays, as ``jax.tree.map(np.asarray,
model.init(key))`` gives it) into a port :class:`~repro_torch.models.
transformer.Model`'s parameters, stacked leaves one to one.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.circuit import Circuit
from .core.partition import SimulationPlan
from .device import DeviceLike
from .models.transformer import Model, flatten_tree
from .sim.engine import ExecutionEngine


def engine_from_reference(
    circuit_json: str,
    plan_json: str,
    tensors: Mapping[int, np.ndarray],
    *,
    use_kernels: bool = True,
    device: DeviceLike = None,
    backend: str = "cuda",
) -> ExecutionEngine:
    """A port engine on the reference's circuit and plan whose constant
    registry holds the reference's op tensors (uids and shapes must match
    the port's compiled program, which they do when both compilers see the
    same plan). ``backend``: any of the engine's (``"offload"`` runs the
    reference's plan and tensors with the state in host memory)."""
    eng = ExecutionEngine(Circuit.from_json(circuit_json), SimulationPlan.from_json(plan_json),
                          use_kernels=use_kernels, device=device, backend=backend)
    eng.load_consts({int(uid): np.asarray(t) for uid, t in tensors.items()})
    return eng


def lm_params_from_reference(model: Model, tree: Any) -> Model:
    """Load the reference's parameter tree into ``model`` (in place; returns
    it). Each leaf's path joined by ``.`` names a parameter. A missing or
    extra key, or a shape that differs, raises ``ValueError``; bf16 leaves
    go through float32, which ``torch.from_numpy`` needs."""
    leaves = flatten_tree(tree)
    own = dict(model.named_parameters())
    missing, extra = sorted(set(own) - set(leaves)), sorted(set(leaves) - set(own))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, extra {extra}")
    state = {}
    for name, leaf in leaves.items():
        arr = np.array(leaf, np.float32)
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != the port's "
                             f"{tuple(own[name].shape)}")
        state[name] = torch.from_numpy(arr).to(own[name].dtype)
    model.load_state_dict(state)
    return model

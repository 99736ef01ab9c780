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
transformer.Model`'s parameters, stacked leaves one to one;
:func:`adamw_state_from_reference` carries its optimizer state (the
reference's ``AdamWState`` as numpy) into the port's, keyed by the same
parameter names, so a training run crosses mid-run. On a model on a mesh
(or with ``mesh``) every rank passes the whole tree, and each keeps the
slices the reference's placements give it, as ``build_model`` places drawn
weights.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.circuit import Circuit
from .core.partition import SimulationPlan
from .device import DeviceLike
from .models.parallel import distribute_like
from .models.transformer import Model, flatten_tree
from .optim.adamw import AdamWState
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


def _same_names(model: Model, leaves: Mapping[str, Any], what: str) -> dict:
    own = dict(model.named_parameters())
    missing, extra = sorted(set(own) - set(leaves)), sorted(set(leaves) - set(own))
    if missing or extra:
        raise ValueError(f"{what} trees differ: missing {missing}, extra {extra}")
    for name, leaf in leaves.items():
        if tuple(np.shape(leaf)) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(np.shape(leaf))} != the port's "
                             f"{tuple(own[name].shape)}")
    return own


def lm_params_from_reference(model: Model, tree: Any, mesh=None) -> Model:
    """Load the reference's parameter tree into ``model`` (in place; returns
    it). Each leaf's path joined by ``.`` names a parameter. A missing or
    extra key, or a shape that differs, raises ``ValueError``; bf16 leaves
    go through float32, which ``torch.from_numpy`` needs. ``mesh``: a
    ``DeviceMesh`` to shard a one-device ``model`` on after the load
    (every rank calls it with the same tree); a model already on a mesh
    keeps its slices of each leaf."""
    leaves = flatten_tree(tree)
    own = _same_names(model, leaves, "parameter")
    model.load_full({name: torch.from_numpy(np.array(leaf, np.float32)).to(own[name].dtype)
                     for name, leaf in leaves.items()})
    if mesh is not None and model.mesh is None:
        model.shard(mesh)
    elif mesh is not None and model.mesh is not mesh:
        raise ValueError("the model is on another mesh")
    return model


def adamw_state_from_reference(model: Model, state: Any) -> AdamWState:
    """The reference's ``AdamWState`` (``step``, and ``m``/``v`` trees of
    numpy arrays, float32 or bfloat16) as the port's: moments keyed by
    ``model``'s parameter names, in their own dtype, on its device; the step
    an int32 on the CPU. A missing or extra key, or a shape that differs,
    raises ``ValueError``; bf16 goes through float32."""
    def moments(tree, what):
        leaves = flatten_tree(tree)
        own = _same_names(model, leaves, what)
        out = {}
        for name in own:
            arr = np.asarray(leaves[name])
            dt = torch.bfloat16 if str(arr.dtype) == "bfloat16" else torch.float32
            t = torch.from_numpy(np.array(arr, np.float32)).to(model.device, dt)
            out[name] = distribute_like(t, own[name]) if model.mesh is not None else t
        return out

    return AdamWState(step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
                      m=moments(state.m, "moment m"), v=moments(state.v, "moment v"))

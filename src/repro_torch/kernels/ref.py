"""Plain PyTorch versions of the two hand-written kernels.

Each computes exactly what its kernel computes, with the same arguments and
the same in-place contract, out of ordinary tensor operations. The wrappers
in :mod:`repro_torch.kernels.ops` call them only for tensors on the CPU; the
CPU tests hold them to the JAX package's Pallas kernels, and
``chip_smoke.py`` holds each CUDA kernel to them on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..sim.apply import apply_matrix_bits, mul_bits_

# one shm group member: (kind, local bits, operand [V, ...], variant index [S])
Member = Tuple[str, Tuple[int, ...], torch.Tensor, torch.Tensor]


def fused_apply_ref(
    state: torch.Tensor, u: torch.Tensor, vidx: torch.Tensor,
    bits: Sequence[int], L: int,
) -> torch.Tensor:
    """In place: every shard ``s`` of the flat ``state`` ``[S * 2^L]`` gets
    ``u[vidx[s]]`` (``[2^k, 2^k]``) applied on its local index bits ``bits``
    (bit ``j`` of the matrix index binds to ``bits[j]``). Moves the target
    bits to the bottom, multiplies ``[S, M, K] x [S, K, K]^T``, moves them
    back — the transpose-matmul-transpose of the reference wrapper
    ``repro/kernels/ops.py::apply_fused_shard``."""
    x = state.view(-1, 1 << L)
    us = u[vidx.long()]
    state.copy_(apply_matrix_bits(x, us, bits, lead=1).view(-1))
    return state


def shm_apply_ref(
    state: torch.Tensor, window: Sequence[int], members: Sequence[Member], L: int,
) -> torch.Tensor:
    """In place: apply the members of one shm group to every shard of the
    flat ``state``, one after another. A ``"mat"`` member is a
    ``[V, 2^kg, 2^kg]`` matrix on its bits, a ``"diag"`` member a
    ``[V, 2^kd]`` diagonal indexed by the values of its bits; shard ``s``
    uses variant ``vidx[s]``. ``window`` (the union of the member bits) is
    what the kernel stages on chip; this version does not need it."""
    x = state.view(-1, 1 << L)
    for kind, bits, op, vidx in members:
        sel = op[vidx.long()]
        if kind == "mat":
            x.copy_(apply_matrix_bits(x, sel, bits, lead=1))
        else:
            mul_bits_(x, sel, bits, lead=1)
    return state

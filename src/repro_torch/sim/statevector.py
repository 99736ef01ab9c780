"""Dense single-device reference simulators (the oracles for the engine).

:func:`simulate` applies every gate in order to a torch state on the
device; :func:`simulate_np` is the reference's complex128 numpy oracle,
copied unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.circuit import Circuit
from ..device import DeviceLike, resolve_device
from .apply import apply_matrix_bits


def zero_state(n: int, dtype=torch.complex64, device: DeviceLike = None) -> torch.Tensor:
    psi = torch.zeros(2**n, dtype=dtype, device=resolve_device(device))
    psi[0] = 1.0
    return psi


def simulate(
    circuit: Circuit,
    psi0=None,
    dtype=torch.complex64,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Apply every gate in order to the flat state vector; returns flat psi
    with logical qubit q = index bit q."""
    dev = resolve_device(device)
    n = circuit.n_qubits
    if psi0 is None:
        psi = zero_state(n, dtype, dev)
    else:
        psi = torch.as_tensor(psi0).to(device=dev, dtype=dtype).reshape(-1).clone()
    for g in circuit.gates:
        mat = torch.as_tensor(g.matrix).to(device=dev, dtype=dtype)
        psi = apply_matrix_bits(psi, mat, list(g.qubits))
    return psi


def simulate_np(circuit: Circuit, psi0: Optional[np.ndarray] = None) -> np.ndarray:
    """complex128 numpy oracle (exact-ish; for small n in tests)."""
    n = circuit.n_qubits
    if psi0 is None:
        psi = np.zeros(2**n, dtype=np.complex128)
        psi[0] = 1.0
    else:
        psi = np.asarray(psi0, dtype=np.complex128)
    view = psi.reshape((2,) * n)
    for g in circuit.gates:
        k = g.n_qubits
        mat_t = g.matrix.reshape((2,) * (2 * k))
        state_axes = [n - 1 - b for b in g.qubits]
        in_axes = [2 * k - 1 - j for j in range(k)]
        out = np.tensordot(mat_t, view, axes=(in_axes, state_axes))
        dest = [state_axes[k - 1 - i] for i in range(k)]
        view = np.moveaxis(out, list(range(k)), dest)
    return np.ascontiguousarray(view).reshape(-1)


def fidelity(a, b, chunk: int = 1 << 24) -> float:
    """``|<a|b>|``, accumulated in complex128. Two torch tensors on one
    device are reduced there chunk by chunk (no host copy of a large
    state); anything else goes through numpy."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.device == b.device:
        a, b = a.reshape(-1), b.reshape(-1)
        acc = torch.zeros((), dtype=torch.complex128, device=a.device)
        for i in range(0, a.numel(), chunk):
            acc += torch.vdot(a[i:i + chunk].to(torch.complex128),
                              b[i:i + chunk].to(torch.complex128))
        return float(acc.abs())
    a = _host(a).reshape(-1)
    b = _host(b).reshape(-1)
    return float(abs(np.vdot(a.astype(np.complex128), b.astype(np.complex128))))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

"""The hand-written CUDA kernels against their plain versions, on a card.

Marked ``gpu``: without a CUDA device they skip. Imports no JAX, so they run
on a machine with the card and no JAX:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

ATOL = 1e-4  # float32 arithmetic on O(1) amplitudes


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _unitary(rng, k, V=1):
    out = []
    for _ in range(V):
        q, _ = np.linalg.qr(rng.normal(size=(2**k, 2**k)) + 1j * rng.normal(size=(2**k, 2**k)))
        out.append(q)
    return np.stack(out).astype(np.complex64)


def _members(rng, window, n_members, V=1):
    mem = []
    for q in range(n_members):
        kind = "mat" if q % 3 != 2 else "diag"
        kg = min(len(window), 1 + q % 2 if kind == "mat" else 2 + q % 2)
        bits = tuple(int(b) for b in rng.choice(window, size=kg, replace=False))
        if kind == "mat":
            op = _unitary(rng, kg, V)
        else:
            op = np.exp(1j * rng.uniform(0, 2 * np.pi, size=(V, 1 << kg))).astype(np.complex64)
        mem.append((kind, bits, op))
    return mem


def _t(a):
    return torch.from_numpy(np.array(a, copy=True, order="C"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [[3], [0, 5], [9, 2, 4], [1, 2, 3, 4, 6], [8, 0, 1, 2, 3, 4, 5]])
def test_fused_kernel_on_card(cuda, bits):
    rng = np.random.default_rng(len(bits))
    n, L = 16, 14
    state = _t(_cplx(rng, 1 << n))
    u = _t(_unitary(rng, len(bits), V=2))
    vidx = _t(np.array([0, 1, 1, 0], dtype=np.int32))
    want = ref.fused_apply_ref(state.clone(), u, vidx, bits, L)
    got = ops.fused_apply(state.to(cuda), u.to(cuda), vidx.to(cuda), bits, L)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [[3, 4, 5, 6], [0, 1, 2, 7, 8], list(range(1, 14))])
def test_shm_kernel_on_card(cuda, window):
    rng = np.random.default_rng(sum(window))
    n, L = 16, 14
    state = _t(_cplx(rng, 1 << n))
    mem = [(kind, bits, _t(op), _t(np.array([1, 0, 1, 1], dtype=np.int32)))
           for kind, bits, op in _members(rng, window, 9, V=2)]
    want = ref.shm_apply_ref(state.clone(), window, mem, L)
    got = ops.shm_apply(state.to(cuda), window,
                        [(k, b, o.to(cuda), v.to(cuda)) for k, b, o, v in mem], L)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)

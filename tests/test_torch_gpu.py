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


@pytest.mark.gpu
@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("bits", [[11], [2, 13], [12, 0, 7], [1, 9, 4, 13], [13, 3, 8, 0, 10],
                                  [5, 12, 1, 9, 3, 11], [13, 0, 6, 2, 10, 4, 8]])
def test_fused_kernel_every_width(cuda, bits, V):
    """k = 1..7 on scattered bits, one and two variants: the tensor-core
    kernel (I (x) U below k = 3) against its plain version."""
    rng = np.random.default_rng(10 * len(bits) + V)
    n, L = 16, 14
    state = _t(_cplx(rng, 1 << n))
    u = _t(_unitary(rng, len(bits), V=V))
    vidx = _t(np.array([0, V - 1, V - 1, 0], dtype=np.int32))
    want = ref.fused_apply_ref(state.clone(), u, vidx, bits, L)
    got = ops.fused_apply(state.to(cuda), u.to(cuda), vidx.to(cuda), bits, L)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)


def _mat(rng, bits, V, vidx):
    return ("mat", tuple(bits), _t(_unitary(rng, len(bits), V)), vidx)


def _diag(rng, bits, V, vidx):
    op = np.exp(1j * rng.uniform(0, 2 * np.pi, size=(V, 1 << len(bits)))).astype(np.complex64)
    return ("diag", tuple(bits), _t(op), vidx)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mat3", "mat4", "diag_over_256", "window13", "window12_high"])
def test_shm_kernel_edge_cases(cuda, case):
    """3- and 4-bit matrices (applied in shared memory between phases), a
    diagonal of more than 256 entries, a 13-bit window (the whole tile) and
    a 12-bit window of high bits (the tile adds bit 0 only)."""
    rng = np.random.default_rng(len(case))
    n, L = 16, 14
    vidx = _t(np.array([1, 0, 1, 1], dtype=np.int32))
    if case in ("mat3", "mat4"):
        window = [0, 3, 5, 8, 9, 12]
        kg = int(case[-1])
        mem = [_mat(rng, [5], 2, vidx), _mat(rng, rng.choice(window, kg, replace=False), 2, vidx),
               _mat(rng, [12, 0], 2, vidx), _mat(rng, rng.choice(window, kg, replace=False), 2, vidx),
               _diag(rng, [3, 9], 2, vidx), _mat(rng, [8], 2, vidx)]
    elif case == "diag_over_256":
        window = list(range(2, 13))
        mem = [_mat(rng, [4], 2, vidx), _diag(rng, window, 2, vidx), _mat(rng, [11, 2], 2, vidx),
               _diag(rng, window[::-1][:10], 2, vidx), _mat(rng, [7], 2, vidx)]
    else:
        window = list(range(1, 14)) if case == "window13" else list(range(2, 14))
        mem = [_diag(rng, window, 2, vidx)]
        mem += [_mat(rng, [b], 2, vidx) for b in window]
        mem += [_mat(rng, [window[0], window[-1]], 2, vidx), _diag(rng, window[:9], 2, vidx)]
        mem += [_mat(rng, [b], 2, vidx) for b in window[::-1]]
    state = _t(_cplx(rng, 1 << n))
    want = ref.shm_apply_ref(state.clone(), window, mem, L)
    got = ops.shm_apply(state.to(cuda), window,
                        [(k, b, o.to(cuda), v.to(cuda)) for k, b, o, v in mem], L)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)


@pytest.mark.gpu
def test_shm_kernel_long_group(cuda):
    """A group whose program is about 1500 steps, many chunks of the
    table the kernel stages in shared memory, against the plain version."""
    rng = np.random.default_rng(1500)
    n, L = 16, 14
    window = list(range(1, 14))
    vidx = _t(np.array([1, 0, 1, 1], dtype=np.int32))
    mem = []
    for q in range(1300):
        b = [int(x) for x in rng.choice(window, size=4, replace=False)]
        mem.append(_mat(rng, b[:1], 2, vidx) if q % 5 < 3 else
                   _mat(rng, b[:2], 2, vidx) if q % 5 == 3 else
                   _diag(rng, b[:2], 2, vidx) if q % 10 == 4 else _mat(rng, b[:3 + q % 2], 2, vidx))
    steps = len(ops.shm_descriptors(ops.shm_layout(n, L, window), mem))
    assert 1400 <= steps and steps > 10 * ops.SHM_TABLE_CHUNK
    state = _t(_cplx(rng, 1 << n))
    want = ref.shm_apply_ref(state.clone(), window, mem, L)
    got = ops.shm_apply(state.to(cuda), window,
                        [(k, b, o.to(cuda), v.to(cuda)) for k, b, o, v in mem], L)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [4, 7])
def test_kernels_on_small_shards(cuda, L):
    """Shards smaller than a tile: fused tiles with fewer groups than the
    kernel's warps cover, shm blocks of fewer than 32 threads."""
    rng = np.random.default_rng(L)
    n = L + 2
    state = _t(_cplx(rng, 1 << n))
    vidx = _t(np.array([0, 1, 1, 0], dtype=np.int32))
    bits = [L - 1, 0][: 1 + (L > 4)]
    u = _t(_unitary(rng, len(bits), V=2))
    want = ref.fused_apply_ref(state.clone(), u, vidx, bits, L)
    got = ops.fused_apply(state.to(cuda), u.to(cuda), vidx.to(cuda), bits, L)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)
    if L >= ops.SHM_REG_BITS:
        window = list(range(L))
        mem = [_mat(rng, [0], 2, vidx), _diag(rng, window, 2, vidx), _mat(rng, [L - 1, 2], 2, vidx),
               _mat(rng, [1, 3, 5], 2, vidx), _mat(rng, [6], 2, vidx)]
        want = ref.shm_apply_ref(state.clone(), window, mem, L)
        got = ops.shm_apply(state.to(cuda), window,
                            [(k, b, o.to(cuda), v.to(cuda)) for k, b, o, v in mem], L)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)

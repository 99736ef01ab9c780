"""The port's kernel layer against the JAX package's Pallas kernels.

Mirrors tests/test_kernels.py: the plain versions of both hand-written
kernels (and the wrappers, which run them for CPU tensors) against
``fused_matmul`` / ``shm_apply`` in interpret mode and ``apply_shm_group``,
on the same numpy-seeded inputs at atol 1e-4. The CUDA kernels' tile
addressing is emulated in numpy against the plain versions; the kernels
themselves are held to them on the card by tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fusion import fused_matmul
from repro.kernels.ops import apply_shm_group
from repro.kernels.shm import shm_apply as ref_shm_apply
from repro_torch.kernels import ops, ref

ATOL = 1e-4  # float32 arithmetic on O(1) amplitudes, as in tests/test_kernels.py


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _unitary(rng, k, V=1):
    out = []
    for _ in range(V):
        q, _ = np.linalg.qr(rng.normal(size=(2**k, 2**k)) + 1j * rng.normal(size=(2**k, 2**k)))
        out.append(q)
    return np.stack(out).astype(np.complex64)


def _t(a):
    """A torch copy (the wrappers update states in place)."""
    return torch.from_numpy(np.array(a, copy=True, order="C"))


# ----------------------------------------------------------------------
# fused_apply vs fused_matmul
# ----------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 5, 7])
def test_fused_ref_matches_pallas(k):
    rng = np.random.default_rng(k)
    M, K = 128, 2**k
    s = _cplx(rng, M, K)
    u = _unitary(rng, k)
    o_re, o_im = fused_matmul(
        jnp.array(s.real), jnp.array(s.imag), jnp.array(u[0].real), jnp.array(u[0].imag),
        block_m=32, interpret=True)
    want = np.asarray(o_re) + 1j * np.asarray(o_im)
    n = 7 + k  # flat index = m * K + c: the target bits are the lowest k, in order
    vidx = torch.zeros(1, dtype=torch.int32)
    got = ref.fused_apply_ref(_t(s.reshape(-1)), _t(u), vidx, list(range(k)), n)
    np.testing.assert_allclose(got.numpy().reshape(M, K), want, atol=ATOL)
    ops.reset_kernel_counters()
    got = ops.fused_apply(_t(s.reshape(-1)), _t(u), vidx, list(range(k)), n)
    np.testing.assert_allclose(got.numpy().reshape(M, K), want, atol=ATOL)
    assert ops.kernel_call_counts() == {"fused": 1, "shm": 0}


def test_fused_dep_variants_on_scattered_bits():
    """Per-shard variants on target bits away from the bottom: shard s gets
    u[vidx[s]], compared with the Pallas kernel on the transposed shard."""
    rng = np.random.default_rng(3)
    n, L, bits = 10, 8, [6, 2, 4]
    S, k = 1 << (n - L), len(bits)
    state = _cplx(rng, 1 << n)
    u = _unitary(rng, k, V=2)
    vidx = np.array([1, 0, 0, 1], dtype=np.int32)
    got = ops.fused_apply(_t(state), _t(u), _t(vidx), bits, L).numpy()
    rest = [b for b in range(L) if b not in bits]
    for s in range(S):
        view = state[s << L:(s + 1) << L].reshape((2,) * L)
        perm = [L - 1 - b for b in reversed(rest)] + [L - 1 - b for b in reversed(bits)]
        x = np.transpose(view, perm).reshape(-1, 1 << k)
        U = u[vidx[s]]
        o_re, o_im = fused_matmul(jnp.array(x.real), jnp.array(x.imag),
                                  jnp.array(U.real), jnp.array(U.imag), interpret=True)
        out = (np.asarray(o_re) + 1j * np.asarray(o_im)).reshape((2,) * L)
        want = np.transpose(out, np.argsort(perm)).reshape(-1)
        np.testing.assert_allclose(got[s << L:(s + 1) << L], want, atol=ATOL)


# ----------------------------------------------------------------------
# shm_apply vs shm_apply (Pallas) and apply_shm_group
# ----------------------------------------------------------------------


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


@pytest.mark.parametrize("a,n_members", [(3, 4), (4, 6), (6, 9)])
def test_shm_ref_matches_pallas(a, n_members):
    rng = np.random.default_rng(10 + a)
    M = 16
    x = _cplx(rng, M, 1 << a)
    window = list(range(a))
    mem = _members(rng, window, n_members)
    o_re, o_im = ref_shm_apply(jnp.array(x.real), jnp.array(x.imag),
                               [(bits, op[0]) for _, bits, op in mem], a,
                               block_m=8, interpret=True)
    want = np.asarray(o_re) + 1j * np.asarray(o_im)
    n = 4 + a
    vidx = torch.zeros(1, dtype=torch.int32)
    tm = [(kind, bits, _t(op), vidx) for kind, bits, op in mem]
    got = ref.shm_apply_ref(_t(x.reshape(-1)), window, tm, n)
    np.testing.assert_allclose(got.numpy().reshape(M, -1), want, atol=ATOL)
    ops.reset_kernel_counters()
    got = ops.shm_apply(_t(x.reshape(-1)), window, tm, n)
    np.testing.assert_allclose(got.numpy().reshape(M, -1), want, atol=ATOL)
    assert ops.kernel_call_counts() == {"fused": 0, "shm": 1}


@pytest.mark.parametrize("window", [[2, 3, 5, 6], [1, 4, 7]])
def test_shm_window_not_lowest_with_dep_variants(window):
    """Window bits away from the bottom and per-shard operand variants,
    against the reference's transposing wrapper shard by shard."""
    rng = np.random.default_rng(sum(window))
    n, L = 10, 8
    S = 1 << (n - L)
    state = _cplx(rng, 1 << n)
    mem = _members(rng, window, 6, V=2)
    vidx = np.array([0, 1, 1, 0], dtype=np.int32)
    tm = [(kind, bits, _t(op), _t(vidx)) for kind, bits, op in mem]
    got = ops.shm_apply(_t(state), window, tm, L).numpy()
    for s in range(S):
        view = jnp.asarray(state[s << L:(s + 1) << L].reshape((2,) * L))
        gates = [(bits, op[vidx[s]]) for _, bits, op in mem]
        want = np.asarray(apply_shm_group(view, gates, window)).reshape(-1)
        np.testing.assert_allclose(got[s << L:(s + 1) << L], want, atol=ATOL)


def test_wrappers_reject_what_the_kernels_do_not_take():
    L = 6
    st = torch.zeros(1 << L, dtype=torch.complex64)
    u = torch.zeros(1, 2, 2, dtype=torch.complex64)
    v = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.fused_apply(st.to(torch.complex128), u, v, [0], L)
    with pytest.raises(ValueError):
        ops.fused_apply(st.view(2, -1).t().reshape(-1)[::2], u, v, [0], L)
    with pytest.raises(ValueError):
        ops.fused_apply(st, u, v, [0, 1], L)  # u is 2x2, two bits need 4x4
    with pytest.raises(ValueError):
        ops.fused_apply(st, u, v, [L], L)  # not a local bit
    with pytest.raises(TypeError):
        ops.fused_apply(st, u, v.long(), [0], L)
    m5 = torch.zeros(1, 32, 32, dtype=torch.complex64)
    with pytest.raises(ValueError):  # matrix members hold at most 4 bits
        ops.shm_apply(st, [0, 1, 2, 3, 4], [("mat", (0, 1, 2, 3, 4), m5, v)], L)
    with pytest.raises(ValueError):  # member bits must lie in the window
        ops.shm_apply(st, [0, 1], [("mat", (2,), u, v)], L)


# ----------------------------------------------------------------------
# the CUDA kernels' tile addressing, emulated in numpy
# ----------------------------------------------------------------------


def _insert_zero_bits(i, pos):
    for p in pos:
        i = ((i >> p) << (p + 1)) | (i & ((1 << p) - 1))
    return i


def _tile_addresses(lay, tile_id):
    j = np.arange(1 << lay.t)
    off = np.zeros_like(j)
    for i, p in enumerate(lay.pos):
        off |= ((j >> i) & 1) << p
    return _insert_zero_bits(tile_id, lay.pos) + off


def _emulate_fused(state, u, vidx, bits, L):
    """fused_apply.cu, tile by tile: jc/jg tables, out[g] = U s[g]."""
    n = state.size.bit_length() - 1
    lay = ops.fused_layout(n, L, bits)
    k = len(bits)
    jc = np.array([sum(((c >> b) & 1) << lay.tb[b] for b in range(k)) for c in range(1 << k)])
    jg = np.array([sum(((g >> b) & 1) << lay.gb[b] for b in range(len(lay.gb)))
                   for g in range(1 << len(lay.gb))])
    out, seen = state.copy(), np.zeros(state.size, dtype=int)
    for tile_id in range(lay.n_tiles):
        addr = _tile_addresses(lay, tile_id)
        seen[addr] += 1
        buf = out[addr]
        idx = jg[:, None] + jc[None, :]
        buf[idx] = buf[idx] @ u[vidx[addr[0] >> L]].T
        out[addr] = buf
    assert (seen == 1).all(), "tiles must cover the state exactly once"
    return out


def _emulate_shm(state, window, members, L):
    """shm_apply.cu, tile by tile: members applied in order in the tile."""
    n = state.size.bit_length() - 1
    lay = ops.shm_layout(n, L, window)
    where = {b: i for i, b in enumerate(lay.pos)}
    out, seen = state.copy(), np.zeros(state.size, dtype=int)
    for tile_id in range(lay.n_tiles):
        addr = _tile_addresses(lay, tile_id)
        seen[addr] += 1
        buf = out[addr]
        for kind, bits, op, vidx in members:
            tb = [where[b] for b in bits]
            O = op[vidx[addr[0] >> L]]
            j = np.arange(buf.size)
            e = np.zeros_like(j)
            for q, b in enumerate(tb):
                e |= ((j >> b) & 1) << q
            if kind == "diag":
                buf = buf * O[e]
            else:
                offs = np.array([sum(((c >> q) & 1) << tb[q] for q in range(len(tb)))
                                 for c in range(1 << len(tb))])
                idx = j[e == 0][:, None] + offs[None, :]
                buf[idx] = buf[idx] @ O.T
        out[addr] = buf
    assert (seen == 1).all(), "tiles must cover the state exactly once"
    return out


@pytest.mark.parametrize("bits", [[3], [0, 5], [9, 2, 4], [1, 2, 3, 4, 6], [8, 0, 1, 2, 3, 4, 5]])
def test_fused_tile_emulation(bits):
    rng = np.random.default_rng(len(bits))
    n, L = 12, 10
    state = _cplx(rng, 1 << n)
    u = _unitary(rng, len(bits), V=2)
    vidx = np.array([0, 1, 1, 0], dtype=np.int32)
    got = _emulate_fused(state, u, vidx, bits, L)
    want = ref.fused_apply_ref(_t(state), _t(u), _t(vidx), bits, L).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("window", [[3, 4, 5, 6], [0, 1, 2, 7, 8], [5, 6, 7, 8, 9]])
def test_shm_tile_emulation(window):
    rng = np.random.default_rng(sum(window))
    n, L = 12, 10
    state = _cplx(rng, 1 << n)
    mem = [(kind, bits, op, np.array([1, 0, 1, 1], dtype=np.int32))
           for kind, bits, op in _members(rng, window, 7, V=2)]
    got = _emulate_shm(state, window, mem, L)
    tm = [(kind, bits, _t(op), _t(v)) for kind, bits, op, v in mem]
    want = ref.shm_apply_ref(_t(state), window, tm, L).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tile_layouts():
    lay = ops.fused_layout(30, 28, [3, 4, 9, 10, 11, 20, 6])
    assert lay.t == 13 and lay.n_tiles == 1 << 17  # 64 groups of 128
    assert [lay.pos[i] for i in lay.tb] == [3, 4, 9, 10, 11, 20, 6]
    lay = ops.shm_layout(30, 28, range(6, 19))
    assert lay.pos == (0,) + tuple(range(6, 19))  # 13 window bits + bit 0
    lay = ops.shm_layout(30, 28, [0, 1, 2, 10])
    assert lay.t == ops.SHM_MIN_TILE_BITS and lay.pos[:4] == (0, 1, 2, 3)


def test_shm_descriptor_table():
    """One row per member: kind, bit count, the tile bits of the operand's
    index bits, operand pointer, entries per variant, variant-index pointer."""
    lay = ops.shm_layout(16, 14, list(range(3, 14)))
    v = torch.zeros(4, dtype=torch.int32)
    members = [("mat", (4, 3), torch.zeros(1, 4, 4, dtype=torch.complex64), v),
               ("diag", tuple(range(3, 13)), torch.zeros(2, 1024, dtype=torch.complex64), v)]
    desc = ops.shm_descriptors(lay, members)
    where = {b: i for i, b in enumerate(lay.pos)}
    assert desc.shape == (2, ops.SHM_DESC_WORDS)
    assert list(desc[:, 0]) == [0, 1] and list(desc[:, 1]) == [2, 10]
    assert list(desc[0, 2:4]) == [where[4], where[3]]
    assert list(desc[1, 2:12]) == [where[b] for b in range(3, 13)]
    assert list(desc[:, 19]) == [16, 1024]
    assert desc[0, 18] == members[0][2].data_ptr() and desc[1, 20] == v.data_ptr()

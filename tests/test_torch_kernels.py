"""The port's kernel layer against the JAX package's Pallas kernels.

Mirrors tests/test_kernels.py: the plain versions of both hand-written
kernels (and the wrappers, which run them for CPU tensors) against
``fused_matmul`` / ``shm_apply`` in interpret mode and ``apply_shm_group``,
on the same numpy-seeded inputs at atol 1e-4. What the CUDA kernels do
is emulated in numpy against the plain versions: their tile addressing,
fused_apply's MMA fragment mapping and 3xTF32 arithmetic, and shm_apply's
program of register phases, step by step from the table the kernel
reads. The kernels themselves are held to the plain versions on the card
by tests/test_torch_gpu.py."""

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


def _mma_product(ut, buf, KE, NG, ROW):
    """out[g, r] = sum_c U[r, c] s[g, c] as fused_apply.cu forms it: per
    m16n8k8 tile the three real products of the Karatsuba form (P1 = Re Re,
    P2 = Im Im, P3 = (Re + Im)(Re + Im)), their fragment registers loaded
    where the PTX fragment layout puts them (a0..a3 = U[r][c], U[r + 8][c],
    U[r][c + 4], U[r + 8][c + 4]; b0, b1 = s[g][c], s[g][c + 4]), A @ B
    accumulated over k8 steps, D read back by the same layout, out = (P1 -
    P2, P3 - P1 - P2). ``ut``/``buf``: flat complex, rows of ROW entries."""
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    parts = (lambda z: z.real, lambda z: z.imag, lambda z: z.real + z.imag)
    out = np.zeros((NG, KE), dtype=np.complex128)
    for mi in range(KE // 16):
        for ni in range(NG // 8):
            P = np.zeros((3, 16, 8))
            for c0 in range(0, KE, 8):
                r, c, g = mi * 16 + gid, c0 + tig, ni * 8 + gid
                u = [ut[r * ROW + c], ut[(r + 8) * ROW + c],
                     ut[r * ROW + c + 4], ut[(r + 8) * ROW + c + 4]]
                s0, s1 = buf[g * ROW + c], buf[g * ROW + c + 4]
                for m, part in enumerate(parts):
                    A, B = np.zeros((16, 8)), np.zeros((8, 8))
                    A[gid, tig], A[gid + 8, tig] = part(u[0]), part(u[1])
                    A[gid, tig + 4], A[gid + 8, tig + 4] = part(u[2]), part(u[3])
                    B[tig, gid], B[tig + 4, gid] = part(s0), part(s1)
                    P[m] += A @ B
            for q in range(4):
                row, col = gid + (q >> 1) * 8, 2 * tig + (q & 1)
                p1, p2, p3 = P[0][row, col], P[1][row, col], P[2][row, col]
                out[ni * 8 + col, mi * 16 + row] = (p1 - p2) + 1j * (p3 - p1 - p2)
    return out


def _emulate_fused(state, u, vidx, bits, L):
    """fused_apply.cu, tile by tile: the tile gathered into [group][column]
    rows of KE + 4 entries (I (x) U below 4 bits), the product by the MMA
    fragment mapping, the result written in place and scattered back."""
    n = state.size.bit_length() - 1
    lay = ops.fused_layout(n, L, bits)
    k, ke = len(bits), len(lay.tb)
    KE, NG = 1 << ke, ops.fused_groups_per_tile(k)
    ROW = KE + 4
    sw = np.zeros(lay.t, dtype=np.int64)  # buffer offset of each tile bit
    for m, b in enumerate(lay.tb):
        sw[b] = 1 << m
    for q, b in enumerate(lay.gb):
        sw[b] = (1 << q) * ROW
    j = np.arange(1 << lay.t)
    sidx = sum(((j >> i) & 1) * sw[i] for i in range(lay.t))
    assert len(set(sidx.tolist())) == j.size
    out, seen = state.astype(np.complex128), np.zeros(state.size, dtype=int)
    for tile_id in range(lay.n_tiles):
        addr = _tile_addresses(lay, tile_id)
        seen[addr] += 1
        U = u[vidx[addr[0] >> L]].astype(np.complex128)
        Ue = np.kron(np.eye(KE >> k), U)  # I (x) U: row r = (identity, U row)
        ut = np.zeros(KE * ROW, dtype=np.complex128)
        ut[(np.arange(KE)[:, None] * ROW + np.arange(KE)[None, :]).ravel()] = Ue.ravel()
        buf = np.zeros(NG * ROW, dtype=np.complex128)
        buf[sidx] = out[addr]
        res = _mma_product(ut, buf, KE, NG, ROW)
        buf[(np.arange(NG)[:, None] * ROW + np.arange(KE)[None, :]).ravel()] = res.ravel()
        out[addr] = buf[sidx]
    assert (seen == 1).all(), "tiles must cover the state exactly once"
    return out


def _field(row, f):
    return (int(np.uint64(row[2 + f // 4])) >> (16 * (f % 4))) & 0xFFFF


def _swz(j):
    return j ^ (((j >> 4) ^ (j >> 8)) & 15)


def _emulate_shm(state, window, members, L):
    """shm_apply.cu, tile by tile, from the step table it is given: each
    thread's 32 registers, the swizzled tile buffer, the operand of the
    tile's shard from the pointer and variant-index words. Checks that a
    write between phases only reaches slots the same thread read last (the
    kernel has no barrier before it)."""
    n = state.size.bit_length() - 1
    lay = ops.shm_layout(n, L, window)
    t, R = lay.t, ops.SHM_REG_BITS
    desc = ops.shm_descriptors(lay, members)
    ptrs = {}
    for _, _, op, v in members:
        ptrs[op.data_ptr()] = op.numpy().reshape(-1)
        ptrs[v.data_ptr()] = v.numpy()
    T = np.arange(1 << (t - R))[:, None]
    i = np.arange(1 << R)[None, :]

    def layout_index(perm):
        return (sum(((T >> b) & 1) << perm[R + b] for b in range(t - R))
                + sum(((i >> q) & 1) << perm[q] for q in range(R)))

    io = layout_index(ops.shm_io_layout(t))
    out, seen = state.astype(np.complex128), np.zeros(state.size, dtype=int)
    for tile_id in range(lay.n_tiles):
        addr = _tile_addresses(lay, tile_id)
        seen[addr] += 1
        shard = addr[0] >> L
        x = out[addr[io]]
        buf = np.full(1 << t, np.nan, dtype=np.complex128)
        owner = None
        for row in desc:
            kind, f = row[0], [_field(row, q) for q in range(16)]
            if kind in (ops.STEP_WRITE, ops.STEP_READ):
                phys = _swz(layout_index(f[:t]))
                assert len(set(phys.ravel().tolist())) == 1 << t
                if kind == ops.STEP_READ:
                    x = buf[phys]
                    owner = np.empty(1 << t, dtype=int)
                    owner[phys] = np.broadcast_to(T, phys.shape)
                    continue
                if owner is not None:
                    assert (owner[phys] == T).all()
                buf[phys] = x
                continue
            v = ptrs[int(row[8])][shard]
            op = ptrs[int(row[6])][v * row[7]:(v + 1) * row[7]].astype(np.complex128)
            if kind == ops.STEP_DIAG:
                e = (sum(((T >> b) & 1) * f[R + b] for b in range(t - R))
                     + sum(((i >> q) & 1) * f[q] for q in range(R)))
                x = x * op[e]
                continue
            kg = int(row[1])
            D = 1 << kg
            M = op.reshape(D, D)
            offs = np.array([sum(((c >> q) & 1) << f[q] for q in range(kg)) for c in range(D)])
            if kind == ops.STEP_SMEM_MAT:
                tile = buf[_swz(np.arange(1 << t))]
                jj = np.arange(1 << t)
                base = jj[(jj[:, None] & offs[None, :]).sum(1) == 0]
                tile[base[:, None] + offs[None, :]] = tile[base[:, None] + offs[None, :]] @ M.T
                buf[_swz(np.arange(1 << t))] = tile
            else:
                assert kind in (ops.STEP_MAT1, ops.STEP_MAT2) and kg == kind + 1
                ii = np.arange(1 << R)
                base = ii[(ii[:, None] & offs[None, :]).sum(1) == 0]
                x[:, base[:, None] + offs[None, :]] = x[:, base[:, None] + offs[None, :]] @ M.T
        out[addr[io]] = x
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
    v = _t(np.array([1, 0, 1, 1], dtype=np.int32))
    tm = [(kind, bits, _t(op), v) for kind, bits, op in _members(rng, window, 7, V=2)]
    got = _emulate_shm(state, window, tm, L)
    want = ref.shm_apply_ref(_t(state), window, tm, L).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tile_layouts():
    lay = ops.fused_layout(30, 28, [3, 4, 9, 10, 11, 20, 6])
    assert lay.t == 12 and lay.n_tiles == 1 << 18  # 32 groups of 128
    assert [lay.pos[i] for i in lay.tb] == [3, 4, 9, 10, 11, 20, 6]
    assert [lay.pos[i] for i in lay.gb] == [0, 1, 2, 5, 7]
    lay = ops.fused_layout(30, 28, [9])  # I (x) U on bits 9, 0, 1, 2; 128 groups
    assert [lay.pos[i] for i in lay.tb] == [9, 0, 1, 2] and lay.t == 11
    lay = ops.shm_layout(30, 28, range(6, 19))
    assert lay.pos == tuple(range(6, 19))  # 13 window bits fill the tile
    lay = ops.shm_layout(30, 28, range(16, 28))
    assert lay.pos == (0,) + tuple(range(16, 28))
    lay = ops.shm_layout(30, 28, [0, 1, 2, 10])
    assert lay.t == ops.SHM_TILE_BITS and lay.pos[:4] == (0, 1, 2, 3)


def test_shm_descriptor_table():
    """One row per step of the schedule: kind, operand bits, sixteen packed
    16-bit fields, operand pointer, entries per variant, variant-index
    pointer."""
    lay = ops.shm_layout(16, 14, list(range(3, 14)))
    v = torch.zeros(4, dtype=torch.int32)
    members = [("mat", (4, 3), torch.zeros(1, 4, 4, dtype=torch.complex64), v),
               ("diag", tuple(range(3, 13)), torch.zeros(2, 1024, dtype=torch.complex64), v)]
    desc = ops.shm_descriptors(lay, members)
    steps = ops.shm_schedule(lay, members)
    where = {b: i for i, b in enumerate(lay.pos)}
    assert desc.shape == (len(steps), ops.SHM_DESC_WORDS)
    kinds = [s[0] for s in steps]
    assert kinds == ["write", "read", "mat", "diag", "write", "read"]
    assert list(desc[:, 0]) == [ops.STEP_WRITE, ops.STEP_READ, ops.STEP_MAT2, ops.STEP_DIAG,
                                ops.STEP_WRITE, ops.STEP_READ]
    layout = steps[2][1]
    assert [_field(desc[1], f) for f in range(lay.t)] == list(layout)
    assert [_field(desc[2], f) for f in range(2)] == [layout.index(where[4]),
                                                       layout.index(where[3])]
    diag_bits = [where[b] for b in range(3, 13)]
    assert [_field(desc[3], f) for f in range(lay.t)] == [
        1 << diag_bits.index(b) if b in diag_bits else 0 for b in layout]
    assert list(desc[2:4, 1]) == [2, 10] and list(desc[2:4, 7]) == [16, 1024]
    assert desc[2, 6] == members[0][2].data_ptr() and desc[3, 8] == v.data_ptr()
    assert tuple(_field(desc[5], f) for f in range(lay.t)) == ops.shm_io_layout(lay.t)


# ----------------------------------------------------------------------
# fused_apply's arithmetic: the 3xTF32 split, emulated in numpy
# ----------------------------------------------------------------------


def _tf32(x):
    """float32 -> TF32 (10 mantissa bits), to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds; the result is a float32 value."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x):
    """float32 -> TF32 by dropping the low 13 mantissa bits."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(U, S, three):
    """out[g, r] = sum_c U[r, c] S[g, c] as the kernel forms it: the three
    real products of the Karatsuba form on TF32 operands, each m16n8k8
    product exact, added to a float32 accumulator per k-step of 8 columns;
    ``three``: small*big + big*small + big*big, else big*big. As the kernel
    splits: big = x rounded to TF32, small = x - big (exact in float32)
    truncated to TF32."""
    K = U.shape[0]
    terms = []
    for a, b in ((U.real, S.real), (U.imag, S.imag),
                 (U.real + U.imag, S.real + S.imag)):  # float32 sums, as in registers
        a, b = a.astype(np.float32), b.T.astype(np.float32)
        ab, bb = _tf32(a), _tf32(b)
        as_, bs = _tf32_trunc(a - ab), _tf32_trunc(b - bb)
        terms.append([(as_, bb), (ab, bs), (ab, bb)] if three else [(ab, bb)])
    P = []
    for pairs in terms:
        acc = np.zeros((K, S.shape[0]), dtype=np.float32)
        for k0 in range(0, K, 8):
            for a, b in pairs:
                part = a[:, k0:k0 + 8].astype(np.float64) @ b[k0:k0 + 8].astype(np.float64)
                acc = (acc + part).astype(np.float32)
        P.append(acc)
    p1, p2, p3 = P
    return ((p1 - p2) + 1j * (p3 - p1 - p2)).T


def test_tf32_rounding():
    x = np.array([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-11, -(1 + 2**-11), 3.0e-3], dtype=np.float32)
    got = _tf32(x)
    assert got[0] == 1.0 and got[1] == 1 + 2**-10  # a tie rounds away from zero
    assert got[2] == 1 + 2**-9 and got[3] == -(1 + 2**-10)
    assert abs(got[4] - x[4]) <= 2.0**-11 * abs(x[4])
    assert (got.view(np.uint32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_3xtf32_within_atol_at_k7(seed):
    """The kernel's 3xTF32 product on O(1) amplitudes at k = 7 stays within
    ATOL of the float64 product of the same complex64 inputs."""
    rng = np.random.default_rng(seed)
    U, S = _unitary(rng, 7)[0], _cplx(rng, 64, 128)
    want = S.astype(np.complex128) @ U.astype(np.complex128).T
    err = np.abs(_tf32_product(U, S, three=True) - want).max()
    assert err < ATOL / 10


def test_fused_single_tf32_pass_misses_atol_at_k7():
    """One TF32 pass (big*big only) keeps ~3 digits: beyond ATOL at k = 7."""
    rng = np.random.default_rng(0)
    U, S = _unitary(rng, 7)[0], _cplx(rng, 64, 128)
    want = S.astype(np.complex128) @ U.astype(np.complex128).T
    assert np.abs(_tf32_product(U, S, three=False) - want).max() > ATOL


# ----------------------------------------------------------------------
# shm_apply's phase schedule
# ----------------------------------------------------------------------


def _random_group(rng, window, n_members, V, S):
    """Members of every kind the kernel takes: 1- to 4-bit matrices and
    diagonals up to the whole window (more than 256 entries from 9 bits)."""
    mem = []
    vidx = _t(rng.integers(0, V, size=S).astype(np.int32))
    for _ in range(n_members):
        roll = rng.random()
        if roll < 0.7:
            kg = 1 if roll < 0.4 else 2 if roll < 0.55 else 3 if roll < 0.65 else 4
            kg = min(kg, len(window))
            bits = tuple(int(b) for b in rng.choice(window, size=kg, replace=False))
            mem.append(("mat", bits, _t(_unitary(rng, kg, V)), vidx))
        else:
            kd = int(rng.integers(1, len(window) + 1))
            bits = tuple(int(b) for b in rng.choice(window, size=kd, replace=False))
            op = np.exp(1j * rng.uniform(0, 2 * np.pi, size=(V, 1 << kd))).astype(np.complex64)
            mem.append(("diag", bits, _t(op), vidx))
    return mem


@pytest.mark.parametrize("seed", range(6))
def test_shm_phase_schedule_emulation(seed):
    """Random windows (5 to 13 bits of 14 local ones) and member lists with
    diagonals and 3-4-bit matrices: the kernel's program, emulated step by
    step, reproduces shm_apply_ref."""
    rng = np.random.default_rng(100 + seed)
    n, L = 15, 14
    a = int(rng.integers(5, 14))
    window = sorted(int(b) for b in rng.choice(L, size=a, replace=False))
    mem = _random_group(rng, window, int(rng.integers(1, 30)), V=2, S=1 << (n - L))
    state = _cplx(rng, 1 << n)
    got = _emulate_shm(state, window, mem, L)
    want = ref.shm_apply_ref(_t(state), window, mem, L).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_shm_schedule_phases(seed):
    """Every register matrix lies in its phase's register bits, exchanges
    come as write/read pairs (3-4-bit matrices only between them), and the
    program starts and ends in the I/O layout."""
    rng = np.random.default_rng(200 + seed)
    L = 14
    window = sorted(int(b) for b in rng.choice(L, size=13, replace=False))
    mem = _random_group(rng, window, 40, V=1, S=1)
    lay = ops.shm_layout(L, L, window)
    steps = ops.shm_schedule(lay, mem)
    io = ops.shm_io_layout(lay.t)
    cur, open_write = io, False
    for step in steps:
        kind = step[0]
        if kind == "write":
            assert not open_write and step[1] == cur
            open_write = True
        elif kind == "read":
            assert open_write and sorted(step[1]) == list(range(lay.t))
            cur, open_write = step[1], False
        elif kind == "smem_mat":
            assert open_write and len(step[1]) > ops.SHM_REG_MATRIX_BITS
        else:
            assert not open_write and step[1] == cur
            if kind == "mat":
                assert set(step[2]) <= set(cur[:ops.SHM_REG_BITS])
    assert cur == io and not open_write
    assert sum(s[0] not in ("write", "read") for s in steps) == len(mem)


def test_shm_schedule_of_a_sweep_of_one_bit_gates():
    """An Ising-like group, one-bit gates on each of 13 window bits twice
    with window diagonals between: phases of 5 register bits, the first and
    the last in the I/O layout, the gates of a sweep (which commute) in the
    order that fills them, so 4 exchanges (each one barrier) for 28
    members, not 2 barriers per member."""
    L = 28
    window = [0, 1, 2] + list(range(18, 28))
    v = torch.zeros(4, dtype=torch.int32)
    x1 = torch.zeros(4, 2, 2, dtype=torch.complex64)
    dg = torch.zeros(4, 1 << 13, dtype=torch.complex64)
    sweep = [("mat", (b,), x1, v) for b in window]
    mem = [("diag", tuple(window), dg, v)] + sweep + [("diag", tuple(window), dg, v)] + sweep
    steps = ops.shm_schedule(ops.shm_layout(30, L, window), mem)
    assert sum(s[0] == "read" for s in steps) == 4


@pytest.mark.parametrize("window", [[0, 1, 2] + list(range(18, 28)), [0, 1] + list(range(18, 28)),
                                    list(range(3, 16))])
def test_shm_exchanges_free_of_bank_conflicts(window):
    """Ising-like groups (one-bit gates over the window, window diagonals):
    in every exchange each half-warp's 8-byte accesses reach 16 distinct
    slots mod 16 of the swizzled buffer, i.e. all 32 banks once."""
    L, R = 28, ops.SHM_REG_BITS
    v = torch.zeros(4, dtype=torch.int32)
    x1 = torch.zeros(4, 2, 2, dtype=torch.complex64)
    dg = torch.zeros(4, 1 << len(window), dtype=torch.complex64)
    sweep = [("mat", (b,), x1, v) for b in window]
    mem = [("diag", tuple(window), dg, v)] + sweep + [("diag", tuple(window), dg, v)] + sweep
    lay = ops.shm_layout(30, L, window)
    t = lay.t
    T = np.arange(1 << (t - R))[:, None]
    i = np.arange(1 << R)[None, :]
    exchanges = [s[1] for s in ops.shm_schedule(lay, mem) if s[0] in ("write", "read")]
    assert exchanges
    for perm in exchanges + [ops.shm_io_layout(t)]:
        j = (sum(((T >> b) & 1) << perm[R + b] for b in range(t - R))
             + sum(((i >> q) & 1) << perm[q] for q in range(R)))
        slots = _swz(j) % 16
        for h in range(0, slots.shape[0], 16):
            for r in range(1 << R):
                assert len(set(slots[h:h + 16, r].tolist())) == 16


# ----------------------------------------------------------------------
# long groups, the scheduler's order, counters and the table cache
# ----------------------------------------------------------------------


def _long_group(rng, window, n_members, S):
    """Mostly one- and two-bit matrices with some diagonals and 3-4-bit
    matrices, V=2: a program many table chunks long."""
    vidx = _t(rng.integers(0, 2, size=S).astype(np.int32))
    mem = []
    for _ in range(n_members):
        roll = rng.random()
        if roll < 0.85:
            kg = 1 if roll < 0.6 else 2 if roll < 0.8 else 3 if roll < 0.83 else 4
            bits = tuple(int(b) for b in rng.choice(window, size=kg, replace=False))
            mem.append(("mat", bits, _t(_unitary(rng, kg, 2)), vidx))
        else:
            bits = tuple(int(b) for b in rng.choice(window, size=2, replace=False))
            op = np.exp(1j * rng.uniform(0, 2 * np.pi, size=(2, 4))).astype(np.complex64)
            mem.append(("diag", bits, _t(op), vidx))
    return mem


def test_shm_long_group_emulation():
    """A group of 1300 members: its program runs past ten chunks of the
    kernel's table, and the emulated program still reproduces shm_apply_ref."""
    rng = np.random.default_rng(7)
    n, L = 14, 13
    window = list(range(L))
    mem = _long_group(rng, window, 1300, 1 << (n - L))
    lay = ops.shm_layout(n, L, window)
    assert len(ops.shm_descriptors(lay, mem)) > 10 * ops.SHM_TABLE_CHUNK
    state = _cplx(rng, 1 << n)
    got = _emulate_shm(state, window, mem, L)
    want = ref.shm_apply_ref(_t(state), window, mem, L).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _must_precede(a, b):
    """Whether member a must stay before a later member b: a shared bit,
    and not both diagonal (the rule the schedule keeps)."""
    both_diag = all(m[0] == "diag" or not m[1] for m in (a, b))
    return bool(set(a[1]) & set(b[1])) and not both_diag


@pytest.mark.parametrize("seed", range(3))
def test_shm_schedule_keeps_every_noncommuting_pair(seed):
    """Each member steps once, and every pair that does not commute keeps
    its order, checked pair by pair (the scheduler follows only each
    member's direct predecessors)."""
    rng = np.random.default_rng(300 + seed)
    L = 14
    window = sorted(int(b) for b in rng.choice(L, size=int(rng.integers(5, 14)), replace=False))
    mem = _random_group(rng, window, 150, V=1, S=1) + _long_group(rng, window, 150, 1)
    lay = ops.shm_layout(L, L, window)
    where = {b: i for i, b in enumerate(lay.pos)}
    order = []
    for step in ops.shm_schedule(lay, mem):
        if step[0] in ("write", "read"):
            continue
        op, bits = step[-2], step[-3]
        i = next(i for i, m in enumerate(mem) if m[2] is op and i not in order
                 and tuple(where[b] for b in m[1]) == bits)
        order.append(i)
    assert sorted(order) == list(range(len(mem)))
    rank = {i: r for r, i in enumerate(order)}
    for j in range(len(mem)):
        for i in range(j):
            if _must_precede(mem[i], mem[j]):
                assert rank[i] < rank[j], (i, j)


def test_shm_schedule_of_a_long_group_is_quick():
    """3000 members schedule in well under a second's worth of steps: the
    scheduler takes ready members from sorted lists, not by rescanning the
    group (a rescan per step took seconds at 1600 members)."""
    import time

    rng = np.random.default_rng(11)
    L = 14
    window = list(range(1, 14))
    mem = _long_group(rng, window, 3000, 1)
    t0 = time.perf_counter()
    steps = ops.shm_schedule(ops.shm_layout(L, L, window), mem)
    assert sum(s[0] not in ("write", "read") for s in steps) == len(mem)
    assert time.perf_counter() - t0 < 5.0


@pytest.mark.parametrize("ks", [[1, 3, 3], [7, 6, 6, 7, 6]])
def test_fused_calls_counted_by_width(ks):
    """The wrapper counts each call once in total and once under its k."""
    rng = np.random.default_rng(len(ks))
    n, L = 9, 8
    vidx = _t(np.array([0, 0], dtype=np.int32))
    state = _t(_cplx(rng, 1 << n))
    ops.reset_kernel_counters()
    for k in ks:
        ops.fused_apply(state, _t(_unitary(rng, k)), vidx, list(range(L - k, L)), L)
    assert ops.kernel_call_counts() == {"fused": len(ks), "shm": 0}
    assert ops.fused_call_counts_by_k() == {k: ks.count(k) for k in set(ks)}
    ops.reset_kernel_counters()
    assert ops.fused_call_counts_by_k() == {}


def test_shm_device_table_built_once_per_group():
    """The table of a group is built once and found again for the same
    operands; other operands (another address) get their own table."""
    rng = np.random.default_rng(5)
    L = 14
    window = list(range(2, 14))
    mem = _random_group(rng, window, 12, V=2, S=1)
    lay = ops.shm_layout(L, L, window)
    cpu = torch.device("cpu")
    first = ops._device_table(lay, mem, cpu)
    assert ops._device_table(lay, list(mem), cpu) is first
    np.testing.assert_array_equal(first.numpy(), ops.shm_descriptors(lay, mem))
    other = [mem[0][:2] + (mem[0][2].clone(), mem[0][3])] + mem[1:]
    table = ops._device_table(lay, other, cpu)
    assert table is not first and table[:, 6].tolist() != first[:, 6].tolist()

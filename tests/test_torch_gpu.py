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


def _operand(rng, kind, k, V):
    if kind == "mat":
        return _unitary(rng, k, V)
    return np.exp(1j * rng.uniform(0, 2 * np.pi, size=(V, 1 << k))).astype(np.complex64)


def _each_row(state, rows, apply):
    """``apply(row, r)`` on each of the ``rows`` states of ``state`` alone,
    each from its own copy."""
    out = state.clone().view(rows, -1)
    for r in range(rows):
        row = out[r].clone()
        apply(row, r)
        out[r] = row
    return out.view(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["batch3", "sweep3x2"])
def test_kernels_on_batches_and_sweeps(cuda, shape):
    """One launch over the shards of 3 states (a batch whose size is not a
    power of two), or of 3 sweep points whose operand tables stack to
    ``[P * V, ...]`` with ``vidx[p * S + s] = p * V + v(s)``: against the
    plain versions, and against the kernel on each state alone (the same
    arithmetic on each tile, so exactly equal)."""
    rng = np.random.default_rng(3)
    n, L, P, V = 16, 14, 3, 2
    v_of = np.array([0, 1, 1, 0], dtype=np.int32)
    sweep = shape.startswith("sweep")
    T = P if sweep else 1  # tables stacked in the operands
    state = _t(_cplx(rng, P << n))
    vidx = ((np.arange(P)[:, None] * V if sweep else np.zeros((P, 1), np.int32))
            + v_of[None, :]).reshape(-1).astype(np.int32)
    bits = [12, 3, 7]
    u = _unitary(rng, len(bits), T * V)
    window = list(range(2, 13))
    shapes = [(kind, bits_) for kind, bits_, _ in _members(rng, window, 9)]
    ops_ = [_operand(rng, kind, len(b), T * V) for kind, b in shapes]

    def table(a, r):  # the V variants row r reads
        return a[r * V:(r + 1) * V] if sweep else a

    dv, dv_of = _t(vidx).to(cuda), _t(v_of).to(cuda)
    want = ref.fused_apply_ref(state.clone(), _t(u), _t(vidx), bits, L)
    got = ops.fused_apply(state.to(cuda, copy=True), _t(u).to(cuda), dv, bits, L).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    alone = _each_row(state.to(cuda, copy=True), P, lambda x, r: ops.fused_apply(
        x, _t(table(u, r)).to(cuda), dv_of, bits, L))
    assert torch.equal(alone.cpu(), got)

    mem = [(k, b, _t(op)) for (k, b), op in zip(shapes, ops_)]
    want = ref.shm_apply_ref(state.clone(), window, [(k, b, op, _t(vidx)) for k, b, op in mem], L)
    got = ops.shm_apply(state.to(cuda, copy=True), window,
                        [(k, b, op.to(cuda), dv) for k, b, op in mem], L).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    alone = _each_row(state.to(cuda, copy=True), P, lambda x, r: ops.shm_apply(
        x, window, [(k, b, _t(table(op.numpy(), r)).to(cuda), dv_of) for k, b, op in mem], L))
    assert torch.equal(alone.cpu(), got)


@pytest.mark.gpu
def test_kernels_beyond_int32_amplitudes(cuda):
    """A ``[4, 2^30]`` batch (2^32 amplitudes, 32 GiB): one launch of each
    kernel over its 16 shards against the same kernel on each row alone,
    from an 8 GiB copy of that row. The plain versions' temporaries would
    not fit; the single-row launch is held to its plain version at n=30 by
    ``chip_smoke.py``. Both launches do the same arithmetic on each tile,
    so they agree exactly."""
    if torch.cuda.get_device_properties(cuda).total_memory < (48 << 30):
        pytest.skip("needs 48 GiB of device memory")
    B, n, L = 4, 30, 28
    S = 1 << (n - L)
    gen = torch.Generator(device=cuda)

    def row(b):
        gen.manual_seed(100 + b)
        return torch.randn(1 << n, dtype=torch.complex64, device=cuda, generator=gen)

    rng = np.random.default_rng(4)
    u = _t(_unitary(rng, 6, 2)).to(cuda)
    v_of = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=cuda)
    window = [1, 2] + list(range(18, 28))
    mem = [(k, b, _t(op).to(cuda)) for k, b, op in _members(rng, window, 12, 2)]
    bits = [27, 3, 9, 20, 0, 14]
    x = torch.empty(B << n, dtype=torch.complex64, device=cuda)
    for b in range(B):
        x[b << n:(b + 1) << n] = row(b)
    assert x.numel() > 2**31
    ops.fused_apply(x, u, v_of.repeat(B), bits, L)
    ops.shm_apply(x, window, [(k, bb, op, v_of.repeat(B)) for k, bb, op in mem], L)
    torch.cuda.synchronize()
    for b in range(B):
        y = row(b)
        ops.fused_apply(y, u, v_of, bits, L)
        ops.shm_apply(y, window, [(k, bb, op, v_of) for k, bb, op in mem], L)
        torch.cuda.synchronize()
        assert torch.equal(x[b << n:(b + 1) << n], y), f"row {b}"
        del y
    assert S * B == 16


def _offload_pair(cuda, n=24, L=20):
    """``ising(n)`` planned once, on the in-card backend and on the offload
    backend (16 shards of 2^L)."""
    from repro_torch.core.generators import FAMILIES
    from repro_torch.core.partition import partition
    from repro_torch.sim.engine import ExecutionEngine

    circ = FAMILIES["ising"](n)
    plan = partition(circ, L, n - L, 0)
    return (ExecutionEngine(circ, plan, device=cuda),
            ExecutionEngine(circ, plan, device=cuda, backend="offload"))


@pytest.mark.gpu
def test_offload_matches_in_card_run(cuda):
    """An offload run of ``ising(24)`` in 16 shards of 2^20 against the
    in-card run of the same plan: the same state, one kernel launch per op
    and shard, dispatches that overlap, peak device memory within four
    shards above the op tables, and a second run that pins no new host
    memory."""
    in_card, eng = _offload_pair(cuda)
    want = in_card.run_packed()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    ops.reset_kernel_counters()
    got = eng.run_packed()
    peak = torch.cuda.max_memory_allocated(cuda)
    counts = eng.op_counts()
    S = eng.backend.S
    assert ops.kernel_call_counts() == {"fused": S * counts.get("fused", 0),
                                        "shm": S * counts.get("shm", 0)}
    assert got.is_pinned() and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want.cpu().numpy(), atol=ATOL)
    assert eng.backend.overlap_ratio > 0
    shard_bytes = 8 << eng.L
    assert peak - base <= 4 * shard_bytes, (peak - base) / shard_bytes
    del got
    pinned = torch.cuda.host_memory_stats()["allocated_bytes.allocated"]
    again = eng.run_packed()
    assert torch.cuda.host_memory_stats()["allocated_bytes.allocated"] - pinned < shard_bytes
    np.testing.assert_allclose(again.numpy(), want.cpu().numpy(), atol=ATOL)


@pytest.mark.gpu
def test_offload_pin_failure_raises(cuda, monkeypatch):
    """A host buffer that cannot be pinned stops the run: the offload
    backend never carries on with pageable memory or another backend."""
    _, eng = _offload_pair(cuda, n=12, L=8)
    real = torch.empty

    def failing(*args, **kw):
        if kw.get("pin_memory"):
            raise RuntimeError("CUDA error: out of memory (pinning refused)")
        return real(*args, **kw)

    monkeypatch.setattr(torch, "empty", failing)
    with pytest.raises(RuntimeError, match="pinning refused"):
        eng.run()


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["exact", "bf16", "int8"])
def test_offload_store_matches_in_card_run(cuda, tier, tmp_path):
    """``ising(24)`` through the shard store with half the shards spilled:
    one launch per op and shard, the in-card state within the run's own
    error bound (exactly for the exact tier), host staging pinned, peak
    device memory within four shards."""
    from repro_torch.sim.engine import ExecutionEngine, OffloadBackend
    from repro_torch.sim.shard_store import AT_REST_BYTES_PER_AMP

    in_card, eng = _offload_pair(cuda)
    budget = int(AT_REST_BYTES_PER_AMP[tier] * (1 << 24) / 2)
    store_eng = ExecutionEngine(eng.circuit, eng.plan, device=cuda, backend=OffloadBackend(
        storage=f"{tier}:dram_bytes={budget}:dir={tmp_path}:tol=0.25"))
    want = in_card.run_packed()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    ops.reset_kernel_counters()
    got = store_eng.run_packed()
    peak = torch.cuda.max_memory_allocated(cuda)
    counts, S = store_eng.op_counts(), store_eng.backend.S
    assert ops.kernel_call_counts() == {"fused": S * counts.get("fused", 0),
                                        "shm": S * counts.get("shm", 0)}
    snap = store_eng.backend.storage_snapshot()
    assert snap["spills"] > 0 and snap["spill_loads"] > 0
    assert got.is_pinned()
    diff = float(np.linalg.norm(got.numpy() - want.cpu().numpy()))
    if tier == "exact":
        assert diff == 0.0
    else:
        assert diff <= snap["relative_error_bound"] + 1e-5
    assert peak - base <= 4 * (8 << eng.L)
    assert not list(tmp_path.iterdir())


@pytest.mark.gpu
def test_offload_checkpoint_resume_on_the_card(cuda, tmp_path):
    """Killed by an injected shard transfer error in stage 1 while copies
    are in flight, then resumed in a fresh engine: the uninterrupted state
    bit for bit."""
    from repro_torch.sim import faults
    from repro_torch.sim.engine import ExecutionEngine, OffloadBackend

    _, eng = _offload_pair(cuda)
    want = eng.run_packed()
    S = eng.backend.S

    def fresh():
        return ExecutionEngine(eng.circuit, eng.plan, device=cuda,
                               backend=OffloadBackend(checkpoint_dir=str(tmp_path)))

    killed = fresh()
    plan = faults.FaultPlan(seed=1).add("shard_transfer_error", after=S + 3, count=1)
    with faults.inject(plan):
        with pytest.raises(faults.ShardTransferError):
            killed.run_packed()
    assert killed.backend.stats["checkpointed_stages"] >= 1
    again = fresh()
    got = again.run_packed()
    assert again.backend.stats["resumed_stages"] >= 1
    assert torch.equal(got, want)
    assert not list(tmp_path.iterdir())


def _grad_ansatz(n):
    """Every parametric gate kind the sweep meets in the port's families and
    beyond (``cx``, ``u3``, ``cry``, ``crz``, ``rzz``, rotations), on pairs
    in both bit orders, with shared and affine parameters: a swapped
    bit order passes the symmetric gates only."""
    from repro_torch.core.circuit import Circuit
    from repro_torch.core.gates import Param

    c = Circuit(n)
    for q in range(n):
        c.add("ry", q, params=[Param(f"a{q % 4}")])
    for q in range(n - 1):
        c.add("cx", q + 1, q)
    c.add("u3", n - 1, params=[Param("a0"), 0.4, Param("J")])
    c.add("cry", 0, n - 1, params=[Param("J") * 0.5])
    c.add("crz", n - 2, 1, params=[Param("a1")])
    c.add("rzz", 2, n - 3, params=[Param("J")])
    for q in range(n):
        c.add("rx", q, params=[Param(f"a{(q + 1) % 4}") * -0.7])
    return c


@pytest.mark.gpu
@pytest.mark.parametrize("n", [10, 20])
def test_value_and_grad_kernels_match_plain_on_card(cuda, n):
    """The reverse sweep through ``fused_apply`` against the same sweep
    through its plain version, on one forward state (n=10: shards below one
    full tile), with the launch count of one value_and_grad."""
    from repro_torch.core.partition import partition
    from repro_torch.sim.adjoint import AdjointProgram
    from repro_torch.sim.engine import ExecutionEngine

    circ = _grad_ansatz(n)
    obs = f"Z0 Z1 + 0.5*X{n - 1} + 0.3*Y2 X3 - 0.1"
    eng = ExecutionEngine(circ, partition(circ, n - 2, 2, 0), device=cuda)
    theta = np.random.default_rng(n).uniform(0.2, 2.0, len(circ.param_names))
    ops.reset_kernel_counters()
    value, grads = eng.value_and_grad(obs, params=theta)
    slots = sum(len(g.param_slots) for g in circ.gates)
    assert ops.kernel_call_counts()["fused"] == (eng.op_counts().get("fused", 0) + 5
                                                 + 2 * len(circ.gates) + slots)
    plain = AdjointProgram(circ, obs, device=cuda, use_kernels=False)
    pv, pg = plain.value_and_grad(eng.run(), eng.bound_circuit)
    assert abs(value - pv) < 2e-5
    np.testing.assert_allclose(grads, pg, atol=1e-4)


@pytest.mark.gpu
def test_grad_sweep_on_card_matches_points(cuda):
    """``grad_sweep`` of 3 bindings as one ``[3, 2^n]`` sweep (one launch per
    gate application for all rows) against ``value_and_grad`` per point."""
    from repro_torch.core.partition import partition
    from repro_torch.sim.engine import ExecutionEngine

    n = 12
    circ = _grad_ansatz(n)
    obs = "Z0 Z1 + 0.5*X11"
    eng = ExecutionEngine(circ, partition(circ, n - 2, 2, 0), device=cuda)
    batch = np.random.default_rng(1).uniform(0.2, 2.0, (3, len(circ.param_names)))
    ops.reset_kernel_counters()
    vals, grads = eng.grad_sweep(batch, obs)
    slots = sum(len(g.param_slots) for g in circ.gates)
    assert ops.kernel_call_counts()["fused"] == (eng.op_counts().get("fused", 0) + 3
                                                 + 2 * len(circ.gates) + slots)
    for p in range(3):
        v, g = eng.value_and_grad(obs, params=batch[p])
        assert abs(vals[p] - v) < 2e-4
        np.testing.assert_allclose(grads[p], g, atol=2e-4)


@pytest.mark.gpu
def test_profiler_launches_the_hand_kernels_on_card(cuda):
    """``profile_fusion`` and ``profile_shm`` at L=20 time the hand kernels
    through the engine's wrappers: the launch counters rise by every
    warm-up and timed call, and the measured constants are positive."""
    from repro_torch.sim import profiler

    ops.reset_kernel_counters()
    fusion = profiler.profile_fusion(20, repeats=2, device=cuda)
    shm = profiler.profile_shm(20, repeats=2, device=cuda)
    assert ops.fused_call_counts_by_k() == {k: 3 for k in range(1, 8)}
    assert ops.kernel_call_counts() == {"fused": 7 * 3, "shm": 4 * 3}
    assert fusion["mxu_us_per_2k"] > 0 and set(fusion["raw"]["per_k_us"]) == {
        str(k) for k in range(1, 8)}
    assert shm["shm_gate_us"] > 0 and 0 < shm["shm_diag_gate_us"] <= shm["shm_gate_us"]


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "offload"])
@pytest.mark.parametrize("entry", ["run", "run_packed"])
def test_guarded_run_recovers_from_nan_on_card(cuda, monkeypatch, backend, entry):
    """``ising(24)`` with a NaN injected into its output: ``verify=True``
    re-runs the plan once through the hand kernels (the per-gate oracle is
    never called) and returns the clean run's state on the device the run's
    output lives on (the host for offload); a clean guarded run records no
    retry."""
    from repro_torch.core.generators import FAMILIES
    from repro_torch.sim import faults, statevector
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.statevector import fidelity

    def no_oracle(*a, **k):
        raise AssertionError("the guard fell back to the per-gate oracle")

    monkeypatch.setattr(statevector, "simulate", no_oracle)
    eng = engine_for(FAMILIES["ising"](24), 22, 2, 0, backend=backend, cache=None, device=cuda)
    ops.reset_kernel_counters()
    clean = getattr(eng, entry)(verify=True)
    per_run = ops.kernel_call_counts()
    assert "integrity_retries" not in eng.provenance and sum(per_run.values()) > 0
    ops.reset_kernel_counters()
    with faults.inject(faults.FaultPlan(seed=3).add("nan_amplitudes", count=1)):
        out = getattr(eng, entry)(verify=True)
    assert ops.kernel_call_counts() == {k: 2 * v for k, v in per_run.items()}
    assert out.device == clean.device and bool(torch.isfinite(out).all())
    assert fidelity(out, clean) >= 1 - 1e-5
    assert eng.provenance["integrity_retries"] == eng.provenance["integrity_recovered"] == 1


@pytest.mark.gpu
def test_kernel_build_failure_surfaces_typed_at_engine_construction(cuda, monkeypatch):
    """A kernel build that fails on the card raises ``PallasLoweringError``
    (a ``BackendBuildError``) out of ``engine_for``, chained from the
    compiler's error: no engine lands on the plain versions."""
    from repro_torch.core.generators import FAMILIES
    from repro_torch.kernels import build
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.faults import BackendBuildError, PallasLoweringError

    def boom(names=build.SOURCES):
        raise RuntimeError("nvcc failed for fused_apply.cu (exit 1)")

    monkeypatch.setattr(ops, "_LIBS", {})
    monkeypatch.setattr(build, "build", boom)
    with pytest.raises(PallasLoweringError) as ei:
        engine_for(FAMILIES["ising"](12), 10, 2, 0, cache=None, device=cuda)
    assert isinstance(ei.value, BackendBuildError)
    assert isinstance(ei.value.__cause__, RuntimeError)


@pytest.mark.gpu
def test_served_batch_is_one_launch_per_op_on_card(cuda):
    """A service on the card (its defaults: the device, the hand kernels)
    serves 4 ``isingparam(20)`` requests as one batch: one kernel launch
    per compiled op for all 4 rows, no shm program scheduled once warm, and
    each row's amplitude and expectation against the point run alone on
    the same engine."""
    import asyncio

    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.serve import ServeConfig, SimRequest, SimulationService

    sym = PARAM_FAMILIES["isingparam"](20)
    points = np.random.default_rng(4).uniform(-1.5, 1.5, (5, 2))
    obs = "Z0 Z1 + 0.5*X2"

    async def go():
        async with SimulationService(ServeConfig(R=2, max_batch_size=4,
                                                 max_wait_ms=200.0)) as svc:
            assert svc.pool.device.type == "cuda" and svc.cfg.use_kernels
            await svc.submit(SimRequest(circuit=sym, params=points[4]))  # warm: plan, build
            await asyncio.gather(*[svc.submit(SimRequest(circuit=sym, params=p))
                                   for p in points[:4]])  # warm: the 4-row sweep
            ops.reset_kernel_counters()
            sched = ops.SCHEDULE_CALLS["shm"]
            digests = [svc.submit_nowait(SimRequest(circuit=sym, params=p)) for p in points[:4]]
            measured = [svc.submit_nowait(SimRequest(circuit=sym, params=p, observables=(obs,)))
                        for p in points[:4]]
            digests, measured = await asyncio.gather(asyncio.gather(*digests),
                                                     asyncio.gather(*measured))
            return svc, digests, measured, ops.kernel_call_counts(), sched

    svc, digests, measured, launches, sched = asyncio.run(asyncio.wait_for(go(), 600))
    eng = svc.pool.engines()[0]
    counts = eng.op_counts()
    assert [r.batch_size for r in digests + measured] == [4] * 8
    # two batches (digest rows and packed measured rows), one launch per op each
    assert launches == {"fused": 2 * counts.get("fused", 0), "shm": 2 * counts.get("shm", 0)}
    assert sum(launches.values()) > 0 and ops.SCHEDULE_CALLS["shm"] == sched
    from repro_torch.sim.measure import Frame, measure_to_result, measurer_for

    for p, d, m in zip(points[:4], digests, measured):
        alone = eng.run(params=p)
        assert abs(d.amp0 - complex(alone[0].item())) < 1e-5
        want = measure_to_result(measurer_for(alone, Frame.identity(20)), backend="cuda",
                                 observables=[obs])
        for k, v in want.expectations.items():
            assert abs(m.result.expectations[k] - v) < 1e-5


@pytest.mark.gpu
def test_shardmap_world_size_one_over_nccl_on_card(cuda, tmp_path):
    """The shardmap backend under an NCCL group of one rank (the transport a
    multi-card node uses; R=G=0, so no collective runs) on the card, with
    the hand kernels: bit for bit ``CudaBackend``'s state on the same plan,
    one launch per compiled op, nothing sent."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.core.generators import random_circuit
    from repro_torch.core.partition import partition
    from repro_torch.sim import collective
    from repro_torch.sim.engine import ExecutionEngine
    from repro_torch.sim.shardmap_executor import ShardMapExecutor

    circ = random_circuit(18, 160, seed=2)
    plan = partition(circ, 18, 0, 0)
    want = ExecutionEngine(circ, plan, device=cuda).run()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1, timeout=timedelta(seconds=120))
    try:
        ex = ShardMapExecutor(circ, plan, device=cuda)
        assert ex.backend.name == "shardmap" and ex.backend.transport.backend == "nccl"
        ops.reset_kernel_counters()
        collective.reset_collective_counters()
        got = ex.run()
        torch.cuda.synchronize()
        counts = ex.op_counts()
        assert ops.kernel_call_counts() == {"fused": counts.get("fused", 0),
                                            "shm": counts.get("shm", 0)}
        assert sum(ops.kernel_call_counts().values()) > 0
        assert collective.collective_counts()["bytes_sent"] == 0
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_shardmap_cli_at_world_size_one_over_nccl_under_torchrun(cuda, tmp_path):
    """``repro_torch.launch.simulate --executor shardmap`` launched by
    ``torchrun`` as one process over NCCL (the default backend on the card)
    with the hand kernels: the state checked against the dense reference,
    one launch per compiled op, no remap, and only rank 0's lines."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    out_json = tmp_path / "result.json"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "-m", "repro_torch.launch.simulate", "--circuit", "qft", "--qubits", "20", "--L", "20",
         "--executor", "shardmap", "--check", "--result-json", str(out_json)],
        cwd=root, env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "torch.distributed nccl, world size 1; devices by rank: cuda:0" in proc.stdout
    assert "fidelity vs dense reference: 1.000000" in proc.stdout
    doc = json.loads(out_json.read_text())
    counts = doc["op_counts"]
    assert doc["backend"] == "shardmap" and doc["device"] == "cuda:0" and not doc["remaps"]
    assert [(c["fused"], c["shm"]) for c in doc["launches"]] == [
        (counts.get("fused", 0), counts.get("shm", 0))]
    assert sum(counts.values()) > 0


@pytest.mark.gpu
def test_shardmap_value_and_grad_on_four_ranks_matches_cuda_backend(cuda, tmp_path):
    """``value_and_grad`` on 4 gloo ranks of the card (``backend="shardmap"``,
    each rank's reverse sweep through ``fused_apply`` on its shard) against
    ``CudaBackend``'s on the same plan: the value within 1e-5 and every
    gradient within 1e-4 on every rank, the sweep's launches per rank, and
    its bytes within the bound."""
    import _torch_shardmap_grad_ranks as rank_side
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.core.partition import partition
    from repro_torch.sim.engine import ExecutionEngine
    from repro_torch.sim.ranks import run_ranks

    n, L = 16, 14
    circ = PARAM_FAMILIES["isingparam"](n)
    plan = partition(circ, L, 2, 0)
    dev = plan.stages[-1].layout[L:]
    obs = f"Z0 Z1 + 0.5*X2 + 0.4*X{dev[0]} Y{dev[1]} - 0.3*Z{dev[0]} X3"
    theta = np.random.default_rng(5).uniform(0.2, 2.0, len(circ.param_names))
    points = np.random.default_rng(6).uniform(0.0, 2 * np.pi, (2, len(circ.param_names)))
    want = ExecutionEngine(circ, plan, device=cuda).value_and_grad(obs, params=theta)
    torch.cuda.empty_cache()
    case = {"circuit": circ.to_json(), "plan": plan.to_json(), "obs": obs, "theta": theta,
            "points": points}
    found = run_ranks(rank_side.main, 4, str(tmp_path), args=({"isingparam": case}, "cuda"),
                      timeout=600, init_timeout=300)
    for d, f in enumerate(x["isingparam"] for x in found):
        assert "error" not in f, f.get("error")
        assert abs(f["value"] - want[0]) <= 1e-5, d
        np.testing.assert_allclose(f["grads"], want[1], atol=1e-4)
        counts = f["op_counts"]
        assert f["launches"] == {"fused": counts.get("fused", 0) + 2 * f["n_gates"]
                                 + f["n_slots"] + f["pauli_launches"],
                                 "shm": counts.get("shm", 0)}, d
        assert f["sweep"]["bytes_sent"] <= f["bound"] and f["sweep"]["bytes_received"] <= f["bound"]
        assert f["sweep"]["bytes_sent"] > 0, d


@pytest.mark.gpu
def test_shardmap_service_on_four_ranks_matches_cuda_backend(cuda, tmp_path):
    """A shardmap ``SimulationService`` on 4 gloo ranks of the card (rank 0
    serves, the others follow; ``isingparam(28)`` at L=26, one 2^26 shard a
    rank): one batch of 4 measured requests, each expectation within 1e-6 of
    its binding run alone on ``CudaBackend`` and measured with
    ``TorchMeasurer``, the first request's 32 shots the same for its seed,
    and on every rank one launch per compiled op and row."""
    import _torch_serve_ranks as rank_side
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.measure import measurer_for
    from repro_torch.sim.ranks import run_ranks

    n, L = 28, 26
    eng = engine_for(PARAM_FAMILIES["isingparam"](n), L, 2, 0, device=cuda, cache=None)
    obs = f"Z0 Z1 + 0.5*X{eng.cc.programs[-1].layout[L]}"
    points = [p for p in np.random.default_rng(8).uniform(-1.5, 1.5, (4, 2))]
    want = []
    for i, p in enumerate(points):
        tm = measurer_for(eng.run_packed(params=dict(zip(eng.param_names, p))),
                          eng.measurement_frame)
        want.append((tm.expectation(obs), tm.sample(32, seed=i).tolist() if i == 0 else None))
    counts = eng.op_counts()
    del eng, tm
    torch.cuda.empty_cache()
    found = run_ranks(rank_side.card_main, 4, str(tmp_path), args=(n, L, points, obs),
                      timeout=900, init_timeout=300)
    got = found[0]
    assert all(f == {"batch": 1, "idle": 0} for f in found[1:])
    for r, (value, samples) in zip(got["responses"], want):
        assert r["ok"] and r["batch_size"] == 4
        assert abs(next(iter(r["expectations"].values())) - value) <= 1e-6
        assert samples is None or r["samples"] == samples
    (step,) = got["ranks"]["history"]
    for r in step["per_rank"]:
        assert r["runs"] == 4
        assert r["launches"]["fused"] == 4 * counts.get("fused", 0)
        assert r["launches"]["shm"] == 4 * counts.get("shm", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-1.5b", "mamba2-1.3b", "whisper-base",
                                  "deepseek-v3-671b"])
def test_lm_model_on_card_matches_cpu(cuda, name):
    """A reduced LM's float32 twin on the card against the same weights on
    the CPU (the path the CPU tests hold to the JAX models): forward
    logits, prefill and three decode steps within 1e-4 of the largest
    logit, with TF32 off (float32 sums in other orders)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    cpu = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen, dtype=torch.int32)
    extras = {}
    stub = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if stub:
        extras[stub] = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen).bfloat16()
    on_card = {k: v.to(cuda) for k, v in extras.items()} or None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = cpu.forward(toks, extras=extras or None)[0]
            got = card.forward(toks.to(cuda), extras=on_card)[0].cpu()
        atol = 1e-4 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
        want, cache = cpu.prefill(toks[:, :8], extras=extras or None, cache_len=12)
        got, card_cache = card.prefill(toks[:, :8].to(cuda), extras=on_card, cache_len=12)
        for i in range(8, 11):
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol)
            want, cache = cpu.decode_step(toks[:, i:i + 1], cache, extras=extras or None)
            got, card_cache = card.decode_step(toks[:, i:i + 1].to(cuda), card_cache,
                                               extras=on_card)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
@pytest.mark.parametrize("name,microbatches", [("qwen2-1.5b", 1), ("mamba2-1.3b", 1),
                                               ("deepseek-v2-lite-16b", 2)])
def test_lm_train_step_on_card_matches_cpu(cuda, name, microbatches):
    """One ``make_train_step`` step (remat on, float32 moments) of a reduced
    float32 LM on the card against the same weights and batch on the CPU,
    TF32 off: the loss within a relative 1e-5, the grad norm within 1e-5,
    the updated parameters within 0.5 lr, and the step launches neither
    hand kernel."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    opt = adamw.AdamWConfig(lr=2e-3, warmup_steps=0, moment_dtype="float32")
    cpu = steps.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    card = steps.build_model(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    b = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                         global_batch=4, seed=1)).batch(0)
    out = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_kernel_counters()
    try:
        for model, dev in ((cpu, "cpu"), (card, cuda)):
            params = dict(model.named_parameters())
            batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            params, _, metrics = steps.make_train_step(model, opt, microbatches)(
                params, adamw.init(opt, params), batch)
            out.append(({k: v.detach().cpu() for k, v in params.items()},
                        {k: float(v) for k, v in metrics.items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (want_p, want_m), (got_p, got_m) = out
    assert np.isfinite(want_m["loss"])
    np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=1e-5)
    np.testing.assert_allclose(got_m["grad_norm"], want_m["grad_norm"], rtol=1e-5)
    for k in want_p:
        torch.testing.assert_close(got_p[k], want_p[k], rtol=0, atol=0.5 * opt.lr, msg=k)
    assert not any(ops.kernel_call_counts().values())

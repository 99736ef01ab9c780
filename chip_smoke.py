"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, drives the
port's main path (``repro_torch.launch.simulate``) at full width —
``ising(30)`` with L=28, R=2: a 2^30-amplitude complex64 state, 8 GiB —
and checks it against the port's dense per-gate oracle on the card, then
runs ``qft(22)`` with ``--check`` against the host complex128 oracle. Then
the engine entry point: ``isingparam(30)`` through ``--engine --bind``
(cold build) and a warm rebind through the compile cache; a sweep of 16
bindings of ``isingparam(28)`` as one ``[16, 2^28]`` state (2^32
amplitudes); a batch of 3 basis states of ``qft(28)``. Each of those runs
every kernel once per compiled op, whatever the number of states, and is
held against the dense per-gate oracle on the card; every kernel op of each
of them is held against its plain version as that path launches it (its
shard count, operand tables and variant indices).

Then adjoint gradients: the ``--vqe`` loop on ``isingparam(30)`` L=28 R=2
(three Adam steps; every gate, derivative and Pauli application of each
reverse sweep one ``fused_apply`` launch), its first gradient held against
the same sweep through the plain version on the card, against central
finite differences of the on-card energy and against the complex128
oracle on the observable's light cone, a sample of the sweep's launches
at k=1 and k=2 against the plain version, and the value_and_grad split
(forward, λ, sweep) and peak device memory; ``su2param(20)`` L=18 R=2
against the complex128 oracle on the host; ``grad_sweep`` of 4 bindings of
``isingparam(28)`` as one ``[4, 2^28]`` sweep against each point alone;
``value_and_grad`` of ``isingparam(28)`` L=24 R=4 through the offload
backend against the in-card one.

Then host offload: the pinned link rates; ``ising(32)`` L=28 R=4 through
``--executor offload`` — a 32 GiB pinned host state in 16 shards of 2 GiB,
every stage streamed through the card shard by shard, one launch per op
and shard — with per-stage GB/s against the link bounds, the host remaps,
the measurement split, the peak device memory (at most four shards), the
state against the in-card run of the same plan shard by shard, a warm run
after a rebind that pins no state buffer, and every kernel op on shards 0 and 15
against its plain version; ``qft(26)`` through the staged offload path and
the per-gate baseline; an offload batch of 2 ``qft(28)`` states and a sweep
of 4 ``isingparam(28)`` bindings against the in-card ones, their kernel ops
on shard 0 against the plain versions.

Then the offload backend's shard store and stage checkpoints: the spill
directory's disk and the host's memory; ``ising(32)`` L=28 R=4 through
``--executor offload --storage bf16`` with a DRAM budget of half the 16 GiB
at rest (the rest spilled to disk under ``build/``), held shard by shard
within its own error bound against the in-card run of the same plan, with
its stage, out-of-core remap and spill figures; on that state, Pauli terms
with 2 and 3 non-local X/Y qubits through the streaming measurer (its peak
device memory, and the values against the same terms on the in-card state);
``ising(30)`` L=26 R=4 through the int8 tier, spilled, under the same checks;
and ``ising(30)`` L=26 R=4 with ``--checkpoint-dir``, killed by an injected
``shard_transfer_error`` inside stage 1 and resumed in a fresh engine to the
uninterrupted run's state bit for bit, that run held against the in-card
run of its plan and its kernel ops on shards 0 and 15 against their plain
versions.

Then the profiler, calibrated planning, autotune and the faults (the
smoke points ``REPRO_CALIBRATION_DIR`` at a fresh ``build/calibration``
first, so every phase above plans on the reference's analytic constants
as before): ``python -m repro_torch.sim.profiler --L 28 --repeats 3
--verify`` through ``main(argv)`` (each field beside the constant it
replaces; both kernels launched by the profile); ``ising(30)`` and
``qsvm(30)`` L=28 R=2 planned under the resolved calibration against the
analytic constants (stages, fused widths, shm ops, run seconds, both
against the dense oracle on the card, the calibrated engine's kernel ops
against their plain versions); ``--autotune`` on ``ising(30)`` (every
candidate's replay, the choice, the tuning's peak device memory; then
``engine_for`` with default knobs is a cache hit with no solver call); the
integrity guard at n=28 (clean ``run``/``run_packed`` with ``verify=True``
and no retry, an injected NaN recovered by one re-run of the plan through
the hand kernels, a sweep of 4 ``isingparam(28)`` bindings with one
poisoned row) and the typed
build faults (``xla_trace_error`` at ``cuda.setup``,
``pallas_lowering_error`` at ``engine.init``) raised out of
``engine_for`` with no other engine built.

Then the simulation service (``repro_torch.serve``, what ``python -m
repro_torch.launch.serve_sim`` drives), planned on that calibration:
``SimulationService`` with its defaults (the card, the hand kernels), max
batch 8, max wait 5 ms, tenants gold (weight 4) and free (1); one warm-up
request each for ``isingparam(28)``, ``su2param(28)`` at one layer (L=26, R=2),
``qft(28)`` and ``ising(30)`` (L=28, R=2), then a burst of 40
parameterized requests (``<Z0 Z1 + 0.5*X2>`` each, 4 with 64 shots and a
marginal), 3 identical ``qft(28)`` requests and one ``ising(30)``: no
solver call, no shm program scheduled and no cache miss, each batch one
launch per compiled op, the ``qft`` group one run; every response against
its binding run alone on the same engine, the first point of each
structure against the dense oracle on the card, every kernel op of a
served ``isingparam`` batch against its plain version; a malformed rider
failing alone, a NaN recovered by one re-run through the kernels, a kernel
build failure quarantined; the JSON-lines front end on the loopback; and
each structure's warm run planned on the calibration against the analytic
constants. It prints the stage percentiles, the coalesce factor, the
padded-row share, the launches of every batch and the peak device memory.

Prints the card's name and power limit, the ``shm_apply`` member-count /
window sweep on the widest group as a diagnostic line, one JSON line of
kernel figures (``fused_apply`` per width k beside ``torch.matmul``, both
bounds), and last ``{"ok": true, "device": {...}}``. Any failed phase raises: the
exit code is then non-zero and no result is printed. Needs CUDA.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ATOL = 1e-4  # kernel vs plain version, O(1) amplitudes in float32
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 on CUDA cores (data sheet)
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 on the tensor cores (data sheet)
TF32_PASSES = 3  # fused_apply's 3xTF32 split: three TF32 products per fp32 one
KARATSUBA_OPS = 6  # fused_apply's real operations per complex multiply-add (3 products)
REPLACES = {
    "fused_apply": "src/repro/kernels/fusion.py:58",
    "shm_apply": "src/repro/kernels/shm.py:134",
}
SOURCES = {
    "fused_apply": "src/repro_torch/kernels/csrc/fused_apply.cu",
    "shm_apply": "src/repro_torch/kernels/csrc/shm_apply.cu",
}
MAIN_PATH = ["--circuit", "ising", "--n", "30", "--L", "28", "--R", "2", "--shots", "1024",
             "--marginal", "0,1,2", "--observable", "Z0 Z1 + 0.5*X2"]
CHECKED_PATH = ["--circuit", "qft", "--n", "22", "--L", "20", "--R", "2", "--check"]
ENGINE_PATH = ["--circuit", "isingparam", "--n", "30", "--L", "28", "--R", "2", "--engine",
               "--bind", "J=0.35", "--bind", "h=0.8", "--marginal", "0,1,2",
               "--observable", "Z0 Z1 + 0.5*X2"]
REBIND = {"J": 0.9, "h": 0.2}
SWEEP = {"n": 28, "L": 26, "R": 2, "P": 16}  # [16, 2^28] complex64: 2^32 amplitudes, 32 GiB
BATCH = {"n": 28, "L": 26, "R": 2, "B": 3}  # qft(28), basis states 0, 1, 2
# 16 shards of 2 GiB: a 32 GiB pinned host state, the largest the card's
# host (about 100 GB) holds beside the second state a host remap writes
OFFLOAD_PATH = ["--circuit", "ising", "--n", "32", "--L", "28", "--R", "4", "--executor",
                "offload", "--shots", "64", "--marginal", "0,1,2",
                "--observable", "Z0 Z1 + 0.5*X2"]
PERGATE = {"n": 26, "L": 22, "R": 4}  # qft(26): staged offload against the per-gate baseline
OFFLOAD_ROWS = {"n": 28, "L": 26, "R": 2, "B": 2, "P": 4}
FIDELITY_MIN = 1 - 1e-5
# the shard store: ising(32) at rest in bf16 (16 GiB) with half of it in a
# DRAM budget, the rest on disk; ising(30) in int8 (2 GiB at rest) with half
# spilled. int8 loses ~0.75% of a shard's norm per encode and a run encodes
# every shard three times, which the default tolerance (0.05) does not
# allow: the int8 run takes 0.25.
STORE = {"tier": "bf16", "n": 32, "L": 28, "R": 4, "dram_fraction": 0.5, "tol": 0.05}
STORE_INT8 = {"tier": "int8", "n": 30, "L": 26, "R": 4, "dram_fraction": 0.5, "tol": 0.25}
CHECKPOINT = {"n": 30, "L": 26, "R": 4}
# adjoint gradients: the reference's tolerances (tests/test_grad.py) for a
# float32 sweep against another sweep or an oracle, and central differences
# of the on-card energy (their truncation error at eps 1e-2 is 1.8e-4 of
# the gradient on this path, by the complex128 oracle)
VQE_OBS = "Z0 Z1 + Z1 Z2 + 0.5*X0"
VQE_PATH = ["--circuit", "isingparam", "--n", "30", "--L", "28", "--R", "2", "--vqe", VQE_OBS,
            "--vqe-steps", "3"]
VQE_SEED = 0  # the CLI's --vqe-seed: the angles of the first value_and_grad
VALUE_ATOL, GRAD_ATOL, ROW_ATOL = 2e-5, 1e-4, 2e-4
FD_EPS, FD_RTOL = 1e-2, 2e-3
# isingparam runs two Trotter steps of nearest-neighbour gates, so VQE_OBS
# (qubits 0-2) sees qubits 0-4 only: its energy and gradient at n=30 are
# those at n=10, where the host's complex128 oracle is cheap
LIGHT_CONE_N = 10
ORACLE = {"n": 20, "L": 18, "R": 2, "reps": 1}  # su2param(20): 270 gates, 80 parameters
ORACLE_OBS = "Z0 Z1 + 0.5*X19 - 0.3*Y5 X12 + 0.1"
GRAD_SWEEP = {"n": 28, "L": 26, "R": 2, "P": 4}
OFFLOAD_GRAD = {"n": 28, "L": 24, "R": 4}  # 16 host shards of 2^24
SPILL_ROOT = os.path.join(HERE, "build", "spill")
# the profiler, calibrated planning, autotune and the faults: the smoke's own
# calibration directory, empty until the calibration phase writes it, so
# every earlier phase plans on the analytic constants as before
CALIBRATION_DIR = os.path.join(HERE, "build", "calibration")
CALIBRATION_L, CALIBRATION_REPEATS = 28, 3  # the disk round trip of 2 GiB takes seconds
CALIBRATED = {"n": 30, "L": 28, "R": 2, "families": ("ising", "qsvm")}
AUTOTUNE = {"n": 30, "L": 28, "R": 2}
AUTOTUNE_PATH = ["--circuit", "ising", "--n", "30", "--L", "28", "--R", "2", "--autotune"]
FAULTS = {"n": 28, "L": 26, "R": 2, "P": 4}
CHECKPOINT_DIR = os.path.join(HERE, "build", "checkpoint")
# the simulation service on the card, planned on the card's calibration (it
# runs after the profiler): 40 parameterized requests over isingparam(28) and
# su2param(28) (a full batch of 8 rows is 16 GiB), 4 of them with shots and a
# marginal (host sampling of 2^28 amplitudes costs seconds), 3 identical
# qft(28) requests (one dedup run) and one ising(30) request at the main
# path's width; every served row's amplitudes are held through every
# STRIDE-th amplitude (2^20 of them across the whole state). su2param runs
# one layer (depth cut from the generator's 3: the staging ILP of its 1246
# gates, planned twice here, calibrated and analytic, would dominate the
# phase; one layer is 490 gates with the same 112 parameters)
SERVE = {"n": 28, "L": 26, "R": 2, "su2param_reps": 1, "requests": 40, "shots": 64,
         "shot_requests": (0, 11, 20, 31), "qft": 3, "main_n": 30, "main_L": 28, "seed": 41,
         "stride": 1 << 8}
SERVE_CONFIG = {"max_batch_size": 8, "max_wait_ms": 5.0, "cache_size": 4,
                "tenant_weights": {"gold": 4.0, "free": 1.0}}
SERVE_OBS = "Z0 Z1 + 0.5*X2"
SERVE_ATOL = 1e-5  # a served row against the same binding run alone


def require(ok: bool, msg: str) -> None:
    """A phase check: raises (so the run exits non-zero) when it fails."""
    if not ok:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def gib(b: float) -> str:
    return f"{b / 2**30:.2f} GiB"


def random_state(n: int, gen: torch.Generator) -> torch.Tensor:
    """O(1) complex64 amplitudes, so atol 1e-4 is a real test."""
    return torch.randn(1 << n, dtype=torch.complex64, device="cuda", generator=gen)


def random_unitaries(V: int, k: int, gen: torch.Generator) -> torch.Tensor:
    z = torch.randn(V, 1 << k, 1 << k, dtype=torch.complex64, device="cuda", generator=gen)
    return torch.linalg.qr(z)[0].contiguous()


def random_phases(V: int, k: int, gen: torch.Generator) -> torch.Tensor:
    theta = torch.rand(V, 1 << k, device="cuda", generator=gen) * (2 * np.pi)
    return torch.polar(torch.ones_like(theta), theta).contiguous()


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def variant_index(S: int, V: int) -> torch.Tensor:
    return torch.tensor([(s * 7 + 1) % V for s in range(S)], dtype=torch.int32, device="cuda")


def kernel_sweep(ops, ref, n: int, L: int, gen: torch.Generator) -> dict:
    """Every kernel against its plain version at the main path's state size,
    on target bits and windows away from the lowest bits. Returns the worst
    error by kernel."""
    S = 1 << (n - L)
    worst = {"fused": 0.0, "shm": 0.0}
    x = random_state(n, gen)
    for k in (1, 2, 3, 4, 5, 6, 7):
        bits = [3, 4, 9, 10, 11, 20, 6][:k] if k == 7 else [L - 1 - 3 * j for j in range(k)]
        for V in (1, 2):
            u, vidx = random_unitaries(V, k, gen), variant_index(S, V)
            err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, L),
                          ref.fused_apply_ref(x.clone(), u, vidx, bits, L))
            torch.cuda.synchronize()
            log(f"  fused_apply k={k} V={V} bits={bits}: max |kernel - plain| = {err:.3e}")
            require(err < ATOL, f"fused_apply k={k} V={V} disagrees with its plain version")
            worst["fused"] = max(worst["fused"], err)
    rng = np.random.default_rng(0)
    for a, lo in ((9, 6), (10, 11), (13, 6)):
        window = list(range(lo, lo + a))
        members = []
        for q in range(12):
            kind = "mat" if q % 3 != 2 else "diag"
            kg = {4: 3, 7: 4}.get(q, 1 + q % 2) if kind == "mat" else 3
            bits = tuple(int(b) for b in rng.choice(window, size=kg, replace=False))
            op = random_unitaries(2, kg, gen) if kind == "mat" else random_phases(2, kg, gen)
            members.append((kind, bits, op, variant_index(S, 2)))
        err = max_err(ops.shm_apply(x.clone(), window, members, L),
                      ref.shm_apply_ref(x.clone(), window, members, L))
        torch.cuda.synchronize()
        log(f"  shm_apply a={a} window={lo}..{lo + a - 1} 12 members (1- to 4-bit): "
            f"max |kernel - plain| = {err:.3e}")
        require(err < ATOL, f"shm_apply a={a} disagrees with its plain version")
        worst["shm"] = max(worst["shm"], err)
    return worst


def figures(ops, ref, probe, engine, gen, sweep_err, launches, launches_by_k):
    """Time each kernel, its plain version and (for fused_apply, at every
    width k the plan launches, through ``probe.fused_rows``) one
    torch.matmul on the main path's real ops, and work out the bounds:
    ``bound_ms`` for the route the kernel takes (the 3xTF32 Karatsuba
    product on the tensor cores for fused_apply, fp32 on CUDA cores for
    shm_apply), ``bound_fp32_ms`` for the 4-product fp32 form on CUDA
    cores. ``launches`` / ``launches_by_k``: the counts of the main path's
    run."""
    n, L = engine.n, engine.L
    _, shm_op = probe.main_path_ops(engine)
    state_bytes = 8 << n
    x = random_state(n, gen)
    out = []
    by_k = fused_by_k(ops, ref, probe, engine, x, "main path", launches_by_k)
    widest = dict(by_k[0], launches=launches["fused"], max_abs_err=max(
        [sweep_err["fused"]] + [row["max_abs_err"] for row in by_k]))
    del widest["k"], widest["path"]
    widest["by_k"] = [by_k_row(row) for row in by_k]
    out.append(widest)

    members = engine.backend.shm_members(shm_op)
    window = shm_op.local_bits
    err = max_err(ops.shm_apply(x.clone(), window, members, L),
                  ref.shm_apply_ref(x.clone(), window, members, L))
    require(err < ATOL,
            "shm_apply disagrees with its plain version on the main path's group")
    ms = probe.time_ms(lambda: ops.shm_apply(x, window, members, L))
    plain_ms = probe.time_ms(lambda: ref.shm_apply_ref(x, window, members, L), reps=3)
    nbytes = 2 * state_bytes + sum(op.numel() * 8 + v.numel() * 4 for _, _, op, v in members)
    nops = sum((8 << len(b)) if kind == "mat" else 6 for kind, b, _, _ in members) * (1 << n)
    kinds = [kind for kind, _, _, _ in members]
    out.append(entry("shm_apply", launches["shm"], max(err, sweep_err["shm"]), ms, plain_ms,
                     nbytes, nops, FP32_OPS_PER_S, nops, None,
                     f"a={len(window)} window={list(window)} members={len(members)} "
                     f"({kinds.count('mat')} mat, {kinds.count('diag')} diag) n={n}"))
    sweep = probe.shm_sweep(ops, window, members, L, x)
    log("  shm_apply sweep (members: 0 = a copy; place: the group's window or bits "
        "0..a-1): " + json.dumps([{k: r[k] for k in ("place", "members", "ms")} for r in sweep]))
    worst = hold_ops(ops, ref, engine, engine.backend.pass_of(), x, "main path")
    for k, key in zip(out, ("fused", "shm")):
        k["max_abs_err"] = max(k["max_abs_err"], worst[key])
    return out


def fused_by_k(ops, ref, probe, engine, x, what: str, launches_by_k: dict,
               skip=(), ps=None) -> list:
    """``fused_apply`` at each width k the plan of ``engine`` launches (not
    in ``skip``), on its first op of that width, with the operands of the
    pass ``ps`` (default: the engine's run over all its shards; ``x`` holds
    the pass's shards): against its plain version, timed beside the plain
    version and one torch.matmul, with its bounds."""
    n, L = x.numel().bit_length() - 1, engine.L

    def against_plain(u, vidx, bits):
        err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, L),
                      ref.fused_apply_ref(x.clone(), u, vidx, bits, L))
        require(err < ATOL, f"fused_apply disagrees with its plain version on the {what}'s "
                            f"k={len(bits)} op")
        return {"max_abs_err": err, "plain_ms": probe.time_ms(
            lambda: ref.fused_apply_ref(x, u, vidx, bits, L), reps=3),
            "nbytes": 2 * (8 << n) + u.numel() * 8 + vidx.numel() * 4}

    rows = []
    for r in probe.fused_rows(ops, engine, x, against_plain, skip=skip, ps=ps):
        k = r["k"]
        cmacs = (1 << k) * (1 << n)
        row = entry("fused_apply", launches_by_k.get(k, 0), r["max_abs_err"], r["ms"],
                    r["plain_ms"], r["nbytes"], TF32_PASSES * KARATSUBA_OPS * cmacs,
                    TF32_OPS_PER_S, 8 * cmacs, r["matmul_ms"],
                    f"{what}: k={k} bits={r['bits']} V={r['V']} n={n}")
        rows.append(dict(row, k=k, path=what))
    return rows


def by_k_row(row: dict) -> dict:
    return {key: row[key] for key in ("k", "path", "launches", "ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_fp32_ms", "max_abs_err")}


def hold_ops(ops, ref, eng, ps, x: torch.Tensor, what: str) -> dict:
    """Every kernel op of ``eng``'s program, launched as the pass ``ps``
    launches it (its shard count, operand tables and variant indices),
    against its plain version on the state ``x``. Returns the worst error
    by kernel."""
    be, L = eng.backend, eng.L
    worst, count = {"fused": 0.0, "shm": 0.0}, {"fused": 0, "shm": 0}
    for prog in eng.cc.programs:
        for op in prog.ops:
            if op.kind == "fused":
                u, vidx, bits = ps.consts[op.uid], be.kernel_vidx(op, ps), op.local_bits
                err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, L),
                              ref.fused_apply_ref(x.clone(), u, vidx, bits, L))
            elif op.kind == "shm":
                members = be.shm_members(op, ps)
                err = max_err(ops.shm_apply(x.clone(), op.local_bits, members, L),
                              ref.shm_apply_ref(x.clone(), op.local_bits, members, L))
            else:
                continue
            sync(x.device.type)
            require(err < ATOL, f"{what}: {op.kind} op {op.uid} (bits {list(op.local_bits)}) "
                                "disagrees with its plain version")
            worst[op.kind] = max(worst[op.kind], err)
            count[op.kind] += 1
    log(f"  {what}: every kernel op against its plain version at {x.numel() >> L} shards of "
        f"2^{L}: {count['fused']} fused_apply (max err {worst['fused']:.3e}), "
        f"{count['shm']} shm_apply (max err {worst['shm']:.3e})")
    return worst


def hold_sweep_ops(ops, ref, eng, ps, seed: int, what: str) -> dict:
    """Every kernel op of a sweep, launched once over all P points' shards
    with the stacked tables (the sweep's own launch, past int32 indices),
    against the same kernel launched on each point's row alone with its
    slice of the variant index; the row launches of points 0 and P-1
    against the plain version. The plain versions' temporaries would not
    fit beside the whole sweep's state. Returns the worst error by kernel
    against the plain version."""
    be, L, n, P, S = eng.backend, eng.L, eng.n, ps.rows, eng.backend.S
    device = eng.device

    def row_state(p: int) -> torch.Tensor:
        g = torch.Generator(device=device).manual_seed(seed + p)
        return torch.randn(1 << n, dtype=torch.complex64, device=device, generator=g)

    x = torch.empty(P << n, dtype=torch.complex64, device=device)
    rows = x.view(P, -1)
    worst_row, worst = 0.0, {"fused": 0.0, "shm": 0.0}
    count = {"fused": 0, "shm": 0}
    for prog in eng.cc.programs:
        for op in prog.ops:
            if op.kind == "fused":
                u, vidx, bits = ps.consts[op.uid], be.kernel_vidx(op, ps), op.local_bits

                def launch(st, p=None):
                    v = vidx if p is None else vidx[p * S:(p + 1) * S]
                    return ops.fused_apply(st, u, v, bits, L)

                def plain(st, p):
                    return ref.fused_apply_ref(st, u, vidx[p * S:(p + 1) * S], bits, L)
            elif op.kind == "shm":
                members, window = be.shm_members(op, ps), op.local_bits

                def row_members(p):
                    return [(kind, b, t, v[p * S:(p + 1) * S]) for kind, b, t, v in members]

                def launch(st, p=None):
                    return ops.shm_apply(st, window, members if p is None else row_members(p), L)

                def plain(st, p):
                    return ref.shm_apply_ref(st, window, row_members(p), L)
            else:
                continue
            for p in range(P):
                rows[p] = row_state(p)
            launch(x)
            for p in range(P):
                alone = launch(row_state(p), p)
                err = max_err(rows[p], alone)
                require(err < ATOL, f"{what}: {op.kind} op {op.uid}: the sweep's launch and "
                                    f"the launch on row {p} alone disagree")
                worst_row = max(worst_row, err)
                if p in (0, P - 1):
                    err = max_err(alone, plain(row_state(p), p))
                    require(err < ATOL, f"{what}: {op.kind} op {op.uid} on row {p} disagrees "
                                        "with its plain version")
                    worst[op.kind] = max(worst[op.kind], err)
                del alone
            sync(device.type)
            count[op.kind] += 1
    del x, rows
    log(f"  {what}: every kernel op launched over all {P * S} shards of 2^{L} against the "
        f"launch on each row alone ({count['fused']} fused_apply, {count['shm']} shm_apply; "
        f"max |sweep - row| = {worst_row:.3e}); rows 0 and {P - 1} against the plain versions: "
        f"max err fused {worst['fused']:.3e}, shm {worst['shm']:.3e}")
    return worst


def entry(name, launches, err, ms, plain_ms, nbytes, nops, ops_per_s, fp32_ops, library_ms,
          shape):
    """One kernel's figures: ``bound_ms`` counts ``nops`` at ``ops_per_s``
    (the kernel's route), ``bound_fp32_ms`` the product's ``fp32_ops`` on
    CUDA cores; both against the bytes at the memory rate."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    bound_fp32 = max(t_bytes, fp32_ops / FP32_OPS_PER_S * 1e3)
    log(f"  {name} [{shape}]: {ms:.3f} ms (plain {plain_ms:.3f} ms"
        + (f", torch.matmul {library_ms:.3f} ms" if library_ms is not None else "")
        + f"); bound {max(t_bytes, t_ops):.3f} ms ({nbytes / 1e9:.2f} GB, "
        f"{nops / 1e12:.3f} TFLOP at {ops_per_s / 1e12:.0f} TFLOP/s), fp32 bound "
        f"{bound_fp32:.3f} ms")
    return {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_fp32_ms": bound_fp32, "library_ms": library_ms, "shape": shape}


def trace_run(run, untraced_s: float, what: str = "run_packed") -> None:
    """One more call of ``run`` under torch.profiler: device time by kernel,
    against the untraced call's wall time (the profiled wall time includes
    the profiler's own start-up)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():  # device-side events only: no double count
        dev_us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and str(ev.device_type).endswith("CUDA"):
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"  traced {what}: device time {busy_ms:.1f} ms = {busy_ms / (untraced_s * 1e3):.0%}"
        f" of the untraced run's {untraced_s * 1e3:.1f} ms (profiled wall {wall_ms:.1f} ms); "
        "by kernel:")
    for ms, count, key in rows[:10]:
        log(f"    {ms:9.2f} ms  x{count:<3d} {key[:100]}")


def launches_match(ops, engine, what: str, per_op: int = 1, kinds=("fused", "shm")) -> dict:
    """The kernel launches since the last reset equal the engine's compiled
    ops times ``per_op`` (one launch per op whatever the number of states;
    one per op and shard on the offload path), every kernel of ``kinds``
    ran, and the fused launches match the plan's fused ops by width."""
    launches = ops.kernel_call_counts()
    counts = engine.op_counts()
    want = {"fused": per_op * counts.get("fused", 0), "shm": per_op * counts.get("shm", 0)}
    want_by_k = {}
    for prog in engine.cc.programs:
        for op in prog.ops:
            if op.kind == "fused":
                want_by_k[len(op.local_bits)] = want_by_k.get(len(op.local_bits), 0) + per_op
    log(f"  {what}: kernel launches {launches}, fused by k {ops.fused_call_counts_by_k()}; "
        f"compiled program {counts}" + (f" x {per_op} shards" if per_op > 1 else ""))
    require(launches == want, f"{what}: kernel launches {launches} != compiled ops {want}")
    require(ops.fused_call_counts_by_k() == want_by_k,
            f"{what}: fused launches by k != the plan's fused ops by k {want_by_k}")
    require(all(want[k] > 0 for k in kinds), f"{what} must run {' and '.join(kinds)}")
    return dict(launches, by_k=ops.fused_call_counts_by_k())


def engine_phase(simulate, ops, ref, argv, card: str, device: str = "cuda") -> dict:
    """The engine entry point at full width: ``--engine --bind`` through the
    CLI (a cold build: plan, compile, upload; the first bind fills the
    engine's structural cache), then ``engine_for`` on the same structure
    with other angles: a cache hit that rebinds with no solver call, no
    miss of the structural cache and, through the rebound run, no new shm
    program. Both bindings against the dense per-gate oracle on the card,
    every kernel op of the rebound engine against its plain version."""
    from repro_torch.core import kernelization, staging
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.engine import DEFAULT_CACHE, engine_for
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    ops.reset_kernel_counters()
    run = simulate.main(argv)
    sync(device)
    launches = launches_match(ops, run.engine, "engine path")
    res = run.result
    marg = res.marginals[(0, 1, 2)]
    require(marg.shape == (8,) and bool(np.all(np.isfinite(marg))) and abs(marg.sum() - 1) < 1e-4,
            "engine path: the marginal must be a finite distribution over 8 outcomes")
    require(all(np.isfinite(v) for v in res.expectations.values()),
            "engine path: expectations must be finite")
    eng = run.engine
    first = eng.bound_circuit
    state = eng.finalize(run.state)
    run.state = None
    fid1 = fidelity(state, dense_simulate(first, device=device))
    del state
    log(f"  first binding: fidelity vs dense per-gate oracle {fid1:.9f}; cold build "
        f"(plan + compile + upload) {run.build_seconds:.3f} s, first bind {run.bind_seconds:.3f} s, "
        f"simulate {run.seconds:.3f} s ({card})")
    require(fid1 >= FIDELITY_MIN, f"engine path fidelity {fid1} < {FIDELITY_MIN}")

    def warm_counts():
        return (dict(staging.SOLVER_CALLS), dict(kernelization.SOLVER_CALLS),
                set(eng._struct_cache), ops.SCHEDULE_CALLS["shm"])

    counts = warm_counts()
    hits = DEFAULT_CACHE.hits
    n = eng.n
    bound = PARAM_FAMILIES["isingparam"](n).bind(REBIND)
    sync(device)
    t0 = time.time()
    again = engine_for(bound, eng.L, eng.R, eng.G, device=device)
    sync(device)
    rebind_s = time.time() - t0
    require(again is eng and DEFAULT_CACHE.hits == hits + 1 and eng.bind_count == 2,
            "engine_for on the same structure with other angles must be a cache hit "
            "that rebinds")
    ops.reset_kernel_counters()
    t0 = time.time()
    state = eng.run()
    sync(device)
    run_s = time.time() - t0
    launches_match(ops, eng, "rebound engine")
    require(warm_counts() == counts,
            "a warm rebind and its run must run no solver, miss no entry of the structural "
            "cache and schedule no shm program")
    fid2 = fidelity(state, dense_simulate(bound, device=device))
    del state
    log(f"  rebinding {REBIND}: cache hit, warm rebind {rebind_s:.3f} s (cold build "
        f"{run.build_seconds:.3f} s), run {run_s:.3f} s, fidelity {fid2:.9f}; no solver "
        f"call, no structural-cache miss ({len(counts[2])} entries), no shm program "
        f"scheduled ({card})")
    require(fid2 >= FIDELITY_MIN, f"rebound fidelity {fid2} < {FIDELITY_MIN}")
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(1 << n, dtype=torch.complex64, device=device, generator=gen)
    worst = hold_ops(ops, ref, eng, eng.backend.pass_of(), x, "rebound engine")
    return {"launches": launches, "engine": eng, "x": x, "worst": worst,
            "build_s": run.build_seconds, "first_bind_s": run.bind_seconds,
            "rebind_s": rebind_s, "simulate_s": run.seconds, "rebound_run_s": run_s,
            "fidelity": [fid1, fid2]}


def sweep_phase(ops, ref, n: int, L: int, R: int, P: int, card: str,
                device: str = "cuda") -> dict:
    """``isingparam(n)`` against P bindings in one ``run_sweep``: one launch
    per compiled op for all P points (past int32 indices at n=28, P=16),
    every row against the dense oracle, ``measure_sweep`` finite, against P
    sequential ``run`` calls of the same engine; then every kernel op at
    the sweep's own shapes (:func:`hold_sweep_ops`)."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.measure import measure_sweep
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    sym = PARAM_FAMILIES["isingparam"](n)
    t0 = time.time()
    eng = engine_for(sym, L, R, 0, device=device)
    build_s = time.time() - t0
    rng = np.random.default_rng(13)
    points = [{"J": float(j), "h": float(h)} for j, h in rng.uniform(-1.5, 1.5, size=(P, 2))]
    # warm-up of both shapes: the binding pass's structural cache, index
    # tensors, step tables
    eng.run(params=points[0])
    eng.run_sweep(None, points)
    sync(device)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    t0 = time.time()
    out = eng.run_sweep(None, points)
    sync(device)
    sweep_s = time.time() - t0
    exec_s = eng.timing_snapshot()["run_sweep"]["last_us"] / 1e6
    launches = launches_match(ops, eng, f"sweep of {P}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    require(out.shape == (P, 1 << n), f"sweep output {tuple(out.shape)}")
    fids = []
    t0 = time.time()
    for p in range(P):
        fids.append(fidelity(out[p], dense_simulate(sym.bind(points[p]), device=device)))
        require(fids[-1] >= FIDELITY_MIN, f"sweep row {p} fidelity {fids[-1]} < {FIDELITY_MIN}")
    oracle_s = time.time() - t0
    del out
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    runs = 0.0
    for pt in points:
        eng.run(params=pt)
        runs += eng.timing_snapshot()["run"]["last_us"] / 1e6
    sync(device)
    seq_s = time.time() - t0
    if device == "cuda":
        trace_run(lambda: eng.run_sweep(None, points), exec_s, f"run_sweep of {P}")
        trace_run(eng.run, runs / P, "one run of the sequence")
    t0 = time.time()
    results = measure_sweep(eng, points, marginals=[(0, 1, 2)], observables=["Z0 Z1 + 0.5*X2"])
    measure_s = time.time() - t0
    require(len(results) == P and all(
        bool(np.all(np.isfinite(r.marginals[(0, 1, 2)])))
        and all(np.isfinite(v) for v in r.expectations.values()) for r in results),
        "measure_sweep marginals and expectations must be finite")
    log(f"  isingparam({n}) L={L} R={R}, P={P}: {P << n} amplitudes; sweep {sweep_s:.3f} s = "
        f"{sweep_s / P:.4f} s/point (stage loop {exec_s:.3f} s, the rest host binding); "
        f"{P} sequential runs {seq_s:.3f} s = {seq_s / P:.4f} s/point (stage loops {runs:.3f} s); "
        f"peak device memory {gib(peak)}; fidelity of rows 0..{P - 1} against the oracle "
        f"({oracle_s:.1f} s): min {min(fids):.9f}, max {max(fids):.9f}; measure_sweep "
        f"{measure_s:.1f} s; engine built in {build_s:.2f} s ({card})")
    worst = hold_sweep_ops(ops, ref, eng, eng.backend.pass_of(P, eng.sweep_tables(points)),
                           seed=17, what=f"sweep of {P}")
    return {"launches": launches, "sweep_s": sweep_s, "sweep_exec_s": exec_s,
            "sequential_s": seq_s, "sequential_exec_s": runs, "peak_bytes": peak,
            "fidelity": fids, "worst": worst}


def batch_phase(ops, ref, n: int, L: int, R: int, B: int, card: str,
                device: str = "cuda") -> dict:
    """``qft(n)`` on B basis states in one ``run_batch`` (B need not be a
    power of two): one launch per compiled op, each row against the dense
    oracle, every kernel op at the batch's shard count against its plain
    version."""
    from repro_torch.core.generators import FAMILIES
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    circ = FAMILIES["qft"](n)
    t0 = time.time()
    eng = engine_for(circ, L, R, 0, device=device)
    build_s = time.time() - t0
    psi0s = torch.zeros(B, 1 << n, dtype=torch.complex64, device=device)
    psi0s[torch.arange(B), torch.arange(B)] = 1.0
    eng.run_batch(psi0s)  # warm-up of both shapes: index tensors, step tables
    eng.run(psi0s[0])
    sync(device)
    ops.reset_kernel_counters()
    t0 = time.time()
    out = eng.run_batch(psi0s)
    sync(device)
    batch_s = time.time() - t0
    launches = launches_match(ops, eng, f"batch of {B}")
    t0 = time.time()
    eng.run(psi0s[0])
    sync(device)
    single_s = time.time() - t0
    fids = []
    for b in range(B):
        fids.append(fidelity(out[b], dense_simulate(circ, psi0=psi0s[b], device=device)))
        require(fids[-1] >= FIDELITY_MIN, f"batch row {b} fidelity {fids[-1]} < {FIDELITY_MIN}")
    log(f"  qft({n}) L={L} R={R}, B={B}: run_batch {batch_s:.3f} s = {batch_s / B:.4f} s/state "
        f"(one state alone {single_s:.4f} s); "
        "fidelity " + ", ".join(f"{f:.9f}" for f in fids)
        + f"; engine built in {build_s:.2f} s ({card})")
    del out, psi0s
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(B << n, dtype=torch.complex64, device=device, generator=gen)
    worst = hold_ops(ops, ref, eng, eng.backend.pass_of(B), x, f"batch of {B}")
    return {"launches": launches, "batch_s": batch_s, "single_s": single_s, "fidelity": fids,
            "worst": worst}


def pinned() -> tuple:
    """Blocks and bytes PyTorch's pinned host allocator has pinned so far (a
    block it hands out again is not counted again). Small blocks stage the
    uploads of index tensors and step tables; a state buffer is a block of
    at least a shard."""
    st = torch.cuda.host_memory_stats()
    return int(st["num_host_alloc"]), int(st["allocated_bytes.allocated"])


def release_pinned() -> None:
    """Hand the pinned blocks PyTorch's host allocator keeps cached back to
    the system: the offload states are tens of GiB of host memory, and the
    next phase pins other sizes."""
    gc.collect()
    empty = (getattr(getattr(torch, "accelerator", None), "empty_host_cache", None)
             or getattr(torch._C, "_host_emptyCache", None))
    require(empty is not None, "this torch cannot release its pinned host cache")
    empty()


def link_rates(nbytes: int = 2 << 30) -> dict:
    """Pinned host <-> card copy rates in GB/s at one 2 GiB shard: each
    direction alone (median of 5 CUDA-event timings) and both at once on
    two streams (median of 3 wall timings)."""
    from repro_torch.kernels import probe

    amps = nbytes // 8
    host = [torch.empty(amps, dtype=torch.complex64, pin_memory=True) for _ in range(2)]
    dev = [torch.empty(amps, dtype=torch.complex64, device="cuda") for _ in range(2)]
    h2d = probe.time_ms(lambda: dev[0].copy_(host[0], non_blocking=True)) / 1e3
    d2h = probe.time_ms(lambda: host[1].copy_(dev[1], non_blocking=True)) / 1e3
    streams = [torch.cuda.Stream() for _ in range(2)]
    both = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(streams[0]):
            dev[0].copy_(host[0], non_blocking=True)
        with torch.cuda.stream(streams[1]):
            host[1].copy_(dev[1], non_blocking=True)
        torch.cuda.synchronize()
        both.append(time.perf_counter() - t0)
    del host, dev
    release_pinned()
    return {"h2d": nbytes / h2d / 1e9, "d2h": nbytes / d2h / 1e9,
            "both": 2 * nbytes / float(np.median(both)) / 1e9}


class MeasureClock:
    """While installed, times the measurer's parts (seconds): the shard
    masses, sampling (without the masses), marginals and expectations. On
    its first call it also reads the device memory the run left (peak and
    in use) and resets the peak, so the run's peak and the measurement's
    are told apart."""

    def __init__(self, TM):
        self.TM = TM
        self.seconds = {"masses": 0.0, "sampling": 0.0, "marginal": 0.0, "expectation": 0.0}
        self.run_peak = self.after_run = None

    def _wrap(self, cls, name, part):
        orig = getattr(cls, name)

        def timed(obj, *args, **kw):
            if self.run_peak is None:
                torch.cuda.synchronize()
                self.run_peak = torch.cuda.max_memory_allocated()
                self.after_run = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = orig(obj, *args, **kw)
            self.seconds[part] += time.perf_counter() - t0
            return out

        self._saved.append((cls, name, orig))
        setattr(cls, name, timed)

    def __enter__(self):
        self._saved = []
        self._wrap(self.TM.StreamingMeasurer, "_shard_masses", "masses")
        self._wrap(self.TM.Measurer, "sample", "sampling")
        self._wrap(self.TM.Measurer, "marginal", "marginal")
        self._wrap(self.TM.Measurer, "expectation", "expectation")
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)
        self.seconds["sampling"] -= self.seconds["masses"]


def shard_fidelity(host: torch.Tensor, on_card: torch.Tensor, L: int) -> tuple:
    """``|<host|on_card>|`` accumulated in complex128 shard by shard on the
    card (one host shard copied up at a time), the largest amplitude
    difference, and ``||host - on_card||_2``."""
    host, on_card = host.reshape(-1), on_card.reshape(-1)
    inner = torch.zeros((), dtype=torch.complex128, device="cuda")
    sq = torch.zeros((), dtype=torch.float64, device="cuda")
    worst = 0.0
    for lo in range(0, host.numel(), 1 << L):
        a = host[lo:lo + (1 << L)].to("cuda", non_blocking=True)
        b = on_card[lo:lo + (1 << L)]
        worst = max(worst, max_err(a, b))
        inner += torch.vdot(a.to(torch.complex128), b.to(torch.complex128))
        sq += (a - b).abs().pow_(2).sum(dtype=torch.float64)
        del a
    return float(inner.abs()), worst, float(sq.sqrt())


def stage_lines(be, rates: dict, card: str, what: str) -> list:
    """Log each streamed stage of the offload backend's last run (bytes
    both ways, GB/s, and the link bounds from ``rates``: both directions
    at once at their rates alone, both at once at the rate measured with
    both running, one direction at a time) and each host remap; return the
    stages."""
    stages = [t for t in be.trace if t["kind"] == "stage"]
    for i, t in enumerate(stages):
        half = t["bytes"] / 2
        both = max(half / rates["h2d"], half / rates["d2h"]) / 1e9
        shared = t["bytes"] / rates["both"] / 1e9
        one = (half / rates["h2d"] + half / rates["d2h"]) / 1e9
        t.update(gb_s=t["bytes"] / t["seconds"] / 1e9, bound_both_s=both,
                 bound_shared_s=shared, bound_one_way_s=one)
        log(f"  {what} stage {i}: {t['ops']} ops, {gib(t['bytes'])} moved (up and down) in "
            f"{t['seconds']:.3f} s = {t['gb_s']:.2f} GB/s; link bound {both:.3f} s (both ways "
            f"at once), {shared:.3f} s (both ways at the measured shared rate), {one:.3f} s "
            f"(one way at a time) ({card})")
    remaps = [t for t in be.trace if t["kind"] == "remap"]
    log(f"  {what} host remaps: " + ", ".join(f"{t['slot']} {t['seconds']:.3f} s" for t in remaps))
    return stages


def offload_phase(simulate, ops, ref, probe, card: str, rates: dict, fused: dict) -> dict:
    """``ising(32)`` L=28 R=4 through ``--executor offload``: a 32 GiB
    pinned host state in 16 shards of 2 GiB, streamed through the hand
    kernels stage by stage, then measured shard by shard. Checks one
    launch per op and shard, the run's peak device memory (at most four
    shards above what the engine keeps), every kernel op on shard 0 and
    shard 15 against its plain version, the state against the in-card run
    of the same plan, and a warm run after a rebind that pins no host
    memory and schedules no shm program."""
    from repro_torch.sim import measure as TM
    from repro_torch.sim.engine import ExecutionEngine

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    pins = pinned()
    t0 = time.time()
    with MeasureClock(TM) as clock:
        run = simulate.main(OFFLOAD_PATH)
    cli_s = time.time() - t0
    eng, be = run.engine, run.engine.backend
    S, L = be.S, eng.L
    shard_bytes = 8 << L
    launches = launches_match(ops, eng, "offload path", per_op=S)
    res = run.result
    require(res.samples.shape == (64,) and bool(np.all((res.samples >= 0)
                                                       & (res.samples < 1 << eng.n))),
            "offload path: shots must be 64 basis-state indices")
    marg = res.marginals[(0, 1, 2)]
    require(marg.shape == (8,) and bool(np.all(np.isfinite(marg))) and abs(marg.sum() - 1) < 1e-4,
            "offload path: the marginal must be a finite distribution over 8 outcomes")
    require(all(np.isfinite(v) for v in res.expectations.values()),
            "offload path: expectations must be finite")
    stages = stage_lines(be, rates, card, "offload")
    remaps = [t["seconds"] for t in be.trace if t["kind"] == "remap"]
    run_peak, kept = clock.run_peak - base, clock.after_run - base
    require(run_peak <= 4 * shard_bytes + kept,
            f"offload run: peak device memory {gib(run_peak)} exceeds four shards above the "
            f"{gib(kept)} the engine keeps")
    meas_peak = torch.cuda.max_memory_allocated() - base
    blocks, nbytes = (a - b for a, b in zip(pinned(), pins))
    log(f"  simulate {run.seconds:.3f} s (cold: a first run pins its host states) = "
        f"{sum(t['seconds'] for t in stages):.3f} s streamed stages + {sum(remaps):.3f} s host "
        f"remaps + the rest; pinned {gib(nbytes)} in {blocks} blocks; overlap_ratio "
        f"{be.overlap_ratio:.3f}; peak device memory {gib(run_peak)} ({run_peak / shard_bytes:.2f}"
        f" shards; the engine keeps {gib(kept)}) against a {gib(8 << eng.n)} state; measuring "
        f"{gib(meas_peak)} ({card})")
    m = clock.seconds
    log(f"  measured in {sum(m.values()):.3f} s: shard masses {m['masses']:.3f} s, sampling "
        f"64 shots {m['sampling']:.3f} s ({len(np.unique(res.samples >> L))} distinct shards, "
        f"each a host float64 CDF of 2^{L} amplitudes), marginal {m['marginal']:.3f} s, "
        f"expectation {m['expectation']:.3f} s; the CLI call {cli_s:.1f} s ({card})")

    # the in-card run of the same plan, shard by shard against the offload state
    t0 = time.time()
    in_card = ExecutionEngine(eng.circuit, eng.plan, device="cuda")
    want = in_card.run_packed()
    sync("cuda")
    card_s = time.time() - t0
    fid, diff, _ = shard_fidelity(run.state, want, L)
    log(f"  ising({eng.n}) offload vs in-card on one plan, shard by shard: fidelity {fid:.9f}, "
        f"max |difference| {diff:.3e}; in-card compile + run {card_s:.3f} s ({card})")
    require(fid >= FIDELITY_MIN, f"offload fidelity {fid} < {FIDELITY_MIN}")
    run.state = None
    del in_card

    # a warm run after a rebind: no pinned block, no shm program, same state
    gc.collect()
    pins, schedules = pinned(), ops.SCHEDULE_CALLS["shm"]
    eng.bind_circuit(eng.bound_circuit)
    t0 = time.time()
    again = eng.run_packed()
    warm_s = time.time() - t0
    blocks, nbytes = (a - b for a, b in zip(pinned(), pins))
    require(nbytes < shard_bytes and ops.SCHEDULE_CALLS["shm"] == schedules,
            f"a warm offload run after a rebind must pin no state buffer ({gib(nbytes)} "
            f"pinned) and schedule no shm program")
    warm_stages = stage_lines(be, rates, card, "offload warm")
    fid2, _, _ = shard_fidelity(again, want, L)
    require(fid2 >= FIDELITY_MIN, f"warm offload fidelity {fid2} < {FIDELITY_MIN}")
    log(f"  warm run after a rebind: {warm_s:.3f} s; no state buffer pinned ({nbytes} bytes "
        f"in {blocks} staging blocks), no shm program scheduled, fidelity {fid2:.9f} ({card})")
    del again, want
    torch.cuda.empty_cache()

    # every kernel op of the path on shard 0 and the last shard, as launched
    tops = [op for prog in eng.cc.programs for op in prog.ops]
    worst = {"fused": 0.0, "shm": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(1 << L, dtype=torch.complex64, device="cuda", generator=gen)
    ps0 = None
    for s in (0, S - 1):
        ps = be.shard_pass(s, tops, be.new_run(1))
        ps0 = ps0 or ps
        w = hold_ops(ops, ref, eng, ps, x, f"offload shard {s}")
        worst = {k: max(worst[k], w[k]) for k in worst}
    rows = fused_by_k(ops, ref, probe, eng, x, "offload shard 0", launches["by_k"],
                      skip=[row["k"] for row in fused["by_k"]], ps=ps0)
    fused["by_k"] += [by_k_row(row) for row in rows]
    # each stage's kernels alone on one shard (CUDA events), times the shards
    for i, (prog, t) in enumerate(zip(eng.cc.programs, warm_stages)):
        ps = be.shard_pass(0, prog.ops, be.new_run(1))
        ms = probe.time_ms(lambda: be.apply_ops(x, prog, ps), reps=3)
        t["kernels_s"] = ms * S / 1e3
        log(f"  offload stage {i}: its kernels alone {ms:.2f} ms a shard, {t['kernels_s']:.3f} s "
            f"for {S} shards, against {t['seconds']:.3f} s streamed (warm) ({card})")
    del x, run
    release_pinned()
    return {"launches": launches, "worst": worst, "stages": stages, "warm_stages": warm_stages,
            "remaps": remaps, "measure": m, "run_peak": run_peak, "fidelity": [fid, fid2]}


def pergate_phase(ops, ref, probe, card: str, fused: dict, n: int, L: int, R: int) -> dict:
    """``qft(n)`` through the staged offload path and through the per-gate
    baseline (one pass over the host state for each op): shard transfers,
    seconds, their ratios, each state against the in-card run of the
    staged plan, every kernel op of both on shard 0 and the last shard
    against its plain version."""
    from repro_torch.core.generators import FAMILIES
    from repro_torch.sim.engine import ExecutionEngine, engine_for
    from repro_torch.sim.offload import PerGateOffloadExecutor
    from repro_torch.sim.statevector import fidelity

    circ = FAMILIES["qft"](n)
    staged = engine_for(circ, L, R, 0, backend="offload", device="cuda")
    staged.run()  # first use: pins this size and builds the step tables
    ops.reset_kernel_counters()
    before = staged.backend.stats["shard_transfers"]
    t0 = time.time()
    a = staged.run()
    staged_s = time.time() - t0
    staged_moves = staged.backend.stats["shard_transfers"] - before
    S = staged.backend.S
    staged_launches = launches_match(ops, staged, f"qft({n}) staged offload", per_op=S, kinds=())
    want = ExecutionEngine(circ, staged.plan, device="cuda").run()
    fa = fidelity(a.to("cuda"), want)
    del a
    pg = PerGateOffloadExecutor(circ, L, device="cuda")
    ops.reset_kernel_counters()
    t0 = time.time()
    b = pg.run()
    pg_s = time.time() - t0
    pg_launches = launches_match(ops, pg.engine, f"qft({n}) per-gate", per_op=S, kinds=("fused",))
    fb = fidelity(b.to("cuda"), want)
    del b, want
    passes = sum(len(p.ops) for p in pg.engine.cc.programs)
    require(staged_moves == len(staged.cc.programs) * S,
            "staged offload: one transfer per stage and shard")
    require(pg.stats["shard_transfers"] == passes * S, "per-gate: one transfer per op and shard")
    ratio = pg.stats["shard_transfers"] / staged_moves
    require(ratio > 5, f"the per-gate baseline moves only {ratio:.1f}x the staged shards")
    require(min(fa, fb) >= FIDELITY_MIN, f"qft({n}) offload fidelities {fa}, {fb}")
    log(f"  qft({n}) L={L} R={R}: staged offload {staged_s:.3f} s ({staged_moves} shard "
        f"transfers, {len(staged.cc.programs)} stages), per-gate {pg_s:.3f} s "
        f"({pg.stats['shard_transfers']} shard transfers, {passes} passes); transfers "
        f"{ratio:.2f}x, seconds {pg_s / staged_s:.1f}x; fidelity vs in-card {fa:.9f} (staged), "
        f"{fb:.9f} (per-gate) ({card})")
    worst = {"fused": 0.0, "shm": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(1 << L, dtype=torch.complex64, device="cuda", generator=gen)
    for eng, what in ((staged, "staged"), (pg.engine, "per-gate")):
        be = eng.backend
        tops = [op for prog in eng.cc.programs for op in prog.ops]
        ps0 = None
        for s in (0, S - 1):
            ps = be.shard_pass(s, tops, be.new_run(1))
            ps0 = ps0 or ps
            w = hold_ops(ops, ref, eng, ps, x, f"qft({n}) {what} shard {s}")
            worst = {k: max(worst[k], w[k]) for k in worst}
        launches = staged_launches if eng is staged else pg_launches
        rows = fused_by_k(ops, ref, probe, eng, x, f"qft({n}) {what} shard 0", launches["by_k"],
                          skip=[row["k"] for row in fused["by_k"]], ps=ps0)
        fused["by_k"] += [by_k_row(row) for row in rows]
    del x, staged, pg
    release_pinned()
    return {"staged": staged_launches, "pergate": pg_launches, "worst": worst,
            "staged_s": staged_s, "pergate_s": pg_s, "ratio": ratio}


def offload_rows_phase(ops, ref, card: str, n: int, L: int, R: int, B: int, P: int) -> dict:
    """A batch of B basis states of ``qft(n)`` and a sweep of P bindings of
    ``isingparam(n)`` through the offload backend (``[B, 2^L]`` and
    ``[P, 2^L]`` blocks), each row against the in-card ``run_batch`` /
    ``run_sweep`` of the same plan on the card, every kernel op on shard 0
    at the pass's rows against its plain version."""
    from repro_torch.core.generators import FAMILIES, PARAM_FAMILIES
    from repro_torch.sim.engine import ExecutionEngine, engine_for
    from repro_torch.sim.statevector import fidelity

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(13)
    for what, rows in (("batch", B), ("sweep", P)):
        if what == "batch":
            circ = FAMILIES["qft"](n)
            psi0s = torch.zeros(B, 1 << n, dtype=torch.complex64, device="cuda")
            psi0s[torch.arange(B), torch.arange(B)] = 1.0
            off = engine_for(circ, L, R, 0, backend="offload", device="cuda")
            in_card = ExecutionEngine(circ, off.plan, device="cuda")

            def go(e):
                return e.run_batch(psi0s)
        else:
            circ = PARAM_FAMILIES["isingparam"](n)
            rng = np.random.default_rng(29)
            points = [{"J": float(j), "h": float(h)} for j, h in rng.uniform(-1.5, 1.5, (P, 2))]
            off = engine_for(circ, L, R, 0, backend="offload", device="cuda")
            in_card = ExecutionEngine(circ, off.plan, device="cuda")

            def go(e):
                return e.run_sweep(None, points)
        S = off.backend.S
        ops.reset_kernel_counters()
        t0 = time.time()
        got = go(off)
        off_s = time.time() - t0
        launches = launches_match(ops, off, f"offload {what} of {rows}", per_op=S)
        want = go(in_card)
        fids = [fidelity(got[r].to("cuda"), want[r]) for r in range(rows)]
        require(min(fids) >= FIDELITY_MIN, f"offload {what}: fidelities {fids}")
        log(f"  {'qft' if what == 'batch' else 'isingparam'}({n}) L={L} R={R}, offload {what} "
            f"of {rows}: {off_s:.3f} s (first run), {S} shards of [{rows}, 2^{L}]; fidelity vs "
            f"the in-card {what} " + ", ".join(f"{f:.9f}" for f in fids) + f" ({card})")
        del got, want, in_card
        be = off.backend
        run = be.new_run(rows, off.sweep_tables(points) if what == "sweep" else None)
        tops = [op for prog in off.cc.programs for op in prog.ops]
        ps = be.shard_pass(0, tops, run)
        x = torch.randn(rows << L, dtype=torch.complex64, device="cuda", generator=gen)
        worst = hold_ops(ops, ref, off, ps, x, f"offload {what} of {rows}, shard 0")
        out[what] = {"launches": launches, "worst": worst, "fidelity": fids}
        del x, run, ps, off
        torch.cuda.empty_cache()
        release_pinned()
    return out


def host_check() -> int:
    """The spill directory's disk and the host's memory, as ``df -h`` and
    ``free -g`` print them, and its cores; returns the disk's free bytes."""
    os.makedirs(SPILL_ROOT, exist_ok=True)
    for cmd in (["df", "-h", SPILL_ROOT], ["free", "-g"]):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        for line in (proc.stdout or proc.stderr).strip().splitlines():
            log(f"  {cmd[0]}: {line}")
    log(f"  host cores: {os.cpu_count()}")
    return shutil.disk_usage(SPILL_ROOT).free


def store_budget(tier: str, n: int, fraction: float, free_disk: int) -> int:
    """The DRAM budget that keeps ``fraction`` of the state at rest in DRAM,
    raised where the disk could not take half of what spills: a remap
    holds both generations of the state at rest, less what DRAM holds."""
    from repro_torch.sim.shard_store import AT_REST_BYTES_PER_AMP

    at_rest = AT_REST_BYTES_PER_AMP[tier] * (1 << n)
    budget = fraction * at_rest
    if 2 * at_rest - budget > free_disk / 2:
        budget = 2 * at_rest - free_disk / 2
    require(budget < at_rest, f"the spill disk has {gib(free_disk)} free: too little to spill "
                              f"a {gib(at_rest)} {tier} state")
    return int(budget)


def store_phase(simulate, ops, ref, probe, card: str, fused: dict, free_disk: int, tier: str,
                n: int, L: int, R: int, dram_fraction: float, tol: float, xy: bool = False) -> dict:
    """``ising(n)`` through ``--executor offload --storage tier`` with a DRAM
    budget that spills: one launch per op and shard, spills and reloads,
    the run's peak device memory (at most four shards), each stage and
    out-of-core remap with the store's codec and disk seconds, the pinned
    bytes, and the state against the in-card run of the same plan shard by
    shard within the run's own error bound; every kernel op on shards 0 and
    S-1 against its plain version. With ``xy``, Pauli terms with 2 and 3
    non-local X/Y qubits measured on the store's state (peak device memory)
    and on the in-card state."""
    from repro_torch.sim import measure as TM
    from repro_torch.sim.engine import ExecutionEngine

    budget = store_budget(tier, n, dram_fraction, free_disk)
    spill = os.path.join(SPILL_ROOT, f"{tier}{n}")
    shutil.rmtree(spill, ignore_errors=True)
    argv = ["--circuit", "ising", "--n", str(n), "--L", str(L), "--R", str(R), "--executor",
            "offload", "--storage", tier, "--dram-budget-mb", str(budget / 2**20), "--spill-dir",
            spill, "--storage-tol", str(tol), "--observable", "Z0 Z1 + 0.5*X2"]
    log("  " + " ".join(argv))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    pins = pinned()
    t0 = time.time()
    with MeasureClock(TM) as clock:
        run = simulate.main(argv)
    cli_s = time.time() - t0
    eng, be = run.engine, run.engine.backend
    S, shard_bytes = be.S, 8 << L
    launches = launches_match(ops, eng, f"{tier} store path", per_op=S)
    snap = eng.provenance["storage"]
    require(snap["spills"] > 0 and snap["spill_loads"] > 0,
            f"{tier} store: the run must spill and reload ({snap['spills']} spills, "
            f"{snap['spill_loads']} reloads)")
    require(all(np.isfinite(v) for v in run.result.expectations.values()),
            f"{tier} store: expectations must be finite")
    run_peak, kept = clock.run_peak - base, clock.after_run - base
    require(run_peak <= 4 * shard_bytes + kept,
            f"{tier} store run: peak device memory {gib(run_peak)} exceeds four shards above the "
            f"{gib(kept)} the engine keeps")
    blocks, nbytes = (a - b for a, b in zip(pinned(), pins))
    io = {"spill_write_s": 0.0, "spill_read_s": 0.0, "spill_write_bytes": 0, "spill_read_bytes": 0}
    for t in be.trace:
        st = t.get("store")
        what = {"stage": f"stage ({t.get('ops')} ops)", "remap": f"out-of-core remap {t.get('slot')}"
                }.get(t["kind"], t["kind"])
        line = f"  {tier} store {what}: {t['seconds']:.3f} s"
        if st:
            for k in io:
                io[k] += st[k]
            io_s = st["spill_write_s"] + st["spill_read_s"]
            io_b = st["spill_write_bytes"] + st["spill_read_bytes"]
            line += (f"; encode {st['encode_s']:.3f} s, decode {st['decode_s']:.3f} s, disk "
                     f"{gib(st['spill_write_bytes'])} out + {gib(st['spill_read_bytes'])} in in "
                     f"{io_s:.3f} s" + (f" = {io_b / io_s / 1e9:.2f} GB/s" if io_s else ""))
        log(line + f" ({card})")
    stages = [t["seconds"] for t in be.trace if t["kind"] == "stage"]
    remaps = [t["seconds"] for t in be.trace if t["kind"] == "remap"]
    gather = sum(t["seconds"] for t in be.trace if t["kind"] == "gather")
    io_s = io["spill_write_s"] + io["spill_read_s"]
    log(f"  {tier} ising({n}) L={L} R={R}: simulate {run.seconds:.3f} s = {sum(stages):.3f} s "
        f"stages + {sum(remaps):.3f} s out-of-core remaps + {gather:.3f} s gather + the rest "
        f"(filling the store); spill {gib(io['spill_write_bytes'])} written at "
        f"{io['spill_write_bytes'] / max(io['spill_write_s'], 1e-9) / 1e9:.2f} GB/s, "
        f"{gib(io['spill_read_bytes'])} read at "
        f"{io['spill_read_bytes'] / max(io['spill_read_s'], 1e-9) / 1e9:.2f} GB/s ({io_s:.3f} s); "
        f"{snap['spills']} spills, {snap['spill_loads']} reloads, peak at-rest DRAM "
        f"{gib(snap['peak_dram_bytes'])} of a {gib(budget)} budget; error bound "
        f"{snap['relative_error_bound']:.3e} (tol {tol}); peak device memory {gib(run_peak)} "
        f"({run_peak / shard_bytes:.2f} shards; the engine keeps {gib(kept)}); pinned "
        f"{gib(nbytes)} in {blocks} blocks; the CLI call {cli_s:.1f} s ({card})")

    t0 = time.time()
    in_card = ExecutionEngine(eng.circuit, eng.plan, device="cuda")
    want = in_card.run_packed()
    sync("cuda")
    card_s = time.time() - t0
    fid, diff, l2 = shard_fidelity(run.state, want, L)
    bound = snap["relative_error_bound"]
    log(f"  {tier} store vs in-card on one plan, shard by shard: ||difference|| {l2:.3e} against "
        f"the run's bound {bound:.3e}; fidelity {fid:.9f}, max |difference| {diff:.3e}; in-card "
        f"compile + run {card_s:.3f} s ({card})")
    require(l2 <= bound + 1e-5, f"{tier} store: ||store - in-card|| {l2} exceeds the bound {bound}")
    del in_card
    out = {"launches": launches, "seconds": run.seconds, "stages": stages, "remaps": remaps,
           "io": io, "run_peak": run_peak, "pinned": nbytes, "l2": l2, "bound": bound}
    if xy:
        frame = eng.measurement_frame
        nl = [q for q in range(frame.n) if frame.phys_of[q] >= L]
        loc = [q for q in range(frame.n) if frame.phys_of[q] < L]
        terms = [f"X{nl[0]} Y{nl[1]} Z{loc[0]}", f"X{nl[0]} Y{nl[1]} X{nl[2]} Z{loc[1]}"]
        on_card = [TM.StreamingMeasurer(want, frame, "cuda").expectation(t) for t in terms]
        del want
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m = TM.StreamingMeasurer(run.state, frame, "cuda")
        vals, secs = [], []
        for t in terms:
            t0 = time.time()
            vals.append(m.expectation(t))
            secs.append(time.time() - t0)
        xy_peak = torch.cuda.max_memory_allocated() - base
        for t, v, w, sec in zip(terms, vals, on_card, secs):
            mm = t.count("X") + t.count("Y")
            log(f"  <{t}> (m={mm} non-local X/Y): {v:+.9f} on the {tier} store's state in "
                f"{sec:.3f} s, {w:+.9f} on the in-card state ({card})")
            require(abs(v - w) <= 2.1 * l2 + 1e-5,
                    f"<{t}> on the store's state and on the in-card state differ by {abs(v - w)}")
        log(f"  X/Y terms: peak device memory {gib(xy_peak)} ({xy_peak / shard_bytes:.2f} shards), "
            f"against the run's {gib(run_peak)}; a whole group at m=3 would stack "
            f"{gib(2 * 8 * shard_bytes)} ({card})")
        require(xy_peak <= run_peak + shard_bytes,
                f"X/Y measurement peak {gib(xy_peak)} exceeds the run's {gib(run_peak)} plus a shard")
        out.update(xy_peak=xy_peak, xy=dict(zip(terms, vals)))
    else:
        del want
    torch.cuda.empty_cache()

    tops = [op for prog in eng.cc.programs for op in prog.ops]
    worst = {"fused": 0.0, "shm": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn(1 << L, dtype=torch.complex64, device="cuda", generator=gen)
    ps0 = None
    for s in (0, S - 1):
        ps = be.shard_pass(s, tops, be.new_run(1))
        ps0 = ps0 or ps
        w = hold_ops(ops, ref, eng, ps, x, f"{tier} store shard {s}")
        worst = {k: max(worst[k], w[k]) for k in worst}
    rows = fused_by_k(ops, ref, probe, eng, x, f"{tier} store shard 0", launches["by_k"],
                      skip=[row["k"] for row in fused["by_k"]], ps=ps0)
    fused["by_k"] += [by_k_row(row) for row in rows]
    del x, run
    release_pinned()
    shutil.rmtree(spill, ignore_errors=True)
    out["worst"] = worst
    return out


def checkpoint_phase(card: str, ops, ref, n: int, L: int, R: int) -> dict:
    """``ising(n)`` through the offload backend with ``checkpoint_dir``:
    killed by an injected ``shard_transfer_error`` inside stage 1 (only that
    typed error may end it), then resumed in a fresh engine from the
    journal: the resumed stages' launches, and the state equal to the
    uninterrupted run's bit for bit; the save of each stage timed. The
    uninterrupted run is held against the in-card run of its plan shard by
    shard, and every kernel op of its shards 0 and S-1 against its plain
    version."""
    from repro_torch.core.generators import FAMILIES
    from repro_torch.sim import faults
    from repro_torch.sim.engine import ExecutionEngine, engine_for

    circ = FAMILIES["ising"](n)
    shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    plain = engine_for(circ, L, R, 0, backend="offload", device="cuda", cache=None)
    t0 = time.time()
    want = plain.run()
    plain_s = time.time() - t0
    S = plain.backend.S
    on_card = ExecutionEngine(circ, plain.plan, device="cuda").run()
    fid, diff, _ = shard_fidelity(want, on_card, L)
    del on_card
    torch.cuda.empty_cache()
    log(f"  ising({n}) uninterrupted offload run vs in-card on one plan, shard by shard: "
        f"fidelity {fid:.9f}, max |difference| {diff:.3e} ({card})")
    require(fid >= FIDELITY_MIN, f"checkpoint phase: offload fidelity {fid} < {FIDELITY_MIN}")
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(1 << L, dtype=torch.complex64, device="cuda", generator=gen)
    tops = [op for prog in plain.cc.programs for op in prog.ops]
    worst = {"fused": 0.0, "shm": 0.0}
    for s in (0, S - 1):
        ps = plain.backend.shard_pass(s, tops, plain.backend.new_run(1))
        w = hold_ops(ops, ref, plain, ps, x, f"checkpoint plan shard {s}")
        worst = {k: max(worst[k], w[k]) for k in worst}
    del x, ps
    kw = dict(backend="offload", device="cuda", cache=None, checkpoint_dir=CHECKPOINT_DIR)
    eng = engine_for(circ, L, R, 0, **kw)
    require(len(eng.cc.programs) >= 2, "the checkpoint phase needs a plan of two stages")
    plan = faults.FaultPlan(seed=1).add("shard_transfer_error", site="offload.shard",
                                        after=S + S // 2, count=1)
    killed = None
    t0 = time.time()
    with faults.inject(plan):
        try:
            eng.run()
        except faults.ShardTransferError as e:
            killed = e
    kill_s = time.time() - t0
    require(killed is not None and killed.injected and f"offload.shard{S // 2}" in str(killed),
            "the checkpointed run must end with the injected shard_transfer_error in stage 1")
    saves = [t for t in eng.backend.trace if t["kind"] == "checkpoint"]
    require(eng.backend.stats["checkpointed_stages"] >= 1
            and os.path.exists(os.path.join(CHECKPOINT_DIR, "journal.json")),
            "the killed run must leave a checkpoint")
    fresh = engine_for(circ, L, R, 0, **kw)
    ops.reset_kernel_counters()
    t0 = time.time()
    got = fresh.run()
    resume_s = time.time() - t0
    start = fresh.backend.stats["resumed_stages"]
    require(start >= 1, "the fresh engine must resume from the journal")
    want_launches = {k: S * sum(op.kind == k for prog in fresh.cc.programs[start:]
                                for op in prog.ops) for k in ("fused", "shm")}
    launches = ops.kernel_call_counts()
    require(launches == want_launches,
            f"resumed run: kernel launches {launches} != the resumed stages' ops {want_launches}")
    diff = max_err(got.to("cuda"), want.to("cuda"))
    require(torch.equal(got, want), f"the resumed state differs from the uninterrupted run's "
                                    f"(max |difference| {diff})")
    require(not os.listdir(CHECKPOINT_DIR), "a finished run must delete its checkpoint")
    saves += [t for t in fresh.backend.trace if t["kind"] == "checkpoint"]
    loads = [t["seconds"] for t in fresh.backend.trace if t["kind"] == "resume"]
    log(f"  ising({n}) L={L} R={R}, {len(eng.cc.programs)} stages: uninterrupted offload run "
        f"{plain_s:.3f} s; checkpointed run killed in stage 1 at shard {S // 2} after "
        f"{kill_s:.3f} s; a fresh engine resumed at stage {start} in {resume_s:.3f} s (the "
        f"checkpoint read in {sum(loads):.3f} s); state equal to the uninterrupted run's bit "
        f"for bit; launches {launches}; each _save_state: "
        + ", ".join(f"stage {t['stage']} {gib(t['bytes'])} in {t['seconds']:.3f} s = "
                    f"{t['bytes'] / t['seconds'] / 1e9:.2f} GB/s" for t in saves) + f" ({card})")
    del want, got, plain, eng, fresh
    release_pinned()
    return {"launches": dict(launches, by_k=ops.fused_call_counts_by_k()), "plain_s": plain_s,
            "kill_s": kill_s, "resume_s": resume_s, "saves": [t["seconds"] for t in saves],
            "fidelity": fid, "worst": worst}


def grad_launches(eng, obs: str, per_op: int = 1) -> tuple:
    """The launches of one ``value_and_grad`` (or one fused ``grad_sweep``):
    the forward plan's ops times ``per_op`` (shards, offloaded), then one
    ``fused_apply`` per non-identity Pauli op, two per gate (``U†`` on ψ
    and on λ) and one per symbolic slot. Returns ``(by kind, fused by k)``."""
    from repro_torch.sim.measure import PauliSum

    want, by_k = {"fused": 0, "shm": 0}, {}

    def add(k, count):
        want["fused"] += count
        by_k[k] = by_k.get(k, 0) + count

    for prog in eng.cc.programs:
        for op in prog.ops:
            if op.kind == "fused":
                add(len(op.local_bits), per_op)
            elif op.kind == "shm":
                want["shm"] += per_op
    for t in PauliSum.coerce(obs).terms:
        for _ in t.ops:
            add(1, 1)
    for g in eng.circuit.gates:
        add(len(g.qubits), 2 + len(g.param_slots))
    return want, by_k


def check_grad_launches(ops, eng, obs: str, what: str, calls: int = 1, per_op: int = 1) -> dict:
    """The launches since the last reset are ``calls`` times those of one
    value_and_grad (:func:`grad_launches`), by kind and by width."""
    want, by_k = grad_launches(eng, obs, per_op)
    want = {k: calls * v for k, v in want.items()}
    by_k = {k: calls * v for k, v in by_k.items()}
    got, got_k = ops.kernel_call_counts(), ops.fused_call_counts_by_k()
    log(f"  {what}: kernel launches {got}, fused by k {got_k}; {calls} x (forward plan "
        f"{eng.op_counts()}" + (f" x {per_op} shards" if per_op > 1 else "")
        + f" + the reverse sweep of {len(eng.circuit.gates)} gates)")
    require(got == want and got_k == by_k,
            f"{what}: launches {got} by k {got_k} != forward + sweep {want} by k {by_k}")
    return dict(got, by_k=got_k)


def hold_sweep_sample(ops, ref, probe, eng, obs: str, x: torch.Tensor, fused: dict,
                      launches_by_k: dict, what: str) -> float:
    """A sample of the reverse sweep's ``fused_apply`` launches as the
    sweep makes them (one shard of 2^n, the bound circuit's tables): for
    the first gate with a parameter at k=1 and at k=2, its ``U†`` and its
    derivative, a gate without one, and a Pauli X; each against its plain
    version on ``x``. Then at k=1 and k=2 (where no row has them) the
    kernel timed beside its plain version and one torch.matmul, as rows of
    ``fused["by_k"]``. Returns the worst error."""
    from repro_torch.core import gates as G

    n = eng.n
    prog = eng.adjoint_program(obs)
    inv, d = prog.tensors(eng.bound_circuit)
    vidx = torch.zeros(1, dtype=torch.int32, device=x.device)
    sample, seen, slot = [], set(), 0
    for k, g in enumerate(eng.circuit.gates):
        key = (len(g.qubits), bool(g.param_slots))
        if key not in seen:
            seen.add(key)
            sample.append((f"U† of {g.name}{g.qubits}", inv[k], g.qubits))
            if g.param_slots:
                sample.append((f"dU of {g.name}{g.qubits}", d[slot], g.qubits))
        slot += len(g.param_slots)
    sample.append(("Pauli X0", G.X, (0,)))
    worst, by_width = 0.0, {}
    for label, mat, bits in sample:
        u = torch.from_numpy(np.ascontiguousarray(mat, dtype=np.complex64)).to(x.device)
        u = u.reshape(1, *mat.shape)
        err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, n),
                      ref.fused_apply_ref(x.clone(), u, vidx, bits, n))
        sync(x.device.type)
        require(err < ATOL, f"{what}: fused_apply on {label} disagrees with its plain version")
        log(f"  {what}: {label} k={len(bits)}: max |kernel - plain| = {err:.3e}")
        worst = max(worst, err)
        by_width.setdefault(len(bits), (u, bits, err))
    have = {row["k"] for row in fused["by_k"]}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for k in (1, 2):
            if k in have or k not in by_width:
                continue
            u, bits, err = by_width[k]
            ms = probe.time_ms(lambda: ops.fused_apply(x, u, vidx, bits, n))
            plain_ms = probe.time_ms(lambda: ref.fused_apply_ref(x, u, vidx, bits, n), reps=3)
            xt, ut = x.view(-1, 1 << k), u[0].transpose(0, 1).contiguous()
            matmul_ms = probe.time_ms(lambda: torch.matmul(xt, ut))
            cmacs = (1 << k) * (1 << n)
            row = entry("fused_apply", launches_by_k.get(k, 0), err, ms, plain_ms,
                        2 * (8 << n) + u.numel() * 8 + 4, TF32_PASSES * KARATSUBA_OPS * cmacs,
                        TF32_OPS_PER_S, 8 * cmacs, matmul_ms,
                        f"{what}: k={k} bits={list(bits)} V=1 n={n} (padded to I x U on 4 bits)")
            fused["by_k"].append(by_k_row(dict(row, k=k, path=what)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return worst


def vqe_phase(simulate, ops, ref, probe, card: str, fused: dict) -> dict:
    """The ``--vqe`` loop at full width through the CLI: 1 + 3
    value_and_grad calls, each launch counted; then at the first step's
    angles the value_and_grad split (forward, λ, sweep) and a trace, the
    gradient against the same sweep through the plain version on the same
    forward state, against central finite differences of the on-card
    energy (measured by the port's measurer, another algorithm) and
    against the complex128 oracle on the observable's light cone; a sample
    of the sweep's launches against the plain version."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.adjoint import AdjointProgram, adjoint_gradients_np
    from repro_torch.sim.measure import apply_pauli_sum, measurer_for

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    t0 = time.time()
    run = simulate.main(VQE_PATH)
    sync("cuda")
    cli_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    eng = run.engine
    calls = len(run.grad_seconds)
    require(calls == 4 and len(run.energies) == 4 and all(np.isfinite(run.energies))
            and bool(np.all(np.isfinite(run.theta))), "VQE: four finite energies and angles")
    launches = check_grad_launches(ops, eng, VQE_OBS, "VQE loop", calls=calls)
    log(f"  VQE energies {run.energies}; value_and_grad seconds {run.grad_seconds} (the first "
        f"builds the adjoint program); {run.seconds:.3f} s for 3 steps = {run.seconds / 3:.3f} "
        f"s/step; peak device memory {gib(peak)} against a {gib(8 << eng.n)} state; engine "
        f"built in {run.build_seconds:.3f} s; the CLI call {cli_s:.1f} s ({card})")

    theta0 = np.random.default_rng(VQE_SEED).uniform(0.0, 2 * np.pi, 2).astype(np.float32)
    sync("cuda")
    t0 = time.time()
    value, grads = eng.value_and_grad(VQE_OBS, params=theta0)
    total_s = time.time() - t0
    require(abs(value - run.energies[0]) <= 1e-6,
            f"VQE: value_and_grad at the first angles {value} != the CLI's {run.energies[0]}")
    t0 = time.time()
    psi = eng.run()
    sync("cuda")
    forward_s = time.time() - t0
    t0 = time.time()
    lam = apply_pauli_sum(psi.view(1, -1), VQE_OBS)
    sync("cuda")
    lam_s = time.time() - t0
    del lam
    log(f"  value_and_grad at the first angles: {total_s:.3f} s = forward {forward_s:.3f} s + "
        f"λ = H|ψ⟩ {lam_s:.3f} s + reverse sweep {total_s - forward_s - lam_s:.3f} s ({card})")
    plain = AdjointProgram(eng.circuit, VQE_OBS, device="cuda", use_kernels=False)
    t0 = time.time()
    pv, pg = plain.sweep_(psi.view(1, -1), *plain.tensors(eng.bound_circuit))
    plain_s = time.time() - t0
    del psi
    torch.cuda.empty_cache()
    pv, pg = float(pv[0]), pg[0]
    log(f"  against the plain version's sweep on the same state ({plain_s:.3f} s): value "
        f"{value:+.9f} vs {pv:+.9f}, gradient {grads} vs {pg}")
    require(abs(value - pv) <= VALUE_ATOL and np.abs(grads - pg).max() <= GRAD_ATOL,
            "VQE: the kernel sweep and the plain sweep disagree")
    t0 = time.time()
    ov, og = adjoint_gradients_np(PARAM_FAMILIES["isingparam"](LIGHT_CONE_N), theta0, VQE_OBS)
    log(f"  against the complex128 oracle at n={LIGHT_CONE_N} ({time.time() - t0:.1f} s): value "
        f"{ov:+.9f}, gradient {og}; differences {abs(value - ov):.3e}, "
        f"{np.abs(grads - og).max():.3e}")
    require(abs(value - ov) <= VALUE_ATOL and np.abs(grads - og).max() <= GRAD_ATOL,
            "VQE: the gradient disagrees with the complex128 oracle on the light cone")

    def energy(th):
        packed = eng.run_packed(params=th)
        return measurer_for(packed, eng.measurement_frame, eng).expectation(VQE_OBS)

    th = theta0.astype(np.float64)
    fd = np.array([(energy(th + FD_EPS * e) - energy(th - FD_EPS * e)) / (2 * FD_EPS)
                   for e in np.eye(len(th))])
    rel = float(np.abs(grads - fd).max() / np.abs(fd).max())
    log(f"  against central differences of the on-card energy (eps {FD_EPS}): {fd}; "
        f"max difference {rel:.3e} of the gradient's size (limit {FD_RTOL})")
    require(rel <= FD_RTOL, "VQE: the gradient disagrees with finite differences")
    eng.bind(theta0)

    trace_run(lambda: eng.value_and_grad(VQE_OBS), total_s, "value_and_grad")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(1 << eng.n, dtype=torch.complex64, device="cuda", generator=gen)
    worst = hold_sweep_sample(ops, ref, probe, eng, VQE_OBS, x, fused, launches["by_k"],
                              "isingparam(30) reverse sweep")
    del x
    torch.cuda.empty_cache()
    return {"launches": launches, "worst": {"fused": worst, "shm": 0.0}, "peak": peak,
            "grad_seconds": run.grad_seconds, "split": [forward_s, lam_s, total_s]}


def oracle_phase(ops, card: str, n: int, L: int, R: int, reps: int) -> dict:
    """``value_and_grad`` of ``su2param(n, reps)`` on the card against the
    complex128 adjoint oracle on the host, with its launches."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.adjoint import adjoint_gradients_np
    from repro_torch.sim.engine import engine_for

    sym = PARAM_FAMILIES["su2param"](n, reps=reps)
    t0 = time.time()
    eng = engine_for(sym, L, R, 0, device="cuda")
    build_s = time.time() - t0
    theta = np.random.default_rng(31).uniform(0.0, 2 * np.pi, len(sym.param_names))
    ops.reset_kernel_counters()
    t0 = time.time()
    value, grads = eng.value_and_grad(ORACLE_OBS, params=theta)
    card_s = time.time() - t0
    launches = check_grad_launches(ops, eng, ORACLE_OBS, f"su2param({n})")
    t0 = time.time()
    ov, og = adjoint_gradients_np(sym, theta, ORACLE_OBS)
    oracle_s = time.time() - t0
    dv, dg = abs(value - ov), float(np.abs(grads - og).max())
    log(f"  su2param({n}, reps={reps}) L={L} R={R}: {len(sym.gates)} gates, {len(theta)} "
        f"parameters; value_and_grad {card_s:.3f} s on the card (engine built in {build_s:.2f} "
        f"s), the complex128 oracle {oracle_s:.1f} s on the host; value {value:+.9f} vs "
        f"{ov:+.9f} ({dv:.3e}), gradient max difference {dg:.3e} ({card})")
    require(dv <= VALUE_ATOL and dg <= GRAD_ATOL,
            f"su2param({n}): value_and_grad disagrees with the complex128 oracle")
    return {"launches": launches, "seconds": card_s, "value_err": dv, "grad_err": dg}


def grad_sweep_phase(ops, card: str, n: int, L: int, R: int, P: int) -> dict:
    """``grad_sweep`` of P bindings of ``isingparam(n)`` on the in-card
    backend: one ``[P, 2^n]`` forward sweep and one reverse sweep, each
    application one launch for all P (a single point's count), each row
    against ``value_and_grad`` of that point alone."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.engine import engine_for

    eng = engine_for(PARAM_FAMILIES["isingparam"](n), L, R, 0, device="cuda")
    require(eng.backend.supports_fused_grad(), "the in-card backend must fuse grad_sweep")
    batch = np.random.default_rng(37).uniform(0.0, 2 * np.pi, (P, 2))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    t0 = time.time()
    vals, grads = eng.grad_sweep(batch, VQE_OBS)
    sweep_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = check_grad_launches(ops, eng, VQE_OBS, f"grad_sweep of {P}")
    worst, point_s = 0.0, 0.0
    for p in range(P):
        t0 = time.time()
        v, g = eng.value_and_grad(VQE_OBS, params=batch[p])
        point_s += time.time() - t0
        err = max(abs(vals[p] - v), float(np.abs(grads[p] - g).max()))
        require(err <= ROW_ATOL, f"grad_sweep row {p} differs from its point alone by {err}")
        worst = max(worst, err)
    log(f"  isingparam({n}) L={L} R={R}, P={P}: grad_sweep {sweep_s:.3f} s = {sweep_s / P:.3f} "
        f"s/point, value_and_grad point by point {point_s / P:.3f} s/point; rows against the "
        f"points alone: max difference {worst:.3e}; peak device memory {gib(peak)} ({card})")
    return {"launches": launches, "sweep_s": sweep_s, "point_s": point_s, "peak": peak,
            "err": worst}


def offload_grad_phase(ops, card: str, n: int, L: int, R: int) -> dict:
    """``value_and_grad`` through the offload backend (the forward state
    streamed through the card shard by shard, then uploaded for the sweep)
    against the in-card engine's."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.engine import engine_for

    sym = PARAM_FAMILIES["isingparam"](n)
    theta = np.random.default_rng(41).uniform(0.0, 2 * np.pi, 2)
    off = engine_for(sym, L, R, 0, backend="offload", device="cuda")
    require(not off.backend.supports_fused_grad(), "offload sweeps gradients point by point")
    ops.reset_kernel_counters()
    t0 = time.time()
    value, grads = off.value_and_grad(VQE_OBS, params=theta)
    off_s = time.time() - t0
    launches = check_grad_launches(ops, off, VQE_OBS, f"offload isingparam({n})",
                                   per_op=off.backend.S)
    in_card = engine_for(sym, L, R, 0, device="cuda")
    t0 = time.time()
    cv, cg = in_card.value_and_grad(VQE_OBS, params=theta)
    card_s = time.time() - t0
    err = max(abs(value - cv), float(np.abs(grads - cg).max()))
    log(f"  isingparam({n}) L={L} R={R}: offload value_and_grad {off_s:.3f} s, in-card "
        f"{card_s:.3f} s; max difference {err:.3e} ({card})")
    require(err <= GRAD_ATOL, f"offload value_and_grad differs from the in-card one by {err}")
    del off, in_card
    release_pinned()
    return {"launches": launches, "offload_s": off_s, "in_card_s": card_s, "err": err}


def plan_line(eng) -> str:
    """Stages, ``fused`` ops by width and ``shm`` ops of an engine's plan."""
    by_k = {}
    for prog in eng.cc.programs:
        for op in prog.ops:
            if op.kind == "fused":
                by_k[len(op.local_bits)] = by_k.get(len(op.local_bits), 0) + 1
    counts = eng.op_counts()
    return (f"{eng.plan.n_stages} stages, fused by k {dict(sorted(by_k.items()))}, "
            f"{counts.get('shm', 0)} shm, {counts.get('diag', 0)} diag")


def calibration_phase(ops, card: str) -> dict:
    """The profiler on the card: ``python -m repro_torch.sim.profiler --L
    28 --repeats 3 --verify`` through ``main(argv)``, into the smoke's own
    calibration directory. Every measured field positive and finite,
    printed beside the analytic constant it replaces; both hand kernels
    launched by the profile; ``--verify`` passed."""
    from repro_torch.core.cost_model import DEFAULT_COST_MODEL
    from repro_torch.sim import profiler

    ops.reset_kernel_counters()
    t0 = time.time()
    rc = profiler.main(["--L", str(CALIBRATION_L), "--repeats", str(CALIBRATION_REPEATS),
                        "--verify"])
    profile_s = time.time() - t0
    require(rc == 0, "profiler --verify: the engine under the calibrated model disagrees with "
                     "the dense oracle")
    launches = dict(ops.kernel_call_counts(), by_k=ops.fused_call_counts_by_k())
    require(launches["fused"] > 0 and launches["shm"] > 0,
            f"the profile must launch both hand kernels: {launches}")
    calib = profiler.load_calibration(profiler.default_calibration_path())
    meas, raw = calib["measurements"], calib["meta"]["raw"]
    require(calib["fingerprint"]["platform"] == "cuda" and calib["meta"]["L"] == CALIBRATION_L,
            f"calibration fingerprint {calib['fingerprint']}, L {calib['meta']['L']}")
    for field in sorted(meas):
        v = meas[field]
        require(math.isfinite(v) and v > 0, f"calibrated {field} = {v}")
        log(f"  {field:<18} {v:12.4f}  (analytic {getattr(DEFAULT_COST_MODEL, field):g}) ({card})")
    log("  raw: fused_apply us by k " + json.dumps({k: round(v, 1) for k, v in
                                                   raw["fusion"]["per_k_us"].items()})
        + f"; shm dense 1/5 members {raw['shm']['dense_us']}, diag {raw['shm']['diag_us']}; "
        f"pass {raw['pass']['elementwise_us']:.1f} us; link round trip "
        f"{raw['host_link']['roundtrip_us']:.0f} us; disk round trip "
        f"{raw['disk']['roundtrip_us'] / 1e6:.2f} s in {raw['disk']['dir']}")
    log(f"  profile + verify {profile_s:.1f} s (profile alone {calib['meta']['profile_time_s']:.1f}"
        f" s); launches {launches}")
    return {"launches": launches, "measurements": meas, "seconds": profile_s}


def calibrated_phase(ops, ref, probe, card: str, name: str, fused: dict) -> dict:
    """``name(30)`` L=28 R=2 planned under the resolved calibration
    (``engine_for`` with no cost model) and under the analytic constants:
    each plan's stages, ``fused`` widths and ``shm`` ops and its warm run
    seconds, both states against the dense per-gate oracle on the card,
    launches equal to the plan; the calibrated engine's kernel ops against
    their plain versions."""
    import scipy

    from repro_torch.core.cost_model import DEFAULT_COST_MODEL
    from repro_torch.core.generators import FAMILIES
    from repro_torch.sim import profiler
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    n, L, R = CALIBRATED["n"], CALIBRATED["L"], CALIBRATED["R"]
    circ = FAMILIES[name](n)
    t0 = time.time()
    oracle = dense_simulate(circ, device="cuda")
    oracle_s = time.time() - t0
    out, launches = {}, {}
    for label, cm in (("calibrated", None), ("analytic", DEFAULT_COST_MODEL)):
        t0 = time.time()
        eng = engine_for(circ, L, R, 0, cost_model=cm, cache=None, device="cuda")
        build_s = time.time() - t0
        if cm is None:
            src = eng.provenance["calibration"]
            require(src["source"] == "calibrated", f"{name}({n}) planned on {src}")
        eng.run()  # warm: index tensors, step tables
        ops.reset_kernel_counters()
        torch.cuda.synchronize()
        t0 = time.time()
        state = eng.run()
        torch.cuda.synchronize()
        run_s = time.time() - t0
        launches[label] = launches_match(ops, eng, f"{label} {name}({n})", kinds=())
        require(launches[label]["fused"] + launches[label]["shm"] > 0,
                f"{label} {name}({n}) launched no kernel")
        fid = fidelity(state, oracle)
        del state
        require(fid >= FIDELITY_MIN, f"{label} {name}({n}) fidelity {fid} < {FIDELITY_MIN}")
        log(f"  {label:<10} {name}({n}) L={L} R={R}: {plan_line(eng)}; planned and built in "
            f"{build_s:.2f} s; run {run_s:.4f} s; fidelity {fid:.9f} (host scipy "
            f"{scipy.__version__}; {card})")
        out[label] = {"run_s": run_s, "build_s": build_s, "fidelity": fid,
                      "plan": plan_line(eng), "engine": eng}
    log(f"  dense oracle {oracle_s:.1f} s; calibrated run / analytic run = "
        f"{out['calibrated']['run_s'] / out['analytic']['run_s']:.3f}")
    del oracle
    torch.cuda.empty_cache()
    eng = out["calibrated"]["engine"]
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(1 << n, dtype=torch.complex64, device="cuda", generator=gen)
    worst = hold_ops(ops, ref, eng, eng.backend.pass_of(), x, f"calibrated {name}({n})")
    rows = fused_by_k(ops, ref, probe, eng, x, f"calibrated {name}({n})",
                      launches["calibrated"]["by_k"], skip=[r["k"] for r in fused["by_k"]])
    fused["by_k"] += [by_k_row(row) for row in rows]
    del x, eng
    for v in out.values():
        v.pop("engine")
    torch.cuda.empty_cache()
    return {"launches": launches["calibrated"], "analytic_launches": launches["analytic"],
            "worst": worst, "runs": out}


def autotune_phase(simulate, ops, ref, card: str) -> dict:
    """``--autotune`` on ``ising(30)`` L=28 R=2 through the CLI: every
    candidate's replay, the choice and its speedup, the tuning's peak device
    memory; then ``engine_for`` with default knobs is a cache hit that runs
    no solver, and the tuned run holds against the dense oracle."""
    from repro_torch.core import kernelization, staging
    from repro_torch.core.generators import FAMILIES
    from repro_torch.sim.engine import DEFAULT_CACHE, engine_for
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_kernel_counters()
    t0 = time.time()
    run = simulate.main(AUTOTUNE_PATH)
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = dict(ops.kernel_call_counts(), by_k=ops.fused_call_counts_by_k())
    tuned = run.engine.provenance["autotune"]
    for cand, us in sorted(tuned["replay_us"].items(), key=lambda kv: kv[1]):
        log(f"  candidate {cand:<18} replay {us:12.1f} us")
    log(f"  chose '{tuned['chosen']}' ({tuned['speedup_vs_default']:.3f}x vs default, "
        f"{len(tuned['replay_us'])} candidates, tuning {tuned['tune_time_s']:.1f} s, the CLI "
        f"{cli_s:.1f} s); peak device memory of the tuning {gib(peak)}; launches {launches}; "
        f"tuned plan {plan_line(run.engine)} ({card})")
    require(peak <= 2.25 * (8 << AUTOTUNE["n"]),
            f"the tuning's peak {gib(peak)} is more than one run's two states")
    solves = (dict(staging.SOLVER_CALLS), dict(kernelization.SOLVER_CALLS))
    hits = DEFAULT_CACHE.hits
    again = engine_for(FAMILIES["ising"](AUTOTUNE["n"]), AUTOTUNE["L"], AUTOTUNE["R"], 0,
                       device="cuda")
    require(again is run.engine and DEFAULT_CACHE.hits == hits + 1,
            "engine_for with default knobs must hit the tuned engine")
    require((dict(staging.SOLVER_CALLS), dict(kernelization.SOLVER_CALLS)) == solves,
            "the tuned cache hit must run no ILP or DP solver")
    fid = fidelity(run.state, dense_simulate(again.circuit, device="cuda"))
    require(fid >= FIDELITY_MIN, f"tuned ising fidelity {fid} < {FIDELITY_MIN}")
    log(f"  engine_for(default knobs): cache hit on the tuned engine, no solver call; "
        f"fidelity {fid:.9f}")
    run.state = None
    worst = {"fused": 0.0, "shm": 0.0}
    if tuned["chosen"] != "default":  # the default is the calibrated plan, held above
        gen = torch.Generator(device="cuda").manual_seed(23)
        x = torch.randn(1 << again.n, dtype=torch.complex64, device="cuda", generator=gen)
        worst = hold_ops(ops, ref, again, again.backend.pass_of(), x, "tuned ising(30)")
        del x
    torch.cuda.empty_cache()
    return {"launches": launches, "chosen": tuned["chosen"], "peak_bytes": peak,
            "speedup": tuned["speedup_vs_default"], "replay_us": tuned["replay_us"],
            "fidelity": fid, "worst": worst}


def _built_engines():
    """Record the (backend, use_kernels) of every engine construction while
    the context is open."""
    from repro_torch.sim import engine as teng

    class Recorder:
        def __enter__(self):
            self.seen, self.real = [], teng.ExecutionEngine.__init__
            real, seen = self.real, self.seen

            def init(eng, circuit, plan, use_kernels=True, device=None, **kw):
                be = kw.get("backend", "cuda")
                seen.append((be if isinstance(be, str) else be.name, use_kernels))
                real(eng, circuit, plan, use_kernels, device, **kw)

            teng.ExecutionEngine.__init__ = init
            return self

        def __exit__(self, *exc):
            teng.ExecutionEngine.__init__ = self.real

    return Recorder()


def launches_since(ops, before: dict) -> dict:
    """The kernel launches, by kernel, since the counts ``before``."""
    return {k: v - before[k] for k, v in ops.kernel_call_counts().items()}


def faults_phase(ops, card: str) -> dict:
    """The integrity guard and the build faults at n=28: clean guarded
    ``run`` and ``run_packed`` (no retry; the guard's seconds); a NaN
    injected into each, recovered by one re-run of the plan through the
    hand kernels (twice a clean run's launches) to the clean state; a
    guarded sweep of 4 ``isingparam(28)`` bindings with one poisoned row,
    only that row re-run; ``xla_trace_error`` at
    ``cuda.setup`` and ``pallas_lowering_error`` at ``engine.init`` raise
    their typed errors out of ``engine_for`` with no other engine built."""
    import random

    from repro_torch.core.generators import FAMILIES, PARAM_FAMILIES
    from repro_torch.sim import faults
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.faults import PallasLoweringError, XlaTraceError
    from repro_torch.sim.statevector import fidelity

    n, L, R = FAULTS["n"], FAULTS["L"], FAULTS["R"]
    ops.reset_kernel_counters()
    eng = engine_for(FAMILIES["ising"](n), L, R, 0, cache=None, device="cuda")
    report = {}
    for entry in ("run", "run_packed"):
        fn = getattr(eng, entry)
        fn(verify=True)  # warm: the run's and the guard's buffers
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        before = ops.kernel_call_counts()
        t0 = time.time()
        clean = fn(verify=True)
        torch.cuda.synchronize()
        guarded_s = time.time() - t0
        per_run = launches_since(ops, before)
        require("integrity_retries" not in eng.provenance,
                f"a clean guarded {entry} recorded a retry")
        t0 = time.time()
        eng._norm_of(clean)
        torch.cuda.synchronize()
        norm_s = time.time() - t0
        before = ops.kernel_call_counts()
        t0 = time.time()
        with faults.inject(faults.FaultPlan(seed=3).add("nan_amplitudes", count=1)) as plan:
            out = fn(verify=True)
        torch.cuda.synchronize()
        retry_s = time.time() - t0
        require(plan.fires == {"nan_amplitudes": 1}, f"{entry}: the fault fired {plan.fires}")
        retried = launches_since(ops, before)
        require(sum(per_run.values()) > 0
                and retried == {k: 2 * v for k, v in per_run.items()},
                f"{entry}: the retry must re-run the plan through the kernels "
                f"(a clean run {per_run}, with the retry {retried})")
        prov = eng.provenance
        require(prov.pop("integrity_retries") == prov.pop("integrity_recovered") == 1,
                f"{entry}: one retry, recovered")
        fid = fidelity(out, clean)
        require(fid >= FIDELITY_MIN, f"recovered {entry} fidelity {fid} < {FIDELITY_MIN}")
        same = torch.equal(out, clean)
        log(f"  {entry}(verify=True) ising({n}) L={L} R={R}: clean {guarded_s:.4f} s against "
            f"{plain_s:.4f} s unguarded (the norm pass {norm_s * 1e3:.2f} ms), no retry; NaN "
            f"injected: one re-run through the kernels ({retried} launches), {retry_s:.3f} s, "
            f"fidelity to the clean run {fid:.9f}, bit for bit {same} ({card})")
        report[entry] = {"guarded_s": guarded_s, "plain_s": plain_s, "norm_s": norm_s,
                         "retry_s": retry_s,
                         "fidelity": fid, "bit_for_bit": same}
        del clean, out
    del eng
    torch.cuda.empty_cache()

    P = FAULTS["P"]
    sym = PARAM_FAMILIES["isingparam"](n)
    swp = engine_for(sym, L, R, 0, cache=None, device="cuda")
    rng = np.random.default_rng(29)
    points = [{"J": float(j), "h": float(h)} for j, h in rng.uniform(-1.5, 1.5, size=(P, 2))]
    before = ops.kernel_call_counts()
    clean = swp.run_sweep(None, points)
    per_sweep = launches_since(ops, before)
    seed = 5
    row = random.Random(seed).randrange(P)  # the plan's first draw: the row it poisons
    before = ops.kernel_call_counts()
    t0 = time.time()
    with faults.inject(faults.FaultPlan(seed=seed).add("nan_amplitudes", count=1,
                                                       site="engine.run_sweep")):
        out = swp.run_sweep(None, points, verify=True)
    torch.cuda.synchronize()
    sweep_s = time.time() - t0
    retried = launches_since(ops, before)
    require(swp.bound_circuit is None, "the row's retry must leave the engine unbound")
    swp.bind(points[row])
    before = ops.kernel_call_counts()
    swp.run()
    per_run = launches_since(ops, before)
    require(sum(per_run.values()) > 0
            and retried == {k: per_sweep[k] + per_run[k] for k in per_sweep},
            f"the poisoned row must be re-run through the kernels (a clean sweep {per_sweep}, "
            f"one run {per_run}, the sweep with its retry {retried})")
    require(swp.provenance["integrity_retries"] == swp.provenance["integrity_recovered"] == 1,
            "the sweep must retry one row")
    fids = [fidelity(out[p], clean[p]) for p in range(P)]
    require(min(fids) >= FIDELITY_MIN, f"sweep rows against the clean sweep: {fids}")
    require(all(torch.equal(out[p], clean[p]) for p in range(P) if p != row),
            "the clean rows must come through untouched")
    log(f"  run_sweep(verify=True) of {P} isingparam({n}) bindings, row {row} poisoned: that row "
        f"alone re-run through the kernels ({retried} launches with the sweep's); "
        f"{sweep_s:.3f} s; the row bit for bit {torch.equal(out[row], clean[row])}; row "
        f"fidelities to the clean sweep "
        f"{[round(f, 9) for f in fids]}")
    report["sweep"] = {"seconds": sweep_s, "row": row, "fidelity": fids}
    del clean, out, swp
    torch.cuda.empty_cache()

    small = FAMILIES["ising"](n)
    for point, site, error in (("xla_trace_error", "cuda.setup", XlaTraceError),
                               ("pallas_lowering_error", "engine.init", PallasLoweringError)):
        with _built_engines() as rec, faults.inject(
                faults.FaultPlan(seed=2).add(point, site=site)) as plan:
            try:
                engine_for(small, L, R, 0, cache=None, device="cuda")
            except error as e:
                raised = e
            else:
                raised = None
        require(raised is not None and raised.injected, f"{point} at {site} must raise "
                                                         f"{error.__name__}")
        require(rec.seen == [("cuda", True)] and plan.fires == {point: 1},
                f"{point}: engines built {rec.seen}, fires {plan.fires}")
        log(f"  {point} at {site}: {type(raised).__name__} out of engine_for; engines "
            f"attempted {rec.seen} (no other backend, no plain versions)")
    launches = dict(ops.kernel_call_counts(), by_k=ops.fused_call_counts_by_k())
    log(f"  launches of the faults phase {launches}")
    report["launches"] = launches
    return report


def spy_engine(ops, eng, stride: int) -> list:
    """Record every ``run``, ``run_packed`` and ``run_sweep`` of ``eng`` (as
    instance attributes over the class's methods; :func:`unspy` removes
    them): the entry, its points, the kernel launches of the call, its stage
    loop's seconds (the engine's own timing, to the device's last op) and
    every ``stride``-th amplitude of each output row, on the host."""
    calls = []
    for entry in ("run", "run_packed", "run_sweep"):
        def spy(*a, _real=getattr(type(eng), entry), _entry=entry, **kw):
            before = ops.kernel_call_counts()
            out = _real(eng, *a, **kw)
            launched = launches_since(ops, before)
            rows = out.reshape(-1, 1 << eng.n)
            calls.append({"entry": _entry, "points": a[1] if _entry == "run_sweep" else None,
                          "rows": rows.shape[0], "launches": launched,
                          "loop_s": eng.timings[_entry]["last_us"] / 1e6,
                          "sample": rows[:, ::stride].cpu()})
            return out
        setattr(eng, entry, spy)
    return calls


def unspy(eng) -> None:
    for entry in ("run", "run_packed", "run_sweep"):
        eng.__dict__.pop(entry, None)


def serve_phase(ops, ref, card: str, device: str = "cuda") -> dict:
    """The port's simulation service on the card (``repro_torch.serve``, the
    entry points ``python -m repro_torch.launch.serve_sim`` drives): one
    ``SimulationService`` with its defaults (CUDA, the hand kernels), two
    weighted tenants, planned on the card's calibration.

    One warm-up request per structure (cold builds), then one burst of 44
    requests: every response a cache hit with no solver call and no shm
    program scheduled, each batch one launch per compiled op whatever its
    rows, the qft dedup group one run; every response held against the same
    binding run alone on the same engine (expectations, marginals and counts;
    every STRIDE-th amplitude of each served row) and the first point of
    each structure against the dense per-gate oracle; every kernel op of a
    served ``isingparam`` batch against its plain version. Then the faults (a
    malformed rider alone, a NaN recovered by one re-run through the
    kernels, a kernel build failure quarantined), the JSON-lines front end
    on the loopback, and each structure's warm run planned on the
    calibration against the analytic constants."""
    import asyncio

    from repro_torch.core import kernelization, staging
    from repro_torch.core.cost_model import DEFAULT_COST_MODEL
    from repro_torch.core.generators import FAMILIES, PARAM_FAMILIES
    from repro_torch.launch.serve_sim import handle_client
    from repro_torch.serve import ServeConfig, SimRequest, SimulationService
    from repro_torch.serve.service import WarmPool
    from repro_torch.sim import faults
    from repro_torch.sim.engine import circuit_key_for, engine_for
    from repro_torch.sim.faults import CircuitQuarantined, PallasLoweringError
    from repro_torch.sim.measure import measure_to_result, measurer_for
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    n, L, R, stride = SERVE["n"], SERVE["L"], SERVE["R"], SERVE["stride"]
    mn, mL = SERVE["main_n"], SERVE["main_L"]
    syms = {"isingparam": PARAM_FAMILIES["isingparam"](n),
            "su2param": PARAM_FAMILIES["su2param"](n, reps=SERVE["su2param_reps"])}
    concrete = {"qft": (FAMILIES["qft"](n), L), "ising": (FAMILIES["ising"](mn), mL)}
    rng = np.random.default_rng(SERVE["seed"])

    def point(name):
        lo, hi = (-1.5, 1.5) if name == "isingparam" else (0.1, 6.2)
        return rng.uniform(lo, hi, len(syms[name].param_names))

    def param_request(i, name, params=None, tenant=None):
        shots = SERVE["shots"] if i in SERVE["shot_requests"] else 0
        return SimRequest(circuit=syms[name], params=point(name) if params is None else params,
                          tenant=tenant or ("gold", "free")[(i // 2) % 2], shots=shots,
                          marginals=((0, 1),) if shots else (), observables=(SERVE_OBS,),
                          seed=i, L=L, R=R)

    def concrete_request(name, tenant):
        circ, cl = concrete[name]
        return SimRequest(circuit=circ, tenant=tenant, L=cl, R=R,
                          observables=(SERVE_OBS,) if name == "ising" else ())

    svc = SimulationService(ServeConfig(**SERVE_CONFIG) if device == "cuda"
                            else ServeConfig(**SERVE_CONFIG, device=device))
    require(svc.pool.device.type == device and svc.cfg.use_kernels,
            "the service must default to the card and the hand kernels")
    structures = ["isingparam", "su2param", "qft", "ising"]

    def ckey(name):
        circ, cl = (syms[name], L) if name in syms else concrete[name]
        return circuit_key_for(circ, cl, R, 0, device=svc.pool.device)

    async def warm_and_burst():
        async with svc:
            cold = {}
            for i, name in enumerate(structures):
                req = (param_request(-1, name, tenant="gold") if name in syms
                       else concrete_request(name, "gold"))
                t0 = time.time()
                resp = await svc.submit(req)
                cold[name] = (time.time() - t0, resp.timings["bind_s"])
            engines = {name: svc.pool.cache.peek(key) for name, key in zip(
                structures, [ckey(s) for s in structures])}
            spies = {name: spy_engine(ops, eng, stride) for name, eng in engines.items()}
            reqs = [param_request(i, ("isingparam", "su2param")[i % 2])
                    for i in range(SERVE["requests"])]
            reqs += [concrete_request("qft", ("gold", "free")[i % 2]) for i in range(SERVE["qft"])]
            reqs.append(concrete_request("ising", "gold"))
            raw = {}
            real_observe = svc.metrics.observe

            def observe(name, value):
                raw.setdefault(name, []).append(value)
                real_observe(name, value)

            before = (staging.SOLVER_CALLS["ilp"], staging.SOLVER_CALLS["greedy"],
                      kernelization.SOLVER_CALLS["dp"], WarmPool.shm_schedules(),
                      svc.metrics.counter("cache_misses"), svc.metrics.counter("sweep_rows"),
                      svc.metrics.counter("sweep_rows_padding"))
            svc.metrics.observe = observe
            sync(device)
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            ops.reset_kernel_counters()
            t0 = time.time()
            resps = await asyncio.gather(*[svc.submit_nowait(r) for r in reqs],
                                         return_exceptions=True)
            sync(device)
            wall = time.time() - t0
            launches = dict(ops.kernel_call_counts(), by_k=ops.fused_call_counts_by_k())
            peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
            del svc.metrics.observe
            after = (staging.SOLVER_CALLS["ilp"], staging.SOLVER_CALLS["greedy"],
                     kernelization.SOLVER_CALLS["dp"], WarmPool.shm_schedules(),
                     svc.metrics.counter("cache_misses"), svc.metrics.counter("sweep_rows"),
                     svc.metrics.counter("sweep_rows_padding"))
            for eng in engines.values():
                unspy(eng)
            return cold, engines, spies, reqs, resps, raw, before, after, wall, launches, peak

    (cold, engines, spies, reqs, resps, raw, before, after, wall, launches,
     peak) = asyncio.run(warm_and_burst())
    stats = svc.stats()
    log(f"  calibration the service plans on: {json.dumps(stats['calibration'])}")
    require(device != "cuda" or stats["calibration"]["source"] == "calibrated",
            f"the serve phase must plan on the card's calibration: {stats['calibration']}")
    for name in structures:
        log(f"  cold {name}: first request {cold[name][0]:.3f} s (bind_s {cold[name][1]:.3f} s: "
            f"plan and build); plan {plan_line(engines[name])}")
    failed = [(i, r) for i, r in enumerate(resps) if isinstance(r, Exception)]
    require(not failed, f"served requests failed: {failed[:3]}")
    require(all(r.cache_hit for r in resps), "every warm request must be a cache hit")
    require(after[:3] == before[:3], f"warm serving ran a solver: {before[:3]} -> {after[:3]}")
    require(after[3] == before[3], f"warm serving scheduled shm programs: {before[3]} -> {after[3]}")
    require(after[4] == before[4], "warm serving missed the cache")
    require(launches["fused"] > 0 and launches["shm"] > 0,
            f"the served burst must launch both kernels: {launches}")
    batches = []
    for name, calls in spies.items():
        counts = engines[name].op_counts()
        want = {"fused": counts.get("fused", 0), "shm": counts.get("shm", 0)}
        for c in calls:
            require(c["launches"] == want, f"{name}: a batch of {c['rows']} rows launched "
                                           f"{c['launches']}, the plan has {want} ops")
            batches.append((name, c["entry"], c["rows"], c["launches"], c["loop_s"]))
    require(sum(b[3]["fused"] for b in batches) == launches["fused"]
            and sum(b[3]["shm"] for b in batches) == launches["shm"],
            "every launch of the burst must come from a served batch")
    qft_calls = spies["qft"]
    qft_resps = [r for req, r in zip(reqs, resps) if req.circuit is concrete["qft"][0]]
    require(len(qft_calls) == 1 and qft_calls[0]["entry"] == "run"
            and all(r.batch_size == SERVE["qft"] for r in qft_resps)
            and len({r.amp0 for r in qft_resps}) == 1,
            f"the {SERVE['qft']} identical qft requests must dedup into one run")
    rows = after[5] - before[5]
    padding = after[6] - before[6]
    sizes = raw["batch_size"]
    e2e = [r.timings["e2e_s"] for r in resps]
    log(f"  burst of {len(reqs)} requests in {wall:.3f} s = {len(reqs) / wall:.3f} requests/s; "
        f"e2e p50 {np.percentile(e2e, 50):.6f} s, p99 {np.percentile(e2e, 99):.6f} s; stage p50s: "
        + ", ".join(f"{k} {np.percentile([r.timings[k] for r in resps], 50):.6f} s"
                    for k in ("queue_wait_s", "batch_form_s", "bind_s", "execute_s"))
        + f", measure_s {np.percentile(raw['measure_s'], 50):.6f} s (per batch); "
        f"{len(sizes)} batches, coalesce factor {sum(sizes) / len(sizes):.4f}; rows run "
        f"{rows:.0f} for {rows - padding:.0f} requested rows (padded-row share "
        f"{padding / max(rows, 1):.4f}); peak device memory {gib(peak)} ({card})")
    loops = sum(c["loop_s"] for calls in spies.values() for c in calls)
    log("  batches (structure, entry, rows, launches, stage loop s): "
        + "; ".join(f"{b[0]} {b[1]} {b[2]} {b[3]} {b[4]:.4f}" for b in batches)
        + f"; stage loops {loops:.3f} s of the burst's {wall:.3f} s: the device idle at least "
        f"{1 - loops / wall:.4f} of it")
    log(f"  no solver call, no shm program scheduled ({after[3]} in the process), no cache "
        f"miss; launches of the burst {launches}")

    # every response against the same binding run alone on the same engine
    t0 = time.time()
    worst_amp, worst_exp, bitwise = 0.0, 0.0, True
    for req, resp in zip(reqs, resps):
        name = next(k for k, s in syms.items() if s is req.circuit) if req.params is not None \
            else ("qft" if req.circuit is concrete["qft"][0] else "ising")
        eng = engines[name]
        if req.params is not None:
            pt = dict(zip(eng.param_names, np.asarray(req.params, dtype=np.float64)))
            call, row = next((c, i) for c in spies[name] if c["points"] is not None
                             for i, p in enumerate(c["points"]) if p == pt)
            alone = eng.run_packed(params=pt)
        else:
            call, row = spies[name][0], 0
            alone = eng.run() if req.wants_state else eng.run_packed()
        got, want = call["sample"][row], alone.reshape(-1)[::stride].cpu()
        err = max_err(got, want)
        bitwise = bitwise and torch.equal(got, want)
        worst_amp = max(worst_amp, err)
        require(err < SERVE_ATOL, f"{name} request {req.request_id}: served amplitudes differ "
                                  f"from the run alone by {err}")
        if req.wants_state:
            require(abs(resp.amp0 - complex(alone.reshape(-1)[0].item())) < SERVE_ATOL,
                    f"{name}: amp0 differs from the run alone")
        else:
            want_res = measure_to_result(
                measurer_for(alone, eng.measurement_frame, eng), backend="cuda",
                shots=req.shots, seed=req.seed, marginals=req.marginals,
                observables=req.observables)
            for k, v in want_res.expectations.items():
                e = abs(resp.result.expectations[k] - v)
                worst_exp = max(worst_exp, e)
                require(e < SERVE_ATOL, f"{name}: <{k}> differs from the run alone by {e}")
            for q, m in want_res.marginals.items():
                require(float(np.abs(resp.result.marginals[q] - m).max()) < SERVE_ATOL,
                        f"{name}: marginal {q} differs from the run alone")
            if req.shots:
                require(resp.result.counts() == want_res.counts(),
                        f"{name}: the served shots differ from the run alone's")
        del alone
    log(f"  every response against its binding run alone on the same engine ({time.time() - t0:.1f}"
        f" s): every {stride}th amplitude of each row max |diff| {worst_amp:.3e} (bit for bit "
        f"{bitwise}), expectations max |diff| {worst_exp:.3e}, marginals within {SERVE_ATOL}, the "
        f"{len(SERVE['shot_requests'])} shot requests' counts equal")

    # the first point of each structure against the dense per-gate oracle
    t0 = time.time()
    fids = {}
    for name in structures:
        eng = engines[name]
        if name in syms:
            first = next(r for r in reqs if r.circuit is syms[name])
            bound = syms[name].bind(dict(zip(eng.param_names, first.params)))
            state = eng.run(params=dict(zip(eng.param_names, first.params)))
        else:
            bound = concrete[name][0]
            state = eng.run()
        fids[name] = fidelity(state, dense_simulate(bound, device=device))
        del state
        require(fids[name] >= FIDELITY_MIN, f"served {name} fidelity {fids[name]}")
    log("  first point of each structure against the dense oracle on the " + device + ": "
        + ", ".join(f"{k} {v:.9f}" for k, v in fids.items()) + f" ({time.time() - t0:.1f} s)")

    # every kernel op of one served batch against its plain version
    eng = engines["isingparam"]
    call = max(spies["isingparam"], key=lambda c: c["rows"])
    worst = hold_sweep_ops(ops, ref, eng, eng.backend.pass_of(call["rows"],
                                                             eng.sweep_tables(call["points"])),
                           seed=43, what=f"served isingparam({n}) batch of {call['rows']}")
    del spies

    # faults and the front end, on the same warm service
    async def faults_and_front_end():
        async with svc:
            good = [param_request(100 + i, "isingparam", tenant="free") for i in range(3)]
            bad = param_request(103, "isingparam", params=np.array([0.1, 0.2, 0.3]))
            got = await asyncio.gather(*[svc.submit_nowait(r) for r in good + [bad]],
                                       return_exceptions=True)
            require(all(not isinstance(g, Exception) and g.batch_size == 4 for g in got[:3])
                    and isinstance(got[3], ValueError),
                    f"a malformed rider must fail alone: {[type(g).__name__ for g in got]}")
            eng = engines["isingparam"]
            counts = eng.op_counts()
            per_run = {"fused": counts.get("fused", 0), "shm": counts.get("shm", 0)}
            nan_reqs = [param_request(110 + i, "isingparam") for i in range(4)]
            before = ops.kernel_call_counts()
            with faults.inject(faults.FaultPlan(seed=5).add(
                    "nan_amplitudes", count=1, site="engine.run_sweep")) as plan:
                nan_resps = await asyncio.gather(*[svc.submit_nowait(r) for r in nan_reqs])
            retried = launches_since(ops, before)
            require(plan.fires == {"nan_amplitudes": 1}, f"the NaN fired {plan.fires}")
            require(retried == {k: 2 * v for k, v in per_run.items()},
                    f"the poisoned row must be re-run once through the kernels: {retried}, "
                    f"a batch launches {per_run}")
            require(all(r.provenance and r.provenance["integrity_retries"] == 1
                        and r.provenance["integrity_recovered"] == 1 for r in nan_resps),
                    "integrity_retries must be in every response's provenance")
            worst_nan = 0.0
            for req, resp in zip(nan_reqs, nan_resps):
                alone = eng.run_packed(params=dict(zip(eng.param_names, req.params)))
                want = measurer_for(alone, eng.measurement_frame, eng).expectation(SERVE_OBS)
                worst_nan = max(worst_nan, abs(next(iter(resp.result.expectations.values()))
                                               - want))
                del alone
            require(worst_nan < SERVE_ATOL, f"the recovered batch differs by {worst_nan}")
            for key in ("integrity_retries", "integrity_recovered"):
                eng.provenance.pop(key)
            log(f"  a rider with 3 parameters in a batch of 4 failed alone (ValueError); a NaN "
                f"in one row of a served batch of 4 recovered by one re-run through the kernels "
                f"({retried} launches with the batch's), expectations within {worst_nan:.3e} "
                f"of the runs alone, integrity_retries 1 in each response's provenance")
            ghz = FAMILIES["ghz"](n)
            seen = []
            with _built_engines() as rec, faults.inject(faults.FaultPlan(seed=2).add(
                    "pallas_lowering_error", site="engine.init")) as plan:
                for _ in range(svc.cfg.breaker_threshold):
                    try:
                        await svc.submit(SimRequest(circuit=ghz, L=L, R=R))
                    except PallasLoweringError as e:
                        seen.append(e)
                try:
                    await svc.submit(SimRequest(circuit=ghz, L=L, R=R))
                    quarantined = None
                except CircuitQuarantined as e:
                    quarantined = e
            require(len(seen) == svc.cfg.breaker_threshold and all(e.injected for e in seen),
                    "each build must fail typed (PallasLoweringError)")
            require(quarantined is not None and quarantined.retry_after > 0,
                    "the structure must be quarantined with a retry_after")
            require(rec.seen == [("cuda", True)] * svc.cfg.breaker_threshold,
                    f"engines attempted {rec.seen}: no plain versions, no other backend")
            log(f"  pallas_lowering_error at engine.init x{len(seen)}: PallasLoweringError each "
                f"time, then CircuitQuarantined (retry_after {quarantined.retry_after:.1f} s); "
                f"engines attempted {rec.seen}")

            server = await asyncio.start_server(lambda r, w: handle_client(svc, r, w),
                                                "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                valid = param_request(120, "isingparam", tenant="gold")
                lines = [json.dumps({"id": 1, "family": "isingparam", "n": n, "L": L, "R": R,
                                     "params": list(map(float, valid.params)),
                                     "observables": [SERVE_OBS], "tenant": "gold"}),
                         "{not json", json.dumps({"cmd": "stats"})]
                writer.write(("\n".join(lines) + "\n").encode())
                await writer.drain()
                replies = [json.loads(await asyncio.wait_for(reader.readline(), 120))
                           for _ in lines]
                writer.close()
            finally:
                server.close()
                await server.wait_closed()
            answer = next(r for r in replies if r.get("rid") == 1)
            malformed = next(r for r in replies if r.get("error") == "bad_json")
            snap = next(r for r in replies if "stats" in r)
            require(answer["ok"] and answer["batch_size"] == 1 and answer["cache_hit"],
                    f"the valid line: {answer}")
            alone = eng.run_packed(params=dict(zip(eng.param_names, valid.params)))
            want = measurer_for(alone, eng.measurement_frame, eng).expectation(SERVE_OBS)
            del alone
            require(abs(next(iter(answer["expectations"].values())) - want) < SERVE_ATOL,
                    "the front end's expectation differs from the run alone")
            require(not malformed["ok"] and malformed["rid"] is None and snap["ok"]
                    and snap["stats"]["warm_pool"]["size"] == 4,
                    f"the malformed line and stats: {malformed}, {snap.get('ok')}")
            log(f"  front end on 127.0.0.1:{port}: the valid line answered (expectation "
                f"{next(iter(answer['expectations'].values())):.6f}, as the run alone), the "
                f"malformed line {malformed['error']}, stats answered "
                f"(warm pool {snap['stats']['warm_pool']['size']} engines)")

    asyncio.run(faults_and_front_end())

    # each served structure's warm run under the calibration and the analytic constants
    runs = {}
    for name in structures:
        eng = engines[name]
        circ, cl = (syms[name], L) if name in syms else concrete[name]
        pt = None
        if name in syms:
            first = next(r for r in reqs if r.circuit is syms[name])
            pt = dict(zip(eng.param_names, first.params))
        t0 = time.time()
        ana = engine_for(circ, cl, R, 0, cost_model=DEFAULT_COST_MODEL, cache=None,
                         device=device)
        build_s = time.time() - t0
        out = {}
        for label, e in (("calibrated", eng), ("analytic", ana)):
            e.run(params=pt)  # warm
            sync(device)
            t0 = time.time()
            state = e.run(params=pt)
            sync(device)
            out[label] = (time.time() - t0, state, plan_line(e))
        fid = fidelity(out["calibrated"][1], out["analytic"][1])
        require(fid >= FIDELITY_MIN, f"{name}: calibrated and analytic states differ ({fid})")
        runs[name] = {k: v[0] for k, v in out.items()}
        log(f"  {name}: warm run calibrated {out['calibrated'][0]:.4f} s ({out['calibrated'][2]})"
            f", analytic {out['analytic'][0]:.4f} s ({out['analytic'][2]}; planned in "
            f"{build_s:.1f} s); ratio {out['calibrated'][0] / out['analytic'][0]:.3f}; fidelity "
            f"between them {fid:.9f} ({card})")
        del out, state, ana
    del engines
    svc.pool.cache.clear()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "worst": worst, "runs": runs, "wall_s": wall,
            "peak_bytes": peak}


def width_rows(ops, ref, probe, ks, n: int) -> list:
    """``fused_apply`` rows at widths ``ks`` that no plan launched (the
    profile's k on bits 0..k-1 of one shard of 2^n): against the plain
    version, timed beside it and one torch.matmul, with the bounds."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = random_state(n, gen)
    vidx = torch.zeros(1, dtype=torch.int32, device="cuda")
    rows = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for k in ks:
            u = random_unitaries(1, k, gen)
            bits = list(range(k))
            err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, n),
                          ref.fused_apply_ref(x.clone(), u, vidx, bits, n))
            require(err < ATOL, f"fused_apply k={k} disagrees with its plain version")
            ms = probe.time_ms(lambda: ops.fused_apply(x, u, vidx, bits, n))
            plain_ms = probe.time_ms(lambda: ref.fused_apply_ref(x, u, vidx, bits, n), reps=3)
            xt, ut = x.view(-1, 1 << k), u[0].transpose(0, 1).contiguous()
            mm_ms = probe.time_ms(lambda: torch.matmul(xt, ut))
            cmacs = (1 << k) * (1 << n)
            row = entry("fused_apply", 0, err, ms, plain_ms, 2 * (8 << n) + u.numel() * 8 + 4,
                        TF32_PASSES * KARATSUBA_OPS * cmacs, TF32_OPS_PER_S, 8 * cmacs, mm_ms,
                        f"calibration: k={k} bits={bits} V=1 n={n}")
            rows.append(by_k_row(dict(row, k=k, path="calibration")))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return rows


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build, ops, probe, ref
    from repro_torch.launch import simulate
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    shutil.rmtree(CALIBRATION_DIR, ignore_errors=True)
    os.makedirs(CALIBRATION_DIR)
    os.environ["REPRO_CALIBRATION_DIR"] = CALIBRATION_DIR
    os.environ.pop("REPRO_CALIBRATION", None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    t_start = time.time()

    log("== build")
    t0 = time.time()
    ops.load()
    log(f"  built and loaded in {time.time() - t0:.1f}s")
    for line in probe.ptxas_lines(build):
        log(f"  {line}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    log("== kernels vs plain versions (n=30, L=28)")
    sweep_err = kernel_sweep(ops, ref, 30, 28, gen)
    torch.cuda.empty_cache()

    log("== main path: " + " ".join(MAIN_PATH))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    run = simulate.main(MAIN_PATH)
    torch.cuda.synchronize()
    launches = launches_match(ops, run.engine, "main path")
    launches_by_k = ops.fused_call_counts_by_k()
    peak = torch.cuda.max_memory_allocated()
    res = run.result
    amps = 1 << run.engine.n
    require(res.samples.shape == (1024,) and bool(np.all((res.samples >= 0) & (res.samples < amps))),
            "shots must be 1024 basis-state indices")
    marg = res.marginals[(0, 1, 2)]
    require(marg.shape == (8,) and bool(np.all(np.isfinite(marg))) and abs(marg.sum() - 1) < 1e-4,
            "the marginal must be a finite distribution over 8 outcomes")
    require(all(np.isfinite(v) for v in res.expectations.values()), "expectations must be finite")
    log(f"  simulate {run.seconds:.3f}s = {amps / run.seconds / 1e6:.1f} Mamps/s; "
        f"peak device memory {gib(peak)}")
    state = run.engine.finalize(run.state)
    run.state = None
    t0 = time.time()
    oracle = dense_simulate(run.engine.circuit, device="cuda")
    fid = fidelity(state, oracle)
    log(f"  fidelity vs dense per-gate oracle on the card: {fid:.9f} "
        f"(oracle {time.time() - t0:.1f}s)")
    require(fid >= 1 - 1e-5, f"fidelity {fid} < 1 - 1e-5")
    del state, oracle
    torch.cuda.empty_cache()

    log("== trace of the main path's stage loop")
    trace_run(run.engine.run_packed, run.seconds)
    torch.cuda.empty_cache()

    log("== kernel figures on the main path's ops")
    kernels = figures(ops, ref, probe, run.engine, gen, sweep_err, launches, launches_by_k)
    del run
    torch.cuda.empty_cache()

    log("== checked path: " + " ".join(CHECKED_PATH))
    checked = simulate.main(CHECKED_PATH)
    require(round(checked.fidelity, 6) == 1.0, f"qft(22) fidelity {checked.fidelity}")
    del checked
    torch.cuda.empty_cache()

    log("== engine path: " + " ".join(ENGINE_PATH))
    paths = {"ising30": dict(launches, by_k=launches_by_k)}
    worst = []
    eng_run = engine_phase(simulate, ops, ref, ENGINE_PATH, card)
    paths["isingparam30_engine"] = eng_run["launches"]
    worst.append(eng_run["worst"])
    fused = kernels[0]
    new_rows = fused_by_k(ops, ref, probe, eng_run["engine"], eng_run["x"], "engine path",
                          eng_run["launches"]["by_k"], skip=[row["k"] for row in fused["by_k"]])
    fused["by_k"] += [by_k_row(row) for row in new_rows]
    del eng_run, new_rows
    torch.cuda.empty_cache()
    log("== sweep: isingparam({n}) L={L} R={R}, P={P} bindings".format(**SWEEP))
    sweep = sweep_phase(ops, ref, **SWEEP, card=card)
    paths["isingparam28_sweep16"] = sweep["launches"]
    worst.append(sweep["worst"])
    torch.cuda.empty_cache()
    log("== batch: qft({n}) L={L} R={R}, B={B} basis states".format(**BATCH))
    batch = batch_phase(ops, ref, **BATCH, card=card)
    paths["qft28_batch3"] = batch["launches"]
    worst.append(batch["worst"])
    torch.cuda.empty_cache()

    t_grad = time.time()
    log("== VQE: " + " ".join(VQE_PATH))
    vqe = vqe_phase(simulate, ops, ref, probe, card, fused)
    paths["isingparam30_vqe"] = vqe["launches"]
    worst.append(vqe["worst"])
    log("== gradient oracle: su2param({n}, reps={reps}) L={L} R={R}".format(**ORACLE))
    paths["su2param20_grad"] = oracle_phase(ops, card, **ORACLE)["launches"]
    log("== grad_sweep: isingparam({n}) L={L} R={R}, P={P} bindings".format(**GRAD_SWEEP))
    paths["isingparam28_grad_sweep4"] = grad_sweep_phase(ops, card, **GRAD_SWEEP)["launches"]
    torch.cuda.empty_cache()
    log("== offload gradient: isingparam({n}) L={L} R={R}".format(**OFFLOAD_GRAD))
    paths["isingparam28_offload_grad"] = offload_grad_phase(ops, card, **OFFLOAD_GRAD)["launches"]
    torch.cuda.empty_cache()
    log(f"  the gradient phases took {time.time() - t_grad:.1f}s")

    t_offload = time.time()
    log("== host <-> card link (pinned, 2 GiB)")
    rates = link_rates()
    log("  h2d {h2d:.2f} GB/s, d2h {d2h:.2f} GB/s, both at once {both:.2f} GB/s ".format(**rates)
        + f"({card})")
    log("== offload path: " + " ".join(OFFLOAD_PATH))
    off = offload_phase(simulate, ops, ref, probe, card, rates, fused)
    paths["ising32_offload"] = off["launches"]
    worst.append(off["worst"])
    log("== per-gate offload baseline: qft({n}) L={L} R={R}".format(**PERGATE))
    pg = pergate_phase(ops, ref, probe, card, fused, **PERGATE)
    paths["qft26_offload"] = pg["staged"]
    paths["qft26_pergate"] = pg["pergate"]
    worst.append(pg["worst"])
    log("== offload batch and sweep: n={n} L={L} R={R}, B={B}, P={P}".format(**OFFLOAD_ROWS))
    rows = offload_rows_phase(ops, ref, card, **OFFLOAD_ROWS)
    paths["qft28_offload_batch2"] = rows["batch"]["launches"]
    paths["isingparam28_offload_sweep4"] = rows["sweep"]["launches"]
    worst += [rows["batch"]["worst"], rows["sweep"]["worst"]]
    log(f"  the offload phases took {time.time() - t_offload:.1f}s")

    t_store = time.time()
    log("== the host's disk and memory (spill directory build/spill)")
    free_disk = host_check()
    log("== shard store: ising({n}) L={L} R={R}, {tier}, half at rest on disk".format(**STORE))
    store = store_phase(simulate, ops, ref, probe, card, fused, free_disk, xy=True, **STORE)
    paths["ising32_store_bf16"] = store["launches"]
    worst.append(store["worst"])
    log("== shard store: ising({n}) L={L} R={R}, {tier}, half at rest on disk".format(**STORE_INT8))
    store8 = store_phase(simulate, ops, ref, probe, card, fused, free_disk, **STORE_INT8)
    paths["ising30_store_int8"] = store8["launches"]
    worst.append(store8["worst"])
    log("== stage checkpoints: ising({n}) L={L} R={R}, killed in stage 1 and resumed"
        .format(**CHECKPOINT))
    ckpt = checkpoint_phase(card, ops, ref, **CHECKPOINT)
    paths["ising30_checkpoint_resumed"] = ckpt["launches"]
    worst.append(ckpt["worst"])
    log(f"  the store and checkpoint phases took {time.time() - t_store:.1f}s")

    t_cal = time.time()
    log(f"== calibration: python -m repro_torch.sim.profiler --L {CALIBRATION_L} "
        f"--repeats {CALIBRATION_REPEATS} --verify (into build/calibration)")
    paths["calibration_L28"] = calibration_phase(ops, card)["launches"]
    from repro_torch.sim import profiler

    profiler.clear_resolved_cache()
    for name in CALIBRATED["families"]:
        log("== calibrated planning: {name}({n}) L={L} R={R}, calibrated against analytic"
            .format(name=name, **CALIBRATED))
        cal = calibrated_phase(ops, ref, probe, card, name, fused)
        paths[f"{name}30_calibrated"] = cal["launches"]
        worst.append(cal["worst"])
    log("== autotune: " + " ".join(AUTOTUNE_PATH))
    tuned = autotune_phase(simulate, ops, ref, card)
    paths["ising30_autotune"] = tuned["launches"]
    worst.append(tuned["worst"])
    log("== integrity guard and build faults: ising({n}) L={L} R={R}, sweep of {P}"
        .format(**FAULTS))
    paths["ising28_faults"] = faults_phase(ops, card)["launches"]
    log(f"  the calibration, calibrated, autotune and faults phases took "
        f"{time.time() - t_cal:.1f}s")

    t_serve = time.time()
    log("== serving: SimulationService on the card, isingparam({n}) and su2param({n}, "
        "reps={su2param_reps}) L={L} R={R}, qft({n}), ising({main_n}); max batch 8, max wait "
        "5 ms, tenants gold:4 free:1".format(**SERVE))
    serve = serve_phase(ops, ref, card)
    paths["serve28"] = serve["launches"]
    worst.append(serve["worst"])
    log(f"  the serving phase took {time.time() - t_serve:.1f}s")
    for k in kernels:
        key = "fused" if k["name"] == "fused_apply" else "shm"
        k["launches_by_path"] = {path: counts[key] for path, counts in paths.items()}
        k["max_abs_err"] = max([k["max_abs_err"]] + [w[key] for w in worst])
    for row in fused["by_k"]:
        row["launches_by_path"] = {path: counts["by_k"].get(row["k"], 0)
                                   for path, counts in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        require(row["launches"] > 0, f"no path launched fused_apply at k={row['k']}")
    launched_k = {k for counts in paths.values() for k in counts["by_k"]}
    missing = sorted(launched_k - {row["k"] for row in fused["by_k"]})
    for row in width_rows(ops, ref, probe, missing, CALIBRATION_L):
        row["launches_by_path"] = {path: counts["by_k"].get(row["k"], 0)
                                   for path, counts in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        fused["by_k"].append(row)
    require(launched_k <= {row["k"] for row in fused["by_k"]},
            f"a fused_apply width launched on a path has no row: {sorted(launched_k)}")

    log(f"== done in {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, drives the
port's main path (``repro_torch.launch.simulate``) at full width —
``ising(30)`` with L=28, R=2: a 2^30-amplitude complex64 state, 8 GiB —
and checks it against the port's dense per-gate oracle on the card, then
runs ``qft(22)`` with ``--check`` against the host complex128 oracle.

Prints the card's name and power limit, the ``shm_apply`` member-count /
window sweep on the widest group as a diagnostic line, one JSON line of
kernel figures (``fused_apply`` per width k beside ``torch.matmul``, both
bounds), and last ``{"ok": true, "device": {...}}``. Any failed phase raises: the
exit code is then non-zero and no result is printed. Needs CUDA.
"""

from __future__ import annotations

import json
import os
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


def kernel_sweep(ops, ref, n: int, L: int, gen: torch.Generator) -> float:
    """Every kernel against its plain version at the main path's state size,
    on target bits and windows away from the lowest bits."""
    S = 1 << (n - L)
    worst = 0.0
    x = random_state(n, gen)
    for k in (1, 2, 3, 5, 6, 7):
        bits = [3, 4, 9, 10, 11, 20, 6][:k] if k == 7 else [L - 1 - 3 * j for j in range(k)]
        for V in (1, 2):
            u, vidx = random_unitaries(V, k, gen), variant_index(S, V)
            err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, L),
                          ref.fused_apply_ref(x.clone(), u, vidx, bits, L))
            torch.cuda.synchronize()
            log(f"  fused_apply k={k} V={V} bits={bits}: max |kernel - plain| = {err:.3e}")
            require(err < ATOL, f"fused_apply k={k} V={V} disagrees with its plain version")
            worst = max(worst, err)
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
        worst = max(worst, err)
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

    def against_plain(u, vidx, bits):
        err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, L),
                      ref.fused_apply_ref(x.clone(), u, vidx, bits, L))
        require(err < ATOL, f"fused_apply disagrees with its plain version on the main "
                            f"path's k={len(bits)} op")
        return {"max_abs_err": err, "plain_ms": probe.time_ms(
            lambda: ref.fused_apply_ref(x, u, vidx, bits, L), reps=3),
            "nbytes": 2 * state_bytes + u.numel() * 8 + vidx.numel() * 4}

    by_k = []
    for r in probe.fused_rows(ops, engine, x, against_plain):
        k = r["k"]
        cmacs = (1 << k) * (1 << n)
        row = entry("fused_apply", launches_by_k.get(k, 0), r["max_abs_err"], r["ms"],
                    r["plain_ms"], r["nbytes"], TF32_PASSES * KARATSUBA_OPS * cmacs,
                    TF32_OPS_PER_S, 8 * cmacs, r["matmul_ms"],
                    f"k={k} bits={r['bits']} V={r['V']} n={n}")
        by_k.append(dict(row, k=k))
    widest = dict(by_k[0], launches=launches["fused"], max_abs_err=max(
        [sweep_err] + [row["max_abs_err"] for row in by_k]))
    del widest["k"]
    widest["by_k"] = [{key: row[key] for key in ("k", "launches", "ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_fp32_ms", "max_abs_err")}
                      for row in by_k]
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
    out.append(entry("shm_apply", launches["shm"], max(err, sweep_err), ms, plain_ms,
                     nbytes, nops, FP32_OPS_PER_S, nops, None,
                     f"a={len(window)} window={list(window)} members={len(members)} "
                     f"({kinds.count('mat')} mat, {kinds.count('diag')} diag) n={n}"))
    sweep = probe.shm_sweep(ops, window, members, L, x)
    log("  shm_apply sweep (members: 0 = a copy; place: the group's window or bits "
        "0..a-1): " + json.dumps([{k: r[k] for k in ("place", "members", "ms")} for r in sweep]))
    return out


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


def trace_run(engine, untraced_s: float) -> None:
    """One more ``run_packed`` of the main path under torch.profiler: device
    time by kernel, against the untraced run's wall time (the profiled wall
    time includes the profiler's own start-up)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = engine.run_packed()
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    del out
    rows = []
    for ev in prof.key_averages():  # device-side events only: no double count
        dev_us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and str(ev.device_type).endswith("CUDA"):
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"  traced run_packed: device time {busy_ms:.1f} ms = {busy_ms / (untraced_s * 1e3):.0%}"
        f" of the untraced run's {untraced_s * 1e3:.1f} ms (profiled wall {wall_ms:.1f} ms); "
        "by kernel:")
    for ms, count, key in rows[:10]:
        log(f"    {ms:9.2f} ms  x{count:<3d} {key[:100]}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build, ops, probe, ref
    from repro_torch.launch import simulate
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

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
    launches = ops.kernel_call_counts()
    launches_by_k = ops.fused_call_counts_by_k()
    peak = torch.cuda.max_memory_allocated()
    counts = run.engine.op_counts()
    want = {"fused": counts.get("fused", 0), "shm": counts.get("shm", 0)}
    want_by_k = {}
    for op in probe.main_path_ops(run.engine)[0]:
        want_by_k[len(op.local_bits)] = want_by_k.get(len(op.local_bits), 0) + 1
    log(f"  kernel launches {launches}, fused_apply by k {launches_by_k}; "
        f"compiled program {counts}, fused ops by k {want_by_k}")
    require(launches == want, f"kernel launches {launches} != compiled ops {want}")
    require(launches_by_k == want_by_k,
            f"fused_apply launches by k {launches_by_k} != compiled fused ops by k {want_by_k}")
    require(want["fused"] > 0 and want["shm"] > 0, "the main path must run both kernels")
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
    trace_run(run.engine, run.seconds)
    torch.cuda.empty_cache()

    log("== kernel figures on the main path's ops")
    kernels = figures(ops, ref, probe, run.engine, gen, sweep_err, launches, launches_by_k)
    del run
    torch.cuda.empty_cache()

    log("== checked path: " + " ".join(CHECKED_PATH))
    checked = simulate.main(CHECKED_PATH)
    require(round(checked.fidelity, 6) == 1.0, f"qft(22) fidelity {checked.fidelity}")

    log(f"== done in {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

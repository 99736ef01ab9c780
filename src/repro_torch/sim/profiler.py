"""Microbenchmark profiler (paper §VII-A): measure the real kernel primitives
on the device the port runs on and turn them into a
:class:`~repro_torch.core.cost_model.CostModel` calibration.

The port's copy of ``repro/sim/profiler.py``. The analytic constants in
:mod:`repro_torch.core.cost_model` are the reference's, derived for another
chip. This module times the primitives the port's backends execute — the
hand-written ``fused_apply`` kernel per k, the hand-written ``shm_apply``
kernel against member count and diagonal fraction, a raw memory pass,
the pinned host <-> device round trip of one offload shard, an fsync'd
spill-file round trip, and bare dispatch overhead — and reduces them to
the cost model's 2^28-amplitude reference shard so
:meth:`CostModel.from_calibration` can rebuild the model from measurement.

**Shard size.** Each time measured on a 2^L shard is scaled by 2^(28-L).
On a GPU a small shard is launch-bound (a 2^14 pass takes ~10 us, which
scales to ~160 ms against a real ~1.3 ms), so on CUDA a full profile runs
at ``L = REFERENCE_L`` (28), where the scale is 1. ``--fast`` (tiny shards,
few repeats) and the CPU keep the reference's defaults (L=8, L=14).

Calibrations persist as JSON keyed by a **device fingerprint** (platform,
device kind and count, dtype, torch and CUDA versions). The file is the
port's own (:data:`CALIBRATION_FILENAME`): a calibration the JAX package
wrote is never read as the port's, and resolves as ``mismatch`` when it is
named explicitly (its fingerprint carries another runtime).
:func:`resolve_cost_model` is the auto-load hook of
``repro_torch.sim.engine.engine_for``: the calibrated model when a file
whose fingerprint matches the engine's device exists, the analytic
defaults otherwise, memoized per process (and per device) so every caller
sees one model and therefore one :class:`CircuitKey`.

Environment knobs (the reference's):

* ``REPRO_CALIBRATION`` — ``off``/``0``/``none``/``analytic`` forces the
  analytic defaults; any other non-empty value is an explicit calibration
  file path.
* ``REPRO_CALIBRATION_DIR`` — directory searched for
  :data:`CALIBRATION_FILENAME` (default ``~/.cache/repro-atlas``).

CLI::

    python -m repro_torch.sim.profiler --fast --device cpu --out calib.json --verify
    python -m repro_torch.sim.profiler --L 28 --verify      # on the card
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.cost_model import CostModel, DEFAULT_COST_MODEL
from ..device import DeviceLike, resolve_device

# v2: adds the "disk" section (disk_gbps for the shard_store spill tier).
# Files written by older versions miss fields the cost model now prices, so
# resolve_calibration treats a version mismatch like a fingerprint mismatch.
CALIBRATION_VERSION = 2
# the port's own file: never the JAX package's ``calibration.json``
CALIBRATION_FILENAME = "calibration-torch.json"
REFERENCE_L = 28  # the cost model's reference shard: 2^28 amplitudes


# ======================================================================
# Device fingerprint
# ======================================================================


def _default_device(device: DeviceLike) -> torch.device:
    """``device``, or where an engine runs by default: CUDA when there is
    one, the CPU otherwise (a fingerprint never raises for want of a card)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def device_fingerprint(dtype="complex64", device: DeviceLike = None) -> Dict[str, str]:
    """Stable identity of the execution substrate a calibration is valid
    for. Two processes with equal fingerprints may share a calibration."""
    dev = _default_device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        count = torch.cuda.device_count()
    else:
        kind, count = "cpu", 1
    return {
        "platform": dev.type,
        "device_kind": kind,
        "device_count": str(count),
        "dtype": str(dtype).replace("torch.", ""),
        "torch_version": torch.__version__,
        "cuda_version": str(torch.version.cuda),
    }


def fingerprint_digest(fp: Dict[str, str]) -> str:
    payload = tuple(sorted((str(k), str(v)) for k, v in fp.items()))
    return hashlib.sha256(repr(payload).encode()).hexdigest()[:16]


# ======================================================================
# Timing primitives
# ======================================================================


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_us(fn: Callable, *args, device: torch.device, repeats: int = 5,
             warmup: int = 1) -> float:
    """Best-of-N wall time of ``fn(*args)`` in microseconds (the minimum is
    the standard noise-robust estimator for short kernels); the device is
    synchronised before the clock starts and before it is read."""
    for _ in range(max(warmup, 1)):
        fn(*args)
    best = math.inf
    for _ in range(max(repeats, 1)):
        _sync(device)
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _generator(rng: np.random.Generator, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))


def _rand_state(rng: np.random.Generator, L: int, device: torch.device) -> torch.Tensor:
    """A normalised random flat complex64 state of 2^L amplitudes, drawn on
    ``device`` (a 2^28 state drawn on the host would take seconds)."""
    x = torch.randn(1 << L, dtype=torch.complex64, device=device,
                    generator=_generator(rng, device))
    return x / torch.linalg.vector_norm(x)


def _rand_unitary(rng: np.random.Generator, k: int) -> np.ndarray:
    m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
    q, _ = np.linalg.qr(m)
    return q.astype(np.complex64)


def _operand(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A kernel operand with its leading variant axis: ``[1, ...]``."""
    return torch.from_numpy(np.ascontiguousarray(a[None])).to(device)


# ======================================================================
# Microbenchmarks — each times a real engine primitive
# ======================================================================


def profile_dispatch(repeats: int = 20, device: DeviceLike = None) -> Dict:
    """Bare dispatch overhead: one tiny torch op, synchronised. Maps to
    ``launch_us`` (scale-free)."""
    dev = resolve_device(device)
    x = torch.zeros(8, dtype=torch.float32, device=dev)
    t = _time_us(lambda v: v + 0.0, x, device=dev, repeats=repeats, warmup=3)
    return {"launch_us": t, "raw": {"identity_us": t}}


def profile_pass(L: int, repeats: int = 5, rng: Optional[np.random.Generator] = None,
                 device: DeviceLike = None) -> Dict:
    """One memory read+write pass: an out-of-place elementwise multiply over
    a 2^L-amplitude complex64 shard, scaled to the 2^28 reference. Maps to
    ``pass_us``."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    x = _rand_state(rng, L, dev)
    t = _time_us(lambda v: v * complex(0.6, 0.8), x, device=dev, repeats=repeats)
    scale = 2.0 ** (REFERENCE_L - L)
    return {"pass_us": t * scale, "raw": {"L": L, "elementwise_us": t}}


def profile_fusion(L: int, kmax: Optional[int] = None, repeats: int = 3,
                   rng: Optional[np.random.Generator] = None,
                   device: DeviceLike = None) -> Dict:
    """Fusion kernel cost per k: the hand-written ``fused_apply`` kernel
    through the wrapper the engine calls (:func:`repro_torch.kernels.ops.
    fused_apply`; its plain version on the CPU), timed for k = 1..kmax on
    one 2^L shard (k < 4 runs as I x U on 4 bits). The model says
    ``t(k) ~ launch + max(pass, mxu * 2^k)``, so the per-2^k slope of the
    large-k tail estimates ``mxu_us_per_2k``."""
    from ..kernels import ops as kops

    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    kmax = min(kmax or DEFAULT_COST_MODEL.max_fusion_qubits, L - 1)
    kmax = max(kmax, 1)
    view = _rand_state(rng, L, dev)
    vidx = torch.zeros(1, dtype=torch.int32, device=dev)
    scale = 2.0 ** (REFERENCE_L - L)
    per_k: Dict[int, float] = {}
    for k in range(1, kmax + 1):
        u = _operand(_rand_unitary(rng, k), dev)
        bits = tuple(range(k))
        per_k[k] = _time_us(lambda: kops.fused_apply(view, u, vidx, bits, L), device=dev,
                            repeats=repeats)
    # compute-bound tail: t28(k)/2^k flattens to mxu_us_per_2k
    tail = sorted(per_k)[len(per_k) // 2:]
    mxu = float(np.median([per_k[k] * scale / (1 << k) for k in tail]))
    return {
        "mxu_us_per_2k": mxu,
        "raw": {"L": L, "per_k_us": {str(k): v for k, v in per_k.items()}},
    }


def profile_shm(L: int, repeats: int = 3, rng: Optional[np.random.Generator] = None,
                device: DeviceLike = None) -> Dict:
    """shm group cost vs member count and diagonal fraction: the
    hand-written ``shm_apply`` kernel (:func:`repro_torch.kernels.ops.
    shm_apply`) with g member gates costs ``alpha + sum_g cost(g)``; the
    incremental cost between g=1 and g=5 estimates the per-gate constants
    (``shm_gate_us`` non-diagonal via dense 2-qubit unitaries,
    ``shm_diag_gate_us`` via 2-qubit diagonals) on window bits 0..3."""
    from ..kernels import ops as kops

    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    a = min(4, L - 1)
    window = tuple(range(a))
    view = _rand_state(rng, L, dev)
    vidx = torch.zeros(1, dtype=torch.int32, device=dev)
    scale = 2.0 ** (REFERENCE_L - L)

    def time_group(members) -> float:
        return _time_us(lambda: kops.shm_apply(view, window, members, L), device=dev,
                        repeats=repeats)

    def dense_gates(g: int):
        return [("mat", (i % (a - 1), i % (a - 1) + 1), _operand(_rand_unitary(rng, 2), dev),
                 vidx) for i in range(g)]

    def diag_gates(g: int):
        out = []
        for i in range(g):
            d = np.exp(1j * rng.uniform(0, 2 * np.pi, 4)).astype(np.complex64)
            out.append(("diag", (i % (a - 1), i % (a - 1) + 1), _operand(d, dev), vidx))
        return out

    g_lo, g_hi = 1, 5
    t_dense_lo, t_dense_hi = time_group(dense_gates(g_lo)), time_group(dense_gates(g_hi))
    t_diag_lo, t_diag_hi = time_group(diag_gates(g_lo)), time_group(diag_gates(g_hi))
    span = g_hi - g_lo
    gate_us = max((t_dense_hi - t_dense_lo) * scale / span, 1e-2)
    diag_us = max((t_diag_hi - t_diag_lo) * scale / span, 1e-3)
    diag_us = min(diag_us, gate_us)  # a diagonal is never dearer than dense
    return {
        "shm_gate_us": gate_us,
        "shm_diag_gate_us": diag_us,
        "raw": {
            "L": L, "window_bits": a, "g": [g_lo, g_hi],
            "dense_us": [t_dense_lo, t_dense_hi],
            "diag_us": [t_diag_lo, t_diag_hi],
        },
    }


def profile_host_link(L: int, repeats: int = 5, rng: Optional[np.random.Generator] = None,
                      device: DeviceLike = None) -> Dict:
    """Offload host-link bandwidth: a pinned host -> device -> pinned host
    round trip of one 2^L-amplitude complex64 shard, the per-shard motion
    of the offload backend's shard ring (on the CPU: two CPU copies). Maps
    to ``host_link_gbps`` (scale-free)."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    pin = dev.type == "cuda"
    host = torch.empty(1 << L, dtype=torch.complex64, pin_memory=pin)
    host.copy_(_rand_state(rng, L, dev))
    back = torch.empty_like(host, pin_memory=pin)
    buf = torch.empty(1 << L, dtype=torch.complex64, device=dev)

    def roundtrip():
        buf.copy_(host, non_blocking=True)
        back.copy_(buf, non_blocking=True)

    t_us = _time_us(roundtrip, device=dev, repeats=repeats)
    nbytes = 2 * host.numel() * host.element_size()  # down + back
    gbps = nbytes / max(t_us, 1e-3) / 1e3  # bytes/us -> GB/s
    return {"host_link_gbps": gbps,
            "raw": {"L": L, "roundtrip_us": t_us, "bytes": nbytes}}


def profile_disk(L: int, repeats: int = 5, rng: Optional[np.random.Generator] = None,
                 spill_dir: Optional[str] = None, device: DeviceLike = None) -> Dict:
    """Spill-tier bandwidth: an fsync'd write + read round trip of one
    2^L-amplitude at-rest shard file — the per-shard motion of the
    :mod:`repro_torch.sim.shard_store` disk tier (atomic tmp+rename on the
    write side, like the store itself). Maps to ``disk_gbps``
    (scale-free)."""
    import tempfile

    rng = rng or np.random.default_rng(0)
    block = _rand_state(rng, L, _default_device(device)).cpu().numpy()
    d = spill_dir or tempfile.gettempdir()
    path = os.path.join(d, f"repro-torch-profile-disk-{os.getpid()}.npy")

    def roundtrip(b):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, b)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return np.load(path)

    try:
        best = math.inf
        roundtrip(block)  # warmup (page cache, allocator)
        for _ in range(max(repeats, 1)):
            t0 = time.perf_counter()
            roundtrip(block)
            best = min(best, time.perf_counter() - t0)
    finally:
        for p in (path, path + ".tmp"):
            if os.path.exists(p):
                os.remove(p)
    t_us = best * 1e6
    nbytes = 2 * block.nbytes  # write + read
    gbps = nbytes / max(t_us, 1e-3) / 1e3  # bytes/us -> GB/s
    return {"disk_gbps": gbps,
            "raw": {"L": L, "roundtrip_us": t_us, "bytes": nbytes, "dir": d}}


# ======================================================================
# Full profile run
# ======================================================================


def default_shard_bits(fast: bool, device: DeviceLike = None) -> int:
    """The shard the microbenchmarks run on: the reference's 8 (``fast``)
    and 14 (CPU), and on CUDA the reference shard itself (see the module
    docstring)."""
    if fast:
        return 8
    return REFERENCE_L if resolve_device(device).type == "cuda" else 14


def run_profile(fast: bool = True, L: Optional[int] = None, repeats: Optional[int] = None,
                seed: int = 0, dtype="complex64", device: DeviceLike = None) -> Dict:
    """Run every microbenchmark and assemble a calibration dict (the JSON
    payload of :func:`save_calibration`). ``fast`` is the CI/test mode: tiny
    shards, few repetitions — noisy but structurally identical."""
    dev = resolve_device(device)
    L = L if L is not None else default_shard_bits(fast, dev)
    repeats = repeats if repeats is not None else (2 if fast else 8)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    sections = [
        profile_dispatch(repeats=max(repeats, 5), device=dev),
        profile_pass(L, repeats=repeats, rng=rng, device=dev),
        profile_fusion(L, repeats=repeats, rng=rng, device=dev),
        profile_shm(L, repeats=repeats, rng=rng, device=dev),
        profile_host_link(L, repeats=repeats, rng=rng, device=dev),
        profile_disk(L, repeats=repeats, rng=rng, device=dev),
    ]
    measurements: Dict[str, float] = {}
    raw: Dict[str, Dict] = {}
    for name, sec in zip(("dispatch", "pass", "fusion", "shm", "host_link", "disk"), sections):
        raw[name] = sec.pop("raw", {})
        measurements.update(sec)
    cm = CostModel.from_calibration(measurements)
    return {
        "version": CALIBRATION_VERSION,
        "fingerprint": device_fingerprint(dtype, dev),
        "measurements": measurements,
        "cost_model": cm.to_dict(),
        "meta": {
            "fast": fast, "L": L, "repeats": repeats, "seed": seed,
            "profile_time_s": time.perf_counter() - t0,
            "raw": raw,
        },
    }


# ======================================================================
# Persistence + auto-load
# ======================================================================


def default_calibration_dir() -> str:
    return os.environ.get("REPRO_CALIBRATION_DIR",
                          os.path.join(os.path.expanduser("~"), ".cache", "repro-atlas"))


def default_calibration_path() -> str:
    return os.path.join(default_calibration_dir(), CALIBRATION_FILENAME)


def save_calibration(path: str, calib: Dict) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(calib, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_calibration(path: str) -> Dict:
    with open(path) as f:
        calib = json.load(f)
    if not isinstance(calib, dict) or "measurements" not in calib:
        raise ValueError(f"{path}: not a calibration file")
    return calib


_RESOLVED: Dict[Tuple[str, str, Optional[int]], Tuple[CostModel, Dict]] = {}


def resolve_cost_model(path: Optional[str] = None, *, refresh: bool = False,
                       device: DeviceLike = None) -> CostModel:
    """The cost model ``engine_for`` should plan with on ``device`` (default:
    CUDA when there is one, else the CPU): the calibrated model when a
    calibration file with a matching device fingerprint exists, the analytic
    defaults otherwise.

    Memoized per process (per path and device) so every key computation in
    a process sees the SAME model and therefore the same
    :class:`CircuitKey`. Use ``refresh=True`` (or
    :func:`clear_resolved_cache`) after writing a new calibration
    mid-process."""
    cm, _ = resolve_calibration(path, refresh=refresh, device=device)
    return cm


def resolve_calibration(path: Optional[str] = None, *, refresh: bool = False,
                        device: DeviceLike = None) -> Tuple[CostModel, Dict]:
    """:func:`resolve_cost_model` plus provenance: returns ``(model, info)``
    where info records the source (``disabled``/``analytic``/``calibrated``/
    ``mismatch``/``version_mismatch``/``error``), the path probed, and
    fingerprint digests."""
    env = os.environ.get("REPRO_CALIBRATION", "").strip()
    if env.lower() in ("off", "0", "none", "analytic"):
        return DEFAULT_COST_MODEL, {"source": "disabled", "path": None}
    if path is None:
        path = env if env else default_calibration_path()
    dev = _default_device(device)
    key = (os.path.abspath(path), dev.type, dev.index)
    if not refresh and key in _RESOLVED:
        return _RESOLVED[key]
    info: Dict = {"path": key[0]}
    cm = DEFAULT_COST_MODEL
    try:
        calib = load_calibration(key[0])
        here = fingerprint_digest(device_fingerprint(device=dev))
        there = fingerprint_digest(calib.get("fingerprint", {}))
        info["fingerprint"] = there
        ver = int(calib.get("version", 0))
        if ver != CALIBRATION_VERSION:
            # a file from another schema version misses (or mis-scales)
            # fields the model now prices — fall back to analytic, loudly
            info["source"] = "version_mismatch"
            info["file_version"] = ver
            info["expected_version"] = CALIBRATION_VERSION
        elif here != there:
            info["source"] = "mismatch"
            info["local_fingerprint"] = here
        else:
            cm = CostModel.from_calibration(calib.get("measurements", {}))
            info["source"] = "calibrated"
    except FileNotFoundError:
        info["source"] = "analytic"
    except (ValueError, KeyError, OSError, json.JSONDecodeError) as e:
        info["source"] = "error"
        info["error"] = f"{type(e).__name__}: {e}"
    _RESOLVED[key] = (cm, info)
    return cm, info


def clear_resolved_cache() -> None:
    """Drop the per-process resolution memo (tests; post-recalibration)."""
    _RESOLVED.clear()


# ======================================================================
# Production observation sink
# ======================================================================

#: Bounded ring of lightweight runtime observations: every engine run (and
#: every offload stage and remap) appends one record so production traffic
#: keeps contributing data the next calibration can sanity-check against.
OBSERVATIONS: "deque[Dict]" = deque(maxlen=4096)


def record_observation(kind: str, **data) -> None:
    OBSERVATIONS.append({"kind": kind, **data})


def observation_summary() -> Dict[str, Dict]:
    """Per-kind aggregate of the observation ring: count / total / mean /
    max wall-microseconds."""
    agg: Dict[str, Dict] = {}
    for ob in list(OBSERVATIONS):
        a = agg.setdefault(ob["kind"], {"count": 0, "total_us": 0.0, "max_us": 0.0})
        us = float(ob.get("wall_us", 0.0))
        a["count"] += 1
        a["total_us"] += us
        a["max_us"] = max(a["max_us"], us)
    for a in agg.values():
        a["mean_us"] = a["total_us"] / max(a["count"], 1)
    return agg


def clear_observations() -> None:
    OBSERVATIONS.clear()


# ======================================================================
# Verification + CLI
# ======================================================================


def verify_calibration(calib: Dict, n_qubits: int = 6, seed: int = 0,
                       device: DeviceLike = None) -> bool:
    """Plan + run one random circuit under the calibrated model and check
    the engine still matches the dense per-gate oracle — a wrong cost model
    may pick bad plans, it must never pick wrong ones. The split is the
    reference's ``L = n - 2`` but at least 5 local bits (``shm_apply``
    keeps 2^5 amplitudes a thread in registers), the rest ``R``."""
    from ..core.generators import random_circuit
    from .engine import engine_for
    from .statevector import simulate

    dev = resolve_device(device)
    cm = CostModel.from_calibration(calib["measurements"])
    circ = random_circuit(n_qubits, n_gates=24, seed=seed)
    L = min(n_qubits, max(n_qubits - 2, 5))
    eng = engine_for(circ, L=L, R=n_qubits - L, G=0, cost_model=cm, cache=None, device=dev)
    out = eng.run().cpu().numpy().reshape(-1)
    ref = simulate(circ, device=dev).cpu().numpy().reshape(-1)
    phase = np.vdot(ref, out)
    phase = phase / abs(phase) if abs(phase) > 1e-12 else 1.0
    return bool(np.allclose(out, phase * ref, atol=1e-4))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Profile kernel primitives and write a CostModel calibration JSON")
    ap.add_argument("--fast", action="store_true",
                    help="tiny shards, few repetitions (CI smoke mode)")
    ap.add_argument("--L", type=int, default=None,
                    help="shard qubits for the microbenchmarks (default: 8 with --fast, "
                         f"{REFERENCE_L} on CUDA, 14 on the CPU)")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None,
                    help="output path (default: the auto-load location "
                         f"{default_calibration_path()})")
    ap.add_argument("--verify", action="store_true",
                    help="plan+run one circuit under the calibrated model and check it "
                         "against the dense oracle")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    calib = run_profile(fast=args.fast, L=args.L, repeats=args.repeats, seed=args.seed,
                        device=device)
    out = args.out or default_calibration_path()
    save_calibration(out, calib)
    clear_resolved_cache()
    print(f"calibration -> {out}")
    print(f"  fingerprint {fingerprint_digest(calib['fingerprint'])} "
          f"({calib['fingerprint']['platform']} x{calib['fingerprint']['device_count']}, "
          f"{calib['fingerprint']['device_kind']})")
    for k in sorted(calib["measurements"]):
        print(f"  {k:<18} {calib['measurements'][k]:.4g}")
    if args.verify:
        ok = verify_calibration(calib, seed=args.seed, device=device)
        print(f"  verify: {'OK — engine matches dense oracle' if ok else 'FAILED'}")
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end quantum circuit simulation (the CLI).

The paths of ``repro/launch/simulate.py``: generate a circuit, partition it
(ILP staging + DP kernelization), compile the plan, run the staged engine,
then measure. Runs on CUDA unless ``--device cpu``; ``--executor shardmap``
runs on several processes, one per device of the bit-mesh.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit qft --n 22 \\
      --L 20 --R 2 --check
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit ising --n 30 \\
      --L 28 --R 2 --shots 1024 --marginal 0,1,2 --observable "Z0 Z1 + 0.5*X2"
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit qft --n 10 \\
      --L 8 --R 2 --check --device cpu

Engine path (compile cache, parameter binding, batches, sweeps):
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit isingparam \\
      --n 12 --L 10 --R 2 --engine --bind J=0.35 --bind h=0.8 --check
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit isingparam \\
      --n 12 --L 10 --R 2 --sweep points.json --check
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit qft --n 12 \\
      --L 10 --R 2 --batch 3 --check
(points.json: a JSON list of {name: value} objects, {"points": [...]}, or
{"name": [v0, v1, ...]} columns of equal length.)

Host offload (the state in host memory, streamed through the device stage
by stage; ``--engine``, ``--batch`` and ``--sweep`` take it too), and the
per-gate offload baseline:
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit ising --n 32 \
      --L 28 --R 4 --executor offload --shots 64 --marginal 0,1,2
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit qft --n 12 \
      --L 9 --R 3 --executor pergate --check --device cpu

The offload state at rest in a tiered shard store (bf16 or int8 shards in a
DRAM budget, the rest spilled to disk), or checkpointed after every stage
(a killed run resumes from the directory):
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit ising --n 32 \\
      --L 28 --R 4 --executor offload --storage bf16 --dram-budget-mb 8192 \\
      --spill-dir /path/to/disk
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit ising --n 30 \\
      --L 26 --R 4 --executor offload --checkpoint-dir /path/to/ckpt

Variational optimisation: Adam over adjoint-mode ``value_and_grad`` of a
Pauli observable, the reverse sweep through the ``fused_apply`` kernel:
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit isingparam \
      --n 30 --L 28 --R 2 --vqe "Z0 Z1 + Z1 Z2 + 0.5*X0"
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit isingparam \
      --n 8 --L 6 --R 2 --vqe "Z0 Z1 + Z1 Z2 + 0.5*X0" --vqe-steps 5 --device cpu

Plan autotuning: replay candidate plans (the card's calibrated cost model
against the analytic one, kernelizer methods, fusion caps, the optimizer,
ILP comm weights), install the fastest under the default key, then run:
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit ising --n 30 \
      --L 28 --R 2 --autotune
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit qft --n 10 \
      --L 8 --R 2 --autotune --check --device cpu

The explicit-collective executor: one process per device of the 2^(R+G)
bit-mesh, each holding one 2^L shard, started by ``torchrun`` (``python -m
torch.distributed.run``). Every path above runs on it, ``--vqe`` too (each
rank sweeps its own shard back through the plan's stages); only rank 0
prints, with one line per remap and each rank's kernel launches.
``--dist-backend`` is ``nccl`` on CUDA (one rank per card) and ``gloo`` on
the CPU by default; several ranks on one card need ``gloo``. Under
``torchrun`` spell ``--n`` as ``--qubits``: some Python versions' argparse
takes ``--n`` after the script name for an abbreviation of torchrun's own
options and stops. On 8 CPU processes, on one card, and on four cards over
NCCL:
  PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
      -m repro_torch.launch.simulate --circuit qft --qubits 10 --L 7 --R 2 --G 1 \\
      --executor shardmap --device cpu --check
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.simulate --circuit ising --qubits 30 --L 28 --R 2 \\
      --executor shardmap --dist-backend gloo --marginal 0,1,2
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.simulate --circuit ising --qubits 30 --L 28 --R 2 \\
      --executor shardmap --shots 1024 --result-json result.json
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.simulate --circuit isingparam --qubits 30 --L 28 --R 2 \\
      --executor shardmap --dist-backend gloo --vqe "Z0 Z1 + 0.25*X5 Y4" --vqe-steps 1
(``--result-json``: rank 0 writes the run's figures and results as JSON,
since a worker's return value does not reach the caller.)
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.generators import FAMILIES, PARAM_FAMILIES
from ..core.partition import SimulationPlan, partition
from ..device import resolve_device
from ..kernels import ops as kops
from ..sim.engine import DEFAULT_CACHE, ExecutionEngine, engine_for
from ..sim.measure import (
    Frame, StreamingMeasurer, measure_batch, measure_sweep, measure_to_result, measurer_for,
)
from ..sim.offload import PerGateOffloadExecutor
from ..sim.shard_store import StorageConfig
from ..sim.result import SimulationResult
from ..sim.statevector import fidelity, simulate_np
from . import dist as launch_dist

CHECK_MAX_QUBITS = 24  # --check builds a host complex128 state


@dataclass
class SimulateRun:
    """What one run of the CLI produced: the engine (its compiled program and
    device), the plan, the state it ended with (the packed final-stage
    layout when it measured, logical order otherwise; ``[B, 2^n]`` for a
    batch or a sweep; on the shardmap backend this rank's ``2^L`` shard of
    each, ``[2^L]`` or ``[B, 2^L]``), the measurement result(s), the
    simulation's wall time, the --check fidelity of each state (the same
    on every rank), and on the engine path the seconds to get the engine
    (plan, compile and upload on a cache miss) and to bind the --bind
    parameters. ``launches``: the kernel launches of the simulation on
    each rank (one entry on one device); ``peaks``: each rank's peak
    device memory in bytes up to the end of the simulation (0 on the CPU);
    ``remaps``: on the shardmap backend, each remap of the last run with
    the bytes each rank sent and the slowest rank's seconds."""

    engine: ExecutionEngine
    plan: SimulationPlan
    state: Optional[torch.Tensor]
    result: Optional[SimulationResult]
    seconds: float
    fidelity: Optional[float] = None
    results: List[SimulationResult] = field(default_factory=list)
    fidelities: List[float] = field(default_factory=list)
    build_seconds: Optional[float] = None
    bind_seconds: Optional[float] = None
    # --vqe: <H> after the first value_and_grad and after each step, the
    # final angles (ordered by param_names), and the seconds of each
    # value_and_grad call (the first one first); on the shardmap backend,
    # the first call's gradient, and each rank's figures of its sweep
    # (``ShardedAdjointProgram.last_sweep`` with the forward run's seconds
    # and the sweep's byte bound)
    energies: List[float] = field(default_factory=list)
    theta: Optional[np.ndarray] = None
    param_names: Tuple[str, ...] = ()
    grad_seconds: List[float] = field(default_factory=list)
    first_grad: Optional[np.ndarray] = None
    sweeps: List[dict] = field(default_factory=list)
    launches: List[dict] = field(default_factory=list)
    peaks: List[int] = field(default_factory=list)
    remaps: List[dict] = field(default_factory=list)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _parse_bind(specs):
    out = {}
    for spec in specs:
        if "=" not in spec:
            raise SystemExit(f"--bind expects name=value, got {spec!r}")
        name, _, val = spec.partition("=")
        out[name.strip()] = float(val)
    return out


def _load_sweep(path):
    """JSON sweep file -> list of {name: value} points."""
    with open(path) as f:
        d = json.load(f)
    if isinstance(d, dict) and "points" in d:
        d = d["points"]
    if isinstance(d, list):
        return [dict(p) for p in d]
    # columns form: {name: [v0, v1, ...]}
    lengths = {len(v) for v in d.values()}
    if len(lengths) != 1:
        raise SystemExit("--sweep columns must have equal length")
    P = lengths.pop()
    return [{k: float(v[p]) for k, v in d.items()} for p in range(P)]


def _store_line(t: dict) -> str:
    """The shard store's share of one traced step: codec and disk seconds,
    and the disk rate."""
    st = t.get("store")
    if not st:
        return ""
    io_s = st["spill_write_s"] + st["spill_read_s"]
    io_b = st["spill_write_bytes"] + st["spill_read_bytes"]
    return (f"; store: encode {st['encode_s']:.3f}s, decode {st['decode_s']:.3f}s, spill "
            f"{st['spill_write_bytes'] / 2**30:.2f} GiB out + {st['spill_read_bytes'] / 2**30:.2f}"
            f" GiB in in {io_s:.3f}s" + (f" ({io_b / io_s / 1e9:.2f} GB/s)" if io_s > 0 else ""))


def _print_offload(ex: ExecutionEngine) -> None:
    """What the offload backend's last run did: each streamed stage with the
    bytes it moved both ways and its rate, each host remap, each checkpoint,
    the store's codec and disk time, and the counters."""
    be = ex.backend
    if be.name != "offload":
        return
    stage = 0
    for t in be.trace:
        if t["kind"] == "stage":
            print(f"  offload stage {stage}: {t['ops']} ops, {t['bytes'] / 2**30:.2f} GiB moved "
                  f"in {t['seconds']:.3f}s ({t['bytes'] / t['seconds'] / 1e9:.2f} GB/s)"
                  + _store_line(t))
            stage += 1
        elif t["kind"] == "remap":
            print(f"  host remap {t['slot']}: {t['seconds']:.3f}s" + _store_line(t))
        elif t["kind"] == "checkpoint":
            print(f"  checkpoint after stage {t['stage']}: {t['bytes'] / 2**30:.2f} GiB saved "
                  f"in {t['seconds']:.3f}s")
        else:
            print(f"  {t['kind']}: {t['seconds']:.3f}s")
    print(f"  offload stats {be.stats}; overlap_ratio {be.overlap_ratio:.3f}")
    snap = be.storage_snapshot() if be.storage is not None else None
    if snap:
        print(f"storage: {snap['spilled_shards']}/{snap['n_shards']} shards at rest on disk "
              f"after run; {snap['spills']} spills, {snap['spill_loads']} reloads; error "
              f"bound {snap['relative_error_bound']:.3e} (tol {snap['error_tolerance']})")


def _print_results(results) -> None:
    for i, res in enumerate(results):
        bits = []
        if res.shots:
            bits.append("top " + ", ".join(f"{s}:{c}" for s, c in res.top(3)))
        bits += [f"<{k}>={v:+.4f}" for k, v in res.expectations.items()]
        print(f"  [{i}] " + "; ".join(bits))


def _launch_counts() -> np.ndarray:
    """This process's kernel launches so far: ``fused``, ``shm``, then the
    ``fused`` ones at k = 1..7."""
    c, by_k = kops.kernel_call_counts(), kops.fused_call_counts_by_k()
    return np.array([c["fused"], c["shm"]]
                    + [by_k.get(k, 0) for k in range(1, kops.FUSED_MAX_BITS + 1)], dtype=np.int64)


def _report_ranks(ex: ExecutionEngine, run: SimulateRun, before: np.ndarray) -> None:
    """Each rank's kernel launches since ``before`` and peak device memory
    into ``run.launches`` and ``run.peaks`` and, on the shardmap backend,
    the last run's remaps into ``run.remaps``, printed there. On the
    shardmap backend every rank calls it (it gathers over the ranks, as
    host tensors)."""
    peak = torch.cuda.max_memory_allocated(ex.device) if ex.device.type == "cuda" else 0
    mine = np.append(_launch_counts() - before, peak)
    per_rank = [mine]
    if ex.backend.name == "shardmap":
        tr, trace = ex.backend.transport, ex.backend.trace
        per_rank = tr.all_gather(mine)
        figs = tr.all_gather(np.array([[t["bytes_sent"], t["seconds"]] for t in trace],
                                      dtype=np.float64).reshape(-1, 2))
        run.remaps = [{"slot": t["slot"], "m": t["m"], "permute": t["permute"],
                       "bytes_sent": [int(f[i, 0]) for f in figs],
                       "seconds": max(float(f[i, 1]) for f in figs)}
                      for i, t in enumerate(trace)]
    run.peaks = [int(c[-1]) for c in per_rank]
    run.launches = [{"fused": int(c[0]), "shm": int(c[1]),
                     "by_k": {k: int(c[1 + k]) for k in range(1, kops.FUSED_MAX_BITS + 1)
                              if c[1 + k]}} for c in per_rank]
    if ex.backend.name == "shardmap":
        print("kernel launches per rank: " + "; ".join(
            f"{d}: {c['fused']} fused {c['by_k']}, {c['shm']} shm"
            for d, c in enumerate(run.launches)))
        if any(run.peaks):
            print("peak device memory per rank: "
                  + ", ".join(f"{p / 2**30:.2f} GiB" for p in run.peaks))
        for r in run.remaps:
            print(f"  remap {r['slot']}: m={r['m']}, permute {r['permute']}; bytes sent per rank "
                  f"{r['bytes_sent']}; {r['seconds']:.3f}s (slowest rank)")


def _fidelities(ex: ExecutionEngine, states: torch.Tensor, reference) -> List[float]:
    """--check: the fidelity of each logical state of ``states`` (``[2^n]``
    or ``[B, 2^n]``) against ``reference(i)``. On the shardmap backend
    ``states`` are this rank's shards: rank 0 gathers them, computes and
    broadcasts, so every rank returns the same list."""
    rows = states.reshape(-1, states.shape[-1])
    if ex.backend.name != "shardmap":
        return [fidelity(rows[i], reference(i)) for i in range(rows.shape[0])]
    tr = ex.backend.transport
    whole = tr.gather_rows(rows)
    f = np.zeros(rows.shape[0])
    if whole is not None:
        f = np.array([fidelity(whole[i], reference(i)) for i in range(whole.shape[0])])
    return [float(v) for v in tr.broadcast(f, 0)]


def _basis(n: int, b: int) -> np.ndarray:
    psi = np.zeros(1 << n, dtype=np.complex64)
    psi[b % (1 << n)] = 1.0
    return psi


def _basis_rows(B: int, n: int):
    """The batch of basis states ``|b mod 2^n>``, b < B, as ``rows(lo, hi)``:
    amplitudes ``[lo, hi)`` of each row (a shardmap rank builds only its
    own ``2^L`` columns)."""
    def rows(lo: int, hi: int) -> np.ndarray:
        out = np.zeros((B, hi - lo), dtype=np.complex64)
        idx = np.arange(B) % (1 << n)
        hit = np.nonzero((idx >= lo) & (idx < hi))[0]
        out[hit, idx[hit] - lo] = 1.0
        return out
    return rows


def _write_json(path: str, run: SimulateRun) -> None:
    """``--result-json``: the run's figures and results."""
    ex = run.engine

    def result(r: SimulationResult) -> dict:
        return {"samples": None if r.samples is None else r.samples.tolist(),
                "marginals": {",".join(map(str, q)): m.tolist() for q, m in r.marginals.items()},
                "expectations": dict(r.expectations)}

    doc = {"n": ex.n, "L": ex.L, "R": ex.R, "G": ex.G, "backend": ex.backend.name,
           "device": str(ex.device), "op_counts": ex.op_counts(), "seconds": run.seconds,
           "build_seconds": run.build_seconds, "fidelities": run.fidelities,
           "launches": run.launches, "peaks": run.peaks, "remaps": run.remaps,
           "energies": run.energies, "grad_seconds": run.grad_seconds,
           "first_grad": None if run.first_grad is None else run.first_grad.tolist(),
           "sweeps": run.sweeps, "adjoint_builds": ex.adjoint_builds,
           "results": [result(r) for r in ([run.result] if run.result else run.results)]}
    with open(path, "w") as f:
        json.dump(doc, f)


def main(argv=None) -> SimulateRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--circuit", default="qft", choices=sorted(FAMILIES) + sorted(PARAM_FAMILIES))
    ap.add_argument("--n", "--qubits", dest="n", type=int, default=16,
                    help="qubits (--qubits under torchrun: some Python versions' argparse "
                         "rejects --n after the script name there, as an abbreviation of "
                         "torchrun's own --nnodes and --nproc-per-node)")
    ap.add_argument("--L", type=int, default=0, help="local qubits (0: n-R-G)")
    ap.add_argument("--R", type=int, default=0)
    ap.add_argument("--G", type=int, default=0)
    ap.add_argument("--executor", default="cuda",
                    choices=["cuda", "offload", "shardmap", "pergate", "dense"],
                    help="cuda: the planned path through the hand-written kernels "
                         "(on --device); offload: the same with the state in host memory, "
                         "streamed through --device stage by stage; shardmap: one process per "
                         "device of the 2^(R+G) bit-mesh, each with one 2^L shard, started by "
                         "torchrun; pergate: the per-gate offload baseline (one pass over the "
                         "host state per gate); dense: the per-gate oracle behind the engine "
                         "API (implies --engine)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="--executor shardmap: the torch.distributed backend (default nccl "
                         "on cuda, one rank per card; gloo on cpu). Several ranks on one "
                         "card need gloo")
    ap.add_argument("--staging", default="ilp", choices=["ilp", "greedy"])
    ap.add_argument("--kernelizer", default="dp", choices=["dp", "ordered", "greedy"])
    ap.add_argument("--opt", dest="opt", action="store_true",
                    help="run the pre-staging circuit optimizer before planning; "
                         "--check compares with the circuit as written")
    ap.add_argument("--no-opt", dest="opt", action="store_false",
                    help="no pre-staging optimizer (default)")
    ap.set_defaults(opt=False)
    ap.add_argument("--autotune", action="store_true",
                    help="A/B-replay candidate plans first and serve the fastest (implies "
                         "--engine; the winner is cached under the default key)")
    ap.add_argument("--engine", action="store_true",
                    help="go through the compile cache (repro_torch.sim.engine.engine_for)")
    ap.add_argument("--batch", type=int, default=1,
                    help="run B basis initial states in one pass of the engine "
                         "(implies --engine)")
    ap.add_argument("--bind", action="append", default=[], metavar="NAME=VAL",
                    help="bind one circuit parameter (repeatable); required for "
                         "parameterized families unless --sweep is given")
    ap.add_argument("--sweep", default=None, metavar="FILE.json",
                    help="run a parameter sweep in one pass (implies --engine)")
    ap.add_argument("--vqe", default=None, metavar="OBSERVABLE",
                    help="minimize <H> over the circuit's free parameters with Adam over "
                         'adjoint-mode value_and_grad, e.g. --vqe "Z0 Z1 + Z1 Z2 + 0.5*X0" '
                         "(implies --engine)")
    ap.add_argument("--vqe-steps", type=int, default=30)
    ap.add_argument("--vqe-lr", type=float, default=0.1)
    ap.add_argument("--vqe-seed", type=int, default=0,
                    help="seed of the initial angles, uniform in [0, 2 pi)")
    ap.add_argument("--check", action="store_true",
                    help=f"fidelity vs the complex128 dense reference (n <= {CHECK_MAX_QUBITS})")
    ap.add_argument("--shots", type=int, default=0, help="sample N bitstrings")
    ap.add_argument("--seed", type=int, default=0, help="sampling PRNG seed")
    ap.add_argument("--marginal", action="append", default=[],
                    help="comma-separated qubit subset (repeatable)")
    ap.add_argument("--observable", action="append", default=[],
                    help='Pauli sum, e.g. "Z0 Z1 + 0.5*X2" (repeatable)')
    ap.add_argument("--storage", default=None, metavar="SPEC",
                    help="tiered at-rest shard store for --executor offload (implies "
                         "--engine): 'exact'|'bf16'|'int8' with optional ':dram_kib=N', "
                         "':dir=PATH', ':tol=X', e.g. 'int8:dram_kib=4096'. Shards past the "
                         "DRAM budget spill to disk")
    ap.add_argument("--dram-budget-mb", type=float, default=None,
                    help="at-rest DRAM budget in MiB for --storage (overrides any dram_kib "
                         "in the spec)")
    ap.add_argument("--spill-dir", default=None,
                    help="directory for spilled shard files (default: the system temp dir)")
    ap.add_argument("--storage-tol", type=float, default=None,
                    help="max accumulated quantization error bound before the run is "
                         "rejected (default 0.05)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="--executor offload: save the host state after every stage and "
                         "resume a killed run of the same circuit, binding and initial "
                         "state from DIR (implies --engine; not with --storage)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--result-json", default=None, metavar="FILE.json",
                    help="write the run's figures and results as JSON (rank 0 under "
                         "--executor shardmap)")
    args = ap.parse_args(argv)
    if args.executor == "pergate" and (args.engine or args.autotune or args.batch > 1
                                       or args.sweep is not None or args.vqe is not None):
        ap.error("--executor pergate is a baseline outside the engine: no --engine, "
                 "--autotune, --batch, --sweep or --vqe")
    if args.vqe is not None and args.circuit not in PARAM_FAMILIES:
        ap.error(f"--vqe needs a parameterized circuit ({', '.join(sorted(PARAM_FAMILIES))})")
    storage = None
    if args.storage is not None:
        if args.executor != "offload":
            ap.error("--storage requires --executor offload")
        storage = StorageConfig.parse(args.storage)
        if storage is not None:
            over = {}
            if args.dram_budget_mb is not None:
                over["dram_bytes"] = int(args.dram_budget_mb * (1 << 20))
            if args.spill_dir is not None:
                over["spill_dir"] = args.spill_dir
            if args.storage_tol is not None:
                over["error_tolerance"] = args.storage_tol
            if over:
                storage = storage.with_overrides(**over)
    if args.checkpoint_dir is not None:
        if args.executor != "offload":
            ap.error("--checkpoint-dir requires --executor offload")
        if storage is not None:
            ap.error("--checkpoint-dir and --storage are mutually exclusive")
    ctx = None
    if args.executor == "shardmap":
        try:
            ctx = launch_dist.join(args.dist_backend, args.device)
        except launch_dist.LaunchError as e:
            ap.error(str(e))
    elif args.dist_backend is not None:
        ap.error("--dist-backend needs --executor shardmap")
    try:
        # only rank 0 prints
        quiet = ctx is not None and ctx.rank != 0
        with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
            run = _simulate(ap, args, storage, ctx)
        if args.result_json is not None and not quiet:
            _write_json(args.result_json, run)
        return run
    finally:
        if ctx is not None:
            ctx.close()


def _simulate(ap, args, storage, ctx: Optional[launch_dist.RankContext]) -> SimulateRun:
    """``main`` after the flags are checked and the process is in its job."""
    if ctx is None:
        device = resolve_device(args.device)
    else:
        nb = args.R + args.G
        if ctx.world != 1 << nb:
            ap.error(f"--executor shardmap with R={args.R}, G={args.G} runs one rank per device "
                     f"of a 2^{nb} bit-mesh: launch {1 << nb} ranks (torchrun --nproc-per-node "
                     f"{1 << nb}), not {ctx.world}")
        device = ctx.device
        print(f"torch.distributed {ctx.backend}, world size {ctx.world}; devices by rank: "
              + ", ".join(ctx.devices()))
    n = args.n
    L = args.L or (n - args.R - args.G)
    if args.check and n > CHECK_MAX_QUBITS:
        ap.error(f"--check needs n <= {CHECK_MAX_QUBITS}")
    if args.batch < 1:
        ap.error("--batch must be at least 1")
    measuring = bool(args.shots or args.marginal or args.observable)
    if args.check and measuring and (args.batch > 1 or args.sweep is not None):
        ap.error("--check with --batch or --sweep compares states: leave out the measurements")
    circ = (FAMILIES.get(args.circuit) or PARAM_FAMILIES[args.circuit])(n)
    print(f"{args.circuit}(n={n}): {circ.n_gates} gates; L/R/G = {L}/{args.R}/{args.G}"
          f"; device {device}"
          + (f"; {len(circ.param_names)} free params" if not circ.is_bound else ""))
    marginals = [tuple(int(q) for q in spec.split(",")) for spec in args.marginal]
    binds = _parse_bind(args.bind)
    if not circ.is_bound and not binds and args.sweep is None and args.vqe is None:
        ap.error(f"circuit has free parameters {circ.param_names}; "
                 "pass --bind NAME=VAL, --sweep FILE.json or --vqe OBS")
    use_engine = (args.engine or args.autotune or args.batch > 1 or args.executor == "dense"
                  or args.sweep is not None or storage is not None
                  or args.checkpoint_dir is not None or args.vqe is not None)
    if not use_engine and (binds or not circ.is_bound):
        # the engine path binds after the cache lookup, so its key stays
        # parameter-blind; here the circuit is bound up front
        circ = circ.bind(binds)
        binds = {}
    # --check compares with the circuit as written, never the optimizer's
    # rewrite of it
    ref_circ = circ

    build_s = bind_s = None
    t0 = time.time()
    if use_engine:
        if args.autotune:
            from ..core.autotune import autotune_engine

            res = autotune_engine(circ, L, args.R, args.G, backend=args.executor, device=device,
                                  storage=storage, checkpoint_dir=args.checkpoint_dir)
            print(f"autotune: chose '{res.chosen}' ({res.speedup_vs_default:.2f}x vs default, "
                  f"{len(res.replay_us)} candidates, {res.tune_time_s:.1f}s"
                  f"{', cached' if res.cached else ''})")
        ex = engine_for(circ, L, args.R, args.G, backend=args.executor,
                        staging_method=args.staging, kernelize_method=args.kernelizer,
                        optimize=args.opt, device=device, storage=storage,
                        checkpoint_dir=args.checkpoint_dir)
        plan = ex.plan
        build_s = time.time() - t0
        st_cfg = getattr(ex.backend, "storage", None)
        if st_cfg is not None:
            budget = ("unbounded" if st_cfg.dram_bytes is None
                      else f"{st_cfg.dram_bytes / (1 << 20):.1f} MiB")
            print(f"storage: at-rest {st_cfg.at_rest_dtype}, DRAM budget {budget}, "
                  f"tol {st_cfg.error_tolerance}")
        print(f"engine[{ex.backend.name}] ready in {build_s:.2f}s; "
              f"cache: {len(DEFAULT_CACHE)} entries, {DEFAULT_CACHE.hits} hits"
              f"/{DEFAULT_CACHE.misses} misses")
        opt_prov = ex.provenance.get("optimize")
        if opt_prov:
            print(f"optimizer: {opt_prov['gates_before']} -> {opt_prov['gates_after']} gates "
                  f"(-{opt_prov['gates_removed']}; passes: {opt_prov['pass_counts']})")
        if binds:
            t0 = time.time()
            ex.bind(binds)
            _sync(device)
            bind_s = time.time() - t0
            print(f"bound {len(binds)} params in {bind_s:.3f}s "
                  "(tensor swap: no staging, kernelization or stage compile)")
    else:
        if args.opt:
            from ..core.optimize import optimize_circuit

            ores = optimize_circuit(circ)
            print(f"optimizer: {ores.source.n_gates} -> {ores.circuit.n_gates} gates "
                  f"(-{ores.gates_removed}; passes: {ores.pass_counts()})")
            circ = ores.circuit
        if args.executor == "pergate":
            return _pergate(args, circ, L, device, measuring, marginals, ref_circ, binds)
        plan = partition(circ, L, args.R, args.G, staging_method=args.staging,
                         kernelize_method=args.kernelizer)
        t0 = time.time()
        ex = ExecutionEngine(circ, plan, device=device, backend=args.executor)
        print(f"compiled in {time.time() - t0:.2f}s")
    print(f"partition: {plan.n_stages} stages, kernel cost {plan.total_kernel_cost:,.0f} us"
          f" (preprocess {plan.preprocess_time_s:.2f}s); program: "
          + ", ".join(f"{v} {k}" for k, v in sorted(ex.op_counts().items())))

    if args.vqe is not None:
        return _vqe(args, ex, plan, build_s, bind_s)

    def reference(bound, psi0=None):
        return simulate_np(bound if bound.is_bound else bound.bind(binds), psi0)

    # ----------------------------------------------------- parameter sweep
    if args.sweep is not None:
        points = _load_sweep(args.sweep)
        P = len(points)
        run = SimulateRun(engine=ex, plan=plan, state=None, result=None, seconds=0.0,
                          build_seconds=build_s, bind_seconds=bind_s)
        before = _launch_counts()
        _sync(device)
        t0 = time.time()
        if measuring:
            run.results = measure_sweep(ex, points, shots=args.shots, seed=args.seed,
                                        marginals=marginals, observables=args.observable)
            run.seconds = time.time() - t0
            print(f"sweep of {P} bindings simulated+measured in {run.seconds:.3f}s "
                  f"({run.seconds / P:.3f}s/point)")
            _print_results(run.results)
            _report_ranks(ex, run, before)
            return run
        run.state = ex.run_sweep(None, points)
        _sync(device)
        run.seconds = time.time() - t0
        print(f"sweep of {P} bindings in {run.seconds:.3f}s ({run.seconds / P:.3f}s/point, "
              "one structural compile)")
        _print_offload(ex)
        _report_ranks(ex, run, before)
        if args.check:
            run.fidelities = _fidelities(ex, run.state,
                                         lambda p: simulate_np(ref_circ.bind(points[p])))
            for p, f in enumerate(run.fidelities):
                print(f"  fidelity[{p}] vs dense reference: {f:.6f}")
        return run

    # ------------------------------------------------------- batched path
    if args.batch > 1:
        B = args.batch
        psi0s = _basis_rows(B, n)
        run = SimulateRun(engine=ex, plan=plan, state=None, result=None, seconds=0.0,
                          build_seconds=build_s, bind_seconds=bind_s)
        before = _launch_counts()
        _sync(device)
        t0 = time.time()
        if measuring:
            run.results = measure_batch(ex, psi0s, shots=args.shots, seed=args.seed,
                                        marginals=marginals, observables=args.observable)
            run.seconds = time.time() - t0
            print(f"batch of {B} simulated+measured in {run.seconds:.3f}s "
                  f"({run.seconds / B:.3f}s/state)")
            _print_results(run.results)
            _report_ranks(ex, run, before)
            return run
        run.state = ex.run_batch(psi0s)
        _sync(device)
        run.seconds = time.time() - t0
        print(f"batch of {B} simulated in {run.seconds:.3f}s ({run.seconds / B:.3f}s/state, "
              f"{B * circ.n_gates / run.seconds:,.0f} gates/s)")
        _print_offload(ex)
        _report_ranks(ex, run, before)
        if args.check:
            run.fidelities = _fidelities(ex, run.state,
                                         lambda b: reference(ref_circ, _basis(n, b)))
            for b, f in enumerate(run.fidelities):
                print(f"  fidelity[{b}] vs dense reference: {f:.6f}")
        return run

    # ------------------------------------------------------ single state
    before = _launch_counts()
    _sync(device)
    t0 = time.time()
    out = ex.run_packed() if measuring else ex.run()
    _sync(device)
    dt = time.time() - t0
    print(f"simulated in {dt:.3f}s ({circ.n_gates / dt:,.0f} gates/s, "
          f"{2**n / dt / 1e6:,.1f} Mamps/s)")
    _print_offload(ex)
    run = SimulateRun(engine=ex, plan=plan, state=out, result=None, seconds=dt,
                      build_seconds=build_s, bind_seconds=bind_s)
    _report_ranks(ex, run, before)

    if measuring:
        run.result = _measure(measurer_for(out, ex.measurement_frame, ex),
                              f"{ex.backend.name}-{device.type}", args, marginals)
    if args.check:
        logical = ex.finalize(out) if measuring else out
        run.fidelity = _fidelities(ex, logical, lambda _: reference(ref_circ))[0]
        run.fidelities.append(run.fidelity)
        print(f"fidelity vs dense reference: {run.fidelity:.6f}")
    return run


def _vqe(args, ex: ExecutionEngine, plan: SimulationPlan, build_s, bind_s) -> SimulateRun:
    """``--vqe``: Adam (:mod:`repro_torch.optim.adamw`, float32 moments, no
    decay or warmup, clip 10) over ``value_and_grad`` of the observable,
    from angles drawn with ``--vqe-seed``; one value_and_grad before the
    first step and one after each. The iterations must run no solver, miss
    no entry of the structural cache, schedule no ``shm`` program and build
    no adjoint program: each is checked, and a breach raises. The first
    call's launches (and peak) per rank are reported; on the shardmap
    backend every rank runs the loop alike, and the first call's sweep
    figures of every rank are gathered into ``run.sweeps``."""
    from ..core import kernelization, staging
    from ..optim.adamw import AdamWConfig, init as adam_init, update as adam_update

    names = ex.param_names
    rng = np.random.default_rng(args.vqe_seed)
    theta = torch.tensor(rng.uniform(0.0, 2 * np.pi, len(names)), dtype=torch.float32)
    cfg = AdamWConfig(lr=args.vqe_lr, weight_decay=0.0, warmup_steps=0,
                      total_steps=max(args.vqe_steps, 1), min_lr_frac=1.0,
                      moment_dtype="float32", clip_norm=10.0)
    opt = adam_init(cfg, theta)
    run = SimulateRun(engine=ex, plan=plan, state=None, result=None, seconds=0.0,
                      build_seconds=build_s, bind_seconds=bind_s, param_names=names)

    def step_grad():
        t0 = time.time()
        value, grads = ex.value_and_grad(args.vqe, params=theta.numpy())
        run.grad_seconds.append(time.time() - t0)
        run.energies.append(value)
        return value, grads

    before = _launch_counts()
    value, grads = step_grad()
    run.first_grad = np.asarray(grads, dtype=np.float64)
    print(f"VQE over {len(names)} params, H = {args.vqe}; first value+grad (incl. the "
          f"adjoint program's build) in {run.grad_seconds[0]:.3f}s")
    _report_ranks(ex, run, before)
    if ex.backend.name == "shardmap":
        _report_sweeps(ex, run, args.vqe)

    def warm_counts():
        return (dict(staging.SOLVER_CALLS), dict(kernelization.SOLVER_CALLS),
                set(ex._struct_cache), kops.SCHEDULE_CALLS["shm"], ex.adjoint_builds)

    counts = warm_counts()
    t0 = time.time()
    for step in range(args.vqe_steps):
        theta, opt, _ = adam_update(cfg, torch.as_tensor(grads, dtype=torch.float32), opt, theta)
        value, grads = step_grad()
        if step % max(args.vqe_steps // 10, 1) == 0 or step == args.vqe_steps - 1:
            print(f"  step {step:4d}: <H> = {value:+.6f}  |grad| = {float(np.linalg.norm(grads)):.4f}"
                  f"  ({run.grad_seconds[-1]:.3f}s)")
    run.seconds = time.time() - t0
    if warm_counts() != counts:
        raise RuntimeError("VQE iterations ran a solver, missed the structural cache, scheduled "
                           "an shm program or built an adjoint program")
    run.theta = theta.numpy()
    print(f"VQE done: <H> = {value:+.6f} after {args.vqe_steps} steps in {run.seconds:.2f}s "
          f"({run.seconds / max(args.vqe_steps, 1):.3f}s/step; no solver call, no structural-"
          "cache miss, no shm program scheduled, no adjoint program built)")
    return run


def _report_sweeps(ex: ExecutionEngine, run: SimulateRun, observable: str) -> None:
    """The shardmap backend's first sweep on every rank (each rank calls
    it): its forward run's, λ's, the gate applications' and the inverse
    remaps' seconds, and the bytes it sent and received against the
    sweep's bound, into ``run.sweeps`` and printed."""
    prog = ex.adjoint_program(observable)
    keys = ("forward_s", "lambda_s", "kernels_s", "remaps_s", "bytes_sent", "bytes_received",
            "bound", "pauli_launches")
    mine = dict(prog.last_sweep, forward_s=ex.timings["run_packed"]["last_us"] / 1e6,
                bound=prog.sweep_bytes_bound(), pauli_launches=prog.pauli_launches)
    rows = ex.backend.transport.all_gather(np.array([mine[k] for k in keys], dtype=np.float64))
    run.sweeps = [{k: (int(v) if k in ("bytes_sent", "bytes_received", "bound",
                                       "pauli_launches") else float(v))
                   for k, v in zip(keys, row)} for row in rows]
    for d, w in enumerate(run.sweeps):
        print(f"  sweep on rank {d}: forward {w['forward_s']:.3f}s, lambda {w['lambda_s']:.3f}s, "
              f"gates {w['kernels_s']:.3f}s, inverse remaps {w['remaps_s']:.3f}s; bytes sent "
              f"{w['bytes_sent']}, received {w['bytes_received']} (bound {w['bound']})")


def _measure(measurer, backend: str, args, marginals) -> SimulationResult:
    """Measure as the CLI's flags ask, and print what came out."""
    t0 = time.time()
    res = measure_to_result(measurer, backend=backend, shots=args.shots, seed=args.seed,
                            marginals=marginals, observables=args.observable)
    print(f"measured in {time.time() - t0:.3f}s")
    if args.shots:
        top = ", ".join(f"{b}:{c}" for b, c in res.top(8))
        print(f"  top counts ({args.shots} shots): {top}")
    for qs, m in res.marginals.items():
        head = np.array2string(m[:8], precision=4, suppress_small=True)
        print(f"  marginal{qs}: {head}{' ...' if m.size > 8 else ''}")
    for name, val in res.expectations.items():
        print(f"  <{name}> = {val:+.6f}")
    return res


def _pergate(args, circ, L, device, measuring, marginals, ref_circ, binds) -> SimulateRun:
    """``--executor pergate``: the per-gate offload baseline. Its state is
    in logical order, measured in shards of 2^L (identity frame)."""
    n = circ.n_qubits
    pg = PerGateOffloadExecutor(circ, L, device=device)
    t0 = time.time()
    out = pg.run()
    dt = time.time() - t0
    ex = pg.engine
    print(f"per-gate baseline: {sum(len(p.ops) for p in ex.cc.programs)} passes over the host "
          f"state in {dt:.3f}s; shard transfers {pg.stats['shard_transfers']}, host remaps "
          f"{pg.stats['host_remaps']}")
    res = None
    if measuring:
        res = _measure(StreamingMeasurer(out, Frame.identity(n, L), device),
                       f"pergate-{device.type}", args, marginals)
    run = SimulateRun(engine=ex, plan=ex.plan, state=out, result=res, seconds=dt)
    if args.check:
        run.fidelity = fidelity(out, simulate_np(ref_circ if ref_circ.is_bound
                                                 else ref_circ.bind(binds)))
        run.fidelities.append(run.fidelity)
        print(f"fidelity vs dense reference: {run.fidelity:.6f}")
    return run


if __name__ == "__main__":
    main()

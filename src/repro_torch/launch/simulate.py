"""End-to-end quantum circuit simulation on one device (the CLI).

The default single-state path of ``repro/launch/simulate.py``: generate a
circuit, partition it (ILP staging + DP kernelization), compile the plan,
run the staged engine, then measure. Runs on CUDA unless ``--device cpu``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit qft --n 22 \\
      --L 20 --R 2 --check
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit ising --n 30 \\
      --L 28 --R 2 --shots 1024 --marginal 0,1,2 --observable "Z0 Z1 + 0.5*X2"
  PYTHONPATH=src python -m repro_torch.launch.simulate --circuit qft --n 10 \\
      --L 8 --R 2 --check --device cpu
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.generators import FAMILIES
from ..core.partition import SimulationPlan, partition
from ..device import resolve_device
from ..sim.engine import ExecutionEngine
from ..sim.measure import TorchMeasurer, measure_to_result
from ..sim.result import SimulationResult
from ..sim.statevector import fidelity, simulate_np

CHECK_MAX_QUBITS = 24  # --check builds a host complex128 state


@dataclass
class SimulateRun:
    """What one run of the CLI produced: the engine (its compiled program and
    device), the plan, the state it ended with (the packed final-stage
    layout when it measured, logical order otherwise), the measurement
    result, the simulation's wall time, and the --check fidelity."""

    engine: ExecutionEngine
    plan: SimulationPlan
    state: torch.Tensor
    result: Optional[SimulationResult]
    seconds: float
    fidelity: Optional[float] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> SimulateRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--circuit", default="qft", choices=sorted(FAMILIES))
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--L", type=int, default=0, help="local qubits (0: n-R-G)")
    ap.add_argument("--R", type=int, default=0)
    ap.add_argument("--G", type=int, default=0)
    ap.add_argument("--staging", default="ilp", choices=["ilp", "greedy"])
    ap.add_argument("--kernelizer", default="dp", choices=["dp", "ordered", "greedy"])
    ap.add_argument("--check", action="store_true",
                    help=f"fidelity vs the complex128 dense reference (n <= {CHECK_MAX_QUBITS})")
    ap.add_argument("--shots", type=int, default=0, help="sample N bitstrings")
    ap.add_argument("--seed", type=int, default=0, help="sampling PRNG seed")
    ap.add_argument("--marginal", action="append", default=[],
                    help="comma-separated qubit subset (repeatable)")
    ap.add_argument("--observable", action="append", default=[],
                    help='Pauli sum, e.g. "Z0 Z1 + 0.5*X2" (repeatable)')
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    n = args.n
    L = args.L or (n - args.R - args.G)
    circ = FAMILIES[args.circuit](n)
    print(f"{args.circuit}(n={n}): {circ.n_gates} gates; L/R/G = {L}/{args.R}/{args.G}"
          f"; device {device}")
    measuring = bool(args.shots or args.marginal or args.observable)
    marginals = [tuple(int(q) for q in spec.split(",")) for spec in args.marginal]

    plan = partition(circ, L, args.R, args.G, staging_method=args.staging,
                     kernelize_method=args.kernelizer)
    print(f"partition: {plan.n_stages} stages, kernel cost {plan.total_kernel_cost:,.0f} us"
          f" (preprocess {plan.preprocess_time_s:.2f}s)")
    t0 = time.time()
    ex = ExecutionEngine(circ, plan, device=device)
    counts = ex.op_counts()
    print(f"compiled in {time.time() - t0:.2f}s: "
          + ", ".join(f"{v} {k}" for k, v in sorted(counts.items())))

    _sync(device)
    t0 = time.time()
    out = ex.run_packed() if measuring else ex.run()
    _sync(device)
    dt = time.time() - t0
    print(f"simulated in {dt:.3f}s ({circ.n_gates / dt:,.0f} gates/s, "
          f"{2**n / dt / 1e6:,.1f} Mamps/s)")

    res = None
    if measuring:
        t0 = time.time()
        res = measure_to_result(
            TorchMeasurer(out, ex.measurement_frame), backend=f"torch-{device.type}",
            shots=args.shots, seed=args.seed, marginals=marginals,
            observables=args.observable,
        )
        print(f"measured in {time.time() - t0:.3f}s")
        if args.shots:
            top = ", ".join(f"{b}:{c}" for b, c in res.top(8))
            print(f"  top counts ({args.shots} shots): {top}")
        for qs, m in res.marginals.items():
            head = np.array2string(m[:8], precision=4, suppress_small=True)
            print(f"  marginal{qs}: {head}{' ...' if m.size > 8 else ''}")
        for name, val in res.expectations.items():
            print(f"  <{name}> = {val:+.6f}")

    run = SimulateRun(engine=ex, plan=plan, state=out, result=res, seconds=dt)
    if args.check:
        if n > CHECK_MAX_QUBITS:
            ap.error(f"--check needs n <= {CHECK_MAX_QUBITS}")
        logical = ex.finalize(out) if measuring else out
        run.fidelity = fidelity(logical, simulate_np(circ))
        print(f"fidelity vs dense reference: {run.fidelity:.6f}")
    return run


if __name__ == "__main__":
    main()

"""Distributed quantum circuit simulation with explicit collectives; the twin
of ``examples/simulate_qft.py``.

Runs a 20-qubit QFT on a bit-mesh of 2^(R+G) = 8 ``torch.distributed``
ranks with the shardmap executor and compares every execution path with the
dense oracle: the planned engine on one device (the reference's pjit), the
shardmap executor with and without the hand kernels, and the host-offloaded
executor; then measures through ``simulate_and_measure`` on the shardmap,
one-device and offload backends. The reference fakes 8 XLA devices; the
port runs 8 processes. Started plainly, it spawns its own 8-rank gloo group
(on the card every rank runs on it); under ``torchrun`` it uses the group
it is given. Runs on the card unless given ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.simulate_qft [--device cpu]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
        -m repro_torch.examples.simulate_qft --dist-backend gloo

Rank 0 prints; the one-device and offload paths run on rank 0 while the
other ranks wait. ``kernel launches:`` sums every rank's.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.generators import qft
from ..core.partition import partition
from ..device import resolve_device
from ..kernels import ops as kops
from ..launch import dist as launch_dist
from ..sim.collective import Transport
from ..sim.executor import StagedExecutor
from ..sim.measure import expectation_np, marginal_np, simulate_and_measure
from ..sim.offload import OffloadedExecutor
from ..sim.ranks import run_ranks
from ..sim.shardmap_executor import ShardMapExecutor
from ..sim.statevector import fidelity, simulate

OBS = "Z0 Z1 + 0.5*X0"
MARGINAL = (0, 1, 2)


def _launches() -> np.ndarray:
    """This process's kernel launches: fused, shm, then fused by k = 1..7."""
    by_k = kops.fused_call_counts_by_k()
    calls = kops.kernel_call_counts()
    return np.array([calls["fused"], calls["shm"]]
                    + [by_k.get(k, 0) for k in range(1, kops.FUSED_MAX_BITS + 1)], dtype=np.int64)


def _rank(rank: int, n: int, L: int, R: int, G: int, shots: int, seed: int,
          device_type: str, backend: Optional[str], t_launch: Optional[float]) -> Dict:
    """One rank's share of the example; rank 0 prints and returns the figures."""
    ctx = launch_dist.join(backend, device_type, what="simulate_qft runs one process per rank "
                           "of the bit-mesh", example="repro_torch.examples.simulate_qft")
    try:
        return _paths(ctx, n, L, R, G, shots, seed, t_launch)
    finally:
        ctx.close()


def _paths(ctx, n: int, L: int, R: int, G: int, shots: int, seed: int,
           t_launch: Optional[float]) -> Dict:
    joined = None if t_launch is None else time.time() - t_launch
    dev = ctx.device
    lead = ctx.rank == 0
    world = 1 << (R + G)
    if ctx.world != world:
        raise ValueError(f"the bit-mesh of R={R}, G={G} needs {world} ranks, the group has "
                         f"{ctx.world}")
    transport = Transport(None, dev)
    kops.reset_kernel_counters()

    def say(msg: str = "") -> None:
        if lead:
            print(msg, flush=True)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    circuit = qft(n)
    plan = partition(circuit, L, R, G)
    say(f"qft({n}): {circuit.n_gates} gates -> {plan.n_stages} stages, "
        f"{sum(len(s.kernels) for s in plan.stages)} kernels "
        f"(2^{L} amps/shard on {world} ranks)")
    ref = simulate(circuit, device=dev)
    lo = ctx.rank << L
    seconds: Dict[str, float] = {}
    fids: Dict[str, float] = {}

    def timed(name: str, label: str, fn: Callable[[], torch.Tensor], whole: bool) -> None:
        """Run ``fn`` (rank 0 alone when ``whole``: a path on one device);
        its state's fidelity against the oracle, the shards' summed over
        the ranks."""
        transport.all_reduce_sum(torch.zeros(1))  # start together
        t0 = time.perf_counter()
        out = fn() if (lead or not whole) else None
        sync()
        transport.all_reduce_sum(torch.zeros(1))
        seconds[name] = time.perf_counter() - t0
        say(f"  {label:28s} {seconds[name]:6.2f}s")
        if whole:
            fids[name] = fidelity(out, ref) if lead else 0.0
            return
        part = torch.vdot(ref[lo:lo + (1 << L)].to(torch.complex128),
                          out.reshape(-1).to(torch.complex128))
        tot = transport.all_reduce_sum(torch.tensor([part.real.item(), part.imag.item()],
                                                    dtype=torch.float64))
        fids[name] = float(torch.complex(tot[0], tot[1]).abs())

    timed("cuda", "one device (the pjit twin)",
          lambda: StagedExecutor(circuit, plan, device=dev).run(), whole=True)
    timed("shardmap", "shardmap (explicit a2a)",
          lambda: ShardMapExecutor(circuit, plan, use_kernels=False, device=dev).run(), whole=False)
    timed("shardmap+kernels", "shardmap + CUDA kernels",
          lambda: ShardMapExecutor(circuit, plan, use_kernels=True, device=dev).run(), whole=False)
    timed("offloaded", "host-DRAM offloaded", lambda: OffloadedExecutor(
        circuit, partition(circuit, L, n - L, 0), device=dev).run(), whole=True)
    for name, f in fids.items():
        if lead:  # the one-device paths ran on rank 0 alone
            say(f"  fidelity[{name}] = {f:.8f}")
            assert f > 0.9999, name

    # --- measurement API: consume the state through shots / marginals /
    # Pauli expectations instead of gathering 2^n amplitudes. The planned
    # backends measure in the final stage's layout (no closing remap).
    say(f"\nmeasurement ({shots} shots, marginal over qubits 0-2, <{OBS}>):")
    host = ref.cpu().numpy() if lead else None
    e_ref = expectation_np(host, OBS) if lead else 0.0
    m_ref = marginal_np(host, MARGINAL) if lead else None
    measured: Dict[str, Dict] = {}
    for backend in ("shardmap", "cuda", "offload"):
        if backend != "shardmap" and not lead:
            continue
        off = backend == "offload"
        t0 = time.perf_counter()
        res = simulate_and_measure(
            circuit, backend=backend, plan=None if off else plan, L=L,
            R=n - L if off else R, G=0 if off else G, shots=shots, seed=seed,
            marginals=[MARGINAL], observables=OBS, device=dev)
        if not lead:
            continue
        e = res.expectation(OBS)  # accessor canonicalizes the key
        m = res.marginal(MARGINAL)
        top = ", ".join(f"{b}:{c}" for b, c in res.top(3))
        say(f"  {backend:9s} <obs>={e:+.6f} (ref {e_ref:+.6f})  top: {top}")
        assert abs(e - e_ref) < 1e-4, backend
        assert np.abs(m - m_ref).max() < 1e-5, backend
        measured[backend] = {"expectation": e, "marginal": m.tolist(),
                             "seconds": time.perf_counter() - t0}

    launches = np.sum(transport.all_gather(_launches()), axis=0)
    joins = transport.all_gather(np.array([-1.0 if joined is None else joined]))
    counts = {"fused": int(launches[0]), "shm": int(launches[1]),
              "by_k": {k: int(c) for k, c in enumerate(launches[2:], 1) if c}}
    say(f"kernel launches: {json.dumps(counts)}")
    launch_s = None if joined is None else float(max(j[0] for j in joins))
    if launch_s is not None:
        say(f"launch: {world} ranks joined their group {launch_s:.2f}s after the start")
    return {"rank": ctx.rank, "fidelities": fids, "seconds": seconds, "measured": measured,
            "expectation_ref": e_ref, "launches": counts, "launch_s": launch_s}


def run(n: int = 20, L: int = 17, R: int = 2, G: int = 1, shots: int = 512, seed: int = 0,
        device: str = "cuda", dist_backend: Optional[str] = None,
        timeout: float = 600.0) -> Dict:
    """The example at ``qft(n)``, ``2^L`` amplitudes a shard on ``2^(R+G)``
    ranks: in this process's group (or under torchrun), else in a gloo
    group of spawned ranks, one thread each. Returns rank 0's figures
    (fidelity and seconds by path, each backend's measurements, the
    kernel launches of all ranks, and the spawned ranks' launch seconds);
    under torchrun, this rank's (``"rank"``: which)."""
    device_type = resolve_device(device).type  # CUDA asked for and absent raises here
    if dist.is_initialized() or all(v in os.environ for v in launch_dist.TORCHRUN_VARS):
        return _rank(-1, n, L, R, G, shots, seed, device_type, dist_backend, None)
    if dist_backend not in (None, "gloo"):
        raise ValueError("a spawned group runs over gloo (several ranks share one card)")
    if device_type == "cuda":
        from ..kernels import build

        build.build()  # once, before the ranks load the kernels
    rendezvous = tempfile.mkdtemp(prefix="simulate_qft-")
    try:
        outs = run_ranks(_rank, 1 << (R + G), rendezvous, timeout=timeout, threads=1,
                         args=(n, L, R, G, shots, seed, device_type, None, time.time()))
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)
    return outs[0]


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="under torchrun: the group's backend (nccl on cuda, one rank per "
                         "card; gloo on cpu, or several ranks on one card)")
    args = ap.parse_args(argv)
    out = run(device=args.device, dist_backend=args.dist_backend)
    if out["rank"] == 0:
        print("OK")
    return out


if __name__ == "__main__":
    main()

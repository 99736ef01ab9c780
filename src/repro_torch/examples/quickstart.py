"""Quickstart: the full Atlas pipeline on one device in under a minute; the
twin of ``examples/quickstart.py``.

Builds a 12-qubit QFT circuit, partitions it hierarchically (ILP staging +
DP kernelization), simulates it with the staged executor through the hand
kernels, and verifies the result against the dense reference simulator.
Runs on the card unless given ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

from ..core.generators import qft
from ..core.partition import partition
from ..kernels import ops as kops
from ..sim.executor import StagedExecutor
from ..sim.statevector import fidelity, simulate

KINDS = {0: "fusion", 1: "shm", 2: "insular"}


def run(n: int = 12, R: int = 2, G: int = 1, device=None) -> Dict:
    """The example at ``qft(n)`` on ``2^(R+G)`` shards of ``2^(n-3)``
    amplitudes; returns the plan, the state, its fidelity and the kernel
    launches of the staged run."""
    circuit = qft(n)
    print(f"qft({n}): {circuit.n_gates} gates")

    # Hierarchical partitioning for a (virtual) 1-pod machine with
    # 2^2 = 4 accelerators (R=2) x 2 pods (G=1), 2^9 amplitudes per shard.
    plan = partition(circuit, L=n - 3, R=R, G=G)
    print(f"staging: {plan.n_stages} stages "
          f"(ILP objective = {plan.staging_objective} qubit moves)")
    for i, st in enumerate(plan.stages):
        ks = ", ".join(f"{KINDS[k.kind]}({k.n_qubits}q x{len(k.gate_ids)}g)"
                       for k in st.kernels)
        print(f"  stage {i}: {len(st.gate_ids)} gates -> {ks}")
    print(f"modeled kernel cost: {plan.total_kernel_cost:,.0f} us/shard")

    kops.reset_kernel_counters()
    ex = StagedExecutor(circuit, plan, device=device)
    out = ex.run()
    launches = dict(kops.kernel_call_counts(), by_k=kops.fused_call_counts_by_k())
    ref = simulate(circuit, device=device)
    f = fidelity(out, ref)
    print(f"fidelity vs dense reference: {f:.8f}")
    print(f"compiled ops: {json.dumps(ex.op_counts())}")
    print(f"kernel launches: {json.dumps(launches)}")
    assert f > 0.9999
    return {"plan": plan, "state": out, "fidelity": f, "launches": launches}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    print("OK")
    return out


if __name__ == "__main__":
    main()

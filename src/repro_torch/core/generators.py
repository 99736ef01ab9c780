"""Scalable benchmark circuit families (paper Table I, MQT-Bench/NWQBench style).

(Copied from ``repro/core/generators.py`` so this package imports nothing of the
JAX package; only imports differ.)

Gate counts are calibrated against Table I of the paper (exact for ghz, qft,
qpeexact, qsvm, wstate, su2random, ae, vqc, ising±1, dj±1; graphstate exact).
``hhl`` reproduces the Appendix C2 case study shape: #gates >> #qubits.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np

from .circuit import Circuit
from .gates import Param


def ghz(n: int) -> Circuit:
    """GHZ state: n gates."""
    c = Circuit(n)
    c.add("h", 0)
    for i in range(n - 1):
        c.add("cx", i + 1, i)  # target=i+1 (low bit), control=i (high bit)
    return c


def dj(n: int, seed: int = 7) -> Circuit:
    """Deutsch-Jozsa with a balanced oracle: ~3n gates (Table I: 3n-2)."""
    del seed  # deterministic balanced oracle, calibrated to Table I (3n-2)
    c = Circuit(n)
    anc = n - 1
    c.add("x", anc)
    for q in range(n - 1):
        c.add("h", q)
    c.add("h", anc)
    # balanced oracle: CX from qubits 0..n-4 onto the ancilla
    for q in range(max(1, n - 3)):
        c.add("cx", anc, q)
    for q in range(n - 1):
        c.add("h", q)
    return c


def graphstate(n: int, seed: int = 11) -> Circuit:
    """Graph state on a degree-2 random-ring graph: 2n gates."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for q in range(n):
        c.add("h", q)
    perm = rng.permutation(n)
    for i in range(n):
        a, b = int(perm[i]), int(perm[(i + 1) % n])
        c.add("cz", a, b)
    return c


def ising(n: int, steps: int = 5, seed: int = 13) -> Circuit:
    """Trotterized transverse-field Ising: n + steps*(2n-1) gates (303 @ n=28)."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for q in range(n):
        c.add("h", q)
    for _ in range(steps):
        for q in range(n - 1):
            c.add("rzz", q, q + 1, params=(float(rng.uniform(0.1, 1.0)),))
        for q in range(n):
            c.add("rx", q, params=(float(rng.uniform(0.1, 1.0)),))
    return c


def qft(n: int) -> Circuit:
    """Quantum Fourier transform (no final swaps): n + n(n-1)/2 gates."""
    c = Circuit(n)
    for i in range(n - 1, -1, -1):
        c.add("h", i)
        for j in range(i - 1, -1, -1):
            c.add("cp", j, i, params=(math.pi / (2 ** (i - j)),))
    return c


def iqft_on(c: Circuit, qs: List[int]) -> None:
    m = len(qs)
    for i in range(m):
        for j in range(i):
            c.add("cp", qs[j], qs[i], params=(-math.pi / (2 ** (i - j)),))
        c.add("h", qs[i])


def qpeexact(n: int) -> Circuit:
    """Exact quantum phase estimation: 1 eigenstate qubit + n-1 estimation."""
    c = Circuit(n)
    t = n - 1  # eigenstate qubit
    c.add("x", t)
    for j in range(n - 1):
        c.add("h", j)
    theta = 2 * math.pi * (1.0 / 2 ** (n - 1))
    for j in range(n - 1):
        c.add("cp", t, j, params=(theta * (2**j),))
    iqft_on(c, list(range(n - 1)))
    return c


def qsvm(n: int, seed: int = 17) -> Circuit:
    """ZZ-feature-map (2 reps): 2*(2n + 3(n-1)) = 10n-6 gates."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for _ in range(2):
        for q in range(n):
            c.add("h", q)
        for q in range(n):
            c.add("p", q, params=(float(rng.uniform(0, 2 * math.pi)),))
        for q in range(n - 1):
            c.add("cx", q + 1, q)
            c.add("p", q + 1, params=(float(rng.uniform(0, 2 * math.pi)),))
            c.add("cx", q + 1, q)
    return c


def su2random(n: int, reps: int = 3, seed: int = 19) -> Circuit:
    """SU2 ansatz, full entanglement: 4n + reps*n(n-1)/2 gates (1246 @ n=28)."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)

    def rot_layer():
        for q in range(n):
            c.add("ry", q, params=(float(rng.uniform(0, 2 * math.pi)),))
        for q in range(n):
            c.add("rz", q, params=(float(rng.uniform(0, 2 * math.pi)),))

    rot_layer()
    for _ in range(reps):
        for i in range(n):
            for j in range(i + 1, n):
                c.add("cx", j, i)
    rot_layer()
    return c


def vqc(n: int, reps: int = 4, seed: int = 23) -> Circuit:
    """Variational classifier: 2n^2 + 11n - 3 gates (1873 @ n=28)."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)

    def rot_layer():
        for q in range(n):
            c.add("ry", q, params=(float(rng.uniform(0, 2 * math.pi)),))
        for q in range(n):
            c.add("rz", q, params=(float(rng.uniform(0, 2 * math.pi)),))

    rot_layer()  # encoding
    for _ in range(reps):
        for i in range(n):
            for j in range(i + 1, n):
                c.add("cx", j, i)
        rot_layer()
    for q in range(n - 1):  # final ladder: 3(n-1)
        c.add("cx", q + 1, q)
        c.add("ry", q + 1, params=(float(rng.uniform(0, 2 * math.pi)),))
        c.add("cx", q + 1, q)
    return c


def wstate(n: int) -> Circuit:
    """W state (Cruz et al. construction): 1 + 4(n-1) gates (109 @ n=28)."""
    c = Circuit(n)
    c.add("x", n - 1)
    for i in range(n - 1, 0, -1):
        # F gate (control q_i, target q_{i-1}) followed by CX
        theta = math.acos(math.sqrt(1.0 / (i + 1)))
        c.add("ry", i - 1, params=(-theta,))
        c.add("cz", i - 1, i)
        c.add("ry", i - 1, params=(theta,))
        c.add("cx", i, i - 1)
    return c


def ae(n: int) -> Circuit:
    """Amplitude estimation: n(n+9)/2 - 4 gates (514 @ n=28)."""
    c = Circuit(n)
    t = n - 1
    theta = 2 * math.asin(math.sqrt(0.3))
    c.add("ry", t, params=(theta,))
    for j in range(n - 1):
        c.add("h", j)
    for j in range(n - 1):
        # controlled-Grover^(2^j): 4-gate cry decomposition
        a = theta * (2**j)
        c.add("ry", t, params=(a / 2,))
        c.add("cx", t, j)
        c.add("ry", t, params=(-a / 2,))
        c.add("cx", t, j)
    iqft_on(c, list(range(n - 1)))
    return c


def hhl(n_problem: int, n_total: int = 28) -> Circuit:
    """HHL-like circuit padded to ``n_total`` qubits (Appendix C2 case study).

    Gate count grows ~exponentially with ``n_problem`` via the controlled-
    rotation cascade over all clock-register basis states.
    """
    n = max(n_total, n_problem)
    c = Circuit(n)
    clock = list(range(1, n_problem - 1)) if n_problem > 2 else [1]
    b = 0  # solution qubit
    anc = n_problem - 1 if n_problem > 2 else 2
    c.add("x", b)
    for q in clock:
        c.add("h", q)
    for j, q in enumerate(clock):
        c.add("cp", b, q, params=(math.pi / 2 ** (j + 1),))
    iqft_on(c, clock)
    # eigenvalue-conditioned rotations: one multi-controlled ry per basis state,
    # decomposed into a cx/ry ladder => exponential gate count in |clock|
    for basis in range(1, 2 ** len(clock)):
        ang = 2 * math.asin(min(1.0, 0.5 / max(basis, 1)))
        prev = None
        for bit, q in enumerate(clock):
            if (basis >> bit) & 1:
                if prev is not None:
                    c.add("cx", q, prev)
                prev = q
        c.add("ry", anc, params=(ang / 2,))
        c.add("cx", anc, prev)
        c.add("ry", anc, params=(-ang / 2,))
        c.add("cx", anc, prev)
    iqft_on(c, clock)  # (stand-in for uncompute)
    for q in clock:
        c.add("h", q)
    return c


def redundant(n: int, reps: int = 2, seed: int = 29) -> Circuit:
    """Cancellation-rich family for the pre-staging circuit optimizer.

    Deliberately wasteful on three axes the optimizer targets:

    * **inverse pairs** — h·h and cx·cx that drop entirely, including
      long-range cx/swap pairs between qubit 0 and qubit n-1 whose literal
      staging must localize both endpoints (extra stages the optimized plan
      never pays);
    * **mergeable rotation runs** — three adjacent rz per qubit that fold to
      one;
    * **commuting diagonal blocks** — cp's interleaved with off-qubit h's,
      so only commutation-aware reordering can sink them together.

    A qft-like entangling backbone survives optimization, keeping the
    planned circuit non-trivial. Used by ``benchmarks/bench_optimize.py``,
    where the optimizer must *strictly* reduce both gate count and stage
    count on this family.
    """
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for q in range(n):
        c.add("h", q)
    for _ in range(reps):
        for q in range(n):
            c.add("h", q)
            c.add("h", q)
        for q in range(n - 1):
            c.add("cx", q + 1, q)
            c.add("cx", q + 1, q)
        if n >= 2:
            # long-range redundancy: forces qubits 0 and n-1 co-local in the
            # literal plan (swap is non-insular on BOTH qubits)
            c.add("cx", 0, n - 1)
            c.add("cx", 0, n - 1)
            c.add("swap", 0, n - 1)
            c.add("swap", 0, n - 1)
        for q in range(n):
            for _k in range(3):
                c.add("rz", q, params=(float(rng.uniform(0.1, 1.0)),))
        for q in range(n - 1):
            c.add("cx", q + 1, q)
        for q in range(n - 1):
            c.add("cp", q, q + 1, params=(float(rng.uniform(0.1, 1.0)),))
            c.add("h", (q + 2) % n)
    for q in range(n):
        c.add("h", q)
    return c


def su2param(n: int, reps: int = 3) -> Circuit:
    """Symbolic su2random: the same structure as :func:`su2random` but every
    rotation angle is a free :class:`Param` (``r{layer}_{q}`` names). This is
    the canonical parameterized-serving workload — one structural compile,
    many bindings (VQE/QSVM-style sweeps)."""
    c = Circuit(n)

    def rot_layer(tag: str):
        for q in range(n):
            c.add("ry", q, params=[Param(f"ry{tag}_{q}")])
        for q in range(n):
            c.add("rz", q, params=[Param(f"rz{tag}_{q}")])

    rot_layer("0")
    for _ in range(reps):
        for i in range(n):
            for j in range(i + 1, n):
                c.add("cx", j, i)
    rot_layer("1")
    return c


def ising_param(n: int, steps: int = 2) -> Circuit:
    """Symbolic Trotterized Ising: shared ``J`` (coupling) and ``h`` (field)
    parameters across all layers — exercises parameter *sharing* (one name
    bound into many gates) through the rebinding pass."""
    c = Circuit(n)
    for q in range(n):
        c.add("h", q)
    for _ in range(steps):
        for q in range(n - 1):
            c.add("rzz", q, q + 1, params=[Param("J")])
        for q in range(n):
            c.add("rx", q, params=[Param("h")])
    return c


def random_circuit(n: int, n_gates: int, seed: int = 0, two_qubit_frac: float = 0.45) -> Circuit:
    """Random circuit for property tests."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    one_q = ["h", "x", "y", "z", "s", "t", "rx", "ry", "rz", "p", "sx"]
    two_q = ["cx", "cz", "cp", "swap", "rzz", "crz", "cry"]
    from . import gates as G

    while c.n_gates < n_gates:
        if n >= 2 and rng.random() < two_qubit_frac:
            name = two_q[rng.integers(len(two_q))]
            a, b_ = rng.choice(n, size=2, replace=False)
            qs = (int(a), int(b_))
        else:
            name = one_q[rng.integers(len(one_q))]
            qs = (int(rng.integers(n)),)
        npar = G.GATE_DEFS[name].n_params
        params = tuple(float(rng.uniform(0.1, 2 * math.pi)) for _ in range(npar))
        c.add(name, *qs, params=params)
    return c


# Symbolic (parameterized) families: excluded from FAMILIES so the
# whole-family benchmark sweeps stay value-executable without binding; the
# launch CLI exposes them behind --bind/--sweep.
PARAM_FAMILIES: Dict[str, Callable[[int], Circuit]] = {
    "su2param": su2param,
    "isingparam": ising_param,
}

FAMILIES: Dict[str, Callable[[int], Circuit]] = {
    "ghz": ghz,
    "dj": dj,
    "graphstate": graphstate,
    "ising": ising,
    "qft": qft,
    "qpeexact": qpeexact,
    "qsvm": qsvm,
    "redundant": redundant,
    "su2random": su2random,
    "vqc": vqc,
    "wstate": wstate,
    "ae": ae,
}

# Table I gate counts (paper) for the calibration test.
TABLE_I = {
    "ae": {28: 514, 32: 652, 36: 806},
    "dj": {28: 82, 32: 94, 36: 106},
    "ghz": {28: 28, 32: 32, 36: 36},
    "graphstate": {28: 56, 32: 64, 36: 72},
    "ising": {28: 302, 32: 346, 36: 390},
    "qft": {28: 406, 32: 528, 36: 666},
    "qpeexact": {28: 432, 32: 559, 36: 701},
    "qsvm": {28: 274, 32: 314, 36: 354},
    "su2random": {28: 1246, 32: 1616, 36: 2034},
    "vqc": {28: 1873, 32: 2397, 36: 2985},
    "wstate": {28: 109, 32: 125, 36: 141},
}

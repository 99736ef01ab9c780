"""Uniform measurement result object returned by every backend.

(Copied from ``repro/sim/result.py`` so this package imports nothing of the
JAX package; only imports differ.)

A :class:`SimulationResult` is what a caller actually consumes: sampled
bitstrings, marginal distributions over qubit subsets, and Pauli-observable
expectation values — never the raw ``2^n`` amplitude vector (which is
meaningless to gather beyond ~30 qubits). All payloads are host-side numpy,
small (``O(shots + 2^|subset|)``), and backend-agnostic.

Conventions:

* a *sample* is the integer basis-state index in **logical** qubit order
  (logical qubit ``q`` = index bit ``q``, bit 0 least significant);
* a *bitstring* renders qubit ``n-1`` leftmost (standard MSB-first notation);
* a marginal over ``qubits=(q0, q1, ...)`` is a vector of length
  ``2^len(qubits)`` whose index bit ``j`` is the value of ``qubits[j]``.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


def index_to_bitstring(index: int, n_qubits: int) -> str:
    """Render a logical basis-state index MSB-first (qubit n-1 leftmost)."""
    return format(index, f"0{n_qubits}b")


def bitstring_to_index(bits: str) -> int:
    return int(bits, 2)


@dataclass
class SimulationResult:
    """Everything a measurement pass produced, in one place."""

    n_qubits: int
    backend: str
    shots: int = 0
    seed: int = 0
    samples: Optional[np.ndarray] = None  # [shots] int64 logical indices
    marginals: Dict[Tuple[int, ...], np.ndarray] = field(default_factory=dict)
    expectations: Dict[str, float] = field(default_factory=dict)
    meta: Dict[str, float] = field(default_factory=dict)

    # ------------------------------------------------------------- samples
    def bitstrings(self) -> List[str]:
        """Sampled shots as MSB-first bitstrings."""
        if self.samples is None:
            return []
        return [index_to_bitstring(int(s), self.n_qubits) for s in self.samples]

    def counts(self) -> Dict[str, int]:
        """Histogram of sampled bitstrings (Qiskit-style ``get_counts``)."""
        return dict(Counter(self.bitstrings()))

    def top(self, k: int = 10) -> List[Tuple[str, int]]:
        """The ``k`` most frequent sampled bitstrings with their counts."""
        return Counter(self.bitstrings()).most_common(k)

    def probability_of(self, bits: str) -> float:
        """Empirical probability of one bitstring among the sampled shots."""
        if not self.shots:
            return 0.0
        return self.counts().get(bits, 0) / self.shots

    # ----------------------------------------------------------- accessors
    def marginal(self, qubits) -> np.ndarray:
        return self.marginals[tuple(qubits)]

    def expectation(self, observable: str) -> float:
        """Look up by the observable string as the caller wrote it (keys are
        stored canonicalized, e.g. ``"Z0 + 2"`` -> ``"1*Z0 + 2*I"``)."""
        if observable in self.expectations:
            return self.expectations[observable]
        from .measure import PauliSum

        return self.expectations[str(PauliSum.coerce(observable))]

    def __repr__(self) -> str:  # compact, log-friendly
        parts = [f"SimulationResult(n={self.n_qubits}, backend={self.backend!r}"]
        if self.shots:
            parts.append(f", shots={self.shots}")
        if self.marginals:
            parts.append(f", marginals={sorted(self.marginals)}")
        if self.expectations:
            exp = ", ".join(f"{k!r}: {v:.6g}" for k, v in self.expectations.items())
            parts.append(f", expectations={{{exp}}}")
        return "".join(parts) + ")"

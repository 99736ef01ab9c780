"""Measurement, sampling & observables over the engine's device state.

The twin of ``repro/sim/measure.py``: shots, marginals and Pauli
expectations are computed from the packed state in the final stage's
physical layout (``run_packed`` skips the final remap), and a
:class:`Frame` maps physical bits back to logical qubits on indices only.

* **shot sampling** — two-level inverse-CDF with uniforms from
  ``np.random.default_rng(seed)``: the ``[2^(R+G)]`` shard masses pick the
  shard, then that shard's local CDF, built in float64 on the host exactly
  as the reference builds it, picks the amplitude. So a seed gives the
  reference's shots;
* **marginals** — one reduction on the device over the non-kept bits;
* **Pauli expectations** — basis changes ``H`` (X) and ``H·S†`` (Y) on the
  device, then a signed reduction.

:class:`PauliSum`, :class:`Frame`, the :class:`Measurer` base class and the
complex128 oracles :func:`expectation_np` / :func:`marginal_np` are copied
from the reference unchanged; :class:`TorchMeasurer` replaces its
``ShardedMeasurer``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import gates as G
from .apply import apply_matrix_bits, sum_bits
from .result import SimulationResult

# basis-change matrices: V with V† Z V = P  =>  <psi|P|psi> = sum |V psi|^2 * sign
_BASIS_CHANGE = {
    "X": G.H,  # H Z H = X
    "Y": G.H @ G.SDG,  # (H S†)† Z (H S†) = Y
}
# X_p P X_p = corr * P — correction when the measured bit carries a lazy flip
_FLIP_CORRECTION = {"X": 1.0, "Y": -1.0, "Z": -1.0}


# ======================================================================
# Pauli observables
# ======================================================================


_TERM_RE = re.compile(
    r"^\s*([+-]?\s*(?:\d+\.?\d*|\.\d+)?)\s*\*?\s*((?:[IXYZixyz]\s*\d+\s*)*)$"
)
_OP_RE = re.compile(r"([IXYZixyz])\s*(\d+)")


@dataclass(frozen=True)
class PauliTerm:
    """``coeff * P_{q0} P_{q1} ...`` with ``ops`` sorted by qubit."""

    coeff: float
    ops: Tuple[Tuple[int, str], ...]  # ((qubit, 'X'|'Y'|'Z'), ...)

    def __str__(self) -> str:
        body = " ".join(f"{p}{q}" for q, p in self.ops) or "I"
        return f"{self.coeff:g}*{body}"


@dataclass(frozen=True)
class PauliSum:
    """A real-weighted sum of Pauli strings (a Hermitian observable)."""

    terms: Tuple[PauliTerm, ...]

    @staticmethod
    def parse(text: str) -> "PauliSum":
        """Parse e.g. ``"Z0 Z1 + 0.5*X2 Y3 - 2.0"``.

        Grammar: terms joined by ``+``/``-``; each term is an optional real
        coefficient (optionally ``*``-separated) followed by whitespace-
        separated single-qubit Paulis like ``Z0``, ``X12`` (``I`` ops and a
        bare coefficient — an identity term — are allowed).
        """
        chunks = re.findall(r"[+-]?[^+-]+", text)
        terms: List[PauliTerm] = []
        for chunk in chunks:
            if not chunk.strip():
                continue
            m = _TERM_RE.match(chunk)
            if m is None:
                raise ValueError(f"cannot parse Pauli term {chunk!r}")
            coeff_txt = m.group(1).replace(" ", "")
            if coeff_txt in ("", "+", "-"):
                coeff = -1.0 if coeff_txt == "-" else 1.0
            else:
                coeff = float(coeff_txt)
            ops: Dict[int, str] = {}
            for p, q in _OP_RE.findall(m.group(2)):
                p = p.upper()
                q = int(q)
                if p == "I":
                    continue
                if q in ops:
                    raise ValueError(f"duplicate qubit {q} in term {chunk!r}")
                ops[q] = p
            terms.append(PauliTerm(coeff, tuple(sorted(ops.items()))))
        if not terms:
            raise ValueError(f"empty observable {text!r}")
        return PauliSum(tuple(terms))

    @staticmethod
    def coerce(obs: Union[str, "PauliSum", PauliTerm]) -> "PauliSum":
        if isinstance(obs, PauliSum):
            return obs
        if isinstance(obs, PauliTerm):
            return PauliSum((obs,))
        return PauliSum.parse(obs)

    def __str__(self) -> str:
        return " + ".join(str(t) for t in self.terms)

    @property
    def max_qubit(self) -> int:
        return max((q for t in self.terms for q, _ in t.ops), default=-1)


_PAULI_MATS = {"X": G.X, "Y": G.Y, "Z": G.Z}


def pauli_sum_ops(
    obs: Union[str, PauliSum],
) -> Tuple[Tuple[float, Tuple[Tuple[int, np.ndarray], ...]], ...]:
    """A :class:`PauliSum` as an op stream: ``(coeff, ((qubit, 2x2), ...))``
    per term. The adjoint sweep and :func:`apply_pauli_sum` consume this to
    apply ``H`` to a state with one 1-qubit matrix application per non-I op —
    no ``2^n x 2^n`` observable matrix is ever built."""
    obs = PauliSum.coerce(obs)
    return tuple(
        (t.coeff, tuple((q, _PAULI_MATS[p]) for q, p in t.ops))
        for t in obs.terms
    )


def expectation_np(psi: np.ndarray, obs: Union[str, PauliSum]) -> float:
    """complex128 oracle via the pairing identity (no basis change):

    ``<psi|P|psi> = sum_j conj(psi[j ^ x_mask]) * phase(j) * psi[j]`` with
    ``phase(j) = i^{#Y} * (-1)^{popcount(j & (y_mask | z_mask))}``.

    Deliberately a *different algorithm* from the backend measurers so tests
    cross-check the two.
    """
    obs = PauliSum.coerce(obs)
    psi = np.asarray(psi, dtype=np.complex128).reshape(-1)
    n = int(round(np.log2(psi.size)))
    j = np.arange(psi.size, dtype=np.int64)
    total = 0.0 + 0.0j
    for t in obs.terms:
        x_mask = y_mask = z_mask = 0
        for q, p in t.ops:
            if p == "X":
                x_mask |= 1 << q
            elif p == "Y":
                y_mask |= 1 << q
            else:
                z_mask |= 1 << q
        flip = x_mask | y_mask
        n_y = bin(y_mask).count("1")
        parity = np.zeros(psi.size, dtype=np.int64)
        m = j & (y_mask | z_mask)
        for b in range(n):
            parity ^= (m >> b) & 1
        phase = (1j**n_y) * np.where(parity, -1.0, 1.0)
        total += t.coeff * np.sum(np.conj(psi[j ^ flip]) * phase * psi)
    return float(total.real)


def marginal_np(psi: np.ndarray, qubits: Sequence[int]) -> np.ndarray:
    """Dense-oracle marginal: index bit ``j`` of the output = ``qubits[j]``."""
    psi = np.asarray(psi).reshape(-1)
    n = int(round(np.log2(psi.size)))
    p2 = (psi.real**2 + psi.imag**2).reshape((2,) * n)
    keep = list(qubits)
    drop = tuple(sorted(n - 1 - b for b in range(n) if b not in keep))
    out = p2.sum(axis=drop)
    desc = sorted(keep, reverse=True)  # axis i of `out` <-> bit desc[i]
    perm = [desc.index(b) for b in reversed(keep)]  # want axis i <-> keep[k-1-i]
    return np.ascontiguousarray(np.transpose(out, perm)).reshape(-1)


# ======================================================================
# Frame: physical <-> logical index mapping
# ======================================================================


@dataclass(frozen=True)
class Frame:
    """How physical packed-index bits map to logical qubits.

    Physical bit ``p`` (bit ``p`` of the flat packed index; local bits are
    ``p < L``) stores logical qubit ``layout[p]``; if ``p`` is in
    ``flip_bits`` the stored value is the logical value XOR 1 (a pending
    Häner-Steiger lazy flip that was never materialized).
    """

    n: int
    L: int
    layout: Tuple[int, ...]
    flip_bits: Tuple[int, ...] = ()

    @staticmethod
    def identity(n: int, L: Optional[int] = None) -> "Frame":
        return Frame(n=n, L=n if L is None else L, layout=tuple(range(n)))

    @staticmethod
    def from_compiled(cc) -> "Frame":
        """Frame of a CompiledCircuit's *pre-final-remap* state."""
        layout = tuple(cc.programs[-1].layout)
        flips = tuple(cc.final_remap.flip_bits) if cc.final_remap is not None else ()
        return Frame(n=cc.n, L=cc.L, layout=layout, flip_bits=flips)

    @property
    def n_shards(self) -> int:
        return 1 << (self.n - self.L)

    @property
    def phys_of(self) -> Dict[int, int]:
        return {q: p for p, q in enumerate(self.layout)}

    def phys_to_logical(self, phys: np.ndarray) -> np.ndarray:
        """Vectorized physical-index -> logical-index bit relabeling."""
        phys = np.asarray(phys, dtype=np.int64)
        out = np.zeros_like(phys)
        flips = set(self.flip_bits)
        for p in range(self.n):
            bit = (phys >> p) & 1
            if p in flips:
                bit = bit ^ 1
            out |= bit << self.layout[p]
        return out

    def logical_to_phys(self, logical: np.ndarray) -> np.ndarray:
        logical = np.asarray(logical, dtype=np.int64)
        out = np.zeros_like(logical)
        flips = set(self.flip_bits)
        for p in range(self.n):
            bit = (logical >> self.layout[p]) & 1
            if p in flips:
                bit = bit ^ 1
            out |= bit << p
        return out


# ======================================================================
# Measurers
# ======================================================================


def _probs64(row: np.ndarray) -> np.ndarray:
    """Shared host-side float64 |amp|^2 (the local-CDF path)."""
    row = np.asarray(row)
    return row.real.astype(np.float64) ** 2 + row.imag.astype(np.float64) ** 2



class Measurer:
    """Backend-agnostic measurement front end.

    Subclasses provide four primitives over the *physical* packed state; the
    base class composes them into sampling / marginals / expectations in
    *logical* qubit coordinates, undoing the :class:`Frame` permutation on
    indices (O(shots)) and small host arrays (O(2^|subset|)) only.
    """

    def __init__(self, frame: Frame):
        self.frame = frame
        self._masses: Optional[np.ndarray] = None  # computed once per state

    # -- backend primitives -------------------------------------------------
    def shard_masses(self) -> np.ndarray:
        """[n_shards] float64, cached (the measured state is immutable for
        the lifetime of a measurer, and `_shard_masses` costs one device
        dispatch per shard)."""
        if self._masses is None:
            self._masses = np.asarray(self._shard_masses(), dtype=np.float64)
        return self._masses

    def _shard_masses(self) -> np.ndarray:  # [n_shards] float64
        raise NotImplementedError

    def _local_probs(self, shard_id: int) -> np.ndarray:  # [2^L] float64
        raise NotImplementedError

    def _marginal_phys(self, keep_bits: Tuple[int, ...]) -> np.ndarray:
        """Marginal over physical bits; output index bit j <-> keep_bits[j]
        (keep_bits ascending)."""
        raise NotImplementedError

    def _expect_term_phys(
        self,
        sign_bits: Tuple[int, ...],
        xy: Tuple[Tuple[int, np.ndarray], ...],
    ) -> float:
        """sum_i |V psi|^2(i) * prod_{b in sign_bits} (-1)^{bit b of i}, with
        V the product of 1-qubit basis changes ``xy`` (phys bit, 2x2)."""
        raise NotImplementedError

    # -- sampling -----------------------------------------------------------
    def sample(self, shots: int, seed: int = 0) -> np.ndarray:
        """Sample ``shots`` logical basis-state indices.

        Deterministic for a fixed ``seed``: uniforms are drawn host-side from
        ``np.random.default_rng(seed)``; shard choice via the shard-mass CDF
        (``2^(R+G)`` entries), intra-shard choice via that shard's local CDF.
        Only the *distinct* sampled shards ever ship a ``2^L`` row to host.
        """
        L = self.frame.L
        rng = np.random.default_rng(seed)
        u = rng.random((shots, 2))
        masses = self.shard_masses()
        cdf = np.cumsum(masses / masses.sum())
        cdf[-1] = 1.0
        sid = np.clip(
            np.searchsorted(cdf, u[:, 0], side="right"), 0, masses.size - 1
        )
        phys = np.empty(shots, dtype=np.int64)
        for s in np.unique(sid):
            mask = sid == s
            lp = np.asarray(self._local_probs(int(s)), dtype=np.float64)
            lcdf = np.cumsum(lp)
            lcdf /= lcdf[-1]
            lcdf[-1] = 1.0
            loc = np.clip(
                np.searchsorted(lcdf, u[mask, 1], side="right"), 0, lp.size - 1
            )
            phys[mask] = (int(s) << L) | loc
        return self.frame.phys_to_logical(phys)

    # -- marginals ----------------------------------------------------------
    def marginal(self, qubits: Sequence[int]) -> np.ndarray:
        """P(qubits) as a ``2^k`` vector; output index bit j = qubits[j]."""
        qubits = tuple(qubits)
        n = self.frame.n
        assert len(set(qubits)) == len(qubits), "duplicate qubits"
        assert all(0 <= q < n for q in qubits), "qubit out of range"
        phys_of = self.frame.phys_of
        phys = [phys_of[q] for q in qubits]
        keep = tuple(sorted(phys))
        raw = np.asarray(self._marginal_phys(keep), dtype=np.float64)
        # raw index bit j <-> keep[j]; remap to requested order + apply flips
        k = len(qubits)
        pos_in_keep = {b: j for j, b in enumerate(keep)}
        flips = set(self.frame.flip_bits)
        out = np.empty(1 << k, dtype=np.float64)
        for m in range(1 << k):
            src = 0
            for j, q in enumerate(qubits):
                p = phys[j]
                bit = ((m >> j) & 1) ^ (1 if p in flips else 0)
                src |= bit << pos_in_keep[p]
            out[m] = raw[src]
        return out

    # -- expectations -------------------------------------------------------
    def expectation(self, obs: Union[str, PauliSum, PauliTerm]) -> float:
        obs = PauliSum.coerce(obs)
        n = self.frame.n
        assert obs.max_qubit < n, "observable acts on out-of-range qubit"
        phys_of = self.frame.phys_of
        flips = set(self.frame.flip_bits)
        total = 0.0
        for t in obs.terms:
            if not t.ops:
                total += t.coeff
                continue
            sign_bits = tuple(sorted(phys_of[q] for q, _ in t.ops))
            xy: List[Tuple[int, np.ndarray]] = []
            corr = 1.0
            for q, p in t.ops:
                pb = phys_of[q]
                if p in ("X", "Y"):
                    xy.append((pb, _BASIS_CHANGE[p]))
                if pb in flips:
                    corr *= _FLIP_CORRECTION[p]
            xy.sort(key=lambda e: e[0])
            total += t.coeff * corr * self._expect_term_phys(sign_bits, tuple(xy))
        return float(total)

    def expectations(self, observables) -> Dict[str, float]:
        if isinstance(observables, (str, PauliSum, PauliTerm)):
            observables = [observables]
        return {
            str(PauliSum.coerce(o)): self.expectation(o) for o in observables
        }


class TorchMeasurer(Measurer):
    """Measurer over a packed state tensor (flat ``[2^n]`` or
    ``[2^G, 2^R, 2^L]``) on the engine's device: the twin of the
    reference's ``ShardedMeasurer``. Only ``2^(R+G)`` masses, one ``2^L``
    row per distinct sampled shard, and ``2^|subset|`` marginals reach the
    host."""

    def __init__(self, state: torch.Tensor, frame: Frame):
        super().__init__(frame)
        self.xflat = state.reshape(-1)
        assert self.xflat.numel() == 1 << frame.n
        self.x2d = self.xflat.view(frame.n_shards, 1 << frame.L)

    def _shard_masses(self) -> np.ndarray:
        return np.array([
            float(_abs2(self.x2d[s]).sum(dtype=torch.float64))
            for s in range(self.frame.n_shards)
        ], dtype=np.float64)

    def _local_probs(self, shard_id: int) -> np.ndarray:
        # ship the complex row and square in float64 host math, as the
        # reference does, so both build the same local CDF
        return _probs64(self.x2d[shard_id].cpu().numpy())

    def _marginal_phys(self, keep_bits: Tuple[int, ...]) -> np.ndarray:
        return sum_bits(_abs2(self.xflat), keep_bits).cpu().numpy()

    def _expect_term_phys(self, sign_bits, xy) -> float:
        v = self.xflat
        for b, mat in xy:
            m = torch.as_tensor(np.asarray(mat)).to(device=v.device, dtype=v.dtype)
            v = apply_matrix_bits(v, m, [b])
        marg = sum_bits(_abs2(v), sign_bits).cpu().numpy()
        idx = np.arange(marg.size)
        parity = np.zeros(marg.size, dtype=np.int64)
        for j in range(len(sign_bits)):
            parity ^= (idx >> j) & 1
        return float(np.sum(np.where(parity, -marg, marg)))


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real ** 2 + x.imag ** 2


# ======================================================================
# Entry point
# ======================================================================


def measure_to_result(
    measurer: Measurer,
    *,
    backend: str,
    shots: int = 0,
    seed: int = 0,
    marginals: Sequence[Sequence[int]] = (),
    observables: Union[str, PauliSum, Sequence] = (),
) -> SimulationResult:
    """Run the requested measurements on ``measurer`` and package them.

    The single result-filling path of the launch script."""
    result = SimulationResult(
        n_qubits=measurer.frame.n, backend=backend, shots=shots, seed=seed
    )
    if shots:
        result.samples = measurer.sample(shots, seed=seed)
    if marginals and isinstance(marginals[0], (int, np.integer)):
        marginals = [marginals]  # single subset passed bare
    for qs in marginals:
        result.marginals[tuple(qs)] = measurer.marginal(qs)
    if isinstance(observables, (str, PauliSum, PauliTerm)):
        observables = [observables]
    for obs in observables:
        ps = PauliSum.coerce(obs)
        result.expectations[str(ps)] = measurer.expectation(ps)
    return result

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

:class:`PauliSum`, :class:`Frame`, the :class:`Measurer` base class,
:class:`DenseMeasurer` (the host oracle path) and the complex128 oracles
:func:`expectation_np` / :func:`marginal_np` are copied from the reference;
:class:`TorchMeasurer` measures a state held whole on one device (the
single-device case of the reference's ``ShardedMeasurer``),
:class:`ShardedMeasurer` the shardmap backend's state, one shard per
``torch.distributed`` rank, and :class:`StreamingMeasurer` the offload
backend's host state one shard at a time, as the reference's does. Batches and sweeps
(:func:`measure_batch`, :func:`measure_sweep`) measure element ``b`` / point
``p`` with seed ``seed + b`` / ``seed + p``, as the reference does.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import gates as G
from ..core.circuit import Circuit
from ..kernels.ops import to_device
from .apply import apply_matrix_bits, n_bits_of, permute_bits, sum_bits
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


def apply_pauli_sum(psi: torch.Tensor, obs: Union[str, PauliSum],
                    use_kernels: bool = True) -> torch.Tensor:
    """``H|psi>`` for a dense *logical-order* state: flat ``[2^n]``, or
    ``[P, 2^n]`` rows, each row on its own. A new tensor of ``psi``'s shape.

    Each non-identity Pauli op is one per-gate apply
    (:func:`repro_torch.sim.adjoint.apply_gate_`: the ``fused_apply`` kernel
    over all rows, or with ``use_kernels=False`` its plain version) on a
    working copy of ``psi``; the terms accumulate with their coefficients.
    No ``2^n x 2^n`` matrix is built, and the call holds three states:
    ``psi``, the copy and the sum. The λ-initialization of the adjoint
    sweep."""
    from .adjoint import apply_gate_

    rows = psi.reshape(-1, psi.shape[-1])
    n = n_bits_of(rows.shape[1])
    vidx = to_device(np.zeros(rows.shape[0], dtype=np.int32), psi.device)
    acc = torch.zeros_like(rows)
    work = None
    for coeff, ops in pauli_sum_ops(obs):
        if not ops:  # an identity term
            acc.add_(rows, alpha=coeff)
            continue
        if work is None:
            work = torch.empty_like(rows)
        work.copy_(rows)
        for q, mat in ops:
            u = to_device(mat.astype(np.complex64).reshape(1, 2, 2), psi.device)
            apply_gate_(work.view(-1), u, vidx, (q,), n, use_kernels)
        acc.add_(work, alpha=coeff)
    return acc.view(psi.shape)


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


_PROBS_CHUNK = 1 << 20  # amplitudes squared per step of _probs64


def _probs64(row) -> np.ndarray:
    """Shared host-side float64 |amp|^2 (the local-CDF path): ``re**2 +
    im**2`` with each part widened to float64 first, as the reference
    computes it, so bit for bit its values. Worked in chunks with torch's
    multi-threaded CPU ops into one output, so a 2^28-amplitude shard pages
    in no whole-shard temporaries. ``row``: a host complex array or
    tensor."""
    t = row if isinstance(row, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(row))
    v = torch.view_as_real(t.reshape(-1))
    out = torch.empty(v.shape[0], dtype=torch.float64)
    for lo in range(0, v.shape[0], _PROBS_CHUNK):
        c = v[lo:lo + _PROBS_CHUNK].to(torch.float64)
        o = out[lo:lo + _PROBS_CHUNK]
        torch.mul(c[:, 0], c[:, 0], out=o)
        o.add_(c[:, 1] * c[:, 1])
    return out.numpy()



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
        return _probs64(self.x2d[shard_id].cpu())

    def _marginal_phys(self, keep_bits: Tuple[int, ...]) -> np.ndarray:
        return sum_bits(_abs2(self.xflat), keep_bits).cpu().numpy()

    def _expect_term_phys(self, sign_bits, xy) -> float:
        return _signed_sum(self.xflat, xy, sign_bits)


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real ** 2 + x.imag ** 2


def _signed_sum(v: torch.Tensor, xy, sign_bits: Sequence[int]) -> float:
    """``sum_i |V v|^2(i) * prod_{b in sign_bits} (-1)^{bit b of i}`` for a
    flat state ``v``, with ``V`` the 1-qubit basis changes ``xy`` (bit,
    2x2), on ``v``'s device; the signs are applied on the host to the
    float64 marginal over ``sign_bits``."""
    for b, mat in xy:
        m = torch.as_tensor(np.asarray(mat)).to(device=v.device, dtype=v.dtype)
        v = apply_matrix_bits(v, m, [b])
    marg = sum_bits(_abs2(v), sign_bits).cpu().numpy()
    idx = np.arange(marg.size)
    parity = np.zeros(marg.size, dtype=np.int64)
    for j in range(len(sign_bits)):
        parity ^= (idx >> j) & 1
    return float(np.sum(np.where(parity, -marg, marg)))


# a non-local X/Y group is rotated on the device in chunks of at most
# 2^(L - GROUP_CHUNK_SHIFT) amplitudes: half a shard
GROUP_CHUNK_SHIFT = 1


class StreamingMeasurer(Measurer):
    """Measurer over the offload backend's host state (flat ``[2^n]``, in
    ``2^(R+G)`` shards of ``2^L``): the twin of the reference's
    ``StreamingMeasurer``.

    Every reduction (the shard masses, a marginal, each Pauli term) is
    **one pass** over the host shards, each shard copied to ``device`` and
    reduced there, so measuring costs one read of the state whatever the
    number of qubits measured. X/Y basis changes on non-local bits couple
    groups of ``2^m`` shards (m: the term's non-local X/Y bits); each group
    is rotated on the device by the Kronecker product of its ``2^m x 2^m``
    basis change in column chunks: a chunk fixes the values of the highest
    local bits that no local X/Y rotation touches, so the group's ``2^m``
    rows of one chunk hold at most ``2^(L - GROUP_CHUNK_SHIFT)`` amplitudes
    (half a shard) and each shard is still read once. The local CDF of a
    sampled shard is built from its host amplitudes in float64
    (``_probs64``), as the reference builds it, so a seed gives the
    reference's shots."""

    MAX_GROUP_BITS = 8  # non-local X/Y bits of one term: 2^m shards a group

    def __init__(self, state: torch.Tensor, frame: Frame, device: torch.device):
        super().__init__(frame)
        self.state = state.reshape(-1)
        assert self.state.numel() == 1 << frame.n
        self.device = torch.device(device)

    def _host_shard(self, s: int) -> torch.Tensor:
        L = self.frame.L
        return self.state[s << L:(s + 1) << L]

    def _shard(self, s: int) -> torch.Tensor:
        """Shard ``s`` on the measuring device (a view when that is where
        the host state lies)."""
        return self._host_shard(s).to(self.device, non_blocking=True)

    def _shard_masses(self) -> np.ndarray:
        return np.array([float(_abs2(self._shard(s)).sum(dtype=torch.float64))
                         for s in range(self.frame.n_shards)], dtype=np.float64)

    def _local_probs(self, shard_id: int) -> np.ndarray:
        return _probs64(self._host_shard(shard_id))

    def _marginal_phys(self, keep_bits: Tuple[int, ...]) -> np.ndarray:
        L = self.frame.L
        loc = tuple(b for b in keep_bits if b < L)
        nl = [b for b in keep_bits if b >= L]
        pos = {b: j for j, b in enumerate(keep_bits)}
        # local pattern -> offset within the output index
        spread = np.zeros(1 << len(loc), dtype=np.int64)
        for ll in range(1 << len(loc)):
            for jl, b in enumerate(loc):
                if (ll >> jl) & 1:
                    spread[ll] |= 1 << pos[b]
        out = np.zeros(1 << len(keep_bits), dtype=np.float64)
        for s in range(self.frame.n_shards):
            part = sum_bits(_abs2(self._shard(s)), loc).cpu().numpy()
            base = 0
            for b in nl:
                if (s >> (b - L)) & 1:
                    base |= 1 << pos[b]
            out[base + spread] += part
        return out

    def _chunk(self, s: int, cbits: Sequence[int], j: int) -> torch.Tensor:
        """Host shard ``s`` with its local bits ``cbits`` (high -> low; bit
        ``t`` of ``j`` is the value of ``cbits[t]``) fixed: a view whose
        dimensions, flattened, index the other local bits in order."""
        L = self.frame.L
        shape, hi = [], L
        for b in cbits:
            shape += [1 << (hi - 1 - b), 2]
            hi = b
        v = self._host_shard(s).view(shape + [1 << hi])
        for t in range(len(cbits)):
            v = v.select(t + 1, (j >> t) & 1)
        return v

    def _expect_term_phys(self, sign_bits, xy) -> float:
        L = self.frame.L
        xy_loc = [(b, m) for b, m in xy if b < L]
        xy_nl = [(b, m) for b, m in xy if b >= L]
        m = len(xy_nl)
        if m > self.MAX_GROUP_BITS:
            raise ValueError(f"{m} non-local X/Y bits exceed the 2^{self.MAX_GROUP_BITS} "
                             "shard-group working-set cap; re-plan with these qubits local")
        sign_nl = [b for b in sign_bits if b >= L]
        # group rotation: index bit t <-> xy_nl[t]; kron builds low bits last
        U = np.array([[1.0]], dtype=np.complex128)
        for _, mat in reversed(xy_nl):
            U = np.kron(U, mat)
        Ud = torch.as_tensor(U).to(device=self.device, dtype=self.state.dtype)
        nl_mask = 0
        for b, _ in xy_nl:
            nl_mask |= 1 << (b - L)
        # chunk bits: the highest local bits no local rotation touches, as
        # many as it takes to bring a group's chunk under the limit
        touched = {b for b, _ in xy_loc}
        limit = 1 << max(L - GROUP_CHUNK_SHIFT, 0)
        cbits: List[int] = []
        for b in range(L - 1, -1, -1):
            if (1 << (m + L - len(cbits))) <= limit:
                break
            if b not in touched:
                cbits.append(b)
        kept = [b for b in range(L) if b not in cbits]
        pos = {b: i for i, b in enumerate(kept)}
        xy_in = [(pos[b], mat) for b, mat in xy_loc]
        sign_in = [pos[b] for b in sign_bits if b in pos]
        sign_fixed = [t for t, b in enumerate(cbits) if b in sign_bits]
        buf = torch.empty((1 << m, 1 << len(kept)), dtype=self.state.dtype, device=self.device)
        total = 0.0
        for base in range(self.frame.n_shards):
            if base & nl_mask:
                continue  # shard handled inside its group
            group_ids = []
            for g in range(1 << m):
                sidx = base
                for t, (b, _) in enumerate(xy_nl):
                    if (g >> t) & 1:
                        sidx |= 1 << (b - L)
                group_ids.append(sidx)
            for j in range(1 << len(cbits)):
                for g, sidx in enumerate(group_ids):
                    src = self._chunk(sidx, cbits, j)
                    buf[g].view(src.shape).copy_(src, non_blocking=True)
                rows = torch.matmul(Ud, buf) if m else buf
                for sidx, row in zip(group_ids, rows):
                    parity = sum((sidx >> (b - L)) & 1 for b in sign_nl)
                    parity += sum((j >> t) & 1 for t in sign_fixed)
                    total += (-1.0) ** parity * _signed_sum(row, xy_in, sign_in)
                del rows
        return total


class ShardedMeasurer(Measurer):
    """Measurer over the shardmap backend's state: the twin of the
    reference's ``ShardedMeasurer`` (which measures the same state held
    across the bit-mesh). Each rank holds its ``2^L`` shard ``d`` (physical
    bits ``p >= L`` spell ``d``) and calls every method in the same order
    as the others; every rank returns the same result. What reaches one
    place is what the reference's docstring says: the ``2^(R+G)`` float64
    masses (gathered on every rank), one float64 ``2^L`` row per distinct
    sampled shard (sent by its owner to rank 0, which draws the shots and
    broadcasts them), and ``2^|subset|`` marginals.

    A Pauli term is ``<ψ|P|ψ> = i^{#Y} Σ_j (-1)^{|j ∧ (y|z)|}
    conj(ψ[j ⊕ (x|y)]) ψ[j]`` summed over each rank's ``j``: a term with
    X/Y on device bits of mask ``M`` has rank ``d`` receive the shard of
    rank ``d ⊕ M`` (one permute of one shard per rank, no gather); Z-only
    terms and local X/Y terms move no shard. Shots for a seed are those of
    the reference: the masses are summed as :class:`TorchMeasurer` sums
    them and the local CDF is built from :func:`_probs64`."""

    def __init__(self, shard: torch.Tensor, frame: Frame, transport):
        super().__init__(frame)
        self.shard = shard.reshape(-1)
        if self.shard.numel() != 1 << frame.L or transport.world != frame.n_shards:
            raise ValueError(f"a shard of {self.shard.numel()} amplitudes on {transport.world} "
                             f"ranks is not a 2^{frame.n} state in 2^{frame.L}-shards")
        self.t = transport
        self.rank = transport.rank

    def _gather_sum(self, part: np.ndarray) -> np.ndarray:
        """Every rank's ``part`` summed in rank order (the same bits on every
        rank)."""
        parts = self.t.all_gather(part)
        total = parts[0].copy()
        for p in parts[1:]:
            total += p
        return total

    def _shard_masses(self) -> np.ndarray:
        local = _abs2(self.shard).sum(dtype=torch.float64).reshape(1).cpu().numpy()
        return np.concatenate(self.t.all_gather(local))

    def _sampled_shards(self, shots: int, seed: int) -> np.ndarray:
        """The shard of each shot, as :meth:`Measurer.sample` draws it."""
        rng = np.random.default_rng(seed)
        u = rng.random((shots, 2))
        masses = self.shard_masses()
        cdf = np.cumsum(masses / masses.sum())
        cdf[-1] = 1.0
        return np.clip(np.searchsorted(cdf, u[:, 0], side="right"), 0, masses.size - 1)

    def sample(self, shots: int, seed: int = 0) -> np.ndarray:
        if self.rank == 0:
            logical = super().sample(shots, seed)  # rows arrive in _local_probs
        else:
            if self.rank in set(self._sampled_shards(shots, seed).tolist()):
                self.t.send(_probs64(self.shard.cpu()), 0)
            logical = np.empty(shots, dtype=np.int64)
        return self.t.broadcast(logical, 0)

    def _local_probs(self, shard_id: int) -> np.ndarray:
        # rank 0 only: its own row, or the owner's
        if shard_id == 0:
            return _probs64(self.shard.cpu())
        return self.t.recv(np.empty(1 << self.frame.L, dtype=np.float64), shard_id)

    def _marginal_phys(self, keep_bits: Tuple[int, ...]) -> np.ndarray:
        L = self.frame.L
        loc = tuple(b for b in keep_bits if b < L)
        pos = {b: j for j, b in enumerate(keep_bits)}
        base = sum(1 << pos[b] for b in keep_bits if b >= L and (self.rank >> (b - L)) & 1)
        spread = np.zeros(1 << len(loc), dtype=np.int64)
        for ll in range(1 << len(loc)):
            for jl, b in enumerate(loc):
                if (ll >> jl) & 1:
                    spread[ll] |= 1 << pos[b]
        out = np.zeros(1 << len(keep_bits), dtype=np.float64)
        out[base + spread] = sum_bits(_abs2(self.shard), loc).cpu().numpy()
        return self._gather_sum(out)

    def _expect_term_phys(self, sign_bits, xy) -> float:
        L = self.frame.L
        y_bits = set()
        for b, mat in xy:
            if np.array_equal(mat, _BASIS_CHANGE["Y"]):
                y_bits.add(b)
            elif not np.array_equal(mat, _BASIS_CHANGE["X"]):
                raise ValueError(f"bit {b}: not the X or Y basis change")
        flip = [b for b, _ in xy]
        signs = [s for s in sign_bits if s not in flip or s in y_bits]  # the Y and Z bits
        dev_mask = sum(1 << (b - L) for b in flip if b >= L)
        own = self.shard
        partner = own
        if dev_mask:  # the shard of rank d ^ M, one permute
            other = self.rank ^ dev_mask
            partner = self.t.permute(own, other, other, torch.empty_like(own))
        loc_flip = [b for b in flip if b < L]
        if loc_flip:
            partner = permute_bits(partner, list(range(L)), loc_flip)
        a, b = torch.view_as_real(partner).unbind(-1), torch.view_as_real(own).unbind(-1)
        # Re or Im of conj(partner[j ^ f]) * own[j], as i^{#Y} picks
        if len(y_bits) % 2 == 0:
            vals = torch.mul(a[0], b[0]).addcmul_(a[1], b[1])
        else:
            vals = torch.mul(a[0], b[1]).addcmul_(a[1], b[0], value=-1.0)
        del partner, a
        sign_loc = tuple(s for s in signs if s < L)
        marg = sum_bits(vals, sign_loc).cpu().numpy()
        parity = np.zeros(marg.size, dtype=np.int64)
        for j in range(len(sign_loc)):
            parity ^= (np.arange(marg.size) >> j) & 1
        local = float(np.sum(np.where(parity, -marg, marg)))
        dev_parity = sum((self.rank >> (s - L)) & 1 for s in signs if s >= L)
        # i^{#Y} times the real or imaginary part taken above
        local *= (-1.0) ** dev_parity * (1.0, -1.0, -1.0, 1.0)[len(y_bits) % 4]
        return float(self._gather_sum(np.array([local]))[0])


class DenseMeasurer(Measurer):
    """Host numpy measurer over a flat state (the oracle path; the ``ref``
    backend of :func:`simulate_and_measure`). Shard masses are summed as
    :class:`TorchMeasurer` sums them, so both build the same sampling CDF
    for the same state."""

    def __init__(self, state: np.ndarray, frame: Optional[Frame] = None):
        state = np.asarray(state).reshape(-1)
        n = int(round(np.log2(state.size)))
        super().__init__(frame if frame is not None else Frame.identity(n))
        assert self.frame.n == n
        self.state = state

    @classmethod
    def with_frame(cls, psi_logical: np.ndarray, frame: Frame) -> "DenseMeasurer":
        """Re-store a *logical-order* dense state in ``frame``'s physical
        order, so this measurer is comparable to a planned backend measuring
        in that frame (same shard CDFs, same shots for a seed)."""
        psi_logical = np.asarray(psi_logical).reshape(-1)
        idx = frame.phys_to_logical(np.arange(psi_logical.size, dtype=np.int64))
        return cls(psi_logical[idx], frame)

    def _row(self, shard_id: int) -> np.ndarray:
        L = self.frame.L
        return self.state[shard_id << L:(shard_id + 1) << L]

    def _shard_masses(self) -> np.ndarray:
        return np.array([
            float(_abs2(torch.from_numpy(np.ascontiguousarray(self._row(s)))).sum(
                dtype=torch.float64))
            for s in range(self.frame.n_shards)
        ], dtype=np.float64)

    def _local_probs(self, shard_id: int) -> np.ndarray:
        return _probs64(self._row(shard_id))

    def _marginal_phys(self, keep_bits: Tuple[int, ...]) -> np.ndarray:
        n = self.frame.n
        p2 = _probs64(self.state).reshape((2,) * n)
        drop = tuple(sorted(n - 1 - b for b in range(n) if b not in keep_bits))
        return p2.sum(axis=drop).reshape(-1)

    def _expect_term_phys(self, sign_bits, xy) -> float:
        n = self.frame.n
        v = self.state.astype(np.complex128).reshape((2,) * n)
        for b, mat in xy:
            ax = n - 1 - b
            v = np.moveaxis(np.tensordot(mat, v, axes=([1], [ax])), 0, ax)
        p2 = v.real**2 + v.imag**2
        for b in sign_bits:
            a = n - 1 - b
            p2 = p2 * np.array([1.0, -1.0]).reshape((1,) * a + (2,) + (1,) * (n - 1 - a))
        return float(p2.sum())


def measurer_for(state, frame: Frame, engine=None) -> Measurer:
    """The measurer for a state. What produced it decides, never the device
    the tensor happens to lie on: a state of an ``engine`` on the offload
    backend is a host state in shards, streamed through the engine's device
    (:class:`StreamingMeasurer`); any other tensor is measured where it
    lies (:class:`TorchMeasurer`), a numpy array on the host
    (:class:`DenseMeasurer`). On the shardmap backend ``state`` is this
    rank's shard, measured with the other ranks (:class:`ShardedMeasurer`)."""
    if engine is not None and engine.backend.name == "offload":
        return StreamingMeasurer(state, frame, engine.device)
    if engine is not None and engine.backend.name == "shardmap":
        return ShardedMeasurer(state, frame, engine.backend.transport)
    if isinstance(state, torch.Tensor):
        return TorchMeasurer(state, frame)
    return DenseMeasurer(state, frame)


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


_BACKENDS = ("ref", "cuda", "offload", "shardmap")


def simulate_and_measure(
    circuit: Circuit,
    *,
    backend: str = "ref",
    L: Optional[int] = None,
    R: int = 0,
    G: int = 0,
    plan=None,
    shots: int = 0,
    seed: int = 0,
    marginals: Sequence[Sequence[int]] = (),
    observables: Union[str, PauliSum, Sequence] = (),
    use_kernels: bool = True,
    psi0=None,
    params=None,
    device=None,
    **plan_kw,
) -> SimulationResult:
    """Simulate ``circuit`` and consume the state through measurement only.

    Backends: ``'ref'`` (the dense per-gate oracle on ``device``, measured
    on the host), ``'cuda'`` (the planned engine on ``device``),
    ``'offload'`` (the planned engine with its state in host memory,
    streamed through ``device``) and ``'shardmap'`` (this rank's shard of
    the planned engine over the default process group; every rank calls it
    and gets the same result). The planned backends measure in the final
    stage's layout: the final remap is skipped. ``params`` binds a
    parameterized circuit first. ``device`` defaults to CUDA."""
    import time

    from .statevector import simulate

    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from {_BACKENDS}")
    if params is not None or not circuit.is_bound:
        circuit = circuit.bind(params if params is not None else {})
    n = circuit.n_qubits
    t0 = time.time()
    meta: Dict[str, float] = {}
    if backend == "ref":
        psi = simulate(circuit, psi0=psi0, device=device)
        measurer: Measurer = DenseMeasurer(psi.cpu().numpy())
    else:
        from ..core.partition import partition
        from .engine import ExecutionEngine

        if plan is None:
            plan = partition(circuit, L if L is not None else n - R - G, R, G, **plan_kw)
        ex = ExecutionEngine(circuit, plan, use_kernels=use_kernels, device=device,
                             backend=backend)
        measurer = measurer_for(ex.run_packed(psi0), ex.measurement_frame, ex)
        meta["n_stages"] = plan.n_stages
    meta["simulate_s"] = time.time() - t0
    t0 = time.time()
    result = measure_to_result(measurer, backend=backend, shots=shots, seed=seed,
                               marginals=marginals, observables=observables)
    meta["measure_s"] = time.time() - t0
    result.meta = meta
    return result


def measure_batch(
    engine,
    psi0s,
    *,
    shots: int = 0,
    seed: int = 0,
    marginals: Sequence[Sequence[int]] = (),
    observables: Union[str, PauliSum, Sequence] = (),
) -> List[SimulationResult]:
    """Run a batch of initial states through an engine's batch path
    (``run_batch(..., apply_final=False)``: the states stay in the final
    stage's layout) and measure every element in the shared frame. Element
    ``b`` samples with ``seed + b``."""
    states = engine.run_batch(psi0s, apply_final=False)
    return _measure_state_batch(engine, states, shots, seed, marginals, observables)


def _measure_state_batch(engine, states, shots, seed, marginals,
                         observables) -> List[SimulationResult]:
    results: List[SimulationResult] = []
    B, frame = states.shape[0], engine.measurement_frame
    for b in range(B):
        res = measure_to_result(
            measurer_for(states[b], frame, engine), backend=engine.backend.name, shots=shots,
            seed=seed + b, marginals=marginals, observables=observables)
        res.meta = {"batch_index": b, "batch_size": B}
        results.append(res)
    return results


def measure_sweep(
    engine,
    params_batch,
    *,
    psi0=None,
    shots: int = 0,
    seed: int = 0,
    marginals: Sequence[Sequence[int]] = (),
    observables: Union[str, PauliSum, Sequence] = (),
) -> List[SimulationResult]:
    """Parameter-sweep counterpart of :func:`measure_batch`: ONE initial
    state against a batch of bindings through the engine's sweep path, then
    every point measured; point ``p`` samples with ``seed + p``."""
    states = engine.run_sweep(psi0, params_batch, apply_final=False)
    return _measure_state_batch(engine, states, shots, seed, marginals, observables)

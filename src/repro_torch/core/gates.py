"""Gate library: matrices + insularity traits (paper Def. 2).

(Copied from ``repro/core/gates.py`` so this package imports nothing of the
JAX package; only imports differ.)

A gate's unitary is stored as a dense ``2^k x 2^k`` complex ndarray over its
qubits ``(q_0, ..., q_{k-1})`` where ``q_0`` is the *least-significant* qubit of
the gate's index space (matching the state-vector bit convention used across
``repro.sim``).

Insularity (paper Def. 2):
  * a single-qubit gate's qubit is insular iff its matrix is diagonal or
    anti-diagonal;
  * all control qubits of a controlled-U gate are insular;
  * everything else is non-insular.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, Mapping, Sequence, Tuple, Union

import numpy as np

SQ2 = 1.0 / math.sqrt(2.0)


# ---------------------------------------------------------------------------
# Symbolic parameters (structure/parameter split)
# ---------------------------------------------------------------------------


class UnboundParameterError(ValueError):
    """Raised when a concrete matrix is requested from a symbolic gate."""


@dataclass(frozen=True)
class Param:
    """A named symbolic angle: ``scale * value(name) + shift``.

    Accepted wherever a gate angle is. Affine arithmetic keeps the common
    ansatz forms (``-theta``, ``0.5 * theta``, ``theta + pi/2``) symbolic so
    the whole circuit stays rebindable from one flat parameter vector.
    """

    name: str
    scale: float = 1.0
    shift: float = 0.0

    def __mul__(self, k: float) -> "Param":
        return Param(self.name, self.scale * float(k), self.shift * float(k))

    __rmul__ = __mul__

    def __neg__(self) -> "Param":
        return self * -1.0

    def __add__(self, k: float) -> "Param":
        return Param(self.name, self.scale, self.shift + float(k))

    __radd__ = __add__

    def __sub__(self, k: float) -> "Param":
        return self + (-float(k))

    def __rsub__(self, k: float) -> "Param":
        return (-self) + float(k)

    def resolve(self, values: Mapping[str, float]) -> float:
        if self.name not in values:
            raise UnboundParameterError(f"no value bound for parameter {self.name!r}")
        return self.scale * float(values[self.name]) + self.shift

    def __repr__(self) -> str:  # compact, stable (used in fingerprints/errors)
        body = self.name
        if self.scale != 1.0:
            body = f"{self.scale:g}*{body}"
        if self.shift != 0.0:
            body = f"{body}{self.shift:+g}"
        return f"Param({body})"


ParamValue = Union[float, Param]


def is_symbolic(params: Sequence[ParamValue]) -> bool:
    return any(isinstance(p, Param) for p in params)


# Generic probe angles for structural analysis of parametric gates: the
# pipeline's structural predicates (insularity, diagonality, flip schedules)
# must not depend on concrete angles, so they are evaluated at fixed generic
# (irrational, non-special) values. Entries that vanish at a *special* angle
# (e.g. rz(0) = I) are still non-zero at the probe, so the probe nonzero
# pattern is a superset of every binding's pattern — structural
# classifications computed here stay valid for all bindings.
PROBE_ANGLES = (
    0.9 * math.sqrt(2.0),  # ~1.27279
    1.1 * math.sqrt(3.0),  # ~1.90526
    0.8 * math.sqrt(5.0),  # ~1.78885
)

# ---------------------------------------------------------------------------
# Base 1q matrices
# ---------------------------------------------------------------------------

I2 = np.eye(2, dtype=np.complex128)
X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
H = np.array([[SQ2, SQ2], [SQ2, -SQ2]], dtype=np.complex128)
S = np.array([[1, 0], [0, 1j]], dtype=np.complex128)
SDG = S.conj().T
T = np.array([[1, 0], [0, np.exp(1j * math.pi / 4)]], dtype=np.complex128)
TDG = T.conj().T
SX = 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]], dtype=np.complex128)


def rx(theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)


def ry(theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def rz(theta: float) -> np.ndarray:
    return np.array(
        [[np.exp(-0.5j * theta), 0], [0, np.exp(0.5j * theta)]], dtype=np.complex128
    )


def p(lam: float) -> np.ndarray:
    return np.array([[1, 0], [0, np.exp(1j * lam)]], dtype=np.complex128)


def u3(theta: float, phi: float, lam: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array(
        [
            [c, -np.exp(1j * lam) * s],
            [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
        ],
        dtype=np.complex128,
    )


def controlled(u: np.ndarray, n_controls: int = 1) -> np.ndarray:
    """Controlled-U with control qubits as the *most significant* gate qubits.

    Qubit order within the gate: (targets..., controls...): target qubits are the
    low bits of the 2^k index, control qubits the high bits. The gate acts as U on
    the subspace where all control bits are 1.
    """
    kt = u.shape[0]
    dim = kt * (2**n_controls)
    m = np.eye(dim, dtype=np.complex128)
    m[dim - kt :, dim - kt :] = u
    return m


CX = controlled(X)
CY = controlled(Y)
CZ = controlled(Z)
CCX = controlled(X, 2)
SWAP = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128
)


def cp(lam: float) -> np.ndarray:
    return controlled(p(lam))


def crz(theta: float) -> np.ndarray:
    return controlled(rz(theta))


def cry(theta: float) -> np.ndarray:
    return controlled(ry(theta))


def crx(theta: float) -> np.ndarray:
    return controlled(rx(theta))


def rzz(theta: float) -> np.ndarray:
    # exp(-i theta/2 Z⊗Z): diagonal
    e = np.exp(-0.5j * theta)
    f = np.exp(0.5j * theta)
    return np.diag([e, f, f, e]).astype(np.complex128)


def rxx(theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), -1j * math.sin(theta / 2)
    m = np.zeros((4, 4), dtype=np.complex128)
    for i in range(4):
        m[i, i] = c
        m[i, i ^ 3] = s
    return m


def ryy(theta: float) -> np.ndarray:
    c = math.cos(theta / 2)
    s = 1j * math.sin(theta / 2)
    m = np.zeros((4, 4), dtype=np.complex128)
    diag_s = [s, -s, -s, s]
    for i in range(4):
        m[i, i] = c
        m[i, i ^ 3] = diag_s[i]
    return m


# ---------------------------------------------------------------------------
# Insularity analysis
# ---------------------------------------------------------------------------


def is_diagonal(m: np.ndarray, tol: float = 1e-12) -> bool:
    return bool(np.allclose(m - np.diag(np.diag(m)), 0, atol=tol))


def is_antidiagonal(m: np.ndarray, tol: float = 1e-12) -> bool:
    return bool(np.allclose(m - np.fliplr(np.diag(np.diag(np.fliplr(m)))), 0, atol=tol))


def insular_mask(matrix: np.ndarray, n_controls: int = 0) -> Tuple[bool, ...]:
    """Per-qubit insularity for a gate given its matrix and #control qubits.

    Gate qubit order is (targets..., controls...). Control qubits are always
    insular. For the target part: if there is a single target qubit, it is
    insular iff the target unitary is (anti-)diagonal. For multi-target gates a
    target qubit q is insular iff, for every non-zero entry U[r, c], bit q of r
    is a function of bit q of c ONLY and that function is either identity
    (diagonal in q) or negation (anti-diagonal in q) consistently, and the
    remaining action factorizes — we use the conservative per-bit test below.
    """
    k = int(round(math.log2(matrix.shape[0])))
    kt = k - n_controls
    mask = [False] * k
    for qc in range(kt, k):
        mask[qc] = True
    # Per-target-bit conservative test: qubit q (bit position q within the gate
    # index) is insular iff every nonzero U[r, c] has r_q == c_q (diagonal-in-q)
    # or every nonzero has r_q != c_q (antidiagonal-in-q).
    rows, cols = np.nonzero(np.abs(matrix) > 1e-12)
    for q in range(kt):
        rb = (rows >> q) & 1
        cb = (cols >> q) & 1
        if np.all(rb == cb) or np.all(rb != cb):
            mask[q] = True
    return tuple(mask)


# ---------------------------------------------------------------------------
# Named gate registry (for circuit generators / (de)serialization)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GateDef:
    name: str
    n_qubits: int
    n_params: int
    n_controls: int
    fn: Callable[..., np.ndarray]


def _const(m: np.ndarray) -> Callable[..., np.ndarray]:
    return lambda: m


GATE_DEFS: Dict[str, GateDef] = {
    "i": GateDef("i", 1, 0, 0, _const(I2)),
    "x": GateDef("x", 1, 0, 0, _const(X)),
    "y": GateDef("y", 1, 0, 0, _const(Y)),
    "z": GateDef("z", 1, 0, 0, _const(Z)),
    "h": GateDef("h", 1, 0, 0, _const(H)),
    "s": GateDef("s", 1, 0, 0, _const(S)),
    "sdg": GateDef("sdg", 1, 0, 0, _const(SDG)),
    "t": GateDef("t", 1, 0, 0, _const(T)),
    "tdg": GateDef("tdg", 1, 0, 0, _const(TDG)),
    "sx": GateDef("sx", 1, 0, 0, _const(SX)),
    "rx": GateDef("rx", 1, 1, 0, rx),
    "ry": GateDef("ry", 1, 1, 0, ry),
    "rz": GateDef("rz", 1, 1, 0, rz),
    "p": GateDef("p", 1, 1, 0, p),
    "u3": GateDef("u3", 1, 3, 0, u3),
    "cx": GateDef("cx", 2, 0, 1, _const(CX)),
    "cy": GateDef("cy", 2, 0, 1, _const(CY)),
    "cz": GateDef("cz", 2, 0, 1, _const(CZ)),
    "cp": GateDef("cp", 2, 1, 1, cp),
    "crx": GateDef("crx", 2, 1, 1, crx),
    "cry": GateDef("cry", 2, 1, 1, cry),
    "crz": GateDef("crz", 2, 1, 1, crz),
    "swap": GateDef("swap", 2, 0, 0, _const(SWAP)),
    "rzz": GateDef("rzz", 2, 1, 0, rzz),
    "rxx": GateDef("rxx", 2, 1, 0, rxx),
    "ryy": GateDef("ryy", 2, 1, 0, ryy),
    "ccx": GateDef("ccx", 3, 0, 2, _const(CCX)),
}


def gate_matrix(name: str, params: Sequence[ParamValue] = ()) -> np.ndarray:
    gd = GATE_DEFS[name]
    if len(params) != gd.n_params:
        raise ValueError(f"gate {name} expects {gd.n_params} params, got {len(params)}")
    if is_symbolic(params):
        raise UnboundParameterError(
            f"gate {name} has unbound symbolic params {tuple(params)}; "
            "bind the circuit (Circuit.bind) before requesting matrices"
        )
    return gd.fn(*params)


# ---------------------------------------------------------------------------
# Analytic derivatives (adjoint-mode differentiation)
# ---------------------------------------------------------------------------


def _controlled_block(dmat: np.ndarray, n_controls: int) -> np.ndarray:
    """Embed a target-gate derivative into the controlled-gate index space.

    d/dθ controlled(U(θ)) is zero everywhere EXCEPT the all-controls-on block
    (the identity block does not depend on θ), so unlike :func:`controlled`
    the off-block diagonal is 0, not 1."""
    kt = dmat.shape[0]
    dim = kt * (2**n_controls)
    out = np.zeros((dim, dim), dtype=np.complex128)
    out[dim - kt:, dim - kt:] = dmat
    return out


_P1 = np.diag([0.0, 1.0]).astype(np.complex128)  # |1><1|


def _du3(theta: float, phi: float, lam: float, slot: int) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    ep, el = np.exp(1j * phi), np.exp(1j * lam)
    if slot == 0:  # d/dtheta
        return 0.5 * np.array(
            [[-s, -el * c], [ep * c, -ep * el * s]], dtype=np.complex128
        )
    if slot == 1:  # d/dphi
        return np.array(
            [[0, 0], [1j * ep * s, 1j * ep * el * c]], dtype=np.complex128
        )
    return np.array(  # d/dlam
        [[0, -1j * el * s], [0, 1j * ep * el * c]], dtype=np.complex128
    )


# name -> tuple of per-slot derivative fns (same arity as the gate fn).
# Rotation gates use the generator rule dU/dθ = -i/2 · G · U(θ); phase gates
# use dU/dλ = i·|1><1|·U; controlled parametric gates differentiate the
# target block only (the identity block is θ-independent).
GATE_DERIVS: Dict[str, Tuple[Callable[..., np.ndarray], ...]] = {
    "rx": (lambda t: -0.5j * X @ rx(t),),
    "ry": (lambda t: -0.5j * Y @ ry(t),),
    "rz": (lambda t: -0.5j * Z @ rz(t),),
    "p": (lambda lam: 1j * _P1 @ p(lam),),
    "u3": tuple(
        (lambda slot: lambda t, f, l: _du3(t, f, l, slot))(s) for s in range(3)
    ),
    "cp": (lambda lam: _controlled_block(1j * _P1 @ p(lam), 1),),
    "crx": (lambda t: _controlled_block(-0.5j * X @ rx(t), 1),),
    "cry": (lambda t: _controlled_block(-0.5j * Y @ ry(t), 1),),
    "crz": (lambda t: _controlled_block(-0.5j * Z @ rz(t), 1),),
    "rzz": (lambda t: -0.5j * np.kron(Z, Z) @ rzz(t),),
    "rxx": (lambda t: -0.5j * np.kron(X, X) @ rxx(t),),
    "ryy": (lambda t: -0.5j * np.kron(Y, Y) @ ryy(t),),
}


def gate_derivative(name: str, params: Sequence[ParamValue], slot: int) -> np.ndarray:
    """Analytic ``∂U/∂params[slot]`` at the (concrete) parameter values.

    This is the adjoint sweep's gate-generator rule: exact matrices, no
    finite differencing. Raises for non-parametric gates / unbound params."""
    gd = GATE_DEFS[name]
    if gd.n_params == 0:
        raise ValueError(f"gate {name} has no parameters to differentiate")
    if not (0 <= slot < gd.n_params):
        raise ValueError(f"gate {name}: slot {slot} out of range [0, {gd.n_params})")
    if is_symbolic(params):
        raise UnboundParameterError(
            f"gate {name} has unbound symbolic params {tuple(params)}; "
            "bind before differentiating"
        )
    return GATE_DERIVS[name][slot](*(float(v) for v in params))


@lru_cache(maxsize=None)
def structural_diagonal_bits(name: str) -> Tuple[bool, ...]:
    """Per-gate-bit *diagonality* at the probe angles: bit ``q`` is diagonal
    iff every structurally-nonzero ``U[r, c]`` has ``r_q == c_q``. Control
    bits of a controlled gate always come out diagonal (the identity block
    is diagonal and the active block keeps them at 1).

    Unlike :func:`insular_mask` this EXCLUDES anti-diagonal bits: two gates
    sharing only mutually-diagonal bits are simultaneously block-diagonal
    over that bit's basis and therefore commute (the optimizer's
    ``gates_commute`` predicate) — a property anti-diagonal bits lack.
    Evaluated at :data:`PROBE_ANGLES`, so it is valid for every binding
    (special concrete angles can only shrink the nonzero pattern).
    """
    m = structural_matrix(name)
    k = int(round(math.log2(m.shape[0])))
    rows, cols = np.nonzero(np.abs(m) > 1e-12)
    return tuple(
        bool(np.all(((rows >> q) & 1) == ((cols >> q) & 1))) for q in range(k)
    )


@lru_cache(maxsize=None)
def structural_matrix(name: str) -> np.ndarray:
    """The gate's matrix at generic :data:`PROBE_ANGLES` — parameter-free.

    Every structural predicate of the compile pipeline (insularity, diagonal
    detection, lazy-flip schedules, kernel costing) evaluates gates through
    this, so staging/kernelization/compilation decisions are identical for
    every binding of the same circuit structure. For non-parametric gates this
    is the concrete matrix.
    """
    gd = GATE_DEFS[name]
    return gd.fn(*PROBE_ANGLES[: gd.n_params])

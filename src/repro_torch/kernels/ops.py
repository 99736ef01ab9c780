"""Wrappers that launch the hand-written CUDA kernels.

* :func:`fused_apply` — ``csrc/fused_apply.cu``, the counterpart of the TPU
  kernel ``repro/kernels/fusion.py::fused_matmul``;
* :func:`shm_apply` — ``csrc/shm_apply.cu``, the counterpart of
  ``repro/kernels/shm.py::shm_apply``.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take. A state on the CPU goes to the kernel's
plain version (:mod:`repro_torch.kernels.ref`); a state on a CUDA device
launches the kernel on PyTorch's current stream, or raises — there is no
fallback. Both update the state in place and return it. The kernels
address index bits themselves, so the tile layouts below (which bits a
thread block stages in shared memory) are plain Python that the CPU tests
reach.

:data:`KERNEL_CALLS` counts the wrappers' dispatches, one per call, so a
run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..sim.apply import n_bits_of
from . import ref
from .ref import Member

KERNEL_CALLS = {"fused": 0, "shm": 0}

# must match csrc/fused_apply.cu (Shape<K>) and csrc/shm_apply.cu
FUSED_MAX_BITS = 7
FUSED_THREADS = 256
FUSED_GROUPS_PER_THREAD = 8
SHM_MAX_WINDOW_BITS = 13
SHM_MAX_TILE_BITS = 14
SHM_MAX_MATRIX_BITS = 4
SHM_MAX_DIAG_BITS = 16
SHM_DESC_WORDS = 24
SHM_MIN_TILE_BITS = 10


def reset_kernel_counters() -> None:
    for k in KERNEL_CALLS:
        KERNEL_CALLS[k] = 0


def kernel_call_counts() -> Dict[str, int]:
    return dict(KERNEL_CALLS)


# ----------------------------------------------------------------------
# tile layouts (which state bits one thread block stages)
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class TileLayout:
    """A block's tile: the state bits ``pos`` (ascending) vary inside it,
    the other bits are fixed per tile. For the fused kernel, ``tb[j]`` is
    the tile bit of matrix index bit ``j`` and ``gb`` the tile bits that
    number the groups inside a tile."""

    n: int
    L: int
    pos: Tuple[int, ...]
    tb: Tuple[int, ...] = ()
    gb: Tuple[int, ...] = ()

    @property
    def t(self) -> int:
        return len(self.pos)

    @property
    def n_tiles(self) -> int:
        return 1 << (self.n - self.t)


def fused_groups_per_tile(k: int) -> int:
    K = 1 << k
    rows_per_thread = min(4, K)
    return FUSED_THREADS // (K // rows_per_thread) * FUSED_GROUPS_PER_THREAD


def fused_layout(n: int, L: int, bits: Sequence[int]) -> TileLayout:
    """The target bits plus the lowest other local bits, enough for the
    kernel's groups per tile (fewer when the shard is smaller)."""
    taken = set(bits)
    others = [b for b in range(L) if b not in taken]
    nb = min(fused_groups_per_tile(len(bits)).bit_length() - 1, len(others))
    gbits = others[:nb]
    pos = tuple(sorted(list(bits) + gbits))
    where = {b: i for i, b in enumerate(pos)}
    return TileLayout(n=n, L=L, pos=pos, tb=tuple(where[b] for b in bits),
                      gb=tuple(where[b] for b in gbits))


def shm_layout(n: int, L: int, window: Sequence[int]) -> TileLayout:
    """The window bits plus the lowest other local bits: those of bits 0-2
    the window leaves out (so tiles move whole 32-byte sectors), and more
    until a tile holds 2^SHM_MIN_TILE_BITS amplitudes, within
    SHM_MAX_TILE_BITS."""
    w = sorted(window)
    taken = set(w)
    others = [b for b in range(L) if b not in taken]
    want = max(sum(1 for b in range(min(3, L)) if b not in taken), SHM_MIN_TILE_BITS - len(w))
    extra = others[:max(0, min(want, SHM_MAX_TILE_BITS - len(w), len(others)))]
    return TileLayout(n=n, L=L, pos=tuple(sorted(w + extra)))


# ----------------------------------------------------------------------
# checks
# ----------------------------------------------------------------------


def _check_state(state: torch.Tensor, L: int) -> Tuple[int, int]:
    if not isinstance(state, torch.Tensor) or state.dtype != torch.complex64:
        raise TypeError("state must be a complex64 tensor")
    if state.dim() != 1 or not state.is_contiguous():
        raise ValueError("state must be a flat contiguous tensor")
    n = n_bits_of(state.numel())
    if not 0 < L <= n:
        raise ValueError(f"L={L} out of range for a 2^{n} state")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {state.device}")
    return n, 1 << (n - L)


def _check_operand(name: str, t: torch.Tensor, state: torch.Tensor, dtype, shape) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise TypeError(f"{name} must be a {dtype} tensor")
    if t.device != state.device:
        raise ValueError(f"{name} is on {t.device}, the state on {state.device}")
    if t.dim() != len(shape) or t.numel() == 0 or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape} "
                         "(None: any size)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_bits(bits: Sequence[int], L: int, limit: int) -> Tuple[int, ...]:
    bits = tuple(int(b) for b in bits)
    if len(set(bits)) != len(bits) or any(not 0 <= b < L for b in bits):
        raise ValueError(f"bits {bits} must be distinct local bits (< {L})")
    if len(bits) > limit:
        raise ValueError(f"{len(bits)} bits exceed the kernel's limit of {limit}")
    return bits


# ----------------------------------------------------------------------
# library loading
# ----------------------------------------------------------------------

_LIBS: Dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)


def load() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load both kernel libraries."""
    if len(_LIBS) < 2:
        from .build import build

        paths = build()
        fused = ctypes.CDLL(str(paths["fused_apply"]))
        fused.fused_apply.argtypes = [_P, _P, _P, _LL, _I, _I, _I, _I, _IP, _IP, _IP, _P]
        fused.fused_apply.restype = _I
        fused.fused_groups_per_tile.argtypes = [_I]
        fused.fused_groups_per_tile.restype = _I
        fused.fused_error_string.argtypes = [_I]
        fused.fused_error_string.restype = ctypes.c_char_p
        shm = ctypes.CDLL(str(paths["shm_apply"]))
        shm.shm_apply.argtypes = [_P, _P, _LL, _I, _I, _I, _IP, _P]
        shm.shm_apply.restype = _I
        shm.shm_max_matrix_bits.restype = _I
        shm.shm_error_string.argtypes = [_I]
        shm.shm_error_string.restype = ctypes.c_char_p
        for k in range(1, FUSED_MAX_BITS + 1):
            if fused.fused_groups_per_tile(k) != fused_groups_per_tile(k):
                raise RuntimeError("fused_apply.cu and ops.py disagree on the tile shape")
        if shm.shm_max_matrix_bits() != SHM_MAX_MATRIX_BITS:
            raise RuntimeError("shm_apply.cu and ops.py disagree on the matrix size")
        _LIBS.update(fused=fused, shm=shm)
    return _LIBS


def _ints(values: Sequence[int]):
    return (ctypes.c_int * max(len(values), 1))(*values)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, errstr, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: {errstr(rc).decode()} (cudaError {rc})")


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------


def fused_apply(
    state: torch.Tensor, u: torch.Tensor, vidx: torch.Tensor,
    bits: Sequence[int], L: int,
) -> torch.Tensor:
    """In place: shard ``s`` of the flat complex64 ``state`` (``[S * 2^L]``)
    gets ``u[vidx[s]]`` applied on local index bits ``bits`` (bit ``j`` of
    the matrix index binds to ``bits[j]``; 1 <= k <= 7). ``u``: complex64
    ``[V, 2^k, 2^k]``; ``vidx``: int32 ``[S]`` with values below ``V`` (not
    checked here: that would stop the host for every launch; the engine
    derives them from the op's dep bits)."""
    n, S = _check_state(state, L)
    bits = _check_bits(bits, L, FUSED_MAX_BITS)
    if not bits:
        raise ValueError("fused_apply needs at least one target bit")
    K = 1 << len(bits)
    _check_operand("u", u, state, torch.complex64, (None, K, K))
    _check_operand("vidx", vidx, state, torch.int32, (S,))
    if state.device.type == "cpu":
        ref.fused_apply_ref(state, u, vidx, bits, L)
        KERNEL_CALLS["fused"] += 1
        return state
    lib = load()["fused"]
    lay = fused_layout(n, L, bits)
    with torch.cuda.device(state.device):
        rc = lib.fused_apply(
            state.data_ptr(), u.data_ptr(), vidx.data_ptr(), lay.n_tiles, L,
            lay.t, len(bits), len(lay.gb), _ints(lay.pos), _ints(lay.tb),
            _ints(lay.gb), _stream(state.device))
    _raise_on(rc, lib.fused_error_string, "fused_apply")
    KERNEL_CALLS["fused"] += 1
    return state


def shm_descriptors(lay: TileLayout, members: Sequence[Member]) -> np.ndarray:
    """The kernel's descriptor table: one row of SHM_DESC_WORDS int64 per
    member (see csrc/shm_apply.cu)."""
    where = {b: i for i, b in enumerate(lay.pos)}
    desc = np.zeros((len(members), SHM_DESC_WORDS), dtype=np.int64)
    for i, (kind, bits, op, vidx) in enumerate(members):
        desc[i, 0] = 0 if kind == "mat" else 1
        desc[i, 1] = len(bits)
        desc[i, 2:2 + len(bits)] = [where[b] for b in bits]
        desc[i, 18] = op.data_ptr()
        desc[i, 19] = op[0].numel()
        desc[i, 20] = vidx.data_ptr()
    return desc


def shm_apply(
    state: torch.Tensor, window: Sequence[int], members: Sequence[Member], L: int,
) -> torch.Tensor:
    """In place: apply the members of one shm group, in order, in one read
    and one write of ``state``. ``window``: the group's local bits (at most
    13); each member ``(kind, bits, op, vidx)`` acts on bits inside it: a
    ``"mat"`` member has ``op`` complex64 ``[V, 2^kg, 2^kg]`` (kg <= 4), a
    ``"diag"`` member ``op`` complex64 ``[V, 2^kd]``; ``vidx`` int32 ``[S]``
    picks the variant of each shard."""
    n, S = _check_state(state, L)
    window = _check_bits(sorted(window), L, SHM_MAX_WINDOW_BITS)
    if not members:
        raise ValueError("shm_apply needs at least one member")
    inside = set(window)
    checked = []
    for kind, bits, op, vidx in members:
        if kind not in ("mat", "diag"):
            raise ValueError(f"unknown shm member kind {kind!r}")
        limit = SHM_MAX_MATRIX_BITS if kind == "mat" else SHM_MAX_DIAG_BITS
        bits = _check_bits(bits, L, limit)
        if not set(bits) <= inside:
            raise ValueError(f"member bits {bits} leave the window {window}")
        D = 1 << len(bits)
        _check_operand("op", op, state, torch.complex64,
                       (None, D, D) if kind == "mat" else (None, D))
        _check_operand("vidx", vidx, state, torch.int32, (S,))
        checked.append((kind, bits, op, vidx))
    if state.device.type == "cpu":
        ref.shm_apply_ref(state, window, checked, L)
        KERNEL_CALLS["shm"] += 1
        return state
    lib = load()["shm"]
    lay = shm_layout(n, L, window)
    with torch.cuda.device(state.device):
        desc = torch.from_numpy(shm_descriptors(lay, checked)).to(state.device)
        rc = lib.shm_apply(state.data_ptr(), desc.data_ptr(), lay.n_tiles, L, lay.t,
                           len(checked), _ints(lay.pos), _stream(state.device))
    _raise_on(rc, lib.shm_error_string, "shm_apply")
    KERNEL_CALLS["shm"] += 1
    return state

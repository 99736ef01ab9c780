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
thread block stages) and the shm kernel's program (its phases of register
bits) are plain Python that the CPU tests reach.

:data:`KERNEL_CALLS` counts the wrappers' dispatches, one per call, so a
run can show that its path went through the kernels; :data:`FUSED_CALLS_BY_K`
splits the ``fused_apply`` ones by the number of target bits k.
:data:`SCHEDULE_CALLS` counts the shm programs scheduled, so a warm rebind
can show that it scheduled none.
"""

from __future__ import annotations

import bisect
import ctypes
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import ref
from .ref import Member

KERNEL_CALLS = {"fused": 0, "shm": 0}
FUSED_CALLS_BY_K: Dict[int, int] = {}
SCHEDULE_CALLS = {"shm": 0}

# must match csrc/fused_apply.cu and csrc/shm_apply.cu
FUSED_MAX_BITS = 7
FUSED_MIN_MATRIX_BITS = 4  # smaller unitaries run as I (x) U on 4 matrix bits
FUSED_TILE_AMPS = 1 << 12
SHM_MAX_WINDOW_BITS = 13
SHM_TILE_BITS = 13
SHM_REG_BITS = 5  # a thread holds 2^5 amplitudes
SHM_REG_MATRIX_BITS = 2  # matrices up to this size are applied from registers
SHM_MAX_MATRIX_BITS = 4
SHM_MAX_DIAG_BITS = 16
SHM_DESC_WORDS = 12
SHM_TABLE_CHUNK = 128  # steps of the table a block holds in shared memory at a time
# shm step kinds (csrc/shm_apply.cu: enum Kind)
STEP_MAT1, STEP_MAT2, STEP_DIAG, STEP_WRITE, STEP_SMEM_MAT, STEP_READ = range(6)


def reset_kernel_counters() -> None:
    for k in KERNEL_CALLS:
        KERNEL_CALLS[k] = 0
    FUSED_CALLS_BY_K.clear()


def kernel_call_counts() -> Dict[str, int]:
    return dict(KERNEL_CALLS)


def fused_call_counts_by_k() -> Dict[int, int]:
    return dict(FUSED_CALLS_BY_K)


def _count_fused(k: int) -> None:
    KERNEL_CALLS["fused"] += 1
    FUSED_CALLS_BY_K[k] = FUSED_CALLS_BY_K.get(k, 0) + 1


# ----------------------------------------------------------------------
# tile layouts (which state bits one thread block stages)
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class TileLayout:
    """A block's tile: the state bits ``pos`` (ascending) vary inside it,
    the other bits are fixed per tile. For the fused kernel, ``tb[j]`` is
    the tile bit of matrix index bit ``j`` (``j >= k``: a bit of the
    identity in I (x) U) and ``gb`` the tile bits that number the groups
    inside a tile. Every tile bit is a local bit (below ``L``), so the
    layout is the same for every shard; ``n`` only sets :attr:`n_tiles`
    (the wrappers build it for one shard, ``n = L``, and launch
    ``S * n_tiles`` tiles for ``S`` shards)."""

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
    """Groups of a tile of 2^12 amplitudes, at most 128 (csrc: Shape::NG)."""
    return FUSED_TILE_AMPS >> max(k, 5)


def fused_layout(n: int, L: int, bits: Sequence[int]) -> TileLayout:
    """The target bits (below 4 of them, plus the lowest other local bits up
    to 4 matrix bits) and the lowest remaining local bits as group bits,
    enough for the kernel's groups per tile (fewer when the shard is
    smaller)."""
    taken = set(bits)
    others = [b for b in range(L) if b not in taken]
    extra = others[:max(0, FUSED_MIN_MATRIX_BITS - len(bits))]
    if len(bits) + len(extra) < FUSED_MIN_MATRIX_BITS:
        raise ValueError(f"fused_apply needs at least {FUSED_MIN_MATRIX_BITS} local bits, L={L}")
    targets = list(bits) + extra
    rest = others[len(extra):]
    nb = min(fused_groups_per_tile(len(bits)).bit_length() - 1, len(rest))
    gbits = rest[:nb]
    pos = tuple(sorted(targets + gbits))
    where = {b: i for i, b in enumerate(pos)}
    return TileLayout(n=n, L=L, pos=pos, tb=tuple(where[b] for b in targets),
                      gb=tuple(where[b] for b in gbits))


def shm_layout(n: int, L: int, window: Sequence[int]) -> TileLayout:
    """The window bits plus the lowest other local bits, up to
    SHM_TILE_BITS tile bits (so tiles move whole 32-byte sectors where the
    window leaves room)."""
    w = sorted(window)
    taken = set(w)
    others = [b for b in range(L) if b not in taken]
    extra = others[:max(0, min(SHM_TILE_BITS, L) - len(w))]
    return TileLayout(n=n, L=L, pos=tuple(sorted(w + extra)))


# ----------------------------------------------------------------------
# the shm kernel's program: phases of register bits
# ----------------------------------------------------------------------
#
# A layout is a tuple of the t tile bits: entries 0..4 are the register
# bits (bit q of a thread's register index), entries 5.. the thread bits
# (bit b of the thread index). A thread holds the 32 amplitudes whose tile
# index has its thread bits fixed.


def shm_io_layout(t: int) -> Tuple[int, ...]:
    """The layout the kernel reads and writes the state in: the top 5 tile
    bits in registers, the thread bits the tile's lowest (address order)."""
    r = SHM_REG_BITS
    return tuple(range(t - r, t)) + tuple(range(t - r))


def _phase_layout(t: int, regs: Sequence[int]) -> Tuple[int, ...]:
    """The layout with register bits ``regs``. The first four thread (lane)
    bits are the lowest others whose residues mod 4 differ, below 12: with
    the kernel's XOR swizzle a half-warp then reaches all 32 banks."""
    io = shm_io_layout(t)
    if set(regs) == set(io[:SHM_REG_BITS]):
        return io
    rest = [b for b in range(t) if b not in regs]
    lanes: List[int] = []
    for b in rest:
        if len(lanes) < 4 and b < 12 and all(b % 4 != c % 4 for c in lanes):
            lanes.append(b)
    return tuple(sorted(regs)) + tuple(lanes) + tuple(b for b in rest if b not in lanes)


def _is_diag(member) -> bool:
    return member[0] == "diag" or not member[1]


def _blockers(mem) -> List[List[int]]:
    """For each member, the earlier members it must directly follow. Two
    members must keep their order when they share a bit and are not both
    diagonal (members on disjoint bits commute, and so do diagonals). On
    each of its bits a member follows the last matrix before it, and a
    matrix also follows the diagonals since then; every other pair that
    must keep its order does so through these."""
    last_mat: Dict[int, int] = {}
    diags_since: Dict[int, List[int]] = {}
    out = []
    for i, m in enumerate(mem):
        diag, before = _is_diag(m), set()
        for b in m[1]:
            if b in last_mat:
                before.add(last_mat[b])
            if not diag:
                before.update(diags_since.get(b, ()))
        for b in m[1]:
            if diag:
                diags_since.setdefault(b, []).append(i)
            else:
                last_mat[b], diags_since[b] = i, []
        out.append(sorted(before))
    return out


def _next_regs(mem, blockers, done, pending, t: int) -> List[int]:
    """Register bits for the next phase: the bits of the pending register
    matrices, in member order, that can run in it (everything they must
    follow is done, or in this phase, or a diagonal that can then run),
    as many as fit; then the I/O register bits (so the last phase may need
    no exchange back), then the highest others. ``pending``: the members
    not done, in order."""
    regs: List[int] = []
    passed = set()
    for i in pending:
        if len(regs) == SHM_REG_BITS:
            break
        if not all(done[j] or j in passed for j in blockers[i]):
            continue
        kind, tb = mem[i][:2]
        if _is_diag(mem[i]):
            passed.add(i)
            continue
        if len(tb) > SHM_REG_MATRIX_BITS:
            continue
        new = [b for b in tb if b not in regs]
        if len(regs) + len(new) <= SHM_REG_BITS:
            regs += new
            passed.add(i)
    for b in list(shm_io_layout(t)[SHM_REG_BITS - 1::-1]) + list(range(t - 1, -1, -1)):
        if len(regs) == SHM_REG_BITS:
            break
        if b not in regs:
            regs.append(b)
    return regs


def shm_schedule(lay: TileLayout, members: Sequence[Member]) -> List[tuple]:
    """The kernel's program for one group on tile layout ``lay``, a list of
    steps (operand bits as tile bits):

    * ``("mat", layout, bits, op, vidx)``: a 1- or 2-bit matrix from registers;
    * ``("diag", layout, bits, op, vidx)``: a diagonal (or a 0-bit matrix);
    * ``("write", layout)`` / ``("read", layout)``: registers to the tile
      buffer and back, an exchange between phases;
    * ``("smem_mat", bits, op, vidx)``: a 3- or 4-bit matrix on the tile
      buffer, between a write and a read.

    Members run in an order that keeps every pair that does not commute
    (a shared bit, not both diagonal) as given: a list schedule that takes
    ready diagonals at once, then ready register matrices inside the
    current register bits, then ready 3- and 4-bit matrices in shared
    memory, and else exchanges to the register bits that let the most
    pending matrices run. It starts and ends in :func:`shm_io_layout`.
    Ready members are kept in sorted lists by the step they take, so a
    program costs about its length times the number of ready members."""
    SCHEDULE_CALLS["shm"] += 1
    t = lay.t
    where = {b: i for i, b in enumerate(lay.pos)}
    mem = [(kind, tuple(where[b] for b in bits), op, vidx) for kind, bits, op, vidx in members]
    blockers = _blockers(mem)
    waiting = [len(b) for b in blockers]
    unblocks: List[List[int]] = [[] for _ in mem]
    for i, before in enumerate(blockers):
        for j in before:
            unblocks[j].append(i)
    klass = ["diag" if _is_diag(m) else "mat" if len(m[1]) <= SHM_REG_MATRIX_BITS else "smem_mat"
             for m in mem]
    ready: Dict[str, List[int]] = {"diag": [], "mat": [], "smem_mat": []}
    for i in range(len(mem)):
        if not waiting[i]:
            ready[klass[i]].append(i)
    done = [False] * len(mem)
    pending = list(range(len(mem)))
    io = shm_io_layout(t)
    cur, steps, left = io, [], len(mem)

    def take(i, step):
        nonlocal left
        steps.append(step)
        done[i], left = True, left - 1
        ready[klass[i]].remove(i)
        for j in unblocks[i]:
            waiting[j] -= 1
            if not waiting[j]:
                bisect.insort(ready[klass[j]], j)

    while left:
        if ready["diag"]:
            i = ready["diag"][0]
            take(i, ("diag", cur, mem[i][1], mem[i][2], mem[i][3]))
            continue
        regs = set(cur[:SHM_REG_BITS])
        i = next((i for i in ready["mat"] if set(mem[i][1]) <= regs), None)
        if i is not None:
            take(i, ("mat", cur, mem[i][1], mem[i][2], mem[i][3]))
            continue
        steps.append(("write", cur))
        while ready["smem_mat"]:
            i = ready["smem_mat"][0]
            take(i, ("smem_mat",) + mem[i][1:])
        pending = [i for i in pending if not done[i]]
        cur = _phase_layout(t, _next_regs(mem, blockers, done, pending, t))
        steps.append(("read", cur))
    if cur != io:
        steps += [("write", cur), ("read", io)]
    return steps


# ----------------------------------------------------------------------
# checks
# ----------------------------------------------------------------------


def _check_state(state: torch.Tensor, L: int) -> int:
    """The number of shards of 2^L amplitudes in ``state``: any count, so
    a batch of B states of 2^n amplitudes is B * 2^(n-L) shards."""
    if not isinstance(state, torch.Tensor) or state.dtype != torch.complex64:
        raise TypeError("state must be a complex64 tensor")
    if state.dim() != 1 or not state.is_contiguous():
        raise ValueError("state must be a flat contiguous tensor")
    if L <= 0 or state.numel() == 0 or state.numel() % (1 << L):
        raise ValueError(f"a state of {state.numel()} amplitudes is no whole number of "
                         f"2^{L}-amplitude shards")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {state.device}")
    return state.numel() >> L


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
        fused.fused_apply.argtypes = [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _IP, _IP, _IP, _P]
        fused.fused_apply.restype = _I
        fused.fused_groups_per_tile.argtypes = [_I]
        fused.fused_groups_per_tile.restype = _I
        fused.fused_error_string.argtypes = [_I]
        fused.fused_error_string.restype = ctypes.c_char_p
        shm = ctypes.CDLL(str(paths["shm_apply"]))
        shm.shm_apply.argtypes = [_P, _P, _LL, _I, _I, _I, _IP, _P]
        shm.shm_apply.restype = _I
        shm.shm_max_matrix_bits.restype = _I
        shm.shm_register_bits.restype = _I
        shm.shm_table_chunk.restype = _I
        shm.shm_error_string.argtypes = [_I]
        shm.shm_error_string.restype = ctypes.c_char_p
        for k in range(1, FUSED_MAX_BITS + 1):
            if fused.fused_groups_per_tile(k) != fused_groups_per_tile(k):
                raise RuntimeError("fused_apply.cu and ops.py disagree on the tile shape")
        if (shm.shm_max_matrix_bits() != SHM_MAX_MATRIX_BITS
                or shm.shm_register_bits() != SHM_REG_BITS
                or shm.shm_table_chunk() != SHM_TABLE_CHUNK):
            raise RuntimeError("shm_apply.cu and ops.py disagree on the matrix or register size "
                               "or the table chunk")
        _LIBS.update(fused=fused, shm=shm)
    return _LIBS


def _ints(values: Sequence[int]):
    return (ctypes.c_int * max(len(values), 1))(*values)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device``. To CUDA it goes from pinned memory
    without the host waiting: from pageable memory the host would wait for
    the current stream's queued work, which stalls an offload stage's
    pipeline of copies and kernels."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


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
    derives them from the op's dep bits). ``S`` is any count: a batch of
    states, or of sweep points, is one launch over all their shards."""
    S = _check_state(state, L)
    bits = _check_bits(bits, L, FUSED_MAX_BITS)
    if not bits:
        raise ValueError("fused_apply needs at least one target bit")
    K = 1 << len(bits)
    _check_operand("u", u, state, torch.complex64, (None, K, K))
    _check_operand("vidx", vidx, state, torch.int32, (S,))
    if state.device.type == "cpu":
        ref.fused_apply_ref(state, u, vidx, bits, L)
        _count_fused(len(bits))
        return state
    lay = fused_layout(L, L, bits)
    lib = load()["fused"]
    with torch.cuda.device(state.device):
        rc = lib.fused_apply(
            state.data_ptr(), u.data_ptr(), vidx.data_ptr(), S * lay.n_tiles, L,
            lay.t, len(bits), len(lay.tb), len(lay.gb), _ints(lay.pos), _ints(lay.tb),
            _ints(lay.gb), _stream(state.device))
    _raise_on(rc, lib.fused_error_string, "fused_apply")
    _count_fused(len(bits))
    return state


def _pack(values: Sequence[int]) -> List[int]:
    """Sixteen 16-bit fields in four words (field f: bits 16 (f % 4) of
    word f // 4)."""
    words = [0] * 4
    for f, v in enumerate(values):
        words[f // 4] |= int(v) << (16 * (f % 4))
    return words


_TEMPLATES: "OrderedDict[tuple, tuple]" = OrderedDict()
_TEMPLATES_KEPT = 256


def _step_template(lay: TileLayout, shape: Tuple[Tuple[str, Tuple[int, ...]], ...]):
    """The step table of a group whose members have the ``(kind, bits)`` of
    ``shape``, with the operand words left 0, plus the rows that take an
    operand and the member each takes. The program depends on nothing else,
    so it is scheduled once per layout and shape: a rebind, or a sweep,
    only fills in the operands."""
    key = (lay.pos, shape)
    hit = _TEMPLATES.get(key)
    if hit is not None:
        _TEMPLATES.move_to_end(key)
        return hit
    rows, at, who = [], [], []
    for step in shm_schedule(lay, [(kind, bits, i, i) for i, (kind, bits) in enumerate(shape)]):
        kind = step[0]
        row = [0] * SHM_DESC_WORDS
        if kind in ("write", "read"):
            row[0] = STEP_WRITE if kind == "write" else STEP_READ
            row[2:6] = _pack(step[1])
            rows.append(row)
            continue
        if kind == "smem_mat":
            tb, member = step[1], step[2]
            row[0], fields = STEP_SMEM_MAT, tb
        else:
            _, layout, tb, member, _ = step
            if kind == "diag":
                row[0] = STEP_DIAG
                fields = [1 << tb.index(b) if b in tb else 0 for b in layout]
            else:
                row[0] = STEP_MAT1 if len(tb) == 1 else STEP_MAT2
                fields = [layout.index(b) for b in tb]
        row[1] = len(tb)
        row[2:6] = _pack(fields)
        at.append(len(rows))
        who.append(member)
        rows.append(row)
    table = np.array(rows, dtype=np.uint64).reshape(-1, SHM_DESC_WORDS).view(np.int64)
    hit = (table, np.array(at, dtype=np.int64), np.array(who, dtype=np.int64))
    _TEMPLATES[key] = hit
    if len(_TEMPLATES) > _TEMPLATES_KEPT:
        _TEMPLATES.popitem(last=False)
    return hit


def shm_descriptors(lay: TileLayout, members: Sequence[Member]) -> np.ndarray:
    """The kernel's step table: one row of SHM_DESC_WORDS int64 per step of
    :func:`shm_schedule` (see csrc/shm_apply.cu). It holds the operands'
    addresses, not their values: words 6-8 of a step are its operand's
    address, the size of one variant and the variant index's address."""
    table, at, who = _step_template(lay, tuple((kind, tuple(bits)) for kind, bits, _, _ in members))
    desc = table.copy()
    if len(at):
        words = np.array([(op.data_ptr(), op[0].numel(), vidx.data_ptr())
                          for _, _, op, vidx in members], dtype=np.uint64).view(np.int64)
        desc[at, 6:9] = words[who]
    return desc


_TABLES: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_TABLES_KEPT = 256


def _device_table(lay: TileLayout, members: Sequence[Member], device) -> torch.Tensor:
    """The step table of a group on ``device``, built once: the engine runs
    the same groups on the same operands every run. The key holds all the
    table depends on (the operands by address and size), so a table found
    under it is the table :func:`shm_descriptors` would build."""
    key = (device, lay, tuple((kind, bits, op.data_ptr(), op[0].numel(), vidx.data_ptr())
                              for kind, bits, op, vidx in members))
    desc = _TABLES.get(key)
    if desc is None:
        desc = to_device(shm_descriptors(lay, members), device)
        _TABLES[key] = desc
        if len(_TABLES) > _TABLES_KEPT:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
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
    S = _check_state(state, L)
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
    lay = shm_layout(L, L, window)
    if lay.t < SHM_REG_BITS:
        raise ValueError(f"shm_apply needs at least {SHM_REG_BITS} local bits, L={L}")
    lib = load()["shm"]
    with torch.cuda.device(state.device):
        desc = _device_table(lay, checked, state.device)
        rc = lib.shm_apply(state.data_ptr(), desc.data_ptr(), S * lay.n_tiles, L, lay.t,
                           len(desc), _ints(lay.pos), _stream(state.device))
    _raise_on(rc, lib.shm_error_string, "shm_apply")
    KERNEL_CALLS["shm"] += 1
    return state

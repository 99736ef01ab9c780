"""Gate application on dense torch state vectors, and the bit-level
permute / flip / broadcast helpers every layer of the port shares.

Conventions (identical to ``repro/sim/apply.py``):

* flat state ``psi[2^n]``: index bit ``p`` (0 = least significant) is
  *physical* qubit ``p``;
* view ``psi.reshape((2,)*n)``: array axis ``i`` corresponds to bit ``n-1-i``;
* a gate's matrix index bit ``j`` (see :mod:`repro_torch.core.gates`) binds
  to ``gate.qubits[j]``.

PyTorch's CUDA elementwise, copy and reduction kernels refuse tensors with
more than :data:`MAX_DIMS` dimensions after coalescing, so no helper here
ever hands PyTorch a ``(2,)*n`` view. Each one first merges runs of adjacent
index bits that move together into one axis (a permutation keeps the runs it
does not break; a broadcast keeps the runs of target and non-target bits).
If an operation still needs more than :data:`MAX_DIMS` axes, it is split over
the values of its smallest axes into several smaller operations, each within
the limit. Tests lower :data:`MAX_DIMS` to force that split.

The numpy helpers at the bottom (``scatter_bits`` .. ``specialize_gate``)
are copied from the reference unchanged: the stage compiler builds its
tensors with them on the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

# PyTorch's CUDA TensorIterator limit (ATen/cuda/detail/OffsetCalculator.cuh)
MAX_DIMS = 25


def n_bits_of(size: int) -> int:
    n = int(size).bit_length() - 1
    if size != 1 << n:
        raise ValueError(f"size {size} is not a power of two")
    return n


# ----------------------------------------------------------------------
# splitting an operation that needs more than MAX_DIMS axes
# ----------------------------------------------------------------------


def _smallest_axis(t: torch.Tensor) -> int:
    return min(range(t.dim()), key=lambda ax: t.shape[ax])


def _copy_into(dst: torch.Tensor, src: torch.Tensor, flip_axes: Sequence[int] = ()) -> None:
    """``dst[...] = src[...]`` with the size-2 axes in ``flip_axes`` read
    reversed. Flipped axes and, past :data:`MAX_DIMS`, the smallest axes are
    peeled off in a Python loop so every copy PyTorch sees is in bounds."""
    if flip_axes:
        ax, rest = flip_axes[0], [a - (a > flip_axes[0]) for a in flip_axes[1:]]
        for i in range(2):
            _copy_into(dst.select(ax, i), src.select(ax, 1 - i), rest)
        return
    if dst.dim() <= MAX_DIMS:
        dst.copy_(src)
        return
    ax = _smallest_axis(dst)
    for i in range(dst.shape[ax]):
        _copy_into(dst.select(ax, i), src.select(ax, i))


def _mul_into(x: torch.Tensor, w: torch.Tensor) -> None:
    """In-place ``x *= w`` with broadcasting (``w`` has ``x``'s rank)."""
    if x.dim() <= MAX_DIMS:
        x.mul_(w)
        return
    ax = _smallest_axis(x)
    for i in range(x.shape[ax]):
        _mul_into(x.select(ax, i), w.select(ax, i if w.shape[ax] > 1 else 0))


def _sum_into(p: torch.Tensor, drop: Sequence[int]) -> torch.Tensor:
    """``p.sum(dim=drop)`` in float64, split over kept axes past MAX_DIMS."""
    if p.dim() <= MAX_DIMS:
        return p.sum(dim=tuple(drop), dtype=torch.float64) if drop else p.to(torch.float64)
    keep = [a for a in range(p.dim()) if a not in drop]
    ax = min(keep, key=lambda a: p.shape[a]) if keep else _smallest_axis(p)
    rest = [a - (a > ax) for a in drop if a != ax]
    parts = [_sum_into(p.select(ax, i), rest) for i in range(p.shape[ax])]
    if ax in drop:
        return sum(parts[1:], parts[0])
    out_ax = sum(1 for a in keep if a < ax)
    return torch.stack(parts, dim=out_ax)


# ----------------------------------------------------------------------
# bit-level permutation, flips, broadcasts and reductions
# ----------------------------------------------------------------------


def permute_bits(
    x: torch.Tensor,
    src_bit_of: Sequence[int],
    flip_bits: Sequence[int] = (),
    lead: int = 0,
) -> torch.Tensor:
    """New contiguous tensor ``y`` with index bit ``p`` of ``y`` = bit
    ``src_bit_of[p]`` of ``x`` (XOR 1 where that source bit is in
    ``flip_bits``). The last dimension of ``x`` is the flat ``2^n`` index;
    the ``lead`` dimensions before it are carried along unchanged."""
    lead_shape = tuple(x.shape[:lead])
    n = len(src_bit_of)
    flips = set(flip_bits)
    assert x.shape[lead:] == (1 << n,), (x.shape, n, lead)
    # runs in output order (high -> low): new bits p, p-1 stay together when
    # their sources are adjacent and neither carries a flip
    runs: List[List[int]] = []  # each: source bits, high -> low
    for p in range(n - 1, -1, -1):
        s = src_bit_of[p]
        if (runs and runs[-1][-1] == s + 1 and s not in flips
                and runs[-1][-1] not in flips):
            runs[-1].append(s)
        else:
            runs.append([s])
    old_order = sorted(range(len(runs)), key=lambda r: -runs[r][0])
    old_shape = lead_shape + tuple(1 << len(runs[r]) for r in old_order)
    axis_of_run = {r: lead + i for i, r in enumerate(old_order)}
    perm = list(range(lead)) + [axis_of_run[r] for r in range(len(runs))]
    src = x.reshape(old_shape).permute(perm)
    out = torch.empty(lead_shape + tuple(1 << len(r) for r in runs),
                      dtype=x.dtype, device=x.device)
    flip_axes = [lead + r for r in range(len(runs)) if runs[r][0] in flips]
    _copy_into(out, src, flip_axes)
    return out.reshape(lead_shape + (1 << n,))


def _bit_groups(n: int, bits: Sequence[int]) -> List[Tuple[bool, int]]:
    """Runs of index bits (high -> low) split by membership in ``bits``:
    ``(is_member, run_length)`` per run."""
    member = set(bits)
    runs: List[Tuple[bool, int]] = []
    for p in range(n - 1, -1, -1):
        m = p in member
        if runs and runs[-1][0] == m:
            runs[-1] = (m, runs[-1][1] + 1)
        else:
            runs.append((m, 1))
    return runs


def mul_bits_(x: torch.Tensor, w: torch.Tensor, bits: Sequence[int], lead: int = 0) -> torch.Tensor:
    """In place ``x[..., i] *= w[..., idx(i)]`` where bit ``j`` of ``idx(i)``
    is bit ``bits[j]`` of ``i``. ``w`` has shape ``w_lead + (2^k,)`` with
    ``w_lead`` broadcastable against ``x``'s ``lead`` dimensions."""
    lead_shape = tuple(x.shape[:lead])
    n = n_bits_of(x.shape[-1])
    k = len(bits)
    if k == 0:
        x.mul_(w.reshape(tuple(w.shape[:-1]) + (1,)))
        return x
    order = sorted(range(k), key=lambda j: bits[j])
    if order != list(range(k)):  # put w's index bits in ascending bit order
        w = permute_bits(w, order, lead=w.dim() - 1)
    runs = _bit_groups(n, bits)
    xv = x.view(lead_shape + tuple(1 << ln for _, ln in runs))
    wv = w.reshape(tuple(w.shape[:-1]) + tuple(
        (1 << ln) if m else 1 for m, ln in runs))
    _mul_into(xv, wv)
    return x


def sum_bits(p: torch.Tensor, keep_bits: Sequence[int]) -> torch.Tensor:
    """float64 marginal of a flat ``[2^n]`` real tensor over ``keep_bits``
    (ascending): output index bit ``j`` = input bit ``keep_bits[j]``."""
    n = n_bits_of(p.numel())
    keep = list(keep_bits)
    assert keep == sorted(keep)
    runs = _bit_groups(n, keep)
    pv = p.reshape(tuple(1 << ln for _, ln in runs))
    drop = [i for i, (m, _) in enumerate(runs) if not m]
    return _sum_into(pv, drop).reshape(-1)


def apply_matrix_bits(
    x: torch.Tensor, mat: torch.Tensor, bits: Sequence[int], lead: int = 0
) -> torch.Tensor:
    """New tensor: ``mat`` (``[..., 2^k, 2^k]``, leading dims broadcast
    against ``x``'s ``lead`` dimensions) applied on index bits ``bits`` of
    the flat last dimension of ``x`` (bit ``j`` of the matrix index binds to
    ``bits[j]``). Moves the target bits to the bottom, multiplies, moves
    them back."""
    lead_shape = tuple(x.shape[:lead])
    n = n_bits_of(x.shape[-1])
    k = len(bits)
    rest = [b for b in range(n) if b not in bits]
    fwd = list(bits) + rest  # new bit p <- old bit fwd[p]
    y = permute_bits(x, fwd, lead=lead)
    y = y.view(lead_shape + (1 << (n - k), 1 << k))
    z = torch.matmul(y, mat.transpose(-1, -2))
    inv = [0] * n
    for p, b in enumerate(fwd):
        inv[b] = p
    return permute_bits(z.reshape(lead_shape + (1 << n,)), inv, lead=lead)


def apply_matrix(psi_view: torch.Tensor, mat: torch.Tensor, bits: Sequence[int]) -> torch.Tensor:
    """Apply a ``2^k x 2^k`` matrix to the ``(2,)*n`` view on index bits
    ``bits`` (bit j of the matrix index binds to bits[j])."""
    shape = psi_view.shape
    out = apply_matrix_bits(psi_view.reshape(-1), mat, bits)
    return out.view(shape)


def apply_diag(psi_view: torch.Tensor, diag: torch.Tensor, bits: Sequence[int]) -> torch.Tensor:
    """Elementwise multiply by ``diag[2^k]`` indexed by the values of ``bits``."""
    out = psi_view.reshape(-1).clone()
    mul_bits_(out, diag.reshape(-1).to(out.dtype), bits)
    return out.view(psi_view.shape)


# ----------------------------------------------------------------------
# host-side numpy helpers (copied from repro/sim/apply.py)
# ----------------------------------------------------------------------


def scatter_bits(values: np.ndarray, positions: Sequence[int]) -> np.ndarray:
    """Vectorized bit scatter: deposit bit ``j`` of each value at position
    ``positions[j]`` of the result (numpy index arithmetic, no Python loop
    over values)."""
    out = np.zeros_like(np.asarray(values, dtype=np.int64))
    for j, p in enumerate(positions):
        out |= ((values >> j) & 1) << p
    return out


def gather_bits(values: np.ndarray, positions: Sequence[int]) -> np.ndarray:
    """Vectorized bit gather: bit ``j`` of the result is bit ``positions[j]``
    of each value (inverse of :func:`scatter_bits`)."""
    out = np.zeros_like(np.asarray(values, dtype=np.int64))
    for j, p in enumerate(positions):
        out |= ((values >> p) & 1) << j
    return out


def embed_matrix(mat: np.ndarray, positions: Sequence[int], k: int) -> np.ndarray:
    """Embed a matrix over ``len(positions)`` bits into a ``2^k``-bit space.

    ``positions[j]`` is the target bit (within the k-bit space) for matrix
    index bit ``j``. Pure numpy index arithmetic (host-side kernel building).
    """
    kk = len(positions)
    dim, DIM = 2**kk, 2**k
    rest = [b for b in range(k) if b not in positions]
    base = scatter_bits(np.arange(1 << len(rest)), rest)  # identity sub-space
    sub = scatter_bits(np.arange(dim), positions)  # embedded matrix indices
    rows = base[:, None, None] | sub[None, :, None]
    cols = base[:, None, None] | sub[None, None, :]
    out = np.zeros((DIM, DIM), dtype=np.complex128)
    out[rows, cols] = np.asarray(mat, dtype=np.complex128)[None, :, :]
    return out


def specialize_gate(
    mat: np.ndarray,
    nonlocal_bits: Sequence[int],
    values: Sequence[int],
    classify: np.ndarray = None,
) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Restrict a gate matrix on its non-local index bits.

    For each non-local matrix bit ``j`` with effective input value ``v``:
    * diagonal-in-j  -> keep entries with r_j == c_j == v;
    * antidiag-in-j  -> keep entries with c_j == v, r_j == 1-v, and report the
      bit as *flipped* (the caller toggles its lazy flip state).

    ``classify`` (optional) supplies the nonzero pattern used for the
    diagonal/antidiagonal branch decisions while entry *values* still come
    from ``mat``. The parametric compile pipeline passes the gate's
    structural (generic-probe) matrix here so that specialization takes the
    same branches — and reports the same flips — for every binding, even at
    special angles where ``mat`` entries vanish (the probe pattern is a
    superset of every binding's pattern, so extra positions only contribute
    zeros to the reduced matrix).

    Returns (reduced matrix over the remaining bits in ascending original
    order, tuple of flipped non-local bit positions).
    """
    k = int(round(np.log2(mat.shape[0])))
    pattern = mat if classify is None else classify
    rows, cols = np.nonzero(np.abs(pattern) > 1e-14)
    flipped = []
    keep = np.ones(len(rows), dtype=bool)
    for j, v in zip(nonlocal_bits, values):
        rb, cb = (rows >> j) & 1, (cols >> j) & 1
        if np.all(rb[keep] == cb[keep]):
            keep &= (cb == v) & (rb == v)
        elif np.all(rb[keep] != cb[keep]):
            keep &= (cb == v) & (rb == (1 - v))
            flipped.append(j)
        else:
            raise ValueError(f"matrix bit {j} is not insular; staging bug")
    local_bits = [j for j in range(k) if j not in nonlocal_bits]
    dim = 2 ** len(local_bits)
    out = np.zeros((dim, dim), dtype=np.complex128)
    r_kept, c_kept = rows[keep], cols[keep]
    out[gather_bits(r_kept, local_bits), gather_bits(c_kept, local_bits)] = mat[
        r_kept, c_kept
    ]
    return out, tuple(flipped)
